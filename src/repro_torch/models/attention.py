"""Attention, ported from the JAX package's ``models/attention.py``.

* :func:`attend_blocked` — flash attention with a flash backward, the
  training path: a ``torch.autograd.Function`` whose forward saves each
  row's logsumexp and whose backward recomputes the probabilities from it,
  as the JAX function's custom VJP does.
* :func:`attend_plain` — materialized-scores attention (the oracle).
* :func:`attend_decode` — one-token GQA attention against a (possibly
  ring-buffered) KV cache.
* :func:`attn_forward` / :func:`attn_decode` — the full attention block:
  projections, qk_norm, rope, cache handling.

Attention goes through ``kernels.ops``, which picks by device: kernels B1
(with its logsumexp when training), B1b (the backward) and B2 on the card,
their plain versions on the CPU (for training, the JAX package's blocked
``_attend_fwd_impl`` / ``_attend_bwd_impl`` over ``block``-row pairs).
On DTensors (a model on a device mesh) q and k are constrained with
``shard_act`` where the JAX function constrains them, and
``attend_blocked``'s Function runs on each rank's local shards
(``ops.run_local``), each rank with the kv heads its q heads read.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.distributed.sharding import is_meshed, local_ranges, redistribute, shard_dims
from repro_torch.kernels import block_of, ops
from repro_torch.kernels.flash_attention import NEG_INF, flash_attention_plain
from repro_torch.models.layers import head_rms_norm, rope, shard_act

__all__ = ["NEG_INF", "attend_blocked", "attend_plain", "attend_decode", "attn_forward",
           "attn_decode"]


class _AttendBlocked(torch.autograd.Function):
    """B1 with its logsumexp forward, B1b backward (the plain blocked versions
    on the CPU). Saves (q, k, v, out, lse), as the JAX custom VJP does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, block):
        out, lse = ops.flash_attention_lse(q, k, v, causal=causal, window=window, block=block)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, block)
        return out

    @staticmethod
    def backward(ctx, dout):
        # B1b takes contiguous tensors (no copy where they are: q, k, v and
        # out of attn_forward); dout may arrive strided
        q, k, v, out, lse, dout = (t.contiguous() for t in (*ctx.saved_tensors, dout))
        causal, window, block = ctx.mask
        dq, dk, dv = ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                             window=window, block=block)
        return dq, dk, dv, None, None, None


def attend_blocked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                   window: int = 0, block: int = 512) -> torch.Tensor:
    """Flash attention with a flash backward. q [B,S,H,hd]; k,v [B,S,KV,hd].

    The backward recomputes p-blocks from the saved (q, k, v, out,
    logsumexp) instead of saving every probability block of the forward.
    ``block`` is the plain versions' block (a divisor of S); the kernels
    take their own tiles."""
    block = min(block, q.shape[1])
    if q.shape[1] % block:
        raise ValueError(f"S={q.shape[1]} is not a multiple of block={block}")
    if is_meshed(q, k, v):
        # the Function runs on each rank's local shards (ops.run_local)
        mesh, qpl, kvpl, hdims = ops.attention_plan(q, k, head_dim=2, kv_dim=2)
        fn = ops.local_heads(lambda q, k, v: _AttendBlocked.apply(q, k, v, causal, window, block),
                             mesh, hdims, q.shape[2], k.shape[2], (1, 2))
        return ops.run_local(fn, mesh, [q, k, v], [qpl, kvpl, kvpl], qpl, q.shape)
    return _AttendBlocked.apply(q, k, v, causal, window, block)


def attend_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool, window: int = 0) -> torch.Tensor:
    """Materialized-scores reference. q [B,S,H,hd]; k,v [B,S,KV,hd]."""
    return flash_attention_plain(q, k, v, causal=causal, window=window)


def attend_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                  positions: torch.Tensor, *, ring: bool = False) -> torch.Tensor:
    """One-token attention against the cache.

    q: [B, H, hd]; caches: [B, W, KV, hd]; positions: [B] (index of the token
    being generated). ``ring=True``: the cache is a ring buffer of width W over
    a longer stream (local layers), every slot written so far in-window.
    """
    return ops.decode_attention(q, k_cache, v_cache, positions, ring=ring)


def _split_heads(t: torch.Tensor, n: int, hd: int, *, split: bool = True) -> torch.Tensor:
    """``t`` [..., n * hd] as [..., n, hd]. A DTensor whose last dim is split
    in a way that does not keep the n heads whole (7 heads over 2 ranks) is
    gathered on that dim first: the kernels take whole heads, as the JAX
    constraint's ``None`` on hd asks. With ``split`` (q's heads) the heads
    are then sliced back over the same mesh dims, each rank a contiguous
    range of at most ``ceil(n / ranks)`` whole heads (DTensor's uneven
    split: 4 and 3; deepseek's 56 over 16 ranks, 4 on each of 14), so that
    each rank's attention takes its own heads, as XLA splits the work; the
    slice moves no data. Without it (kv heads) they stay whole."""
    if is_meshed(t):
        dims = shard_dims(t, t.dim() - 1)
        if n % math.prod(t.device_mesh.size(i) for i in dims):
            from torch.distributed.tensor import Replicate, Shard
            t = redistribute(t, [Replicate() if i in dims else p
                                 for i, p in enumerate(t.placements)])
            t = t.reshape(*t.shape[:-1], n, hd)
            if not split:
                return t
            return redistribute(t, [Shard(t.dim() - 2) if i in dims else p
                                    for i, p in enumerate(t.placements)])
    return t.reshape(*t.shape[:-1], n, hd)


def _whole_heads(t: torch.Tensor) -> torch.Tensor:
    """``t`` [..., n, hd] with a head split that is uneven over its mesh
    dims (:func:`_split_heads`) gathered, so that the heads flatten into
    one dim as DTensor lays out a split."""
    if is_meshed(t):
        dims = shard_dims(t, t.dim() - 2)
        if t.shape[-2] % math.prod(t.device_mesh.size(i) for i in dims):
            from torch.distributed.tensor import Replicate
            return redistribute(t, [Replicate() if i in dims else p
                                    for i, p in enumerate(t.placements)])
    return t


class _MergeHeads(torch.autograd.Function):
    """``[..., n, hd]`` as ``[..., n * hd]`` split over ``dims`` (the mesh
    dims that split the out-projection's rows), as XLA splits the product
    there: the weight's gradient is then split too, where DTensor would
    otherwise multiply the whole heads on every rank of those dims. Heads
    split unevenly are gathered first (:func:`_whole_heads`). The gradient
    comes back through :func:`_split_heads`, gathered first where its
    split does not keep the heads whole (7 heads over 2 ranks) and sliced
    to the heads' uneven split."""

    @staticmethod
    def forward(ctx, t, dims):
        from torch.distributed.tensor import Shard
        ctx.heads = t.shape[-2:]
        t = _whole_heads(t)
        flat = t.reshape(*t.shape[:-2], t.shape[-2] * t.shape[-1])
        mesh, d = flat.device_mesh, flat.dim() - 1
        pl = [Shard(d) if i in dims and p.is_replicate() else p
              for i, p in enumerate(flat.placements)]
        if flat.shape[d] % math.prod(mesh.size(i) for i in dims) or pl == list(flat.placements):
            return flat
        return redistribute(flat, pl)

    @staticmethod
    def backward(ctx, g):
        return _split_heads(g, *ctx.heads), None


def _merge_heads(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``t`` [..., n, hd] as [..., n * hd], the input of ``@ w``."""
    if is_meshed(t, w) and torch.is_grad_enabled() and t.requires_grad:
        return _MergeHeads.apply(t, shard_dims(w, 0))
    t = _whole_heads(t)
    return t.reshape(*t.shape[:-2], t.shape[-2] * t.shape[-1])


def attn_forward(x: torch.Tensor, p: dict, cfg, layer_local: bool,
                 positions: torch.Tensor, *, theta: float,
                 block: int = 512) -> Tuple[torch.Tensor, dict]:
    """Sequence-mode attention (train/prefill). Returns (out, new_cache_entry).

    x: [B, S, D]. Cache entry: k/v [B, W, KV, hd] where W = window for local
    layers (ring-placed) else S. When autograd records (training), attention
    is :func:`attend_blocked` over ``block``-row blocks (the single block S
    where ``block`` does not divide S, as in the JAX package); otherwise the
    serving call, B1 without its logsumexp (on the CPU the same blocked
    forward, so no call holds ``[B, KV, G, S, S]`` scores).
    """
    B, S, D = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _split_heads(x @ p["wq"], H, hd)
    k = _split_heads(x @ p["wk"], KV, hd, split=False)
    v = _split_heads(x @ p["wv"], KV, hd, split=False)
    if cfg.qk_norm:
        q = head_rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = head_rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.causal:  # encoders use absolute positions added at the input
        q = rope(q, positions, theta)
        k = rope(k, positions, theta)
    q = shard_act(q, ("act_batch", "act_seq", "act_heads", None))
    k = shard_act(k, ("act_batch", "act_seq", "act_kv_heads", None))
    window = cfg.sliding_window if layer_local else 0
    blk = block_of(S, block)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        out = attend_blocked(q, k, v, causal=cfg.causal, window=window, block=blk)
    else:
        out = ops.flash_attention(q, k, v, causal=cfg.causal, window=window, block=blk)
    out = shard_act(out, ("act_batch", "act_seq", "act_heads", None))
    y = _merge_heads(out, p["wo"]) @ p["wo"]
    if layer_local and cfg.sliding_window and S > cfg.sliding_window:
        # last W tokens, placed at their ring slots (slot = pos % W)
        W = cfg.sliding_window
        roll = -((S - W) % W)
        cache_k = torch.roll(k[:, -W:], roll, dims=1)
        cache_v = torch.roll(v[:, -W:], roll, dims=1)
    else:
        cache_k, cache_v = k, v
    return y, {"k": cache_k, "v": cache_v}


def attn_decode(x: torch.Tensor, p: dict, cfg, layer_local: bool, cache: dict,
                positions: torch.Tensor, *, theta: float) -> Tuple[torch.Tensor, dict]:
    """One-token attention. x: [B, D]; cache k/v [B, W, KV, hd]; positions [B].

    Unlike the JAX function, the new k/v are written into ``cache`` in place;
    the returned entry holds the same tensors. A DTensor cache is written
    on each rank's local shard (:func:`_update_cache_meshed`)."""
    B, D = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _split_heads(x @ p["wq"], H, hd)
    k = _split_heads(x @ p["wk"], KV, hd, split=False)
    v = _split_heads(x @ p["wv"], KV, hd, split=False)
    if cfg.qk_norm:
        q = head_rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = head_rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q[:, None], positions[:, None], theta)[:, 0]
    k = rope(k[:, None], positions[:, None], theta)[:, 0]
    W = cache["k"].shape[1]
    ring = bool(layer_local and cfg.sliding_window and W == cfg.sliding_window)
    slot = positions % W if ring else positions
    write = _update_cache_meshed if is_meshed(cache["k"]) else _update_cache
    write(cache["k"], k, slot)
    write(cache["v"], v, slot)
    k_cache = shard_act(cache["k"], ("act_batch", "act_kv_seq", "act_kv_heads", None))
    v_cache = shard_act(cache["v"], ("act_batch", "act_kv_seq", "act_kv_heads", None))
    out = attend_decode(q, k_cache, v_cache, positions, ring=ring)
    y = _merge_heads(out, p["wo"]) @ p["wo"]
    return y, cache


def _update_cache(cache: torch.Tensor, new: torch.Tensor, slot: torch.Tensor) -> None:
    """Write new [B, KV, hd] into cache [B, W, KV, hd] at per-batch slots, in place.

    A slot at or past W is dropped, as JAX's scatter drops it (the engine
    reaches this when a prompt buckets to ``max_len``). The dropped row is
    rewritten with its own value, so no host sync decides which rows to skip.
    """
    B, W = cache.shape[:2]
    rows = torch.arange(B, device=cache.device)
    slot = slot.to(device=cache.device, dtype=torch.long)
    inside = slot < W
    at = torch.where(inside, slot, W - 1)
    keep = cache[rows, at]
    cache[rows, at] = torch.where(inside[:, None, None], new.to(cache.dtype), keep)


def _update_cache_meshed(cache, new: torch.Tensor, slot: torch.Tensor) -> None:
    """:func:`_update_cache` on a DTensor cache [B, W, KV, hd], in place on
    each rank's local shard: ``new`` [B, KV, hd] and ``slot`` [B] are laid
    out as the cache's batch and head dims, and a rank whose shard of W
    (split over ``act_kv_seq``, a ring's too) is ``[w0, w1)`` writes the
    slots that fall there, at ``slot - w0``, and drops the others."""
    from torch.distributed.tensor import Replicate, Shard
    mesh, pl = cache.device_mesh, cache.placements
    ranges = local_ranges(cache.shape, mesh, pl, mesh.get_coordinate())
    to_new = {0: 0, 2: 1, 3: 2}           # the cache's dims in new's order (W has none)
    new_pl = [Shard(to_new[p.dim]) if isinstance(p, Shard) and p.dim in to_new else Replicate()
              for p in pl]
    slot_pl = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in pl]
    new_l = _local(new, mesh, new_pl, [ranges[d] for d in (0, 2, 3)])
    slot_l = _local(slot, mesh, slot_pl, ranges[:1])
    w0, w1 = ranges[1]
    slot_l = torch.where(slot_l >= w0, slot_l - w0, w1 - w0)     # w1 - w0: dropped
    _update_cache(cache.to_local(), new_l, slot_l)


def _local(t: torch.Tensor, mesh, placements, ranges) -> torch.Tensor:
    """This rank's shard of ``t`` under ``placements``: a DTensor's local
    tensor after a redistribution, or the block ``ranges`` of a tensor that
    every rank holds whole."""
    if is_meshed(t):
        return redistribute(t, placements).to_local()
    return t[tuple(slice(a, z) for a, z in ranges)]
