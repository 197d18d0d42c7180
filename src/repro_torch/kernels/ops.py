"""Dispatch between the hand-written kernels and their plain versions.

The choice follows the tensor's device and nothing else: a CPU tensor takes
the plain PyTorch version (for prefill attention and the scan, the JAX
package's blocked and chunked forms, not the whole-sequence and
step-by-step oracles the kernels are held to); a CUDA tensor takes the
kernel, whose wrapper raises on what it cannot take. There is no fallback
from one to the other.

The selective scan and the grouped matmul are differentiable: where autograd
records and an input needs a gradient, each goes through a
``torch.autograd.Function`` whose backward dispatches by device in the same
way (kernels B3b and B4b on the card, their plain versions on the CPU). The
scan's forward then asks B3 for its chunk states. Otherwise (the engine,
under ``torch.no_grad``) the call goes straight to B3 or B4 and saves
nothing.

Every dispatch function also takes DTensors (a model on a device mesh). The
kernel, or on the CPU its plain version, then runs on each rank's local
shards (:func:`run_local`, ``local_map``'s form): the inputs are
redistributed to what the kernel can take on its own (batch and heads, or
batch and channels, split over mesh dims; the sequence, head dim and state
whole), the outputs carry the placements that follows from that, and an
input replicated over a mesh dim that splits the work gets a ``Partial``
gradient there. The autograd Functions (here and
``models.attention._AttendBlocked``) see local tensors only. Where a rank's
q heads map to kv heads that are not split with them (GQA with ``KV % mesh
!= 0``), each rank takes the kv heads its q heads read; q's heads may split
unevenly (``models.attention._split_heads``).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (contiguous_stride, is_meshed, mesh_of, placed,
                                              redistribute, shard_dims, split_range)
from repro_torch.kernels import block_of
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import flash_attention_bwd as _flash_bwd
from repro_torch.kernels import mamba_scan as _mamba
from repro_torch.kernels import mamba_scan_bwd as _mamba_bwd
from repro_torch.kernels import moe_gmm as _gmm


# ---------------------------------------------------------------------------
# DTensor inputs: the kernels on local shards
# ---------------------------------------------------------------------------

def run_local(fn, mesh, args, in_pl, out_pl, out_shapes=None):
    """``fn`` on the local shards of ``args`` (placements ``in_pl``, None
    for what is not a tensor), its outputs DTensors of ``out_pl`` (a tuple
    of placements where ``fn`` gives several outputs) and of the global
    shapes ``out_shapes`` (the same nesting; None: as if split evenly,
    which an uneven head split is not). A plain tensor among ``args`` is
    taken as replicated. The inputs move to ``in_pl`` by
    ``sharding.redistribute`` (a split moved between dims by all-to-all).
    An input's gradient keeps its shards and is ``Partial`` on every mesh
    dim that shards any input (``local_map``'s ``in_grad_placements``)."""
    from torch.distributed._functional_collectives import AsyncCollectiveTensor
    from torch.distributed.tensor import DTensor, Partial, Placement, Replicate, Shard
    split = [any(pl is not None and isinstance(pl[i], Shard) for pl in in_pl)
             for i in range(mesh.ndim)]
    local = []
    for a, pl in zip(args, in_pl):
        if pl is None or not isinstance(a, torch.Tensor):
            local.append(a)
            continue
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
        grad_pl = tuple(p if isinstance(p, Shard) else (Partial() if split[i] else Replicate())
                        for i, p in enumerate(pl))
        t = redistribute(a, pl).to_local(grad_placements=grad_pl)
        local.append(t.wait() if isinstance(t, AsyncCollectiveTensor) else t)
    out = fn(*local)
    one = all(isinstance(p, Placement) for p in out_pl)
    outs, pls = ((out,), (out_pl,)) if one else (out, out_pl)
    shapes = (out_shapes,) if one else (out_shapes or (None,) * len(pls))
    res = tuple(o if o is None else _from_local(o, mesh, pl, sh)
                for o, pl, sh in zip(outs, pls, shapes))
    return res[0] if one else res


def _from_local(t: torch.Tensor, mesh, pl, shape):
    """A DTensor of the local ``t`` under ``pl``, of the global ``shape``
    where that is not what an even split gives (an uneven one's, made
    contiguous to carry a contiguous global stride)."""
    from torch.distributed.tensor import DTensor, Shard
    even = list(t.shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            even[p.dim] *= mesh.size(i)
    if shape is None or tuple(shape) == tuple(even):
        return DTensor.from_local(t, mesh, pl, run_check=False)
    return DTensor.from_local(t.contiguous(), mesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=contiguous_stride(shape))


def all_reduce(t: torch.Tensor, op: str, mesh, dims) -> torch.Tensor:
    """``t`` (a rank's local tensor) reduced by ``op`` ("sum", "max") over
    the mesh dims ``dims`` in turn, by functional collectives (the ones the
    dry run's counters see)."""
    import torch.distributed._functional_collectives as funcol
    for d in dims:
        t = funcol.wait_tensor(funcol.all_reduce(t, op, (mesh, d)))
    return t


def with_partial(pl, dims) -> tuple:
    """``pl`` with ``Partial()`` on the mesh dims ``dims``."""
    from torch.distributed.tensor import Partial
    return tuple(Partial() if i in dims else p for i, p in enumerate(pl))


def _kv_for_heads(k: torch.Tensor, h0: int, hl: int, group: int) -> torch.Tensor:
    """The kv heads that q heads ``[h0, h0 + hl)`` read (q head h reads kv
    head ``h // group``), laid out so that local head i reads local kv head
    ``i // (hl / kv_local)``; none where ``hl`` is 0 (an uneven split's
    empty share)."""
    if hl == 0:
        return k[:, :, :0]
    if group % hl == 0:
        return k[:, :, h0 // group:h0 // group + 1]
    if hl % group == 0 and h0 % group == 0:
        return k[:, :, h0 // group:(h0 + hl) // group]
    return k.repeat_interleave(group, dim=2)[:, :, h0:h0 + hl]


def attention_plan(q, k, *, head_dim: int, kv_dim: int, batch_of=None):
    """Placements for an attention kernel on local shards: q's batch (dim 0)
    and heads (``head_dim``) stay split where q has them split, evenly or
    not (7 heads over 2 ranks: 4 and 3); the kv tensors split batch with q,
    and heads with q where their count divides the split (else they are
    whole and each rank takes its q heads' kv heads, :func:`local_heads`).
    Everything else is whole. Returns (mesh, q placements, kv placements,
    the q-head mesh dims where kv is whole). ``batch_of``: the tensor whose
    batch split q and kv take (decode: the cache, so that q is sliced to
    the cache's rows rather than the cache gathered to q's)."""
    mesh = mesh_of(q, k)
    bdims = shard_dims(q if batch_of is None else batch_of, 0)
    hdims = [i for i in shard_dims(q, head_dim) if i not in bdims]
    n = math.prod(mesh.size(i) for i in hdims)
    kv_split = k.shape[kv_dim] % n == 0
    qpl = placed(mesh, {0: bdims, head_dim: hdims})
    kvpl = placed(mesh, {0: bdims, kv_dim: hdims if kv_split else []})
    return mesh, qpl, kvpl, ([] if kv_split else hdims)


def local_heads(fn, mesh, hdims, H, KV, kv_args: Sequence[int], kv_grads: Sequence[int] = ()):
    """``fn`` with the kv arguments cut to the kv heads of this rank's q
    heads, where q's heads are split over ``hdims`` and kv's are whole; the
    outputs ``kv_grads`` (gradients of the cut kv heads) are laid back into
    all KV heads, zeros where this rank's q heads read none."""
    if not hdims:
        return fn
    h0, h1 = split_range(mesh, hdims, H)
    group = H // KV

    def local(*a):
        a = list(a)
        for i in kv_args:
            a[i] = _kv_for_heads(a[i], h0, h1 - h0, group)
        out = fn(*a)
        if not kv_grads:
            return out
        out = list(out)
        for i in kv_grads:
            out[i] = _kv_grad_for_heads(out[i], KV, h0, h1 - h0, group)
        return tuple(out)
    return local


def _kv_grad_for_heads(g: torch.Tensor, KV: int, h0: int, hl: int, group: int) -> torch.Tensor:
    """The adjoint of :func:`_kv_for_heads`: ``g``, the gradient of the kv
    heads that q heads ``[h0, h0 + hl)`` read, as a gradient of all ``KV``
    heads (dim 2)."""
    out = g.new_zeros(g.shape[:2] + (KV,) + g.shape[3:])
    if hl == 0:                          # an uneven split's empty share reads none
        return out
    if group % hl == 0:
        out[:, :, h0 // group] = g[:, :, 0]
    elif hl % group == 0 and h0 % group == 0:
        out[:, :, h0 // group:(h0 + hl) // group] = g
    else:
        idx = torch.arange(h0, h0 + hl, device=g.device) // group
        out.index_add_(2, idx, g)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, block: int = 512) -> torch.Tensor:
    """The attention output: kernel B1 on the card (its own tiles: ``block``
    is not read); on the CPU the blocked forward over ``block``-row pairs
    (the JAX package's ``attend_blocked``), one pair's scores at a time
    (``block_of(S, block)``)."""
    if is_meshed(q, k, v):
        mesh, qpl, kvpl, hdims = attention_plan(q, k, head_dim=2, kv_dim=2)
        fn = local_heads(lambda q, k, v: flash_attention(q, k, v, causal=causal, window=window,
                                                         block=block),
                         mesh, hdims, q.shape[2], k.shape[2], (1, 2))
        return run_local(fn, mesh, [q, k, v], [qpl, kvpl, kvpl], qpl, q.shape)
    if not q.shape[2]:                   # a rank's empty share of an uneven head split
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return _flash_bwd.attend_fwd_plain(q, k, v, causal=causal, window=window,
                                           block=block_of(q.shape[1], block))[0]
    return _flash.flash_attention(q, k, v, causal=causal, window=window)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        block: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse [B,S,KV,G] float32), the forward of training: kernel B1 with
    its logsumexp on the card; on the CPU the blocked forward over ``block``
    rows (the JAX package's ``_attend_fwd_impl``). On DTensors, split as
    :func:`flash_attention` splits (q's heads stay split where kv's do not
    split with them), and the lse is ``[B, S, H]``, the same storage as
    ``[B, S, KV, G]`` flattened, so that it splits with q's heads; each rank
    runs the kernel on its ``[B, S, KVl, Gl]``."""
    if is_meshed(q, k, v):
        mesh, qpl, kvpl, hdims = attention_plan(q, k, head_dim=2, kv_dim=2)

        def local(q, k, v):
            out, lse = flash_attention_lse(q, k, v, causal=causal, window=window, block=block)
            return out, lse.flatten(2)
        fn = local_heads(local, mesh, hdims, q.shape[2], k.shape[2], (1, 2))
        return run_local(fn, mesh, [q, k, v], [qpl, kvpl, kvpl], (qpl, qpl),
                         (q.shape, q.shape[:3]))
    if not q.shape[2]:
        return torch.empty_like(q), q.new_empty(q.shape[:2] + (0, 1), dtype=torch.float32)
    if q.device.type == "cpu":
        return _flash_bwd.attend_fwd_plain(q, k, v, causal=causal, window=window, block=block)
    return _flash.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0, block: int = 512) -> _flash_bwd.Grads:
    """(dq, dk, dv): kernel B1b on the card; on the CPU the JAX package's
    ``_attend_bwd_impl`` over ``block``-row block pairs. On DTensors, as
    :func:`flash_attention_lse` splits them and gives the lse (``[B, S,
    H]``); where kv is whole, each rank's dk and dv are its q heads' share,
    ``Partial`` over the mesh dims that split q's heads."""
    if is_meshed(q, k, v, out, lse, dout):
        mesh, qpl, kvpl, hdims = attention_plan(q, k, head_dim=2, kv_dim=2)

        def local(q, k, v, out, lse, dout):
            lse = lse.unflatten(2, (k.shape[2], -1))
            return tuple(flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                             window=window, block=block))
        fn = local_heads(local, mesh, hdims, q.shape[2], k.shape[2], (1, 2), (1, 2))
        dkv = with_partial(kvpl, hdims)
        return run_local(fn, mesh, [q, k, v, out, lse, dout], [qpl, kvpl, kvpl, qpl, qpl, qpl],
                         (qpl, dkv, dkv), (q.shape, k.shape, v.shape))
    if not q.shape[2]:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    if q.device.type == "cpu":
        return _flash_bwd.flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=causal,
                                                    window=window, block=block)
    return _flash_bwd.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                          window=window)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     positions: torch.Tensor, *, ring: bool = False) -> torch.Tensor:
    """One token's attention against the cache: kernel B2 on the card, its
    plain version on the CPU. On DTensors whose cache slots are split
    (``act_kv_seq``), each rank attends over its own slots and the ranks
    combine their partials (:func:`_decode_slot_split`); otherwise batch and
    heads split as :func:`attention_plan` has them."""
    if is_meshed(q, k_cache, v_cache, positions):
        sdims = [i for i in shard_dims(k_cache, 1) if i not in shard_dims(k_cache, 0)]
        if sdims:
            return _decode_slot_split(q, k_cache, v_cache, positions, ring, sdims)
        mesh, qpl, kvpl, hdims = attention_plan(q, k_cache, head_dim=1, kv_dim=2,
                                                batch_of=k_cache)
        ppl = placed(mesh, {0: shard_dims(k_cache, 0)})
        fn = local_heads(lambda q, k, v, p: decode_attention(q, k, v, p, ring=ring),
                         mesh, hdims, q.shape[1], k_cache.shape[2], (1, 2))
        return run_local(fn, mesh, [q, k_cache, v_cache, positions], [qpl, kvpl, kvpl, ppl],
                         qpl, q.shape)
    if not q.shape[1]:
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return _decode.decode_attention_plain(q, k_cache, v_cache, positions, ring=ring)
    return _decode.decode_attention(q, k_cache, v_cache, positions, ring=ring)


def _decode_slot_split(q, k_cache, v_cache, positions, ring: bool, sdims) -> torch.Tensor:
    """Flash-decoding across ranks, the JAX package's form for a cache split
    over its slots: each rank takes the partial ``(acc, m, l)`` of its slot
    range (B2's partial route on the card, its plain version on the CPU),
    then the largest m and the two rescaled sums are all-reduced over the
    slots' mesh dims. q's heads stay whole on those dims (every rank needs
    them for its slots); batch and kv heads split as the cache has them. No
    slot leaves its rank."""
    mesh = mesh_of(q, k_cache)
    bdims = shard_dims(k_cache, 0)
    hdims = [i for i in shard_dims(k_cache, 2) if i not in bdims and i not in sdims]
    qpl = placed(mesh, {0: bdims, 1: hdims})
    kvpl = placed(mesh, {0: bdims, 1: sdims, 2: hdims})
    ppl = placed(mesh, {0: bdims})
    W = k_cache.shape[1]

    def local(q, k, v, p):
        w0, _ = split_range(mesh, sdims, W)
        if q.device.type == "cpu":
            acc, m, l = _decode.decode_attention_partial_plain(q, k, v, p, ring=ring, offset=w0,
                                                               total=W)
        else:
            acc, m, l = _decode.decode_attention_partial(q, k, v, p, ring=ring, offset=w0,
                                                         total=W)
        M = all_reduce(m, "max", mesh, sdims)
        w = torch.where(torch.isinf(m), 0.0, torch.exp(m - M))
        sums = all_reduce(torch.cat([acc * w[..., None], (l * w)[..., None]], -1), "sum",
                          mesh, sdims)                                  # [B, H, hd + 1]
        return (sums[..., :-1] / torch.clamp_min(sums[..., -1:], 1e-30)).to(q.dtype)

    return run_local(local, mesh, [q, k_cache, v_cache, positions], [qpl, kvpl, kvpl, ppl], qpl,
                     q.shape)


def _records(*ts) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts)


def mamba_scan(dt: torch.Tensor, x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
               A: torch.Tensor, D: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, h_S) of the selective scan; ``h0=None`` starts from zeros. On
    DTensors the batch and the channels (DI) stay split as x has them."""
    if is_meshed(dt, x, B, C, A, D, h0):
        mesh, _, _, (xpl, bcpl, apl, hpl) = _scan_plan(x)
        return run_local(mamba_scan, mesh, [dt, x, B, C, A, D, h0],
                         [xpl, xpl, bcpl, bcpl, apl, apl, hpl if h0 is not None else None],
                         (xpl, hpl))
    if _records(dt, x, B, C, A, D, h0):
        return _MambaScan.apply(dt, x, B, C, A, D, h0)
    if x.device.type == "cpu":
        return _mamba.mamba_scan_chunked(dt, x, B, C, A, D, h0)
    return _mamba.mamba_scan(dt, x, B, C, A, D, h0)


def _scan_plan(x):
    """(mesh, the batch's and the channels' mesh dims, and the placements of
    x (dt, dy), B (C), A (D) and h0) for the scan on local shards: x's batch
    and channel splits kept, B and C split by batch only, A and D by channel
    only."""
    mesh = mesh_of(x)
    bd = shard_dims(x, 0)
    cd = [i for i in shard_dims(x, 2) if i not in bd]
    return mesh, bd, cd, (placed(mesh, {0: bd, 2: cd}), placed(mesh, {0: bd}),
                          placed(mesh, {0: cd}), placed(mesh, {0: bd, 1: cd}))


def _mamba_scan_states(dt, x, B, C, A, D, h0=None):
    """(y, h_S, the states at the start of every ``state_chunk(N)`` steps)."""
    if x.device.type == "cpu":
        return _mamba.mamba_scan_chunked(dt, x, B, C, A, D, h0,
                                         chunk=_mamba.state_chunk(B.shape[2]))
    return _mamba.mamba_scan(dt, x, B, C, A, D, h0, states=True)


def mamba_scan_bwd(dt, x, B, C, A, D, states, dy, dh_S=None) -> _mamba_bwd.ScanGrads:
    """The scan's VJP: kernel B3b on the card (float32, contiguous), its plain
    version on the CPU. On DTensors, split as :func:`mamba_scan` splits."""
    if is_meshed(dt, x, B, C, A, D, states, dy, dh_S):
        mesh, bd, cd, (xpl, bcpl, apl, hpl) = _scan_plan(x)
        spl = placed(mesh, {0: bd, 2: cd})            # states [B, chunks, DI, N]
        g = run_local(lambda *a: tuple(mamba_scan_bwd(*a)), mesh,
                      [dt, x, B, C, A, D, states, dy, dh_S],
                      [xpl, xpl, bcpl, bcpl, apl, apl, spl, xpl, hpl if dh_S is not None else None],
                      (xpl, xpl, with_partial(bcpl, cd), with_partial(bcpl, cd),
                       with_partial(apl, bd), with_partial(apl, bd), hpl))
        return _mamba_bwd.ScanGrads(*g)
    if x.device.type == "cpu":
        return _mamba_bwd.mamba_scan_bwd_chunked(dt, x, B, C, A, D, states, dy, dh_S,
                                                 chunk=_mamba.state_chunk(B.shape[2]))
    return _mamba_bwd.mamba_scan_bwd(dt, x, B, C, A, D, states, dy, dh_S)


class _MambaScan(torch.autograd.Function):
    """B3 with its chunk states forward, B3b backward (the plain versions on
    the CPU). Saves the inputs and the states; h0 is the states' first."""

    @staticmethod
    def forward(ctx, dt, x, B, C, A, D, h0):
        y, h_S, states = _mamba_scan_states(dt, x, B, C, A, D, h0)
        ctx.save_for_backward(dt, x, B, C, A, D, states)
        ctx.set_materialize_grads(False)
        return y, h_S

    @staticmethod
    def backward(ctx, dy, dh_S):
        dt, x, B, C, A, D, states = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy
        g = mamba_scan_bwd(*(t.contiguous() for t in (dt, x, B, C, A, D, states, dy)),
                           None if dh_S is None else dh_S.contiguous())
        return g.ddt, g.dx, g.dB, g.dC, g.dA, g.dD, g.dh0 if ctx.needs_input_grad[6] else None


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, block_to_expert: torch.Tensor,
                   block_t: int, used_blocks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B4's product; ``used_blocks`` (the layout's, see
    ``models/moe.py::Layout``) reaches only the backward, B4b, which skips
    the all-padding row blocks at and past it. On DTensors, w's split of F
    (its dim 2) stays and the product is split by F; every other split is
    gathered first."""
    if is_meshed(x, w, block_to_expert, used_blocks):
        mesh, xpl, wpl, ypl, fd = _gmm_plan(w)
        rpl = placed(mesh, {})
        return run_local(lambda x, w, b, u: grouped_matmul(x, w, b, block_t, u), mesh,
                         [x, w, block_to_expert, used_blocks],
                         [xpl, wpl, rpl, rpl if used_blocks is not None else None], ypl)
    if _records(x, w):
        return _GroupedMatmul.apply(x, w, block_to_expert, block_t, used_blocks)
    return _grouped_matmul(x, w, block_to_expert, block_t)


def _gmm_plan(w):
    """(mesh, x, w and product placements, the mesh dims splitting F) of a
    grouped matmul on local shards: x whole, w split by F only."""
    mesh = mesh_of(w)
    fd = shard_dims(w, 2)
    return mesh, placed(mesh, {}), placed(mesh, {2: fd}), placed(mesh, {1: fd}), fd


def _grouped_matmul(x, w, block_to_expert, block_t):
    if x.device.type == "cpu":
        return _gmm.grouped_matmul_plain(x, w, block_to_expert, block_t)
    return _gmm.grouped_matmul(x, w, block_to_expert, block_t)


def grouped_matmul_bwd(x, w, dy, block_to_expert, block_t, *, used_blocks=None, need_dx=True,
                       need_dw=True):
    """(dx, dw) of the grouped matmul, None for what is not needed: kernel
    B4b's two entry points on the card, its plain version on the CPU. On
    DTensors, split as :func:`grouped_matmul` splits (dx is then a partial
    sum over F's split)."""
    if is_meshed(x, w, dy, block_to_expert, used_blocks):
        mesh, xpl, wpl, ypl, fd = _gmm_plan(w)
        rpl = placed(mesh, {})
        return run_local(
            lambda x, w, dy, b, u: grouped_matmul_bwd(x, w, dy, b, block_t, used_blocks=u,
                                                      need_dx=need_dx, need_dw=need_dw),
            mesh, [x, w, dy, block_to_expert, used_blocks],
            [xpl, wpl, ypl, rpl, rpl if used_blocks is not None else None],
            (with_partial(xpl, fd) if need_dx else None, wpl if need_dw else None))
    if x.device.type == "cpu":
        return _gmm.grouped_matmul_bwd_plain(x, w, dy, block_to_expert, block_t,
                                             used_blocks=used_blocks, need_dx=need_dx,
                                             need_dw=need_dw)
    dx = (_gmm.grouped_matmul_dx(dy, w, block_to_expert, block_t, used_blocks)
          if need_dx else None)
    dw = (_gmm.grouped_matmul_dw(x, dy, block_to_expert, block_t, w.shape[0], used_blocks)
          if need_dw else None)
    return dx, dw


class _GroupedMatmul(torch.autograd.Function):
    """B4 forward, B4b backward (the plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, x, w, block_to_expert, block_t, used_blocks):
        ctx.save_for_backward(x, w, block_to_expert)
        ctx.block_t, ctx.used_blocks = block_t, used_blocks
        return _grouped_matmul(x, w, block_to_expert, block_t)

    @staticmethod
    def backward(ctx, dy):
        x, w, block_to_expert = ctx.saved_tensors
        dx, dw = grouped_matmul_bwd(x, w, dy.contiguous(), block_to_expert, ctx.block_t,
                                    used_blocks=ctx.used_blocks,
                                    need_dx=ctx.needs_input_grad[0],
                                    need_dw=ctx.needs_input_grad[1])
        return dx, dw, None, None, None


def moe_expert_ffn(xin: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
                   block_to_expert: torch.Tensor, block_t: int,
                   used_blocks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SwiGLU expert FFN over expert-sorted rows, three grouped matmuls:
    ``silu(x @ wg[e]) * (x @ wi[e])`` then ``@ wo[e]``, the gating in plain
    PyTorch. xin [T_pad, D]; wg/wi [E, D, F]; wo [E, F, D]. Under autograd
    each product is differentiable on its own; xin's gradient is the sum of
    the gate and up products' dx. ``used_blocks``: the layout's row blocks
    that hold assignments, for the backward."""
    g = grouped_matmul(xin, wg, block_to_expert, block_t, used_blocks)
    u = grouped_matmul(xin, wi, block_to_expert, block_t, used_blocks)
    return grouped_matmul(F.silu(g) * u, wo, block_to_expert, block_t, used_blocks)
