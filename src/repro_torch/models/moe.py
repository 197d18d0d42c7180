"""Mixture-of-Experts layer, ported from the JAX package's ``models/moe.py``.

Routing is the JAX package's: a float32 router and softmax, top-k, gates
renormalised by ``max(sum, 1e-9)``. Capacity is Switch-style and per batch
row: ``C = int(max(1, ceil(S*k/E) * capacity_factor))``, at most ``S*k``;
within a row a stable sort of the ``S*k`` assignments by expert ranks them,
and an assignment of rank ``C`` or more in its expert is dropped (its token
keeps only the residual path). Decode rows (S = 1, C = 1) never drop: a
token's k experts are distinct.

The expert FFN runs through ``kernels.ops.moe_expert_ffn``: three grouped
matmuls (kernel B4 on the card, its plain version on the CPU) over the
expert-sorted layout of :func:`build_layout`, which the JAX package's
``moe_forward`` never builds (it gathers ``[B, E, C, D]`` buffers and runs
einsums). The layout groups the kept assignments of all batch rows by
expert and pads each group with zero rows to a multiple of ``block_t``. It
is built on the device with sorts, ``searchsorted`` and scatters at a row
count fixed by the shapes, ``nt_max = ceil(N / block_t) + min(E, N)`` blocks
for ``N = B*S*k`` assignments, so building it never waits for the card
(one host round trip per layer would be 48 per decode step of
``moonshot_v1_16b``).

The combine keeps the JAX rounding: each row's output times its gate cast
to the activation type, the product in the activation type, and each token
sums its kept contributions from zero in the activation type in ascending
expert order (the order of JAX's scatter-add over expert-sorted slots), by
gathers and adds rather than ``index_add_``, whose atomics on the card
reorder bf16 sums from run to run.

Training differentiates the three products through ``kernels.ops`` (B4b on
the card). The dispatch gather and the combine have backwards of their own,
each the other's forward turned round: :class:`_Dispatch`'s sums each
token's kept rows' gradients by gathers in ascending expert order, as the
combine sums their outputs, where PyTorch's backward of the gather would
scatter-add them; :class:`_Combine`'s hands each kept row its token's
gradient by one gather over ``row_token``, where PyTorch's backward of the
combine's gathers would scatter every dropped assignment's gradient into
the one discarded row (at the random weights of a training start most
assignments are dropped, and that serial accumulation took a quarter of
moonshot_v1_16b's train step on an H100 SXM at 700 W).

The JAX package's capacity chunking (``GROUPS``) is not ported: it bounds
the ``[B, E, C, D]`` buffers of the einsum form, which the sorted layout
never builds, and it is 1 at every serving shape (``B*E*C*D*2`` is 0.79 MB
at S32 for ``moonshot_v1_16b``). :func:`moe_aux_loss` is the load-balancing
loss of training.

On a device mesh (DTensor inputs) :func:`_moe_meshed` runs the layer on each
rank's local shards: with the experts split over ``model`` (expert
parallelism), each rank keeps the assignments to its own experts
(``build_layout(..., experts=)``), and the output is a partial sum over
``model``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed.sharding import is_meshed, mesh_of, placed, shard_dims, split_range
from repro_torch.kernels import ops


class Layout(NamedTuple):
    """The expert-sorted, block-padded dispatch layout of one MoE call."""
    block_to_expert: torch.Tensor   # [nt] int32: the expert of each row block
    row_token: torch.Tensor         # [T_pad] int64: source token b*S+s; B*S (zeros) on padding
    row_gate: torch.Tensor          # [T_pad] float32: the row's gate; 0 on padding
    token_rows: torch.Tensor        # [B, S, k] int64: each assignment's row; T_pad if dropped
    block_t: int
    used_blocks: torch.Tensor       # [1] int32: blocks holding an assignment; the rest padding


def capacity(S: int, k: int, E: int, capacity_factor: float) -> int:
    """Slots per expert per batch row (``moe.py:38-39`` of the JAX package)."""
    return min(int(max(1, -(-S * k // E) * capacity_factor)), S * k)


def block_rows(B: int, C: int) -> int:
    """The layout's ``block_t``: the least of 8, 16, ..., 128 that holds
    ``B*C`` rows, the most one expert can keep, so that B4 reads each used
    expert's weights once per column tile. At every serving shape up to a
    64-token prompt (C at most 7) that is 8; padding the 12 assignments of a
    2-slot decode step to 128-row blocks would leave 90% of the rows zero."""
    bt = 8
    while bt < min(B * C, 128):
        bt *= 2
    return bt


def route(x: torch.Tensor, router: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (expert ids [B, S, k] int64, gates [B, S, k] float32)."""
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    gate, eidx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    return eidx, gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)


def build_layout(eidx: torch.Tensor, gate: torch.Tensor, C: int, block_t: int,
                 num_experts: int, experts: Optional[Tuple[int, int]] = None) -> Layout:
    """The expert-sorted layout for B4 from the router's choices.

    Kept are the assignments of rank below ``C`` in their expert within their
    batch row (the JAX package's stable sort). The kept assignments of all
    rows are grouped by expert (within an expert, in flat ``(b, s, j)``
    order), each group padded with zero rows to a multiple of ``block_t``.
    Blocks past the last used one take that block's expert and hold zero
    rows, so every id lies in ``[0, E)``; ``used_blocks`` counts the used
    ones (``sum_e ceil(kept_e / block_t)``), on the device, so that B4b can
    skip the rest without a host round trip.

    ``experts = (lo, hi)`` keeps only the assignments to experts ``lo`` to
    ``hi - 1`` (one rank's experts under expert parallelism), their ids
    taken from ``lo``; ranks are still counted over all experts."""
    B, S, k = eidx.shape
    E, Sk = num_experts, S * k
    lo, hi = experts or (0, E)
    El = hi - lo
    N = B * Sk
    nt = -(-N // block_t) + min(El, N)
    T_pad = nt * block_t
    dev = eidx.device
    ar_e = torch.arange(E + 1, device=dev)
    # rank of each assignment within its expert, per batch row
    flat_e = eidx.reshape(B, Sk)
    se, order = torch.sort(flat_e, dim=-1, stable=True)
    starts = torch.searchsorted(se, ar_e[:E].expand(B, E).contiguous())
    pos = torch.arange(Sk, device=dev).expand(B, Sk) - torch.gather(starts, 1, se)
    rank = torch.empty_like(pos).scatter_(1, order, pos).reshape(N)
    kept = rank < C
    fe = flat_e.reshape(N)
    if experts is not None:
        kept = kept & (fe >= lo) & (fe < hi)
        ar_e = torch.arange(El + 1, device=dev)
    # group the kept assignments of all rows by expert; the dropped sort last
    key = torch.where(kept, fe - lo, El)
    skey, order = torch.sort(key, stable=True)
    gstart = torch.searchsorted(skey, ar_e)                  # [El+1] first index per expert
    counts = gstart[1:] - gstart[:-1]
    nblk = -(-counts // block_t)
    blk_end = torch.cumsum(nblk, 0)
    row_start = (blk_end - nblk) * block_t
    e_of = skey.clamp_max(El - 1)
    srow = torch.where(skey < El, row_start[e_of] + torch.arange(N, device=dev) - gstart[e_of],
                       T_pad)
    token_rows = torch.empty_like(srow).scatter_(0, order, srow)
    # per row: its source token and gate (the extra last row takes the dropped)
    row_token = torch.full((T_pad + 1,), B * S, dtype=torch.int64, device=dev).scatter_(
        0, token_rows, torch.arange(N, device=dev) // k)[:T_pad]
    row_gate = torch.zeros(T_pad + 1, dtype=torch.float32, device=dev).scatter_(
        0, token_rows, gate.reshape(N).float())[:T_pad]
    last = torch.where(counts > 0, ar_e[:El], 0).max()
    bmap = torch.searchsorted(blk_end, torch.arange(nt, device=dev), right=True)
    bmap = torch.where(bmap < El, bmap, last).to(torch.int32)
    return Layout(bmap, row_token, row_gate, token_rows.reshape(B, S, k), block_t,
                  blk_end[-1:].to(torch.int32))


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``cat([x, 0])[idx]``: an index of ``len(x)`` reads the zero row."""
    return torch.cat([x, x.new_zeros(1, x.shape[1])])[idx]


def _sum_rows(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``sum_j cat([x, 0])[rows[:, j]]``, added in the order of ``rows``'
    columns, from zero in x's type."""
    xp = torch.cat([x, x.new_zeros(1, x.shape[1])])
    y = xp[rows[:, 0]]
    for j in range(1, rows.shape[1]):
        y = y + xp[rows[:, j]]
    return y


class _Dispatch(torch.autograd.Function):
    """The dispatch gather ``cat([x2, 0])[row_token]`` (row ``B*S`` is the
    zero row of padding). Its backward sums each token's rows, ``rows``
    [B*S, k] in ascending expert order (``T_pad`` for a dropped one), by
    gathers and adds in that order: the same bits on every run."""

    @staticmethod
    def forward(ctx, x2, row_token, rows):
        ctx.save_for_backward(rows)
        return _gather_rows(x2, row_token)

    @staticmethod
    def backward(ctx, g):
        return _sum_rows(g, ctx.saved_tensors[0]), None, None


class _Combine(torch.autograd.Function):
    """The combine, :class:`_Dispatch` turned round: each token sums its rows
    in ascending expert order; each kept row belongs to one token, so its
    gradient is that token's, one gather over ``row_token``."""

    @staticmethod
    def forward(ctx, contrib, rows, row_token):
        ctx.save_for_backward(row_token)
        return _sum_rows(contrib, rows)

    @staticmethod
    def backward(ctx, g):
        return _gather_rows(g, ctx.saved_tensors[0]), None, None


def moe_forward(x: torch.Tensor, p: dict, cfg,
                experts: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """x [B, S, D] (or [B, D] for decode) -> the same shape. ``p`` holds
    ``router`` [D, E], ``wg``/``wi`` [E, D, F] and ``wo`` [E, F, D] (with
    ``experts = (lo, hi)``, only experts lo to hi - 1: the output is then
    their part of the sum). On DTensors, :func:`_moe_meshed`."""
    if is_meshed(x, *p.values()):
        return _moe_meshed(x, p, cfg)
    e = cfg.moe
    squeeze = x.dim() == 2
    if squeeze:
        x = x[:, None]
    B, S, D = x.shape
    C = capacity(S, e.top_k, e.num_experts, e.capacity_factor)
    eidx, gate = route(x, p["router"], cfg)
    lay = build_layout(eidx, gate, C, block_rows(B, C), e.num_experts, experts)
    # each token's rows in ascending expert order (T_pad where dropped)
    rows = torch.gather(lay.token_rows, -1, torch.argsort(eidx, dim=-1))
    xin = _Dispatch.apply(x.reshape(B * S, D), lay.row_token, rows.reshape(B * S, -1))
    out = ops.moe_expert_ffn(xin, p["wg"], p["wi"], p["wo"], lay.block_to_expert, lay.block_t,
                             lay.used_blocks)
    contrib = (out * lay.row_gate[:, None].to(out.dtype)).to(x.dtype)
    y = _Combine.apply(contrib, rows.reshape(B * S, -1), lay.row_token).reshape(B, S, D)
    return y[:, 0] if squeeze else y


def _moe_meshed(x: torch.Tensor, p: dict, cfg) -> torch.Tensor:
    """The MoE layer on a device mesh, each rank on its local shards.

    The tokens of a batch shard are whole on every other mesh dim (the
    reference's ``xin`` ``("act_batch", "act_expert", None, None)``); the
    router is whole everywhere. Where the experts are split over a mesh dim
    (``w_expert``: expert parallelism), each rank routes its tokens, keeps
    the assignments to its own experts and runs B4 over them only; where
    the expert FFN's width is split instead (``w_moe_mlp``), each runs its
    slice of every expert. Either way the output is a partial sum over that
    mesh dim, which the next activation constraint reduces."""
    mesh = mesh_of(x, *p.values())
    bd = shard_dims(x, 0)
    ed = [i for i in shard_dims(p["wg"], 0) if i not in bd]
    fd = [i for i in shard_dims(p["wg"], 2) if i not in bd + ed]
    xpl, rpl = placed(mesh, {0: bd}), placed(mesh, {})
    wpl, wopl = placed(mesh, {0: ed, 2: fd}), placed(mesh, {0: ed, 1: fd})
    lo_hi = split_range(mesh, ed, cfg.moe.num_experts) if ed else None

    def local(x, router, wg, wi, wo):
        return moe_forward(x, {"router": router, "wg": wg, "wi": wi, "wo": wo}, cfg, lo_hi)
    return ops.run_local(local, mesh, [x, p["router"], p["wg"], p["wi"], p["wo"]],
                         [xpl, rpl, wpl, wpl, wopl], ops.with_partial(xpl, ed + fd))


def moe_aux_loss(x: torch.Tensor, p: dict, cfg) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch): E * sum(f_e * P_e), f_e the share
    of tokens whose top-1 expert is e, P_e the mean router probability."""
    E = cfg.moe.num_experts
    f, P = _balance(x, p["router"], E)
    return E * (f * P).sum()


def _balance(x: torch.Tensor, router: torch.Tensor, E: int, shards: int = 1):
    """(f, P) of :func:`moe_aux_loss` over x's tokens, each divided by
    ``shards``. On DTensors each batch shard's means are a partial sum of the
    whole batch's (the shards hold equal numbers of tokens)."""
    if is_meshed(x, router):
        mesh = mesh_of(x, router)
        bd = shard_dims(x, 0)
        part = ops.with_partial(placed(mesh, {}), bd)
        n = math.prod(mesh.size(i) for i in bd)
        return ops.run_local(lambda x, r: _balance(x, r, E, n), mesh, [x, router],
                             [placed(mesh, {0: bd}), placed(mesh, {})], (part, part))
    probs = torch.softmax(x.reshape(-1, x.shape[-1]).float() @ router.float(), dim=-1)
    f = torch.nn.functional.one_hot(probs.argmax(-1), E).float().mean(0)
    P = probs.mean(0)
    return (f, P) if shards == 1 else (f / shards, P / shards)
