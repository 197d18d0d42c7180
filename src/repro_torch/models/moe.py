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

The JAX package's capacity chunking (``GROUPS``) is not ported: it bounds
the ``[B, E, C, D]`` buffers of the einsum form, which the sorted layout
never builds, and it is 1 at every serving shape (``B*E*C*D*2`` is 0.79 MB
at S32 for ``moonshot_v1_16b``). The load-balancing ``moe_aux_loss`` is a
training loss and waits for the training slice.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import ops


class Layout(NamedTuple):
    """The expert-sorted, block-padded dispatch layout of one MoE call."""
    block_to_expert: torch.Tensor   # [nt] int32: the expert of each row block
    row_token: torch.Tensor         # [T_pad] int64: source token b*S+s; B*S (zeros) on padding
    row_gate: torch.Tensor          # [T_pad] float32: the row's gate; 0 on padding
    token_rows: torch.Tensor        # [B, S, k] int64: each assignment's row; T_pad if dropped
    block_t: int


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
                 num_experts: int) -> Layout:
    """The expert-sorted layout for B4 from the router's choices.

    Kept are the assignments of rank below ``C`` in their expert within their
    batch row (the JAX package's stable sort). The kept assignments of all
    rows are grouped by expert (within an expert, in flat ``(b, s, j)``
    order), each group padded with zero rows to a multiple of ``block_t``.
    Blocks past the last used one take that block's expert and hold zero
    rows, so every id lies in ``[0, E)``."""
    B, S, k = eidx.shape
    E, Sk = num_experts, S * k
    N = B * Sk
    nt = -(-N // block_t) + min(E, N)
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
    # group the kept assignments of all rows by expert; the dropped sort last
    key = torch.where(kept, flat_e.reshape(N), E)
    skey, order = torch.sort(key, stable=True)
    gstart = torch.searchsorted(skey, ar_e)                  # [E+1] first index per expert
    counts = gstart[1:] - gstart[:-1]
    nblk = -(-counts // block_t)
    blk_end = torch.cumsum(nblk, 0)
    row_start = (blk_end - nblk) * block_t
    e_of = skey.clamp_max(E - 1)
    srow = torch.where(skey < E, row_start[e_of] + torch.arange(N, device=dev) - gstart[e_of],
                       T_pad)
    token_rows = torch.empty_like(srow).scatter_(0, order, srow)
    # per row: its source token and gate (the extra last row takes the dropped)
    row_token = torch.full((T_pad + 1,), B * S, dtype=torch.int64, device=dev).scatter_(
        0, token_rows, torch.arange(N, device=dev) // k)[:T_pad]
    row_gate = torch.zeros(T_pad + 1, dtype=torch.float32, device=dev).scatter_(
        0, token_rows, gate.reshape(N).float())[:T_pad]
    last = torch.where(counts > 0, ar_e[:E], 0).max()
    bmap = torch.searchsorted(blk_end, torch.arange(nt, device=dev), right=True)
    bmap = torch.where(bmap < E, bmap, last).to(torch.int32)
    return Layout(bmap, row_token, row_gate, token_rows.reshape(B, S, k), block_t)


def moe_forward(x: torch.Tensor, p: dict, cfg) -> torch.Tensor:
    """x [B, S, D] (or [B, D] for decode) -> the same shape. ``p`` holds
    ``router`` [D, E], ``wg``/``wi`` [E, D, F] and ``wo`` [E, F, D]."""
    e = cfg.moe
    squeeze = x.dim() == 2
    if squeeze:
        x = x[:, None]
    B, S, D = x.shape
    C = capacity(S, e.top_k, e.num_experts, e.capacity_factor)
    eidx, gate = route(x, p["router"], cfg)
    lay = build_layout(eidx, gate, C, block_rows(B, C), e.num_experts)
    xin = torch.cat([x.reshape(B * S, D), x.new_zeros(1, D)])[lay.row_token]
    out = ops.moe_expert_ffn(xin, p["wg"], p["wi"], p["wo"], lay.block_to_expert, lay.block_t)
    contrib = (out * lay.row_gate[:, None].to(out.dtype)).to(x.dtype)
    contrib = torch.cat([contrib, contrib.new_zeros(1, D)])   # row T_pad: the dropped
    rows = torch.gather(lay.token_rows, -1, torch.argsort(eidx, dim=-1))
    y = contrib[rows[..., 0]]
    for j in range(1, e.top_k):
        y = y + contrib[rows[..., j]]
    return y[:, 0] if squeeze else y
