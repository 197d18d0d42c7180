"""Dispatch between the hand-written kernels and their plain versions.

The choice follows the tensor's device and nothing else: a CPU tensor takes
the plain PyTorch version; a CUDA tensor takes the kernel, whose wrapper
raises on what it cannot take. There is no fallback from one to the other.

The selective scan and the grouped matmul are differentiable: where autograd
records and an input needs a gradient, each goes through a
``torch.autograd.Function`` whose backward dispatches by device in the same
way (kernels B3b and B4b on the card, their plain versions on the CPU). The
scan's forward then asks B3 for its chunk states. Otherwise (the engine,
under ``torch.no_grad``) the call goes straight to B3 or B4 and saves
nothing.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import flash_attention_bwd as _flash_bwd
from repro_torch.kernels import mamba_scan as _mamba
from repro_torch.kernels import mamba_scan_bwd as _mamba_bwd
from repro_torch.kernels import moe_gmm as _gmm


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    if q.device.type == "cpu":
        return _flash.flash_attention_plain(q, k, v, causal=causal, window=window)
    return _flash.flash_attention(q, k, v, causal=causal, window=window)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        block: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse [B,S,KV,G] float32), the forward of training: kernel B1 with
    its logsumexp on the card; on the CPU the blocked forward over ``block``
    rows (the JAX package's ``_attend_fwd_impl``)."""
    if q.device.type == "cpu":
        return _flash_bwd.attend_fwd_plain(q, k, v, causal=causal, window=window, block=block)
    return _flash.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0, block: int = 512) -> _flash_bwd.Grads:
    """(dq, dk, dv): kernel B1b on the card; on the CPU the JAX package's
    ``_attend_bwd_impl`` over ``block``-row block pairs."""
    if q.device.type == "cpu":
        return _flash_bwd.flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=causal,
                                                    window=window, block=block)
    return _flash_bwd.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                          window=window)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     positions: torch.Tensor, *, ring: bool = False) -> torch.Tensor:
    if q.device.type == "cpu":
        return _decode.decode_attention_plain(q, k_cache, v_cache, positions, ring=ring)
    return _decode.decode_attention(q, k_cache, v_cache, positions, ring=ring)


def _records(*ts) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts)


def mamba_scan(dt: torch.Tensor, x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
               A: torch.Tensor, D: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, h_S) of the selective scan; ``h0=None`` starts from zeros."""
    if _records(dt, x, B, C, A, D, h0):
        return _MambaScan.apply(dt, x, B, C, A, D, h0)
    if x.device.type == "cpu":
        return _mamba.mamba_scan_plain(dt, x, B, C, A, D, h0)
    return _mamba.mamba_scan(dt, x, B, C, A, D, h0)


def _mamba_scan_states(dt, x, B, C, A, D, h0=None):
    """(y, h_S, the states at the start of every ``state_chunk(N)`` steps)."""
    if x.device.type == "cpu":
        return _mamba.mamba_scan_plain(dt, x, B, C, A, D, h0,
                                       chunk=_mamba.state_chunk(B.shape[2]))
    return _mamba.mamba_scan(dt, x, B, C, A, D, h0, states=True)


def mamba_scan_bwd(dt, x, B, C, A, D, states, dy, dh_S=None) -> _mamba_bwd.ScanGrads:
    """The scan's VJP: kernel B3b on the card (float32, contiguous), its plain
    version on the CPU."""
    if x.device.type == "cpu":
        return _mamba_bwd.mamba_scan_bwd_plain(dt, x, B, C, A, D, states, dy, dh_S,
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
    the all-padding row blocks at and past it."""
    if _records(x, w):
        return _GroupedMatmul.apply(x, w, block_to_expert, block_t, used_blocks)
    return _grouped_matmul(x, w, block_to_expert, block_t)


def _grouped_matmul(x, w, block_to_expert, block_t):
    if x.device.type == "cpu":
        return _gmm.grouped_matmul_plain(x, w, block_to_expert, block_t)
    return _gmm.grouped_matmul(x, w, block_to_expert, block_t)


def grouped_matmul_bwd(x, w, dy, block_to_expert, block_t, *, used_blocks=None, need_dx=True,
                       need_dw=True):
    """(dx, dw) of the grouped matmul, None for what is not needed: kernel
    B4b's two entry points on the card, its plain version on the CPU."""
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
