"""Dispatch between the hand-written kernels and their plain versions.

The choice follows the tensor's device and nothing else: a CPU tensor takes
the plain PyTorch version; a CUDA tensor takes the kernel, whose wrapper
raises on what it cannot take. There is no fallback from one to the other.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import flash_attention_bwd as _flash_bwd
from repro_torch.kernels import mamba_scan as _mamba
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


def mamba_scan(dt: torch.Tensor, x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
               A: torch.Tensor, D: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, h_S) of the selective scan; ``h0=None`` starts from zeros."""
    if x.device.type == "cpu":
        return _mamba.mamba_scan_plain(dt, x, B, C, A, D, h0)
    return _mamba.mamba_scan(dt, x, B, C, A, D, h0)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, block_to_expert: torch.Tensor,
                   block_t: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return _gmm.grouped_matmul_plain(x, w, block_to_expert, block_t)
    return _gmm.grouped_matmul(x, w, block_to_expert, block_t)


def moe_expert_ffn(xin: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
                   block_to_expert: torch.Tensor, block_t: int) -> torch.Tensor:
    """SwiGLU expert FFN over expert-sorted rows, three grouped matmuls:
    ``silu(x @ wg[e]) * (x @ wi[e])`` then ``@ wo[e]``, the gating in plain
    PyTorch. xin [T_pad, D]; wg/wi [E, D, F]; wo [E, F, D]."""
    g = grouped_matmul(xin, wg, block_to_expert, block_t)
    u = grouped_matmul(xin, wi, block_to_expert, block_t)
    return grouped_matmul(F.silu(g) * u, wo, block_to_expert, block_t)
