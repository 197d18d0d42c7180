"""Dispatch between the hand-written kernels and their plain versions.

The choice follows the tensor's device and nothing else: a CPU tensor takes
the plain PyTorch version; a CUDA tensor takes the kernel, whose wrapper
raises on what it cannot take. There is no fallback from one to the other.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import mamba_scan as _mamba


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    if q.device.type == "cpu":
        return _flash.flash_attention_plain(q, k, v, causal=causal, window=window)
    return _flash.flash_attention(q, k, v, causal=causal, window=window)


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
