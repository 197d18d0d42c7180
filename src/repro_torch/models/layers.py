"""Core layers and parameter specs, ported from the JAX package's ``models/layers.py``.

Params are described once by :class:`ParamSpec`; :func:`init_param` draws
them from a ``torch.Generator`` on the CPU in float32 before the cast and the
move to the device, so a seed gives the same weights on every device.

The primitive layers are plain functions on tensors and keep the JAX
package's rounding order, so the two agree in bf16 as well as in f32.
There is no activation-sharding hook: the port runs on one card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"                 # normal | zeros | ones
    scale: float = 1.0                   # fan-in style scale for "normal"


def init_param(spec: ParamSpec, gen: torch.Generator) -> torch.Tensor:
    """float32 CPU tensor for ``spec``; the caller casts and moves it."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape)
    if spec.init == "ones":
        return torch.ones(spec.shape)
    if spec.init == "normal":
        fan_in = spec.shape[0] if len(spec.shape) >= 2 else max(spec.shape[-1], 1)
        if len(spec.shape) >= 3:  # stacked [L, fan_in, ...]
            fan_in = spec.shape[-2]
        std = spec.scale / math.sqrt(fan_in)
        return std * torch.randn(spec.shape, generator=gen)
    raise ValueError(f"init {spec.init!r} is not ported yet")


# ---------------------------------------------------------------------------
# Primitive layers (plain functions)
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    # variance accumulated in f32; the scaling runs in x.dtype, in the JAX
    # package's order: (x * inv) * (1 + w)
    x32 = x.float()
    var = (x32 * x32).sum(-1, keepdim=True) / x.shape[-1]
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * (1.0 + w).to(x.dtype)


def head_rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """qk_norm: RMSNorm over the trailing head_dim, weight shared across heads."""
    return rms_norm(x, w, eps)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, half-split. x: [..., S, H, hd] (hd even), positions: [..., S]."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freq                      # [..., S, half]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)


def sinusoidal_pos(seq: int, d: int, dtype: torch.dtype,
                   device: Optional[torch.device] = None) -> torch.Tensor:
    """Absolute sinusoidal position table (encoder inputs)."""
    pos = np.arange(seq)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * i / d))
    tab = np.concatenate([np.sin(ang), np.cos(ang)], -1)
    return torch.as_tensor(tab, dtype=dtype, device=device)


def mlp(x: torch.Tensor, p: dict, gated: bool) -> torch.Tensor:
    """SwiGLU (gated) or tanh-GELU (plain) MLP. Weights: wi [D,F] (+wg), wo [F,D]."""
    if gated:
        h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    else:
        h = F.gelu(x @ p["wi"], approximate="tanh")
    return h @ p["wo"]
