"""Core layers and parameter specs, ported from the JAX package's ``models/layers.py``.

Params are described once by :class:`ParamSpec` trees (shape, logical axes,
initializer); :func:`init_param` fills a parameter that already lies on its
device, in its dtype, from a ``torch.Generator`` on that device (float32
draws, then the cast), so a 7B-parameter model is drawn on the card and
never staged in host memory. A seed gives the same weights on one device
type in every process; the CPU's and the card's generators give different
weights. :func:`build_abstract` and :func:`build_axes` derive the dry run's
trees from the same specs: tensors on the ``meta`` device (no storage) and
the logical axis names of every dimension.

The primitive layers are plain functions on tensors and keep the JAX
package's rounding order, so the two agree in bf16 as well as in f32.

Activation sharding: the models call :func:`shard_act` with *logical* dim
names where the JAX models do; under :func:`sharding_context` a DTensor is
redistributed to the placements the resolver gives
(``distributed.sharding.make_resolver``), the counterpart of
``with_sharding_constraint``. Outside a context, or on a plain tensor, it is
the identity.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]      # logical axis name per dim (w_* names)
    init: str = "normal"                 # normal | zeros | ones | mamba_a | mamba_dt
    scale: float = 1.0                   # fan-in style scale for "normal"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def _map_specs(fn, specs):
    """``fn`` applied to every ParamSpec of a tree of dicts and lists."""
    if isinstance(specs, ParamSpec):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    return [_map_specs(fn, v) for v in specs]


def build_abstract(specs, dtype: torch.dtype):
    """The spec tree as tensors on the ``meta`` device: shapes and a dtype, no
    storage (a 314B-parameter tree allocates nothing)."""
    return _map_specs(lambda s: torch.empty(s.shape, dtype=dtype, device="meta"), specs)


def build_axes(specs):
    """The spec tree's logical axis names, one tuple per parameter."""
    return _map_specs(lambda s: s.axes, specs)


def init_param(spec: ParamSpec, gen: torch.Generator,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fill ``out`` for ``spec`` from ``gen`` and return it.

    ``out`` lies on the generator's device, in any dtype, with the spec's
    shape or the shape of one period's slice of it (``spec.shape[1:]``); the
    fan-in always follows the whole spec. Random values are drawn in float32
    on that device, then cast. Without ``out``, a float32 tensor of the
    spec's shape is made on the generator's device.
    """
    if out is None:
        out = torch.empty(spec.shape, device=gen.device)
    if spec.init == "zeros":
        return out.zero_()
    if spec.init == "ones":
        return out.fill_(1.0)
    if spec.init == "mamba_a":
        # A_log: log of [1..d_state] broadcast over d_inner (mamba1 S4D-real)
        n = spec.shape[-1]
        return out.copy_(torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                                device=out.device)).expand(out.shape))
    if spec.init == "mamba_dt":
        # dt_proj bias: softplus^-1 of dt in [1e-3, 1e-1] log-uniform
        u = torch.rand(out.shape, generator=gen, device=out.device)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        return out.copy_(torch.log(torch.expm1(dt)))
    if spec.init == "normal":
        fan_in = spec.shape[0] if len(spec.shape) >= 2 else max(spec.shape[-1], 1)
        if len(spec.shape) >= 3:  # stacked [L, fan_in, ...]
            fan_in = spec.shape[-2]
        std = spec.scale / math.sqrt(fan_in)
        return out.copy_(std * torch.randn(out.shape, generator=gen, device=out.device))
    raise ValueError(f"init {spec.init!r} is not ported yet")


# ---------------------------------------------------------------------------
# Activation sharding context
# ---------------------------------------------------------------------------

_CTX = threading.local()


@contextlib.contextmanager
def sharding_context(resolver: Callable):
    """resolver(shape, logical names) -> a ``NamedSharding`` or None."""
    prev = getattr(_CTX, "resolver", None)
    _CTX.resolver = resolver
    try:
        yield
    finally:
        _CTX.resolver = prev


def shard_act(x: torch.Tensor, names: Tuple[Optional[str], ...]) -> torch.Tensor:
    """``x`` redistributed to the placements its logical names resolve to
    (a dim left unconstrained keeps its placement; a ``Partial`` is reduced)."""
    resolver = getattr(_CTX, "resolver", None)
    if resolver is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    s = resolver(x.shape, names)
    if s is None:
        return x
    from repro_torch.distributed.sharding import spec_placements
    pl = spec_placements(x.device_mesh, s.spec, current=x.placements)
    return x if tuple(pl) == tuple(x.placements) else x.redistribute(x.device_mesh, pl)


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
    h = shard_act(h, ("act_batch", "act_seq", "act_mlp"))
    return h @ p["wo"]
