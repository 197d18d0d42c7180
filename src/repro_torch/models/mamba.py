"""Mamba-1 (selective SSM) block, ported from the JAX package's ``models/mamba.py``.

Sequence mode runs the selective scan through ``kernels.ops.mamba_scan``:
kernel B3 on the card, its plain sequential version on the CPU. The JAX
package's ``_ssm_chunk_scan`` (the XLA-friendly chunked associative form of
the same recurrence) has no counterpart here; B3 takes its place and, like
it, hands the final state to the decode cache. Under autograd the scan is
differentiable through the same op: B3 saves its chunk states and the
backward is kernel B3b (the plain reverse recurrence on the CPU).

Decode mode is the O(1) recurrence in plain PyTorch, as in the JAX package,
which computes it outside any Pallas kernel. The "cache" is (conv window
``[B, K-1, DI]``, SSM state ``[B, DI, N]`` float32), constant in sequence
length.

The rounding order follows the JAX functions: the causal conv is an explicit
sum of shifted products in x's type, softplus is ``logaddexp(v, 0)`` in the
model's type before the cast to float32, and ``D x`` and the ``silu(z)`` gate
are applied in float32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import shard_act


def softplus(v: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(v, 0) = max(v, 0) + log1p(exp(-|v|)),
    with no switch to the identity for large v (``F.softplus`` has one)."""
    return torch.clamp_min(v, 0) + torch.log1p(torch.exp(-v.abs()))


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 carry: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: [B, S, DI]; w: [K, DI]; carry: [B, K-1, DI].
    Returns (out [B, S, DI], the new carry: the last K-1 inputs)."""
    K = w.shape[0]
    S = x.shape[1]
    if carry is None:
        carry = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([carry, x], dim=1)                    # [B, S+K-1, DI]
    out = sum(xp[:, i:i + S] * w[i] for i in range(K))
    return out, xp[:, -(K - 1):]


def _dt_b_c(xi: torch.Tensor, p: dict, m):
    bcdt = xi @ p["x_proj"]                             # [..., dt_rank + 2N]
    dt, Bc, Cc = torch.split(bcdt, [m.dt_rank, m.d_state, m.d_state], dim=-1)
    dt = softplus(dt @ p["dt_proj"] + p["dt_bias"]).float()
    return dt, Bc, Cc


def mamba_forward(x: torch.Tensor, p: dict, cfg) -> Tuple[torch.Tensor, dict]:
    """Sequence mode. x: [B, S, D] -> (y [B, S, D], cache {conv, ssm})."""
    m = cfg.mamba
    xi = x @ p["in_x"]                                  # [B, S, DI]
    z = x @ p["in_z"]
    xi = shard_act(xi, ("act_batch", "act_seq", "act_mlp"))
    xi, conv_carry = _causal_conv(xi, p["conv_w"])
    xi = F.silu(xi + p["conv_b"])
    dt, Bc, Cc = _dt_b_c(xi, p, m)
    A = -torch.exp(p["A_log"].float())                  # [DI, N]
    # B3 adds D x inside the scan; the JAX model adds it outside: in float32
    # this is the same sum, in the same order
    y, h_last = ops.mamba_scan(dt, xi.float(), Bc.float(), Cc.float(), A, p["D"].float())
    y = y * F.silu(z.float())
    out = y.to(x.dtype) @ p["out_proj"]
    return out, {"conv": conv_carry, "ssm": h_last}


def mamba_decode(x: torch.Tensor, p: dict, cfg, cache: dict) -> Tuple[torch.Tensor, dict]:
    """One-token mode. x: [B, D]; cache {conv [B,K-1,DI], ssm [B,DI,N]}.

    Unlike the JAX function, the new conv window and SSM state are written
    into ``cache`` in place (its tensors may be views of a stacked cache);
    the returned cache holds the same tensors. A DTensor cache takes the
    writes through DTensor's ``copy_``, each rank into its own shard."""
    m = cfg.mamba
    xi = x @ p["in_x"]
    z = x @ p["in_z"]
    xi3, conv_carry = _causal_conv(xi[:, None], p["conv_w"], cache["conv"].to(xi.dtype))
    xi = F.silu(xi3[:, 0] + p["conv_b"])
    dt, Bc, Cc = _dt_b_c(xi, p, m)
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(dt[..., None] * A)                                  # [B, DI, N]
    bx = dt[..., None] * Bc[:, None, :].float() * xi[..., None].float()
    h = a * cache["ssm"] + bx
    y = torch.einsum("ben,bn->be", h, Cc.float())
    y = (y + xi.float() * p["D"].float()) * F.silu(z.float())
    out = y.to(x.dtype) @ p["out_proj"]
    cache["conv"].copy_(conv_carry)
    cache["ssm"].copy_(h)
    return out, cache
