"""The framework's own optimizers, ported from the JAX package's
``train/optimizer.py``.

* :class:`AdamW` — decoupled weight decay, float32 math, moments kept in
  ``state_dtype``.
* :class:`Adafactor` — factored second moment for matrices (row and column
  statistics of the last two axes), full statistics for vectors.
* :class:`SGDM` — momentum SGD.

All are pure, as the reference's are: ``init(params) -> state`` and
``update(grads, state, params) -> (new_params, new_state)`` on dicts of
tensors (nested dicts too), with the reference's arithmetic: float32 math
whatever the parameters' type, the bias corrections ``1 - b**step``, eps
outside the square root. They are not ``torch.optim``'s, which keep other
defaults (AdamW: b2 0.999, decay 1e-2) and update in place.

``state_axes(param_axes)`` gives the state's logical axes, a tree shaped as
``init``'s, from the parameters' (a dict of axis tuples): the moments take
their parameter's axes, Adafactor's row and column statistics ``a[:-1]``
and ``a[:-2] + a[-1:]``, the step ``()``. On a device mesh the state is
made by ``init`` and placed by them (``launch.train.setup_training``);
``update`` on DTensors gives DTensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.distributed.sharding import is_meshed, redistribute


def _map(fn, *trees):
    """``fn`` over the leaves of same-shaped trees of dicts and lists; the
    first tree's structure decides (a later tree may hold a dict at a leaf)."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], list):
        return [_map(fn, *(t[i] for t in trees)) for i in range(len(trees[0]))]
    return fn(*trees)


def _step0(params) -> torch.Tensor:
    leaf = params
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return torch.zeros((), dtype=torch.int32, device=leaf.device)


@dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    state_dtype: str = "float32"

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else self.lr

    def init(self, params):
        dt = getattr(torch, self.state_dtype)
        z = lambda p: torch.zeros_like(p, dtype=dt)
        return {"step": _step0(params), "m": _map(z, params), "v": _map(z, params)}

    def state_axes(self, param_axes):
        """Logical-axes tree matching init()'s structure (for sharding)."""
        return {"step": (), "m": param_axes, "v": param_axes}

    def update(self, grads, state, params):
        step = state["step"] + 1
        lr = self._lr(step)
        c1 = 1.0 - self.b1 ** step.to(torch.float32)
        c2 = 1.0 - self.b2 ** step.to(torch.float32)
        dt = getattr(torch, self.state_dtype)

        def upd(g, m, v, p):
            g32 = g.to(torch.float32)
            m32 = self.b1 * m.to(torch.float32) + (1 - self.b1) * g32
            v32 = self.b2 * v.to(torch.float32) + (1 - self.b2) * g32 * g32
            u = (m32 / c1) / (torch.sqrt(v32 / c2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p.to(torch.float32)
            new_p = p.to(torch.float32) - lr * u
            return new_p.to(p.dtype), m32.to(dt), v32.to(dt)

        out = _map(upd, grads, state["m"], state["v"], params)
        pick = lambda i: _map(lambda o: o[i], out)
        return pick(0), {"step": step, "m": pick(1), "v": pick(2)}



def _factored(r, denom, c, g):
    """Adafactor's second moment of a matrix, ``(r / denom)[..., None] *
    c[..., None, :]``. On DTensors it is made on each rank's shard, laid
    out as the gradient ``g``: r (and denom) take g's splits of its leading
    dims, c those of its leading and last dims. DTensor would pick a layout
    of its own for the broadcast product: the whole product on every rank
    (the reduced grok on ``(2, 4)``), or its layer dim split where g splits
    its last (grok1_314b on ``(16, 16)``: a 24 GiB float32 product, and an
    update that must then move between dims)."""
    if not is_meshed(g):
        return (r[..., None] / denom[..., None]) * c[..., None, :]
    from torch.distributed.tensor import DTensor, Replicate, Shard
    nd, mesh = g.dim(), g.device_mesh

    def keep(dims, shift=None):
        return [Shard(shift.get(p.dim, p.dim) if shift else p.dim)
                if isinstance(p, Shard) and p.dim in dims else Replicate()
                for p in g.placements]
    lead = range(nd - 2)
    rl = redistribute(r, keep(range(nd - 1))).to_local()
    dl = redistribute(denom, keep(lead)).to_local()
    cl = redistribute(c, keep([*lead, nd - 1], {nd - 1: nd - 2})).to_local()
    v = (rl[..., None] / dl[..., None]) * cl[..., None, :]
    return DTensor.from_local(v, mesh, g.placements, run_check=False, shape=g.shape,
                              stride=g.stride())


@dataclass(frozen=True)
class Adafactor:
    """Factored second-moment (Shazeer & Stern). Matrices store row/col stats
    (O(n+m) instead of O(nm)); vectors fall back to full stats."""
    lr: Callable | float = 1e-3
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else self.lr

    def init(self, params):
        def z(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if p.dim() >= 2:
                return {"r": torch.zeros(p.shape[:-1], **f32),
                        "c": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        return {"step": _step0(params), "stats": _map(z, params)}

    def state_axes(self, param_axes):
        def ax(a):
            a = tuple(a)
            if len(a) >= 2:
                return {"r": a[:-1], "c": a[:-2] + a[-1:]}
            return {"v": a}
        return {"step": (), "stats": _map(ax, param_axes)}

    def update(self, grads, state, params):
        step = state["step"] + 1
        lr = self._lr(step)
        beta = 1.0 - step.to(torch.float32) ** -self.decay

        def upd(g, s, p):
            g32 = g.to(torch.float32)
            g2 = g32 * g32 + self.eps
            if g.dim() >= 2:
                r = beta * s["r"] + (1 - beta) * g2.mean(-1)
                c = beta * s["c"] + (1 - beta) * g2.mean(-2)
                denom = torch.clamp_min(r.mean(-1, keepdim=True), self.eps)
                v = _factored(r, denom, c, g)
                ns = {"r": r, "c": c}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                ns = {"v": v}
            u = g32 / torch.sqrt(v + self.eps)
            norm = torch.sqrt((u * u).mean())
            u = u / torch.clamp_min(norm / self.clip_threshold, 1.0)
            return (p.to(torch.float32) - lr * u).to(p.dtype), ns

        out = _map(upd, grads, state["stats"], params)
        pick = lambda i: _map(lambda o: o[i], out)
        return pick(0), {"step": step, "stats": pick(1)}


@dataclass(frozen=True)
class SGDM:
    lr: Callable | float = 1e-2
    momentum: float = 0.9

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else self.lr

    def init(self, params):
        z = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"step": _step0(params), "m": _map(z, params)}

    def state_axes(self, param_axes):
        return {"step": (), "m": param_axes}

    def update(self, grads, state, params):
        step = state["step"] + 1
        lr = self._lr(step)

        def upd(g, m, p):
            m32 = self.momentum * m + g.to(torch.float32)
            return (p.to(torch.float32) - lr * m32).to(p.dtype), m32

        out = _map(upd, grads, state["m"], params)
        pick = lambda i: _map(lambda o: o[i], out)
        return pick(0), {"step": step, "m": pick(1)}


def make_optimizer(name: str, lr, cfg=None):
    if name == "auto" and cfg is not None:
        name = getattr(cfg, "optimizer", "adamw")
    if name == "adamw":
        sd = cfg.opt_state_dtype if cfg is not None else "float32"
        return AdamW(lr=lr, weight_decay=0.01, state_dtype=sd)
    if name == "adafactor":
        return Adafactor(lr=lr)
    if name == "sgdm":
        return SGDM(lr=lr)
    raise ValueError(name)
