"""The framework's own optimizer, ported from the JAX package's
``train/optimizer.py``.

:class:`AdamW` is pure, as the reference's is: ``init(params) -> state`` and
``update(grads, state, params) -> (new_params, new_state)`` on dicts of
tensors (nested dicts too), with the reference's arithmetic: float32
math whatever the parameters' type, moments kept in ``state_dtype``, the bias
corrections ``1 - b**step``, eps outside the square root, and decoupled weight
decay. It is not ``torch.optim.AdamW``, which keeps other defaults (b2 0.999,
decay 1e-2) and updates in place. ``Adafactor`` and ``SGDM`` are not ported
yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


def _map(fn, *trees):
    """``fn`` over the leaves of same-shaped trees of dicts."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


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
        leaf = params
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        z = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
        return {"step": torch.zeros((), dtype=torch.int32, device=leaf.device),
                "m": _map(z, params), "v": _map(z, params)}

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

