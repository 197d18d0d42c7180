"""RQ-B: emulating worker nodes (paper §III.B, Fig. 2), ported from the JAX
package's ``core/emulation.py``.

Pipeline, exactly as the figure prescribes:
  1. put a REAL worker under artificial load (``repro_torch.serving.engine``
     on the card, or the synthetic ground-truth sim) and save invocation
     telemetry;
  2. fit a model of the worker: closed-form ridge regression (a float32
     ``torch.linalg.solve`` on the device) and a small MLP trained with the
     framework's own AdamW (``repro_torch.train.optimizer``);
  3. serve many emulated workers from the model (:class:`EmulatedServiceModel`
     plugs into the simulator as a service-time source);
  4. evaluate fidelity by replaying the step-1 load and comparing latency
     distributions (:func:`fidelity_report`).

``telemetry_matrix``, both models' ``predict``, :class:`EmulatedServiceModel`
and :func:`fidelity_report` are numpy, as in the reference, with the same
order of draws from the numpy generator. The fits take ``device`` (the card
unless the caller asks for ``"cpu"``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.core.types import FunctionConfig, TelemetryRecord
from repro_torch.device import resolve_device
from repro_torch.train.optimizer import AdamW


def telemetry_matrix(records: Sequence[TelemetryRecord]):
    X = np.array([r.features() for r in records], np.float32)
    y = np.array([r.latency for r in records], np.float32)
    ok = np.array([r.ok for r in records], np.float32)
    return X, y, ok


def _standardize(X: np.ndarray):
    mu, sd = X.mean(0), X.std(0) + 1e-8
    return mu, sd, (X - mu) / sd


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------

@dataclass
class RidgeWorkerModel:
    """Closed-form ridge on standardized features; log-latency target."""
    w: np.ndarray = None
    mu: np.ndarray = None
    sd: np.ndarray = None
    resid_std: float = 0.05
    fail_rate: float = 0.0

    @staticmethod
    def fit(X: np.ndarray, y: np.ndarray, ok: np.ndarray, lam: float = 1e-3,
            device=None):
        dev = resolve_device(device)
        mu, sd, xs = _standardize(X)
        Xs = torch.as_tensor(xs, device=dev)
        Xs = torch.cat([Xs, torch.ones((Xs.shape[0], 1), device=dev)], 1)
        ty = torch.log(torch.as_tensor(y, device=dev) + 1e-6)
        A = Xs.T @ Xs + lam * torch.eye(Xs.shape[1], device=dev)
        w = torch.linalg.solve(A, Xs.T @ ty)
        resid = (ty - Xs @ w).cpu().numpy()
        return RidgeWorkerModel(w=w.cpu().numpy(), mu=mu, sd=sd,
                                resid_std=float(resid.std()),
                                fail_rate=float(1 - ok.mean()))

    def predict(self, feats: np.ndarray, rng: np.random.Generator):
        xs = (feats - self.mu) / self.sd
        xs = np.append(xs, 1.0)
        ly = float(xs @ self.w) + rng.normal(0, self.resid_std)
        return float(np.exp(ly)), rng.random() >= self.fail_rate


class MLPNet(nn.Module):
    """``tanh(x @ w1 + b1)``, ``tanh(h @ w2 + b2)``, ``h @ w3 + b3``: the
    reference's network with its parameter names and layouts (``w1`` is
    (d, hidden), not ``nn.Linear``'s transpose)."""

    NAMES = ("w1", "b1", "w2", "b2", "w3", "b3")

    def __init__(self, params: Dict[str, torch.Tensor]):
        super().__init__()
        for name in self.NAMES:
            self.register_parameter(name, nn.Parameter(params[name]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.tanh(x @ self.w1 + self.b1)
        h = torch.tanh(h @ self.w2 + self.b2)
        return (h @ self.w3 + self.b3)[..., 0]


@dataclass
class MLPWorkerModel:
    """2-hidden-layer MLP on standardized features, trained with the port's
    AdamW. The "more complicated model using machine learning" of the paper.
    ``net`` stays on the device it was fitted on, and ``predict`` runs it
    there, one feature row a call, as the reference does."""
    net: MLPNet = None
    mu: np.ndarray = None
    sd: np.ndarray = None
    resid_std: float = 0.05
    fail_rate: float = 0.0

    @property
    def params(self) -> Dict[str, np.ndarray]:
        return {n: p.detach().cpu().numpy() for n, p in self.net.named_parameters()}

    @staticmethod
    def init_params(d: int, hidden: int, seed: int, device) -> Dict[str, torch.Tensor]:
        """The reference's initial draws, scaled as it scales them, from a
        ``torch.Generator`` on ``device`` (torch cannot draw ``jax.random``)."""
        gen = torch.Generator(device).manual_seed(seed)
        normal = lambda *shape: torch.randn(shape, generator=gen, device=device)
        return {
            "w1": 0.5 * normal(d, hidden) / math.sqrt(d),
            "b1": torch.zeros(hidden, device=device),
            "w2": 0.5 * normal(hidden, hidden) / math.sqrt(hidden),
            "b2": torch.zeros(hidden, device=device),
            "w3": 0.5 * normal(hidden, 1) / math.sqrt(hidden),
            "b3": torch.zeros(1, device=device),
        }

    @staticmethod
    def fit(X: np.ndarray, y: np.ndarray, ok: np.ndarray, *, hidden: int = 32,
            steps: int = 400, lr: float = 3e-3, seed: int = 0, device=None,
            init: Optional[Dict[str, np.ndarray]] = None):
        """Full-batch MSE on log-latency, ``steps`` AdamW steps. ``init``, a
        dict of numpy arrays under the network's parameter names, replaces
        the initial draws."""
        dev = resolve_device(device)
        mu, sd, xs = _standardize(X)
        Xs = torch.as_tensor(xs, device=dev)
        ty = torch.log(torch.as_tensor(y, device=dev) + 1e-6)
        params = (MLPWorkerModel.init_params(X.shape[1], hidden, seed, dev) if init is None
                  else {n: torch.tensor(np.asarray(init[n], np.float32), device=dev)
                        for n in MLPNet.NAMES})
        net = MLPNet(params)
        opt = AdamW(lr=lr)
        state = opt.init(dict(net.named_parameters()))
        for _ in range(steps):
            loss = torch.mean((net(Xs) - ty) ** 2)
            named = dict(net.named_parameters())
            grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
            with torch.no_grad():
                new, state = opt.update(grads, state, named)
                for n, p in named.items():
                    p.copy_(new[n])
        with torch.no_grad():
            resid = (net(Xs) - ty).cpu().numpy()
        return MLPWorkerModel(net=net, mu=mu, sd=sd, resid_std=float(resid.std()),
                              fail_rate=float(1 - ok.mean()))

    def predict(self, feats: np.ndarray, rng: np.random.Generator):
        xs = (feats - self.mu) / self.sd
        with torch.no_grad():
            ly = float(self.net(torch.as_tensor(xs[None], device=self.net.w1.device))[0])
        ly += rng.normal(0, self.resid_std)
        return float(np.exp(ly)), rng.random() >= self.fail_rate


# ---------------------------------------------------------------------------
# Simulator adapter + fidelity
# ---------------------------------------------------------------------------

class EmulatedServiceModel:
    """Plugs a fitted worker model into the Simulator (Fig. 2 step 3):
    'whenever a function is called on this emulated worker, it should have
    the same kind of answer within the same timeframes with a comparable
    failure rate.'"""

    def __init__(self, model, seed: int = 0):
        self.model = model
        self.rng = np.random.default_rng(seed)

    def sample(self, cfg: FunctionConfig, *, batch_size: int, queue_len: int,
               prompt: int, cold: bool, fn_cost: float):
        feats = np.array([queue_len, max(batch_size - 1, 0), batch_size,
                          1.0 if cold else 0.0, prompt, cfg.gen_tokens,
                          fn_cost], np.float32)
        lat, ok = self.model.predict(feats, self.rng)
        # clip to the function timeout: an unclipped lognormal tail on a noisy
        # fit can otherwise stall the event loop with day-long service times
        return min(lat, cfg.timeout_s), ok


def fidelity_report(real: np.ndarray, emulated: np.ndarray,
                    real_fail: float = 0.0, emu_fail: float = 0.0) -> dict:
    """Distribution closeness of latencies: percentile errors + KS distance."""
    qs = [50, 90, 95, 99]
    rep = {}
    for q in qs:
        r, e = np.percentile(real, q), np.percentile(emulated, q)
        rep[f"p{q}_rel_err"] = abs(e - r) / max(r, 1e-9)
    rep["mean_rel_err"] = abs(emulated.mean() - real.mean()) / max(real.mean(), 1e-9)
    # two-sample KS statistic
    allv = np.sort(np.concatenate([real, emulated]))
    cdf_r = np.searchsorted(np.sort(real), allv, side="right") / len(real)
    cdf_e = np.searchsorted(np.sort(emulated), allv, side="right") / len(emulated)
    rep["ks"] = float(np.abs(cdf_r - cdf_e).max())
    rep["fail_rate_err"] = abs(real_fail - emu_fail)
    return rep
