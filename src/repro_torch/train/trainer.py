"""Training step construction, ported from the JAX package's ``train/trainer.py``:
gradient-accumulation microbatching in ``opt_state_dtype``, an optional
``grad_transform`` hook on the mean gradients, the ``{"loss", "grad_norm"}``
metrics.

The step is functional, as the JAX one is: ``step(params, opt_state, batch)
-> (params, opt_state, metrics)`` over the dict of parameters that
``LM.params()`` gives (``embed``, ``slots.0.wq``, ...). Each microbatch's loss
is differentiated in detached copies of those tensors with
``torch.autograd.grad``; the optimizer's update runs without autograd and
returns new tensors. The model's own parameters are not touched: load the
result back with ``load_state_dict`` where a module is wanted. Metrics stay
on the device (no host round trip in the step).

On a device mesh the parameters and the optimizer state are DTensors
(``distributed.sharding.place``) and ``place_batch`` puts each microbatch
onto the mesh: the global batch is split into microbatches first, as the
JAX step splits it (microbatch i is rows ``[i*b/accum, (i+1)*b/accum)``),
then each is sharded over ``data``. The step then runs under
``implicit_replication``, so that the plain tensors the model makes
(positions, rope tables, masks) act as replicated, and its metrics are
plain scalars, the same on every rank.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from repro_torch.distributed.sharding import is_meshed, redistribute
from repro_torch.models.transformer import LM, torch_dtype


def _split_microbatches(batch, accum: int):
    def r(x):
        x = torch.as_tensor(x)
        b = x.shape[0]
        if b % accum:
            raise ValueError(f"batch of {b} rows does not split into {accum} microbatches")
        return x.reshape(accum, b // accum, *x.shape[1:])
    split = {k: r(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(accum)]


def _implicit_replication():
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _like(new, old):
    """``new`` redistributed to ``old``'s placements where it is a DTensor
    and they differ (a split moved between dims by all-to-all,
    ``sharding.redistribute``): an update keeps every tensor where the
    shardings put it."""
    if isinstance(new, dict):
        return {k: _like(v, old[k]) for k, v in new.items()}
    if is_meshed(new) and tuple(new.placements) != tuple(old.placements):
        return redistribute(new, old.placements)
    return new


def _plain(t: torch.Tensor) -> torch.Tensor:
    """A scalar's value as a plain tensor (a DTensor's reduced and replicated)."""
    return t.full_tensor() if is_meshed(t) else t


def make_train_step(model: LM, optimizer, *, accum: Optional[int] = None,
                    grad_acc_dtype: Optional[str] = None, grad_transform=None,
                    place_batch: Optional[Callable] = None):
    """Returns step(params, opt_state, batch) -> (params, opt_state, metrics).

    accum: number of gradient-accumulation microbatches (defaults to the
    config's per-arch value). grad_transform: optional fn applied to the mean
    gradients before the optimizer. place_batch: on a device mesh, puts one
    microbatch (a dict of whole tensors) onto the mesh."""
    cfg = model.cfg
    accum = accum or cfg.grad_accum
    acc_dt = torch_dtype(grad_acc_dtype or cfg.opt_state_dtype)
    place = place_batch or (lambda mb: mb)

    def grad_fn(params, batch):
        leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
        with torch.enable_grad():
            loss, _ = model.loss_fn(leaves, batch)
            # a parameter the loss does not reach gets zeros, as under jax.grad
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), dict(zip(leaves, grads))

    @torch.no_grad()
    def step(params, opt_state, batch):
        meshed = is_meshed(*params.values())
        with _implicit_replication() if meshed else contextlib.nullcontext():
            if accum > 1:
                gacc = {n: torch.zeros_like(p, dtype=acc_dt) for n, p in params.items()}
                loss = torch.zeros((), device=model.device)
                for mb in _split_microbatches(batch, accum):
                    mb_loss, g = grad_fn(params, place(mb))
                    gacc = {n: gacc[n] + g[n].to(acc_dt) for n in gacc}
                    loss = loss + mb_loss
                grads = {n: a / accum for n, a in gacc.items()}
                loss = loss / accum
            else:
                loss, grads = grad_fn(params, place(batch))
            if meshed:
                grads = _like(grads, params)
            if grad_transform is not None:
                grads = grad_transform(grads)
            new_params, new_opt = optimizer.update(grads, opt_state, params)
            if meshed:
                new_params, new_opt = _like(new_params, params), _like(new_opt, opt_state)
            gnorm = torch.sqrt(sum((g.to(torch.float32) ** 2).sum() for g in grads.values()))
            return new_params, new_opt, {"loss": _plain(loss), "grad_norm": _plain(gnorm)}

    return step


def make_eval_step(model: LM):
    @torch.no_grad()
    def step(params, batch):
        loss, metrics = model.loss_fn(params, batch)
        return metrics | {"loss": loss}
    return step
