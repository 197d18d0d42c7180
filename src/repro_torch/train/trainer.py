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
"""
from __future__ import annotations

from typing import Optional

import torch

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


def make_train_step(model: LM, optimizer, *, accum: Optional[int] = None,
                    grad_acc_dtype: Optional[str] = None, grad_transform=None):
    """Returns step(params, opt_state, batch) -> (params, opt_state, metrics).

    accum: number of gradient-accumulation microbatches (defaults to the
    config's per-arch value). grad_transform: optional fn applied to the mean
    gradients before the optimizer."""
    cfg = model.cfg
    accum = accum or cfg.grad_accum
    acc_dt = torch_dtype(grad_acc_dtype or cfg.opt_state_dtype)

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
        if accum > 1:
            gacc = {n: torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                    for n, p in params.items()}
            loss = torch.zeros((), device=model.device)
            for mb in _split_microbatches(batch, accum):
                mb_loss, g = grad_fn(params, mb)
                gacc = {n: gacc[n] + g[n].to(acc_dt) for n in gacc}
                loss = loss + mb_loss
            grads = {n: a / accum for n, a in gacc.items()}
            loss = loss / accum
        else:
            loss, grads = grad_fn(params, batch)
        if grad_transform is not None:
            grads = grad_transform(grads)
        new_params, new_opt = optimizer.update(grads, opt_state, params)
        gnorm = torch.sqrt(sum((g.to(torch.float32) ** 2).sum() for g in grads.values()))
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm}

    return step


def make_eval_step(model: LM):
    @torch.no_grad()
    def step(params, batch):
        loss, metrics = model.loss_fn(params, batch)
        return metrics | {"loss": loss}
    return step
