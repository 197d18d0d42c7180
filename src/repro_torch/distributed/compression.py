"""Gradient compression for the cross-pod sync, ported from the JAX package's
``distributed/compression.py``.

Two schemes, both with error feedback (the residual re-enters the next step,
so the compression error does not bias the optimizer in the long run):

* int8 quantization: a 4x smaller payload than float32 gradients, one
  absmax scale per tensor;
* top-k sparsification: the largest ``|g|`` fraction is kept and summed
  dense (as in the JAX package, a demonstration: production would gather
  indices).

The arithmetic is the JAX package's, in float32: the scale is the absmax
floored at 1e-12 over 127, rounding is half to even in both ``jnp.round``
and ``torch.round``, and the top-k threshold is the k-th largest ``|x|``,
kept with ``>=`` so that ties keep as JAX keeps them. Every division is by
a tensor, so the card divides as the CPU does (it would multiply by the
reciprocal of a Python number), bit for bit.

:func:`make_pod_grad_sync` sums the compressed gradients over the ``pod``
dim of a ``DeviceMesh`` with ``torch.distributed.all_reduce`` where the JAX
function runs ``jax.lax.psum(..., "pod")`` inside ``shard_map``. The sync
is a ``grad_transform`` for ``train.trainer.make_train_step``; as in the
JAX package, the launcher does not wire it in.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.distributed.sharding import is_meshed


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 payload, float32 scale) of ``x``: ``round(x / scale)`` clipped
    to +-127, ``scale = max(max|x|, 1e-12) / 127``."""
    m = torch.clamp_min(x.abs().max(), 1e-12)
    # a tensor divisor: CUDA divides by a Python number as a product with
    # its reciprocal, one ulp off the quotient that XLA and the CPU give
    scale = m / m.new_tensor(127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def topk_mask(x: torch.Tensor, frac: float) -> torch.Tensor:
    """1 where ``|x|`` is at least its k-th largest value, ``k = max(1,
    int(numel * frac))``; 0 elsewhere; in x's dtype."""
    k = max(1, int(x.numel() * frac))
    thresh = torch.topk(x.abs().reshape(-1), k).values[-1]
    return (x.abs() >= thresh).to(x.dtype)


def ef_compress_int8(g: torch.Tensor, err: torch.Tensor):
    """Error-feedback int8: returns (payload, scale, new_err)."""
    target = g.to(torch.float32) + err
    q, scale = quantize_int8(target)
    return q, scale, target - dequantize_int8(q, scale)


def ef_compress_topk(g: torch.Tensor, err: torch.Tensor, frac: float):
    """Error-feedback top-k: returns (the values sent, new_err)."""
    target = g.to(torch.float32) + err
    sent = target * topk_mask(target, frac)
    return sent, target - sent


def _map2(fn, a, b):
    """``fn`` over the leaves of two same-shaped trees of dicts, lists and
    tuples; returns the tree of its results."""
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_map2(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def _unzip(tree, i: int):
    """The tree of every :class:`_Pair`'s ``i``-th entry."""
    if isinstance(tree, _Pair):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _unzip(v, i) for k, v in tree.items()}
    return type(tree)(_unzip(v, i) for v in tree)


class _Pair(tuple):
    """A leaf's (synced, new_err), told apart from a tuple of the tree."""


def make_pod_grad_sync(mesh, scheme: str = "int8", topk_frac: float = 0.05):
    """Returns ``sync(grads, err) -> (synced_grads, new_err)``: each leaf
    compressed with its error (``int8``, ``topk``; any other scheme sends
    the float32 gradient and keeps the error), the payloads summed over
    the mesh's ``pod`` dim, divided by the pod count and cast back to the
    gradient's dtype.

    The trees hold each rank's tensors, its pod's gradients: plain tensors,
    or DTensors, which are synced through their local shards and keep their
    placements (the new error too, in float32). A mesh without a ``pod``
    dim sums over one pod."""
    import torch.distributed as dist
    names = tuple(mesh.mesh_dim_names or ())
    group = mesh.get_group("pod") if "pod" in names else None
    npod = mesh.size(names.index("pod")) if group is not None else 1

    def psum(t: torch.Tensor) -> torch.Tensor:
        if group is not None:
            dist.all_reduce(t, group=group)
        return t

    def sync_leaf(g, err):
        wrap = _wrapper(g)
        g = g.to_local() if is_meshed(g) else g
        err = err.to_local() if is_meshed(err) else err
        if scheme == "int8":
            q, scale, new_err = ef_compress_int8(g, err)
            # an int8 sum would overflow: the dequantized values go on the
            # wire (their volume is the int8 payload and one scale)
            total = psum(dequantize_int8(q, scale))
        elif scheme == "topk":
            sent, new_err = ef_compress_topk(g, err, topk_frac)
            total = psum(sent)
        else:
            total, new_err = psum(g.to(torch.float32, copy=True)), err   # summed in place
        return _Pair((wrap((total / total.new_tensor(npod)).to(g.dtype)), wrap(new_err)))

    def sync(grads, err_tree):
        out = _map2(sync_leaf, grads, err_tree)
        return _unzip(out, 0), _unzip(out, 1)

    return sync


def _wrapper(t):
    """A function that puts a local tensor back under ``t``'s mesh and
    placements (the identity for a plain tensor)."""
    if not is_meshed(t):
        return lambda x: x
    from torch.distributed.tensor import DTensor
    return lambda x: DTensor.from_local(x, t.device_mesh, t.placements, run_check=False,
                                        shape=t.shape, stride=t.stride())
