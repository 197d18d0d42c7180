"""Device meshes, ported from the JAX package's ``launch/mesh.py``.

Functions, not module constants: importing this module touches neither
``torch.distributed`` nor a device. A mesh is a ``DeviceMesh`` over the
default process group, one rank a device, with named dims:

* :func:`make_production_mesh` — ``(16, 16)`` ``("data", "model")``, or
  ``(2, 16, 16)`` ``("pod", "data", "model")`` with ``multi_pod``;
* :func:`make_local_mesh` — ``(world // model_axis, model_axis)``
  ``("data", "model")`` over the ranks there are.

Both raise where the world does not fit, where JAX's ``make_mesh`` fails.
:func:`init_process_group` starts the default group from the environment
that ``torch.distributed.run`` sets (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``); without it, a group of one rank over an
in-memory store, so no network is needed. The backend is NCCL on CUDA and
gloo on the CPU, and a failure to start NCCL raises: nothing falls back.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from repro_torch.device import resolve_device

PRODUCTION_SHAPE = (16, 16)
PRODUCTION_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


def backend_for(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_process_group(device=None) -> torch.device:
    """Start the default process group for ``device`` (``None``: the card)
    unless one is running, and return the device this rank runs on (on
    CUDA, the card of its ``LOCAL_RANK``)."""
    import torch.distributed as dist
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", dev.index or 0)))
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend_for(dev):
            raise RuntimeError(f"the running process group is {have}, not "
                               f"{backend_for(dev)} for {dev}")
        return dev
    backend = backend_for(dev)
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, **kw)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **kw)
    return dev


def _mesh(shape, axes, device):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_process_group first")
    world = dist.get_world_size()
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the world has {world}")
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if dist.get_backend() == "nccl" else torch.device("cpu"))
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(multi_pod: bool = False, device=None):
    """The production mesh over the default group's ranks (256, or 512 with
    ``multi_pod``)."""
    if multi_pod:
        return _mesh(MULTI_POD_SHAPE, MULTI_POD_AXES, device)
    return _mesh(PRODUCTION_SHAPE, PRODUCTION_AXES, device)


def make_local_mesh(n_devices: Optional[int] = None, *, model_axis: int = 1, device=None):
    """A ``(n // model_axis, model_axis)`` ``("data", "model")`` mesh, ``n``
    the world size unless given (it must then equal it)."""
    import torch.distributed as dist
    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"--model-axis {model_axis} does not divide {n} ranks")
    return _mesh((n // model_axis, model_axis), ("data", "model"), device)
