"""Weights from the JAX package into the port.

:func:`params_from_numpy` turns the JAX params tree, handed over as numpy
arrays (``jax.tree.map(np.asarray, params)``), into a ``state_dict`` for
:class:`repro_torch.models.LM`: the dotted path of each leaf is its
parameter's name (``slots.0.wq``). The port needs neither JAX nor
``ml_dtypes`` for it: bfloat16 arrays are recognised by ``dtype.name`` and
moved bit for bit through a ``uint16`` view.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor with the array's values; bfloat16 (``ml_dtypes``) included."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = tree


def params_from_numpy(tree, device="cpu",
                      dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` on ``device`` (cast to ``dtype`` when given), ready for
    ``LM.load_state_dict``."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    return {name: tensor_from_numpy(np.asarray(a)).to(device=device, dtype=dtype)
            for name, a in flat.items()}


def mlp_worker_model(model):
    """The port's ``MLPWorkerModel`` from a JAX ``MLPWorkerModel``'s fields
    (``params`` as numpy, ``mu``, ``sd``, ``resid_std``, ``fail_rate``), its
    network on the CPU. A ``RidgeWorkerModel`` is plain numpy and moves by
    its fields."""
    from repro_torch.core.emulation import MLPNet, MLPWorkerModel
    net = MLPNet({n: tensor_from_numpy(np.asarray(model.params[n]))
                  for n in MLPNet.NAMES})
    return MLPWorkerModel(net=net, mu=np.asarray(model.mu), sd=np.asarray(model.sd),
                          resid_std=float(model.resid_std),
                          fail_rate=float(model.fail_rate))
