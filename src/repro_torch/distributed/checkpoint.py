"""Checkpoints, ported from the JAX package's ``distributed/checkpoint.py``:
:class:`CheckpointManager` only, on one card.

The on-disk format is the JAX package's, so either package restores what the
other wrote::

    <dir>/step_000000420/
        MANIFEST.json          # written LAST, then the directory renamed => commit point
        <leaf-escaped-name>/
            shard_0000.npy     # one shard per leaf here: the whole tensor

A tree is nested dicts (and lists or tuples) of tensors, numpy arrays or
numbers; a leaf's name is its JAX key path (``['p']['embed']``) with
every character outside ``[A-Za-z0-9_.-]`` replaced by ``_``. numpy's
``.npy`` has no bfloat16, so a bfloat16 leaf is stored as its raw ``uint16``
bits and the manifest keeps the true dtype. A step is written to a
``.tmp_`` directory renamed to ``step_<n>`` once complete; steps without a
manifest are skipped by ``latest_step``, and ``keep`` bounds retention.
``async_save`` moves the file writes off the training thread; the host copy
of every tensor is taken before ``save`` returns.

The JAX manager's ``shardings=`` (restoring onto another mesh) has no
counterpart: a restored leaf goes to the device of the target's leaf.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_SAFE = re.compile(r"[^A-Za-z0-9_.-]")
_NATIVE_KINDS = set("fiub")


def _flatten(tree, path=()) -> List[Tuple[tuple, Any]]:
    """(key path, leaf) in JAX's order: dict keys sorted, sequences in order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flatten(v, path + (i,))]
    return [(path, tree)]


def _unflatten(tree, leaves: Dict[tuple, Any], path=()):
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves, path + (i,)) for i, v in enumerate(tree))
    return leaves[path]


def _leaf_name(path) -> str:
    # jax.tree_util.keystr: [repr(key)] for a dict key, [i] for a sequence index
    keystr = "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]" for k in path)
    return _SAFE.sub("_", keystr).strip("_") or "root"


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A host copy of the leaf, savable by ``np.save``, and its dtype's name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.array(leaf)
    if a.dtype.kind not in _NATIVE_KINDS:
        raise TypeError(f"cannot checkpoint a leaf of dtype {a.dtype}")
    return a, a.dtype.name


def _tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, *, extra: Optional[dict] = None):
        """Snapshot is taken synchronously (host copies); IO may be async."""
        blocks = []
        for path, leaf in _flatten(tree):
            a, dtype = _host(leaf)
            blocks.append((_leaf_name(path), a.shape, dtype,
                           [(tuple((0, d) for d in a.shape), a)]))
        self.wait()
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, blocks, extra), daemon=True)
            self._thread.start()
        else:
            self._write(step, blocks, extra)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, blocks, extra):
        final = os.path.join(self.dir, f"step_{step:09d}")
        tmp = tempfile.mkdtemp(dir=self.dir, prefix=".tmp_")
        manifest: Dict[str, Any] = {"step": step, "extra": extra or {}, "leaves": {}}
        try:
            for name, shape, dtype, shards in blocks:
                leafdir = os.path.join(tmp, name)
                os.makedirs(leafdir, exist_ok=True)
                entries = []
                for i, (idx, block) in enumerate(shards):
                    fname = f"shard_{i:04d}.npy"
                    np.save(os.path.join(leafdir, fname), block)
                    entries.append({"file": fname, "index": idx})
                manifest["leaves"][name] = {"shape": list(shape), "dtype": dtype,
                                            "shards": entries}
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)      # commit point
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"), ignore_errors=True)
        for d in os.listdir(self.dir):          # orphaned tmpdirs
            if d.startswith(".tmp_"):
                shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", d)
            if m and os.path.exists(os.path.join(self.dir, d, "MANIFEST.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target: Any) -> Any:
        """Reassemble onto ``target``'s structure: each leaf a tensor of the
        saved dtype, on the device of the target's leaf (the CPU where that
        is not a tensor)."""
        stepdir = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(stepdir, "MANIFEST.json")) as f:
            manifest = json.load(f)
        leaves = {}
        for path, tgt in _flatten(target):
            name = _leaf_name(path)
            meta = manifest["leaves"][name]
            dtype = meta["dtype"]
            if dtype != "bfloat16" and np.dtype(dtype).kind not in _NATIVE_KINDS:
                raise TypeError(f"{name}: cannot restore dtype {dtype}")
            arr = np.zeros(meta["shape"], dtype=np.uint16 if dtype == "bfloat16" else dtype)
            for e in meta["shards"]:
                block = np.load(os.path.join(stepdir, name, e["file"]))
                arr[tuple(slice(a, b) for a, b in e["index"])] = block
            device = tgt.device if isinstance(tgt, torch.Tensor) else "cpu"
            leaves[path] = _tensor(arr, dtype, device)
        return _unflatten(target, leaves)

    def restore_latest(self, target: Any):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, target)
