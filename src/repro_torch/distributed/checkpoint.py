"""Checkpoints, ported from the JAX package's ``distributed/checkpoint.py``:
:class:`CheckpointManager`, sharded and elastic.

The on-disk format is the JAX package's, so either package restores what the
other wrote::

    <dir>/step_000000420/
        MANIFEST.json          # written LAST, then the directory renamed => commit point
        <leaf-escaped-name>/
            shard_0000.npy     # one file per unique shard, with its index ranges
            ...                #   in the manifest

A tree is nested dicts (and lists or tuples) of tensors, DTensors, numpy
arrays or numbers; a leaf's name is its JAX key path (``['p']['embed']``)
with every character outside ``[A-Za-z0-9_.-]`` replaced by ``_``. numpy's
``.npy`` has no bfloat16, so a bfloat16 leaf is stored as its raw ``uint16``
bits and the manifest keeps the true dtype. A step is written to a
``.tmp_`` directory renamed to ``step_<n>`` once complete; steps without a
manifest are skipped by ``latest_step``, and ``keep`` bounds retention.
``async_save`` moves the file writes off the training thread; the host copy
of every tensor is taken before ``save`` returns.

A DTensor leaf is written shard by shard: each rank writes the shards it
owns uniquely (its coordinate is 0 on every mesh dim where the leaf is not
split), as ``shard_<i>`` with ``i`` the shard's place among the leaf's
unique shards. No collective runs on the writing thread, where it could
interleave with the training's on the main one: the ranks of a save share
the directory ``.tmp_step_<n>``, each drops a marker file there once its
shards are down, and rank 0 writes the manifest and renames the directory
when every marker of this run is there. ``wait`` returns on every rank
once the step is committed.

``restore(step, target, shardings=tree)`` assembles each leaf on the host
and places it by its ``NamedSharding`` (``distributed.sharding``): each rank
slices its own shard, with no scatter. So a checkpoint written on one mesh
restores onto another, or onto one device. Without ``shardings`` a DTensor
target leaf keeps its own placements and any other leaf goes to the device
of the target's leaf.
"""
from __future__ import annotations

import itertools
import json
import os
import re
import shutil
import tempfile
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import is_meshed, local_ranges, place, sharding_of

COMMIT_TIMEOUT_S = 600.0

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


def _unique_shards(leaf) -> Tuple[List[tuple], Optional[int]]:
    """(index ranges of every unique shard of a DTensor leaf, in order; the
    place in that list of the shard this rank writes, or None)."""
    from torch.distributed.tensor import Shard
    mesh, pl = leaf.device_mesh, leaf.placements
    split = [i for i, p in enumerate(pl) if isinstance(p, Shard)]
    coord = mesh.get_coordinate()
    mine = all(coord[i] == 0 for i in range(mesh.ndim) if i not in split)
    ranges, own = [], None
    for c in itertools.product(*(range(mesh.size(i)) for i in split)):
        full = [0] * mesh.ndim
        for i, ci in zip(split, c):
            full[i] = ci
        if mine and all(full[i] == coord[i] for i in split):
            own = len(ranges)
        ranges.append(local_ranges(leaf.shape, mesh, pl, full))
    return ranges, own


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
        self._pending: Optional[int] = None       # a sharded step not yet seen committed
        self._rank, self._world, self._token = 0, 1, ""
        os.makedirs(directory, exist_ok=True)

    def _group(self):
        """(rank, world, this run's token) of the default process group; the
        token (rank 0's, broadcast once, on the calling thread) marks this
        run's marker files."""
        import torch.distributed as dist
        if not self._token and dist.is_initialized():
            self._rank, self._world = dist.get_rank(), dist.get_world_size()
            tok = [uuid.uuid4().hex if self._rank == 0 else None]
            dist.broadcast_object_list(tok, src=0)
            self._token = tok[0]
        return self._rank, self._world, self._token

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, *, extra: Optional[dict] = None):
        """Snapshot is taken synchronously (host copies); IO may be async."""
        flat = _flatten(tree)
        group = self._group() if any(is_meshed(leaf) for _, leaf in flat) else (0, 1, "")
        blocks = []
        for path, leaf in flat:
            name = _leaf_name(path)
            if is_meshed(leaf):
                from torch.distributed.tensor import Partial, Replicate
                if any(isinstance(p, Partial) for p in leaf.placements):
                    leaf = leaf.redistribute(leaf.device_mesh, [
                        Replicate() if isinstance(p, Partial) else p for p in leaf.placements])
                ranges, own = _unique_shards(leaf)
                local = leaf.to_local()
                a, dtype = _host(local if own is not None else local.reshape(-1)[:0])
                blocks.append((name, tuple(leaf.shape), dtype, ranges,
                               [] if own is None else [(own, a)]))
            else:                               # whole on every rank: rank 0 writes it
                a, dtype = _host(leaf)
                idx = tuple((0, d) for d in a.shape)
                blocks.append((name, a.shape, dtype, [idx], [(0, a)] if group[0] == 0 else []))
        self.wait()
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, blocks, extra, group), daemon=True)
            self._thread.start()
        else:
            self._write(step, blocks, extra, group)
        if group[1] > 1:
            self._pending = step

    def wait(self):
        """Join the writing thread; after a sharded save, also wait (on the
        files, with no collective) for rank 0 to commit the step."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending is not None:
            manifest = os.path.join(self.dir, f"step_{self._pending:09d}", "MANIFEST.json")
            _await(lambda: os.path.exists(manifest), f"the commit of {manifest}")
            self._pending = None

    def _write(self, step: int, blocks, extra, group=(0, 1, "")):
        rank, world, token = group
        final = os.path.join(self.dir, f"step_{step:09d}")
        if world > 1:
            tmp = os.path.join(self.dir, f".tmp_step_{step:09d}")
            os.makedirs(tmp, exist_ok=True)
        else:
            tmp = tempfile.mkdtemp(dir=self.dir, prefix=".tmp_")
        manifest: Dict[str, Any] = {"step": step, "extra": extra or {}, "leaves": {}}
        try:
            for name, shape, dtype, ranges, shards in blocks:
                leafdir = os.path.join(tmp, name)
                os.makedirs(leafdir, exist_ok=True)
                for i, block in shards:
                    np.save(os.path.join(leafdir, f"shard_{i:04d}.npy"), block)
                manifest["leaves"][name] = {
                    "shape": list(shape), "dtype": dtype,
                    "shards": [{"file": f"shard_{i:04d}.npy", "index": idx}
                               for i, idx in enumerate(ranges)]}
            if world > 1:
                with open(os.path.join(tmp, f".done_{rank}"), "w") as f:
                    f.write(token)
                if rank:
                    return
                _await(lambda: all(_read(os.path.join(tmp, f".done_{r}")) == token
                                   for r in range(world)), f"every rank's shards in {tmp}")
                for r in range(world):
                    os.remove(os.path.join(tmp, f".done_{r}"))
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)      # commit point
        except BaseException:
            if world == 1:
                shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc(step)

    def _gc(self, step: int):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"), ignore_errors=True)
        for d in os.listdir(self.dir):          # orphaned tmpdirs
            m = re.fullmatch(r"\.tmp_step_(\d+)", d)
            # a shared one of a later step may be another rank's save under way
            if d.startswith(".tmp_") and (m is None or int(m.group(1)) <= step):
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

    def restore(self, step: int, target: Any, *, shardings: Any = None) -> Any:
        """Reassemble onto ``target``'s structure: each leaf a tensor of the
        saved dtype, placed by its ``NamedSharding`` in ``shardings`` (a tree
        like ``target``'s: the elastic re-meshing path), or as the target's
        leaf is placed (a DTensor's mesh and placements; else its device, the
        CPU where that is not a tensor)."""
        stepdir = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(stepdir, "MANIFEST.json")) as f:
            manifest = json.load(f)
        sh = dict(_flatten(shardings)) if shardings is not None else {}
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
            sharding = sh.get(path)
            if sharding is None and is_meshed(tgt):
                sharding = sharding_of(tgt)
            if sharding is not None:
                leaves[path] = place(_tensor(arr, dtype, "cpu"), sharding)
            else:
                device = tgt.device if isinstance(tgt, torch.Tensor) else "cpu"
                leaves[path] = _tensor(arr, dtype, device)
        return _unflatten(target, leaves)

    def restore_latest(self, target: Any, *, shardings: Any = None):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, target, shardings=shardings)


def _read(path: str) -> Optional[str]:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return None


def _await(cond, what: str, timeout: float = COMMIT_TIMEOUT_S) -> None:
    """Poll ``cond`` until it holds; raise after ``timeout`` seconds."""
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"waited {timeout:.0f} s for {what}")
        time.sleep(0.005)
