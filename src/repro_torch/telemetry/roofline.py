"""Roofline terms of one step of the port, per device, on an H100 SXM; the
counterpart of the JAX package's ``telemetry/roofline.py``::

    compute    = flops_per_device          / PEAK_FLOPS   (989e12 bf16)
    memory     = hbm_bytes_per_device      / HBM_BW       (3.35e12)
    collective = link_bytes_per_device     / LINK_BW      (450e9)

The JAX package reads FLOPs and bytes from XLA's ``cost_analysis()``, the
memory from ``memory_analysis()`` and the collectives from the partitioned
HLO text. The port runs eagerly and has no such text: three counters, each
a ``TorchDispatchMode``, watch the step run instead.

* :func:`count_collectives` sees every ``_c10d_functional`` op that a rank
  runs (``all_reduce``, ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
  ``all_to_all_single``; what DTensor issues when it redistributes) and
  feeds :meth:`CollectiveStats.add` the bytes of its result and the size of
  its group, so the ring factors are the JAX package's. ``wait_tensor`` is
  not a collective of its own and is not counted.
* :func:`count_costs` counts FLOPs and bytes: the matmul and attention
  formulas of ``torch.utils.flop_counter``, one FLOP per output element of
  a pointwise op (a copy does none) and per input element of a reduction;
  the bytes each
  non-view op reads and writes (a gather counts what it gathers, an
  in-place scatter what it writes, as XLA counts gathers and
  dynamic-update-slices).
* :func:`count_memory` follows the storages alive during the step (each
  op's outputs, the arguments) and keeps their peak, per device: the step
  runs on each rank's local shards, so the peak is one device's.

On DTensors every counter sees the ops each rank runs on its local shards,
not the DTensor-level op: a counter returns ``NotImplemented`` for a
DTensor op, so DTensor's dispatch runs and the counter sees the local ops
it issues. The ops that DTensor's sharding propagation runs on global
shapes, to learn an output's shape, are not counted.

The constants are the H100 SXM's datasheet figures, the card the port runs
on (``nvidia-smi``: H100 80GB HBM3, 700.00 W). ``LINK_BW`` is NVLink 4's
rate in each direction, 18 links of 25 GB/s; the machine the port is
measured on has one card, so it is not measured.
"""
from __future__ import annotations

import contextlib
import gc
import json
import threading
import time
import weakref
from dataclasses import asdict, dataclass, field
from typing import Dict, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# --- H100 SXM datasheet figures (per card) ---------------------------------
PEAK_FLOPS = 989e12          # dense bf16 (H100 80GB HBM3, 700.00 W)
HBM_BW = 3.35e12             # bytes/s (H100 80GB HBM3, 700.00 W)
LINK_BW = 450e9              # bytes/s each way, NVLink 4 (18 x 25 GB/s); not measured

_CUDA_BLOCK = 512            # the CUDA caching allocator's smallest block


@dataclass
class CollectiveStats:
    ops: Dict[str, int] = field(default_factory=dict)
    raw_bytes: Dict[str, float] = field(default_factory=dict)   # result bytes
    link_bytes: float = 0.0                                     # ring-adjusted

    def add(self, kind: str, nbytes: float, group_size: int):
        kind = kind.replace("-start", "")
        self.ops[kind] = self.ops.get(kind, 0) + 1
        self.raw_bytes[kind] = self.raw_bytes.get(kind, 0.0) + nbytes
        n = max(group_size, 1)
        ring = (n - 1) / n
        if kind == "all-reduce":
            self.link_bytes += 2 * nbytes * ring
        elif kind in ("all-gather", "reduce-scatter", "all-to-all"):
            self.link_bytes += nbytes * ring
        else:  # collective-permute
            self.link_bytes += nbytes


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_pd: float
    bytes_pd: float
    coll_link_bytes_pd: float
    coll_ops: Dict[str, int]
    coll_raw_bytes: Dict[str, float]
    mem: Dict[str, float]              # the memory counter's fields (per device)
    model_flops: float                 # 6·N·D or 2·N·D (total, all devices)
    # derived:
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    bottleneck: str = ""
    useful_flops_ratio: float = 0.0
    roofline_fraction: float = 0.0     # model_flops-time / max-term

    def derive(self):
        self.t_compute = self.flops_pd / PEAK_FLOPS
        self.t_memory = self.bytes_pd / HBM_BW
        self.t_collective = self.coll_link_bytes_pd / LINK_BW
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        self.bottleneck = max(terms, key=terms.get)
        total_flops = self.flops_pd * self.n_devices
        self.useful_flops_ratio = (self.model_flops / total_flops if total_flops else 0.0)
        # the share of the card's compute roofline that useful FLOPs reach if
        # the step runs at the dominant term's speed
        t_star = max(terms.values())
        ideal = self.model_flops / (self.n_devices * PEAK_FLOPS)
        self.roofline_fraction = ideal / t_star if t_star else 0.0
        return self

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=1, sort_keys=True)


def model_flops(cfg, shape) -> float:
    """Useful FLOPs per step: 6·N_active·D (train) else 2·N_active·D."""
    n = cfg.active_param_count()
    if shape.mode == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.mode == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


# ---------------------------------------------------------------------------
# Counters
# ---------------------------------------------------------------------------

_PROPAGATING = threading.local()


@contextlib.contextmanager
def _skip_propagation():
    """DTensor's shape propagation (its ops on global shapes, run once per
    op signature and cached) flagged while it runs, so that the counters
    leave its ops out."""
    try:
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
    except ImportError:          # no DTensor in this build: nothing to skip
        yield
        return
    name = "_propagate_tensor_meta_non_cached"
    inner = getattr(ShardingPropagator, name, None)
    if inner is None:
        yield
        return

    def flagged(self, *args, **kwargs):
        _PROPAGATING.depth = getattr(_PROPAGATING, "depth", 0) + 1
        try:
            return inner(self, *args, **kwargs)
        finally:
            _PROPAGATING.depth -= 1
    setattr(ShardingPropagator, name, flagged)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, inner)


def _dtensor_type():
    import sys
    mod = sys.modules.get("torch.distributed.tensor")
    return getattr(mod, "DTensor", None)


class _Counter(TorchDispatchMode):
    """Calls :meth:`op` for every op a rank runs on its local tensors."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dt = _dtensor_type()
        if dt is not None and any(issubclass(t, dt) for t in types):
            return NotImplemented      # DTensor's dispatch issues the local ops
        if func is torch.ops._c10d_functional.wait_tensor.default and _is_fake(args[0]):
            return args[0]             # eager waits in place; the fake kernel copies
        if func.namespace in _COLL_NAMESPACES and func._opname != "wait_tensor":
            out = _run_collective(func, args, kwargs)
        else:
            out = func(*args, **kwargs)
        if not getattr(_PROPAGATING, "depth", 0):
            self.op(func, args, kwargs, out)
        return out

    def op(self, func, args, kwargs, out) -> None:
        raise NotImplementedError

    def __enter__(self):
        self._skip = _skip_propagation()
        self._skip.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._skip.__exit__(*exc)


def _run_collective(func, args, kwargs):
    """A collective on real tensors, waited for at once, and returned only
    once the backend's work has let go of its tensors (gloo's worker thread
    holds them a moment after the wait): their storage then leaves in the
    step's own order, not when another thread drops it, so a step's peak
    does not depend on that thread's timing. Fake tensors pass through."""
    ins = [t for t in _tensors((args, kwargs)) if not _is_fake(t)]
    held = [t._use_count() for t in ins]
    out = func(*args, **kwargs)
    outs = [t for t in _tensors(out) if not _is_fake(t)]
    for t in outs:
        torch.ops._c10d_functional.wait_tensor(t)
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and (
            any(t._use_count() > n for t, n in zip(ins, held))
            or any(t._use_count() > 1 for t in outs)):
        time.sleep(1e-5)
    return out


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(t)


def _tensors(x) -> list:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_COLL_KINDS = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
               "all_reduce_coalesced": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all"}
_COLL_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "_dtensor")


def _group_size(args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = [a for a in args if isinstance(a, str)][-1]      # the group's name comes last
    return _resolve_process_group(name).size()


class CollectiveCounter(_Counter):
    """The collectives of a step: :attr:`stats` (a :class:`CollectiveStats`)."""

    def __init__(self):
        super().__init__()
        self.stats = CollectiveStats()

    def op(self, func, args, kwargs, out):
        if func.namespace not in _COLL_NAMESPACES:
            return
        name = func._opname
        if name == "wait_tensor" or name not in _COLL_KINDS and not name.startswith(
                ("permute", "isend", "irecv", "batch_p2p")):
            return
        kind = _COLL_KINDS.get(name, "collective-permute")
        self.stats.add(kind, sum(_nbytes(t) for t in _tensors(out)),
                       _group_size(list(args) + list(kwargs.values())))


def count_collectives() -> CollectiveCounter:
    """A counter of the collectives each rank runs; ``with
    count_collectives() as c: ...`` then ``c.stats``."""
    return CollectiveCounter()


# gathers read only what they gather; in-place scatters write only their values
_GATHERS = {"index.Tensor", "gather.default", "embedding.default", "index_select.default"}
_SCATTERS = {"index_put_.default", "index_put.default", "scatter_.src", "scatter_.value",
             "index_copy_.default", "index_add_.default", "masked_scatter_.default"}
_WRITES_ONLY = {"copy_.default", "fill_.Scalar", "fill_.Tensor", "zero_.default"}
_ALIASES = {"_unsafe_view.default", "lift_fresh.default", "wait_tensor.default",
            "_wrap_tensor_autograd.default"}


def _flops_of(func, args, kwargs, out) -> float:
    from torch.utils.flop_counter import flop_registry
    formula = flop_registry.get(func.overloadpacket)
    if formula is not None:
        return float(formula(*args, **kwargs, out_val=out))
    if torch.Tag.pointwise in func.tags and func._opname not in ("clone", "fill_"):
        return float(sum(t.numel() for t in _tensors(out)))
    if torch.Tag.reduction in func.tags:
        return float(sum(t.numel() for t in _tensors(args)[:1]))
    return 0.0


class CostCounter(_Counter):
    """The FLOPs and the bytes of a step, per device: :attr:`flops`,
    :attr:`bytes`."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0

    def op(self, func, args, kwargs, out):
        outs = _tensors(out)
        name = f"{func._opname}.{func._overloadname}"
        if not outs or func.is_view or name in _ALIASES:
            return
        self.flops += _flops_of(func, args, kwargs, out)
        ins = _tensors((args, kwargs))
        if name in _GATHERS:
            moved = 2 * sum(_nbytes(t) for t in outs)
            moved += sum(_nbytes(t) for t in ins[1:] if not t.is_floating_point())
        elif name in _SCATTERS:
            moved = sum(_nbytes(t) * (2 if t.is_floating_point() else 1) for t in ins[1:])
        elif name in _WRITES_ONLY:
            moved = sum(_nbytes(t) for t in ins[1:]) + sum(_nbytes(t) for t in outs)
        else:
            moved = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self.bytes += moved


def count_costs() -> CostCounter:
    """A counter of each rank's FLOPs and bytes; ``with count_costs() as c:
    ...`` then ``c.flops``, ``c.bytes``."""
    return CostCounter()


def _storages(t) -> list:
    """The storages under ``t``: a wrapper subclass's (a DTensor's local
    tensor, an ``AsyncCollectiveTensor``'s result) or a tensor's own."""
    from torch.utils._python_dispatch import is_traceable_wrapper_subclass
    if is_traceable_wrapper_subclass(t):
        inner = (getattr(t, n) for n in t.__tensor_flatten__()[0])
        return [st for x in inner if isinstance(x, torch.Tensor) for st in _storages(x)]
    return [t.untyped_storage()]


def _storage_bytes(st, device: torch.device) -> int:
    n = st.nbytes()
    if device.type == "cuda":
        return -(-n // _CUDA_BLOCK) * _CUDA_BLOCK
    return n


# ops whose result is their input in eager (a fake kernel may make a new one)
_PASS_THROUGH = {"wait_tensor", "_wrap_tensor_autograd"}
_GC_EVERY = 2000         # a young-generation collection every so many ops, a full one 50x rarer


class MemoryCounter(_Counter):
    """The bytes of the storages alive while a step runs, per device (the
    CUDA allocator's 512-byte blocks on the card): :attr:`current`,
    :attr:`peak`, and the storages of the arguments given, which are alive
    from the start. The result of an op that passes its input through
    (``wait_tensor``, ``_wrap_tensor_autograd``) shares its input's bytes,
    alive while either is."""

    def __init__(self, args=()):
        super().__init__()
        self._groups: Dict[int, list] = {}       # storage -> [bytes, storages alive]
        self._refs: Dict[int, weakref.ref] = {}
        self.current = 0
        self.peak = 0
        self.argument_bytes = self.track(args)

    def track(self, tree) -> int:
        """Counts the storages of ``tree``'s tensors from now on; returns
        the bytes of those not counted before."""
        return sum(self._add(st, t.device) for t in _tensors(tree) for st in _storages(t))

    def _add(self, st, device, like: Optional[int] = None) -> int:
        key = st._cdata
        if key in self._groups:
            return 0
        group = self._groups.get(like)
        if group is None:
            group = [_storage_bytes(st, device), 0]
            self.current += group[0]
            self.peak = max(self.peak, self.current)
        group[1] += 1
        self._groups[key] = group
        self._refs[key] = weakref.ref(st, lambda _, key=key: self._free(key))
        return group[0] if group[1] == 1 else 0

    def _free(self, key: int) -> None:
        self._refs.pop(key, None)
        group = self._groups.pop(key, None)
        if group is not None:
            group[1] -= 1
            if group[1] == 0:
                self.current -= group[0]

    def bytes_of(self, tree) -> int:
        """The bytes of ``tree``'s storages, each counted once."""
        seen = {}
        for t in _tensors(tree):
            for st in _storages(t):
                seen[st._cdata] = _storage_bytes(st, t.device)
        return sum(seen.values())

    def __enter__(self):
        # storages freed by the cycle collector would leave at moments that
        # depend on how many Python objects were made before, which differ
        # between fake and real tensors: the automatic collector is paused
        # and the counter collects every _GC_EVERY ops of its own, so that
        # a step counts the same on fake tensors as on real ones and its
        # garbage does not pile up
        gc.collect()
        self._gc = gc.isenabled()
        self._ticks = 0
        gc.disable()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            if self._gc:
                gc.enable()

    def op(self, func, args, kwargs, out):
        outs = _tensors(out)
        if func._opname in _PASS_THROUGH:
            like = _storages(args[0])[0]._cdata
            for t in outs:
                for st in _storages(t):
                    self._add(st, t.device, like)
            return
        if not outs:
            return
        for t in outs:
            for st in _storages(t):
                self._add(st, t.device)
        self._ticks += 1                  # ops with tensor results, as both modes run them
        if self._ticks % _GC_EVERY == 0:
            gc.collect(2 if self._ticks % (_GC_EVERY * 50) == 0 else 1)


def count_memory(args=()) -> MemoryCounter:
    """A counter of the storages alive during a step, ``args``' from the
    start; ``with count_memory(args) as m: ...`` then ``m.peak``."""
    return MemoryCounter(args)


def mem_dict(argument: int, output: int, alias: int, peak: int) -> Dict[str, float]:
    """The JAX package's memory fields, in GiB: ``peak`` is the counted
    peak, ``argument`` and ``output`` the step's inputs and outputs,
    ``alias`` what the step's inputs donate, and temp the rest, so that
    ``peak = argument + output + temp - alias`` as in JAX's accounting."""
    g = 2 ** 30
    return {"argument_gib": argument / g, "output_gib": output / g,
            "temp_gib": (peak - argument - output + alias) / g, "alias_gib": alias / g,
            "peak_gib": peak / g}


def run_counted(fn, args: Sequence, donated: Sequence[int] = ()):
    """``fn(*args)`` under the three counters. Returns (its output, the cost
    dict of :func:`analyze_from_parts`, the memory dict of
    :func:`mem_dict`). ``donated``: the indices of the arguments the step
    donates (its outputs may alias them)."""
    mem = MemoryCounter(args)
    with mem, count_collectives() as coll, count_costs() as cost:
        out = fn(*args)
    alias = mem.bytes_of([args[i] for i in donated])
    return out, cost_dict(cost, coll), mem_dict(mem.argument_bytes, mem.bytes_of(out), alias,
                                                mem.peak)


def cost_dict(cost: CostCounter, coll: CollectiveCounter) -> dict:
    """The counts so far as :func:`analyze_from_parts` takes them."""
    return {"flops": cost.flops, "bytes": cost.bytes, "link_bytes": coll.stats.link_bytes,
            "ops": dict(coll.stats.ops), "raw_bytes": dict(coll.stats.raw_bytes)}


def analyze(fn, args: Sequence, *, arch: str, shape, mesh_name: str, n_devices: int, cfg,
            donated: Sequence[int] = ()) -> RooflineReport:
    """One report from ``fn(*args)`` run once under the three counters."""
    _, cost, mem = run_counted(fn, args, donated)
    return analyze_from_parts(mem=mem, cost=cost, arch=arch, shape=shape, mesh_name=mesh_name,
                              n_devices=n_devices, cfg=cfg)


def analyze_from_parts(*, mem: Dict[str, float], cost: dict, arch: str, shape,
                       mesh_name: str, n_devices: int, cfg) -> RooflineReport:
    """A report from a memory dict (:func:`mem_dict`) and a cost dict
    (``flops``, ``bytes``, ``link_bytes``, ``ops``, ``raw_bytes``) counted
    apart (see ``launch.dryrun.probe_costs``)."""
    rep = RooflineReport(
        arch=arch, shape=shape.name, mesh=mesh_name, n_devices=n_devices,
        flops_pd=cost["flops"], bytes_pd=cost["bytes"],
        coll_link_bytes_pd=cost["link_bytes"],
        coll_ops=cost["ops"], coll_raw_bytes=cost["raw_bytes"],
        mem=mem, model_flops=model_flops(cfg, shape))
    return rep.derive()
