"""Multi-function workload mixes layered on top of an arrival process.

The port's own copy of the JAX package's ``workloads/workload.py``, which holds no
JAX: the port imports nothing of that package.

A :class:`MixedWorkload` binds one arrival process to a weighted set of
:class:`FunctionProfile`\\ s, each with its own prompt-size distribution —
the heterogeneous-tenant traffic under which platform architectures
actually diverge. Two independent RNG streams (arrivals vs. mix) are
derived from one seed, so adding a function to the mix never perturbs the
arrival times.

Determinism contract: same seed => byte-identical ``Request`` stream
(including ``rid``\\ s when ``rid_base`` is set, the default), and hence a
byte-identical ``RequestResult`` stream out of a seeded ``Simulator``.

The vectorized bulk path (:meth:`MixedWorkload.generate_bulk` →
:class:`RequestBatch`) draws from numpy ``Generator`` streams instead
and carries its *own* contract: same seed ⇒ byte-identical
``RequestBatch`` (pinned by golden digests in tests/test_bulk.py),
matching the scalar path in distribution but not byte-for-byte — the
numpy stream cannot reproduce the Mersenne one. The scalar path above
is untouched.
"""
from __future__ import annotations

import hashlib
import itertools
import math
import random
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.types import Request
from repro_torch.workloads.arrivals import ArrivalProcess


@dataclass(frozen=True)
class SizeDist:
    """Seeded prompt-size sampler. Kinds: const | uniform | lognormal |
    choice. Construct via the classmethods; ``sample`` draws from the
    workload's mix RNG so it stays on the determinism contract."""

    dist: str = "const"
    a: float = 16.0                    # const value / lo / median
    b: float = 0.0                     # hi / sigma
    values: Sequence[int] = ()
    weights: Sequence[float] = ()

    @classmethod
    def const(cls, n: int) -> "SizeDist":
        return cls("const", a=n)

    @classmethod
    def uniform(cls, lo: int, hi: int) -> "SizeDist":
        return cls("uniform", a=lo, b=hi)

    @classmethod
    def lognormal(cls, median: float, sigma: float = 0.6) -> "SizeDist":
        return cls("lognormal", a=median, b=sigma)

    @classmethod
    def choice(cls, values: Sequence[int],
               weights: Optional[Sequence[float]] = None) -> "SizeDist":
        return cls("choice", values=tuple(values),
                   weights=tuple(weights or [1.0] * len(values)))

    def sample(self, rng: random.Random) -> int:
        if self.dist == "const":
            return int(self.a)
        if self.dist == "uniform":
            return rng.randint(int(self.a), int(self.b))
        if self.dist == "lognormal":
            return max(1, round(self.a * math.exp(
                rng.gauss(0.0, self.b))))
        if self.dist == "choice":
            return rng.choices(self.values, weights=self.weights, k=1)[0]
        raise ValueError(f"unknown size distribution {self.dist!r}")

    def sample_array(self, n: int, np_rng: np.random.Generator) -> np.ndarray:
        """Vectorized counterpart of :meth:`sample`: ``n`` int64 draws
        from a numpy ``Generator`` (the bulk path's own determinism
        contract — same distribution as the scalar path, different
        stream)."""
        if self.dist == "const":
            return np.full(n, int(self.a), dtype=np.int64)
        if self.dist == "uniform":
            return np_rng.integers(int(self.a), int(self.b) + 1, size=n,
                                   dtype=np.int64)
        if self.dist == "lognormal":
            draws = self.a * np.exp(np_rng.normal(0.0, self.b, size=n))
            return np.maximum(1, np.rint(draws)).astype(np.int64)
        if self.dist == "choice":
            w = np.asarray(self.weights, dtype=np.float64)
            return np_rng.choice(np.asarray(self.values, dtype=np.int64),
                                 size=n, p=w / w.sum())
        raise ValueError(f"unknown size distribution {self.dist!r}")


@dataclass
class RequestBatch:
    """Columnar (struct-of-arrays) request batch from
    :meth:`MixedWorkload.generate_bulk` — the bulk-ingest counterpart of
    a ``Request`` list, without the per-request object churn. Columns
    are parallel arrays in ascending arrival order; ``fn_idx`` indexes
    into ``fns``; a NaN ``deadline_t`` means "no deadline" (maps to
    ``Request.deadline_t=None``)."""

    fns: Tuple[str, ...]
    arrival_t: np.ndarray              # float64, ascending
    fn_idx: np.ndarray                 # int32 index into fns
    size: np.ndarray                   # int64 prompt sizes
    rid: np.ndarray                    # int64 request ids
    deadline_t: np.ndarray             # float64; NaN => no deadline

    def __len__(self) -> int:
        return len(self.arrival_t)

    def digest(self) -> str:
        """sha256 over the raw column bytes (fixed dtypes/endianness):
        the bulk determinism contract's byte-identity witness."""
        h = hashlib.sha256(repr(self.fns).encode())
        for col, dt in ((self.arrival_t, "<f8"), (self.fn_idx, "<i4"),
                        (self.size, "<i8"), (self.rid, "<i8"),
                        (self.deadline_t, "<f8")):
            h.update(np.ascontiguousarray(col, dtype=dt).tobytes())
        return h.hexdigest()[:16]

    def slice(self, lo: int, hi: int) -> "RequestBatch":
        return RequestBatch(self.fns, self.arrival_t[lo:hi],
                            self.fn_idx[lo:hi], self.size[lo:hi],
                            self.rid[lo:hi], self.deadline_t[lo:hi])

    def iter_chunks(self, chunk: int) -> Iterator["RequestBatch"]:
        """Views (no copies) of ``chunk`` consecutive requests each —
        the streaming unit ``Simulator.load_bulk`` pushes per bulk run."""
        for lo in range(0, len(self), chunk):
            yield self.slice(lo, lo + chunk)

    def to_requests(self) -> List[Request]:
        """Materialize ``Request`` objects (the simulator's payload
        type) in arrival order."""
        fns = self.fns
        out: List[Request] = []
        ap = out.append
        for t, fi, sz, rid, dl in zip(
                self.arrival_t.tolist(), self.fn_idx.tolist(),
                self.size.tolist(), self.rid.tolist(),
                self.deadline_t.tolist()):
            ap(Request(fn=fns[fi], arrival_t=t, size=sz, rid=rid,
                       deadline_t=None if dl != dl else dl))  # NaN check
        return out


@dataclass(frozen=True)
class FunctionProfile:
    """One tenant function in a mix: routing weight + prompt-size shape +
    latency objective + replica memory footprint."""

    fn: str
    weight: float = 1.0
    size: SizeDist = field(default_factory=lambda: SizeDist.const(16))
    # per-function p95 latency SLO the slo_aware autoscaler targets and
    # deadline_aware routing derives request deadlines from;
    # None => no explicit objective for this tenant
    slo_p95_s: Optional[float] = None
    # per-replica memory the placement layer bin-packs against worker
    # capacity; None => the FunctionConfig default (512 MB)
    memory_mb: Optional[int] = None
    # gateway priority class ("interactive" | "batch") stamped onto every
    # request this tenant emits; None => the front door falls back to the
    # tenant quota's class (core/gateway.py), ultimately "interactive"
    priority: Optional[str] = None


class MixedWorkload:
    """Weighted multi-function request stream over an arrival process.

    ``rid_base`` (default 0) assigns request ids deterministically from
    that base, which is what makes two same-seed runs byte-identical.
    Pass ``rid_base=None`` to fall back to the process-global id counter
    (legacy ``poisson_load`` behaviour), or distinct bases when
    submitting several workloads into one simulator.
    """

    def __init__(self, arrivals: ArrivalProcess,
                 profiles: Sequence[FunctionProfile], *,
                 duration_s: Optional[float], seed: int = 1,
                 rid_base: Optional[int] = 0):
        if not profiles:
            raise ValueError("MixedWorkload needs at least one profile")
        self.arrivals = arrivals
        self.profiles = list(profiles)
        self.duration_s = duration_s
        self.seed = seed
        self.rid_base = rid_base
        self._weights = [p.weight for p in self.profiles]

    def fns(self) -> List[str]:
        return [p.fn for p in self.profiles]

    def slo_targets(self) -> dict:
        """Per-function p95 SLOs declared by the mix (fns without an
        explicit objective are omitted) — feed to ``slo_aware``."""
        return {p.fn: p.slo_p95_s for p in self.profiles
                if p.slo_p95_s is not None}

    def requests(self) -> Iterator[Request]:
        arr_rng = random.Random(self.seed)
        mix_rng = random.Random(f"mix-{self.seed}")
        rids = itertools.count(self.rid_base) if self.rid_base is not None \
            else None
        single = self.profiles[0] if len(self.profiles) == 1 else None
        for t in self.arrivals.times(self.duration_s, arr_rng):
            p = single if single is not None else mix_rng.choices(
                self.profiles, weights=self._weights, k=1)[0]
            size = p.size.sample(mix_rng)
            # slo_p95_s doubles as the request's completion deadline —
            # what deadline_aware routing scores branches against
            deadline = (t + p.slo_p95_s if p.slo_p95_s is not None
                        else None)
            if rids is None:
                yield Request(fn=p.fn, arrival_t=t, size=size,
                              deadline_t=deadline, priority=p.priority)
            else:
                yield Request(fn=p.fn, arrival_t=t, size=size,
                              rid=next(rids), deadline_t=deadline,
                              priority=p.priority)

    def generate(self) -> List[Request]:
        return list(self.requests())

    def generate_bulk(self) -> RequestBatch:
        """Vectorized counterpart of :meth:`generate`: the whole stream
        as one columnar :class:`RequestBatch`, drawn from two numpy
        ``Generator`` streams (arrivals vs. mix, spawned from one
        ``SeedSequence`` so adding a function never perturbs arrival
        times — same independence property as the scalar path). Own
        determinism contract: same seed ⇒ byte-identical batch; the
        scalar Mersenne stream is not reproduced, only its
        distribution."""
        if self.rid_base is None:
            raise ValueError(
                "generate_bulk needs a deterministic rid_base (the "
                "process-global id counter cannot be assigned in bulk)")
        arr_ss, mix_ss = np.random.SeedSequence(self.seed % 2**64).spawn(2)
        times = self.arrivals.times_array(
            self.duration_s, np.random.default_rng(arr_ss))
        times = np.ascontiguousarray(times, dtype=np.float64)
        mix_rng = np.random.default_rng(mix_ss)
        n = len(times)
        k = len(self.profiles)
        if k == 1:
            fn_idx = np.zeros(n, dtype=np.int32)
            sizes = self.profiles[0].size.sample_array(n, mix_rng)
        else:
            w = np.asarray(self._weights, dtype=np.float64)
            fn_idx = mix_rng.choice(k, size=n,
                                    p=w / w.sum()).astype(np.int32)
            sizes = np.empty(n, dtype=np.int64)
            for i, p in enumerate(self.profiles):
                mask = fn_idx == i
                sizes[mask] = p.size.sample_array(int(mask.sum()), mix_rng)
        deadlines = np.full(n, np.nan)
        for i, p in enumerate(self.profiles):
            if p.slo_p95_s is not None:
                mask = fn_idx == i
                deadlines[mask] = times[mask] + p.slo_p95_s
        rid0 = self.rid_base
        return RequestBatch(fns=tuple(p.fn for p in self.profiles),
                            arrival_t=times, fn_idx=fn_idx, size=sizes,
                            rid=np.arange(rid0, rid0 + n, dtype=np.int64),
                            deadline_t=deadlines)

    def submit_to(self, sim) -> int:
        """Feed every request into a Simulator; returns the count."""
        n = 0
        for req in self.requests():
            sim.submit(req)
            n += 1
        return n
