"""Partitioning primitives for the parallel simulation runner.

The port's own copy of the JAX package's ``parallel/partition.py``, which holds no
JAX: the port imports nothing of that package.

A scenario parallelises along its *tenant streams*: each per-tenant
workload (one ``MixedWorkload`` / trace stream) is assigned to exactly
one partition, each partition owns a disjoint LB-branch subtree, and no
request, retry, hedge, or replica ever crosses a partition boundary.
That makes each partition an ordinary serial :class:`Simulator` — the
parallel layer adds no new event semantics, only a driver and a merge.

Three pieces live here, all pure functions of their inputs (no RNG, no
wall clock) so the coordinator's directives are byte-reproducible:

- :func:`conservative_window` — the lookahead bound. Cross-partition
  interaction in this testbed flows through capacity (gateway ceiling,
  fleet autoscale), and no capacity change can take effect faster than
  the shortest cold start or the autoscale tick period: a directive
  issued at a barrier cannot influence any event earlier than one
  window later, so partitions may free-run a full window between
  exchanges without missing an interaction.
- :func:`split_ceiling` — largest-remainder apportionment of a global
  concurrency ceiling across partitions, proportional to demand.
- :class:`ResultSink` — a drop-in for ``sim.results`` that folds each
  row into mergeable summary partials + a running stream digest instead
  of retaining row objects (10M ``RequestResult`` rows ≈ 3 GB; the sink
  keeps ~8 bytes per ok row).
"""
from __future__ import annotations

import hashlib
import math
from array import array
from typing import List, Optional, Sequence


def conservative_window(sim) -> float:
    """Lookahead window for one partition: min(shortest cold start,
    autoscale tick period), floored at 1 ms.

    Derivation: the only cross-partition couplings are capacity-shaped
    (gateway ``max_inflight`` splits, whole-fleet autoscale). A capacity
    grant can't convert into served work faster than a cold start warms
    a replica, and fleet-scale decisions only happen on autoscale
    ticks — so a barrier directive has no observable effect for at
    least this long, and exchanging summaries once per window is
    conservative (never late).
    """
    colds = []
    for name in sim.store.list():
        c = sim.store.get(name).cold_start_s
        colds.append(sim.cold_default if c is None else c)
    w = min(colds) if colds else sim.cold_default
    scaler = sim.autoscaler
    if scaler is not None:
        w = min(w, scaler.interval_s)
    return max(float(w), 1e-3)


def split_ceiling(total: int, demands: Sequence[float]) -> List[int]:
    """Apportion a global concurrency ceiling across partitions.

    Largest-remainder (Hamilton) apportionment proportional to
    ``demands``: allocations are integers, sum exactly to ``total``,
    ties break toward the lower partition index, and — when ``total``
    covers every partition — each partition keeps a floor of 1 so a
    momentarily idle tenant group is never locked out entirely (it
    could then never generate the occupancy that would win it quota
    back). Deterministic: same inputs ⇒ same split, which keeps
    barrier-coupled runs byte-reproducible.
    """
    k = len(demands)
    if k == 0:
        return []
    total = int(total)
    sd = float(sum(demands))
    if sd <= 0:
        demands = [1.0] * k
        sd = float(k)
    quota = [total * float(d) / sd for d in demands]
    alloc = [int(math.floor(q)) for q in quota]
    rem = total - sum(alloc)
    order = sorted(range(k), key=lambda i: (-(quota[i] - alloc[i]), i))
    for i in order[:rem]:
        alloc[i] += 1
    if total >= k:
        # floor of 1, funded by the largest allocation (lowest index on
        # ties). total >= k guarantees a donor with alloc >= 2 exists
        # whenever anyone sits at 0.
        for i in range(k):
            while alloc[i] == 0:
                j = max(range(k), key=lambda j: (alloc[j], -j))
                alloc[j] -= 1
                alloc[i] += 1
    return alloc


def partition_streams(streams, n_partitions: int, *, key=None) -> List[list]:
    """Bucket per-tenant workload streams into ``n_partitions`` groups
    by the cross-process-stable tenant hash — the same crc32 assignment
    ``tenant_hash`` routing uses (``repro_torch.core.router.tenant_index``),
    so a union tree whose root routes by ``tenant_hash`` sends every
    request to the branch whose partition owns its stream. ``key`` maps
    a stream to its tenant name; the default reads the first profile's
    function name (each per-tenant stream carries one tenant's mix).
    """
    from repro_torch.core.router import tenant_index
    buckets: List[list] = [[] for _ in range(n_partitions)]
    for s in streams:
        name = key(s) if key is not None else s.profiles[0].fn
        buckets[tenant_index(name, n_partitions)].append(s)
    return buckets


class ResultSink:
    """Memory-bounded stand-in for the ``sim.results`` list.

    Supports exactly the surface the hot path touches — ``append`` and
    ``len`` — and folds each appended row into (a) the
    :func:`repro_torch.core.simulator.part_summary` partials and (b) the same
    per-row hash :func:`repro_torch.core.simulator.stream_digest` computes, so
    a summary-collected partition still reports a byte-identity digest
    of its *result stream* (telemetry is separately disabled on the
    probes that need a sink). NOT usable with an attached autoscaler:
    the controller slices ``sim.results[last:]`` each tick, which needs
    the real list — ``run_partitioned`` only substitutes a sink when no
    autoscaler is bound.
    """

    __slots__ = ("n", "ok", "served", "cold", "t0", "t1", "_lat", "_h")

    def __init__(self):
        self.n = 0
        self.ok = 0
        self.served = 0
        self.cold = 0
        self.t0 = float("inf")
        self.t1 = -float("inf")
        self._lat = array("d")
        self._h = hashlib.sha256()

    def append(self, r) -> None:
        self.n += 1
        if r.arrival_t < self.t0:
            self.t0 = r.arrival_t
        if r.instance != "-":
            self.served += 1
        if r.cold_start:
            self.cold += 1
        if r.ok:
            self.ok += 1
            self._lat.append(r.finish_t - r.arrival_t)
            if r.finish_t > self.t1:
                self.t1 = r.finish_t
        self._h.update(repr(
            (r.rid, r.fn, r.ok, r.arrival_t, r.start_t, r.finish_t,
             r.cold_start, r.worker, r.instance, r.error)).encode())

    def __len__(self) -> int:
        return self.n

    def part(self) -> dict:
        """The :func:`repro_torch.core.simulator.part_summary` dict of every
        row appended so far (mergeable via ``merge_part_summaries``)."""
        import numpy as np
        return {"n": self.n, "ok": self.ok, "served": self.served,
                "cold": self.cold,
                "lat": np.frombuffer(self._lat, dtype=np.float64)
                if self.n else np.zeros(0),
                "t0": self.t0, "t1": self.t1}

    def digest(self) -> str:
        """sha256[:16] over the result stream seen so far — the results
        portion of ``stream_digest``, computed incrementally."""
        return self._h.hexdigest()[:16]


def window_summary(sim) -> dict:
    """One partition's barrier report: the simulator's deterministic
    ``occupancy_summary`` plus the engine's next pending event time
    (``None`` when drained), which lets the coordinator skip empty
    windows instead of spinning barriers across idle gaps."""
    d = sim.occupancy_summary()
    d["next_t"] = sim.engine.peek_t()
    return d


def demand_of(summary: dict) -> float:
    """Apportionment weight from one barrier summary: outstanding work
    (queued + in flight, plus gateway-held slots when a front door is
    attached) with a +1 smoothing term so an all-idle barrier still
    yields a well-defined proportional split."""
    return (summary["queued"] + summary["inflight"]
            + summary.get("gw_inflight", 0) + 1.0)


def combined_digest(digests: Sequence[str]) -> str:
    """Order-sensitive combination of per-partition digests — the
    byte-identity projection of a summary-collected merged run (full
    collects hash the merged streams directly via ``stream_digest``)."""
    h = hashlib.sha256()
    for d in digests:
        h.update(d.encode())
    return h.hexdigest()[:16]


def maybe_attach_sink(sim) -> Optional[ResultSink]:
    """Swap ``sim.results`` for a :class:`ResultSink` when legal (no
    autoscaler bound — see the class docstring). Returns the sink, or
    None when the real list must stay."""
    if sim.autoscaler is not None:
        return None
    if len(sim.results):        # rows already recorded: too late to fold
        return None
    sink = ResultSink()
    sim.results = sink
    return sink
