"""Sliding metrics window the autoscaler control loop observes.

The port's own copy of the JAX package's ``autoscale/metrics.py``, which holds no
JAX: the port imports nothing of that package.

Each ``autoscale_tick`` the controller snapshots the simulator into a
:class:`MetricsSample` (totals over live workers plus deltas since the
previous tick) and pushes it into a bounded :class:`MetricsWindow`.
Policies only ever read aggregates of this window — they never touch the
simulator directly — which keeps every policy a pure function of
deterministic inputs and makes the scaling-decision log byte-identical
across same-seed runs.

Samples are keyed down to *function* granularity: every sample carries a
sorted tuple of :class:`FnSample` rows (per-function queue depth,
inflight, arrival/completion deltas, warm replica count, and a windowed
p95 latency estimate) — the signals SLO-aware policies and per-function
prewarm/reap decisions run on.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Optional, Tuple


@dataclass(frozen=True)
class FnSample:
    """One function's share of a control-loop observation.

    With a front-door gateway attached (``sim.gateway``), ``arrivals``
    is the *post-gateway admitted* delta — the demand that actually
    reached the LB tree — so rate-proportional policies (reactive,
    predictive, slo_aware) scale to the load the platform accepted, not
    to a flood the gateway already refused. ``shed`` carries the refused
    delta and ``goodput`` the successful-completion delta; without a
    gateway, ``arrivals`` is offered load (unchanged semantics) and
    ``shed`` stays 0.
    """

    fn: str
    queue: int                 # queued requests for this fn across workers
    inflight: int              # busy slots serving this fn
    arrivals: int              # fn arrivals since the previous tick
    completions: int           # fn results recorded since the previous tick
    warm: int                  # replicas (ready + warming) across workers
    p95_est: float             # windowed p95 latency estimate (0 => no data)
    shed: int = 0              # gateway refusals since the previous tick
    goodput: int = 0           # ok results recorded since the previous tick

    @property
    def concurrency(self) -> int:
        return self.queue + self.inflight


@dataclass(frozen=True)
class MetricsSample:
    """One control-loop observation (totals at tick time + inter-tick deltas)."""

    t: float
    replicas: int              # branches under the LB root
    workers: int               # live *healthy* (routable) workers
    queue: int                 # queued requests across workers
    inflight: int              # busy instance slots across workers
    arrivals: int              # requests arrived since the previous tick
    completions: int           # results recorded since the previous tick
    cold_starts: int           # instances cold-started since the previous tick
    fns: Tuple[FnSample, ...] = ()     # per-function rows, sorted by name
    unhealthy: int = 0         # workers currently failed/partitioned away

    @property
    def concurrency(self) -> int:
        """Outstanding work (Knative's 'observed concurrency')."""
        return self.queue + self.inflight

    @property
    def load_per_worker(self) -> float:
        return self.concurrency / max(self.workers, 1)

    def fn(self, name: str) -> Optional[FnSample]:
        for f in self.fns:
            if f.fn == name:
                return f
        return None


def merge_fleet_samples(samples) -> MetricsSample:
    """Combine per-partition :class:`MetricsSample` rows into one
    whole-fleet observation (the windowed metrics exchange of
    ``repro_torch.parallel``).

    Counters and deltas sum; per-function rows merge by name with
    ``p95_est`` taken as the max across partitions (a conservative
    fleet-tail estimate — partitions see disjoint tenants, so their
    windows cannot be pooled exactly); ``t`` is the latest partition
    clock. Input order does not matter: rows re-sort by name, so the
    merge is deterministic regardless of summary arrival order.
    """
    samples = [s for s in samples if s is not None]
    if not samples:
        return MetricsSample(t=0.0, replicas=0, workers=0, queue=0,
                             inflight=0, arrivals=0, completions=0,
                             cold_starts=0)
    by_fn: dict = {}
    for s in samples:
        for f in s.fns:
            prev = by_fn.get(f.fn)
            if prev is None:
                by_fn[f.fn] = f
            else:
                by_fn[f.fn] = FnSample(
                    fn=f.fn, queue=prev.queue + f.queue,
                    inflight=prev.inflight + f.inflight,
                    arrivals=prev.arrivals + f.arrivals,
                    completions=prev.completions + f.completions,
                    warm=prev.warm + f.warm,
                    p95_est=max(prev.p95_est, f.p95_est),
                    shed=prev.shed + f.shed,
                    goodput=prev.goodput + f.goodput)
    return MetricsSample(
        t=max(s.t for s in samples),
        replicas=sum(s.replicas for s in samples),
        workers=sum(s.workers for s in samples),
        queue=sum(s.queue for s in samples),
        inflight=sum(s.inflight for s in samples),
        arrivals=sum(s.arrivals for s in samples),
        completions=sum(s.completions for s in samples),
        cold_starts=sum(s.cold_starts for s in samples),
        fns=tuple(by_fn[k] for k in sorted(by_fn)),
        unhealthy=sum(s.unhealthy for s in samples))


class MetricsWindow:
    """Bounded deque of samples with the aggregates policies consume."""

    def __init__(self, maxlen: int):
        self.samples: Deque[MetricsSample] = deque(maxlen=max(1, maxlen))

    def push(self, sample: MetricsSample) -> None:
        self.samples.append(sample)

    def __len__(self) -> int:
        return len(self.samples)

    def last(self) -> Optional[MetricsSample]:
        return self.samples[-1] if self.samples else None

    def avg(self, attr: str, tail: Optional[int] = None) -> float:
        """Mean of a sample attribute over the window (or its last ``tail``
        samples — the panic-window read)."""
        if not self.samples:
            return 0.0
        xs = list(self.samples)[-tail:] if tail else list(self.samples)
        return sum(getattr(s, attr) for s in xs) / len(xs)

    def arrival_rate(self, interval_s: float, tail: Optional[int] = None) -> float:
        """Observed arrivals/s averaged over the window."""
        return self.avg("arrivals", tail) / max(interval_s, 1e-9)

    # ------------------------------------------------- per-function reads
    def fn_names(self) -> Tuple[str, ...]:
        last = self.last()
        return tuple(f.fn for f in last.fns) if last is not None else ()

    def fn_last(self, name: str) -> Optional[FnSample]:
        last = self.last()
        return last.fn(name) if last is not None else None

    def fn_avg(self, name: str, attr: str, tail: Optional[int] = None) -> float:
        """Mean of one function's sample attribute over the window."""
        if not self.samples:
            return 0.0
        xs = list(self.samples)[-tail:] if tail else list(self.samples)
        vals = [getattr(f, attr) for s in xs
                for f in (s.fn(name),) if f is not None]
        return sum(vals) / len(vals) if vals else 0.0


class ServiceEstimator:
    """Windowed per-function mean *service-time* estimate.

    The routing-facing sibling of :class:`LatencyEstimator`: fed one
    observation per completed request (in result order, so it is a pure
    function of the deterministic result stream), read by
    ``deadline_aware`` routing to price a worker's queued backlog. A
    running sum over a bounded deque keeps both ``observe`` and
    ``estimate`` O(1) — this sits on the per-arrival routing hot path.
    """

    def __init__(self, maxlen: int = 128, default_s: float = 0.05):
        self.maxlen = maxlen
        self.default_s = default_s
        self._win: dict = {}       # fn -> deque[float]
        self._sum: dict = {}       # fn -> running sum over the deque

    def observe(self, fn: str, service_s: float) -> None:
        d = self._win.get(fn)
        if d is None:
            d = self._win[fn] = deque(maxlen=self.maxlen)
            self._sum[fn] = 0.0
        if len(d) == self.maxlen:
            self._sum[fn] -= d[0]
        d.append(service_s)
        self._sum[fn] += service_s

    def estimate(self, fn: str) -> float:
        d = self._win.get(fn)
        if not d:
            return self.default_s
        return self._sum[fn] / len(d)


class LatencyEstimator:
    """Bounded per-function latency reservoir feeding ``FnSample.p95_est``.

    Keeps the most recent ``maxlen`` completed-request latencies per
    function (deterministic: fed in result order by the controller) and
    reports an empirical p95. A bounded reservoir keeps each tick
    O(maxlen log maxlen) even under very high completion rates.
    """

    def __init__(self, maxlen: int = 256):
        self.maxlen = maxlen
        self._lat: dict = {}       # fn -> deque[float]

    def observe(self, fn: str, latency: float) -> None:
        d = self._lat.get(fn)
        if d is None:
            d = self._lat[fn] = deque(maxlen=self.maxlen)
        d.append(latency)

    def p95(self, fn: str) -> float:
        d = self._lat.get(fn)
        if not d:
            return 0.0
        xs = sorted(d)
        # nearest-rank p95 (no interpolation: byte-stable across runs).
        # ceil(0.95n) is the nearest-rank definition; the old
        # int(0.95n) index over-shot by one rank — for n ≤ 20 it
        # returned the window *max*, overstating small-sample tails.
        import math
        return xs[math.ceil(0.95 * len(xs)) - 1]
