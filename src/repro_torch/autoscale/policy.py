"""Pluggable autoscaler policies (registry mirrors the LB-policy registry).

The port's own copy of the JAX package's ``autoscale/policy.py``, which holds no
JAX: the port imports nothing of that package.

A policy maps the observed :class:`~repro_torch.autoscale.metrics.MetricsWindow`
to a desired replica count (replica = one LB branch of
``workers_per_replica`` workers). Policies are pure functions of the
window plus their own explicitly-seeded state, so two same-seed simulator
runs produce byte-identical decision streams.

The menu spans the design space the FaaS literature actually compares:

- ``static``             no-op; the paper's provision-for-X replicate recipe
- ``reactive``           queue/utilization threshold scaler (AWS-style)
- ``target_concurrency`` Knative KPA: stable window + panic window
- ``predictive``         Holt linear-trend (EWMA level+trend) rate forecast,
                         built for ``daily_cycle`` envelopes
- ``slo_aware``          per-function p95-vs-SLO pressure scaler; also emits
                         per-function prewarm/reap directives

Besides the fleet size, a policy may steer *per-function* capacity:
:meth:`AutoscalePolicy.fn_actions` returns ``{fn: delta}`` prewarm (+n) /
reap (-n) directives the controller applies through ``sim.prewarm`` /
``sim.reap`` — scaling signals at the granularity FaaS platforms actually
bill at.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping

from repro_torch.autoscale.metrics import MetricsWindow

AUTOSCALERS: Dict[str, Callable[..., "AutoscalePolicy"]] = {}


def register_autoscaler(cls):
    """Class decorator: add an AutoscalePolicy subclass to the registry."""
    AUTOSCALERS[cls.name] = cls
    return cls


def get_autoscaler(name: str, **params) -> "AutoscalePolicy":
    """Construct a registered policy by name: the config/CLI hook."""
    if name not in AUTOSCALERS:
        raise KeyError(f"autoscaler policy {name!r} not registered "
                       f"(have: {sorted(AUTOSCALERS)})")
    return AUTOSCALERS[name](**params)


def list_autoscalers() -> List[str]:
    return sorted(AUTOSCALERS)


class AutoscalePolicy:
    """Base interface: desired replica count given the metrics window."""

    name = "base"

    def desired_replicas(self, window: MetricsWindow, current: int) -> int:
        raise NotImplementedError

    def fn_actions(self, window: MetricsWindow) -> Dict[str, int]:
        """Per-function capacity directives: ``{fn: +n}`` prewarm n
        replicas, ``{fn: -n}`` reap n idle replicas. Default: none."""
        return {}


@register_autoscaler
@dataclass
class StaticPolicy(AutoscalePolicy):
    """No-op baseline: whatever the tree was built with, it keeps.

    This is the paper's scaling story so far — ``replicate(tree, k)`` at
    deploy time — expressed as a policy so the benchmark cost/latency
    accounting is identical across the whole menu.
    """

    name = "static"

    def desired_replicas(self, window, current):
        return current


@register_autoscaler
@dataclass
class ReactivePolicy(AutoscalePolicy):
    """Threshold scaler on outstanding work per worker.

    Scale up proportionally (straight to the load-implied size, not +1
    steps — flash crowds don't wait) when the *latest* sample exceeds
    ``upper``; scale down toward the load-implied size only when the
    *window average* falls below ``lower``, so one calm tick inside a
    burst never sheds capacity.
    """

    target_load: float = 4.0     # design point: outstanding reqs per worker
    upper: float = 6.0           # latest-sample load that triggers scale-up
    lower: float = 1.0           # window-average load that allows scale-down
    name = "reactive"

    def desired_replicas(self, window, current):
        last = window.last()
        if last is None:
            return current
        if last.load_per_worker > self.upper:
            return math.ceil(current * last.load_per_worker / self.target_load)
        if window.avg("load_per_worker") < self.lower:
            down = math.ceil(
                current * window.avg("load_per_worker") / self.target_load)
            return min(current, max(1, down))
        return current


@register_autoscaler
@dataclass
class TargetConcurrencyPolicy(AutoscalePolicy):
    """Knative-KPA-style scaler: size the fleet so observed concurrency
    per worker sits at ``target``; a short panic window overrides the
    stable window when concurrency doubles, and freezes scale-down while
    panicking."""

    target: float = 4.0          # concurrent requests per worker at SLO
    panic_window: int = 2        # samples in the panic (burst) window
    panic_threshold: float = 2.0  # panic when panic-desired >= thr * current
    panic_hold_ticks: int = 8    # ticks scale-down stays frozen after panic
    _panic_left: int = field(default=0, repr=False)
    name = "target_concurrency"

    def _size(self, concurrency: float, workers_per_replica: float) -> int:
        return math.ceil(concurrency / (self.target * workers_per_replica))

    def desired_replicas(self, window, current):
        last = window.last()
        if last is None:
            return current
        wpr = last.workers / max(last.replicas, 1)
        stable = self._size(window.avg("concurrency"), wpr)
        panic = self._size(window.avg("concurrency", self.panic_window), wpr)
        if panic >= self.panic_threshold * current:
            self._panic_left = self.panic_hold_ticks
            return max(current, panic)
        if self._panic_left > 0:
            self._panic_left -= 1
            return max(current, stable)     # panicking: never scale down
        return max(1, stable)


@register_autoscaler
@dataclass
class PredictivePolicy(AutoscalePolicy):
    """Holt linear-trend forecast of the arrival rate (EWMA on level and
    trend), sized against a per-worker service rate. Scales *ahead* of a
    ``daily_cycle`` ramp instead of chasing it; falls back to reactive
    sizing whenever observed load already exceeds the forecast."""

    rate_per_worker: float = 120.0   # sustainable requests/s per worker
    alpha: float = 0.5               # level smoothing
    beta: float = 0.3                # trend smoothing
    lead_ticks: float = 4.0          # forecast horizon, in ticks
    interval_s: float = 1.0          # set by the controller on attach
    _level: float = field(default=-1.0, repr=False)
    _trend: float = field(default=0.0, repr=False)
    name = "predictive"

    def desired_replicas(self, window, current):
        last = window.last()
        if last is None:
            return current
        rate = last.arrivals / max(self.interval_s, 1e-9)
        if self._level < 0.0:                       # first observation
            self._level = rate
        prev = self._level
        self._level = self.alpha * rate + (1 - self.alpha) * (prev + self._trend)
        self._trend = (self.beta * (self._level - prev)
                       + (1 - self.beta) * self._trend)
        forecast = max(0.0, self._level + self._trend * self.lead_ticks)
        wpr = last.workers / max(last.replicas, 1)
        need = math.ceil(forecast / (self.rate_per_worker * wpr))
        # never size below what the backlog already demands right now
        backlog = math.ceil(last.concurrency / (4.0 * wpr))
        return max(1, need, backlog)


@register_autoscaler
@dataclass
class SloAwarePolicy(AutoscalePolicy):
    """Scale on per-function p95 latency pressure against per-function
    SLO targets — not on raw load.

    Pressure for a function is ``max(observed p95, projected wait) /
    (headroom * slo)``: the observed side is the windowed per-function
    p95 estimate; the projected side is a Little's-law backlog read
    (outstanding work over the completion rate) so a burst registers
    before its inflated latencies ever complete. The fleet is sized
    multiplicatively on the worst function's pressure, and cools down to
    the load-implied size only when *every* function sits comfortably
    inside its SLO. Per-function prewarm/reap directives ride on the same
    signal, so hot functions gain warm replicas ahead of the queue and
    cold ones stop pinning capacity slots.
    """

    slo_p95_s: Mapping[str, float] = field(default_factory=dict)
    default_slo_s: float = 1.0       # target for fns without an explicit SLO
    headroom: float = 0.7            # aim p95 at headroom * SLO
    max_step: float = 3.0            # cap on one tick's multiplicative growth
    down_pressure: float = 0.35      # window-avg pressure allowing scale-down
    prewarm_pressure: float = 1.0    # fn pressure that triggers a prewarm
    reap_pressure: float = 0.15      # fn pressure under which idle warm reaps
    interval_s: float = 1.0          # set by the controller on attach
    name = "slo_aware"

    def _slo(self, fn: str) -> float:
        return self.slo_p95_s.get(fn, self.default_slo_s)

    def _fn_pressure(self, window: MetricsWindow, f) -> float:
        """p95-vs-SLO pressure for one FnSample, backlog-projected."""
        # Little's law projection: outstanding work drains at the observed
        # completion rate; a burst shows up here ticks before its inflated
        # latencies complete and move the measured p95
        rate = window.fn_avg(f.fn, "completions") / max(self.interval_s, 1e-9)
        projected = f.concurrency / rate if rate > 0 else (
            float("inf") if f.concurrency > 0 else 0.0)
        est = max(f.p95_est, min(projected, 1e6))
        return est / max(self.headroom * self._slo(f.fn), 1e-9)

    def _pressures(self, window: MetricsWindow) -> Dict[str, float]:
        last = window.last()
        if last is None:
            return {}
        return {f.fn: self._fn_pressure(window, f) for f in last.fns}

    def desired_replicas(self, window, current):
        pressures = self._pressures(window)
        if not pressures:
            return current
        worst = max(pressures.values())
        if worst > 1.0:
            return math.ceil(current * min(worst, self.max_step))
        if worst < self.down_pressure:
            last = window.last()
            wpr = last.workers / max(last.replicas, 1)
            implied = math.ceil(last.concurrency / max(4.0 * wpr, 1e-9))
            return min(current, max(1, implied))
        return current

    def fn_actions(self, window):
        acts: Dict[str, int] = {}
        for fn, pressure in sorted(self._pressures(window).items()):
            f = window.fn_last(fn)
            if f is None:
                continue
            # prewarm only under *live* demand: the latency reservoir
            # remembers a hot past, and a prewarm with nothing arriving
            # would keep the control loop awake forever (each prewarm
            # schedules a future idle_check event)
            if (pressure > self.prewarm_pressure
                    and (f.concurrency > 0 or f.arrivals > 0)):
                acts[fn] = 1                       # warm capacity ahead of queue
            elif (pressure < self.reap_pressure
                    and f.warm > f.inflight and f.warm > 1):
                acts[fn] = -1                      # stop pinning idle slots
        return acts
