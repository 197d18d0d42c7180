"""Seeded fault injection: the testbed's chaos layer.

The port's own copy of the JAX package's ``core/faults.py``, which holds no
JAX: the port imports nothing of that package.

At millions of users something is always failing, and both SeBS (Copik
et al.) and the FaaS Benchmarking Framework treat reliability behavior
as a benchmark dimension next to performance — yet a simulator-grown
fleet is perfect unless failure is a first-class scenario input. This
module makes it one: a :class:`FaultInjector` drives four fault kinds
through the ordinary event engine (kind ``"fault"``), so every injected
failure interleaves deterministically with arrivals, finishes, and
control-loop ticks:

- **worker crash/restart** — per-worker exponential MTTF/MTTR chains
  (crash → restore → next crash), reusing the simulator's
  ``_on_fail`` / ``_on_recover`` semantics (queued work fails, in-flight
  completions die with the worker, the routing view sees it).
- **zone-correlated outages** — whole failure domains (the ``zone``
  attribute workers gain from ``Simulator(zones=...)``) go down and
  recover together, either on a Poisson schedule (``zone_outage_rate``)
  or at scripted instants (``scheduled``) for reproducible experiments.
- **latency stragglers** — transient multiplicative slowdowns layered
  on the existing per-worker ``slowdown`` factor, restored to the prior
  value when the episode ends (so stacked/configured stragglers keep
  their base factor).
- **lost completions** — with probability ``lost_finish_p`` a service's
  ``finish`` event is dropped; the slot stays busy (a zombie execution)
  until the function's ``timeout_s``, at which point the slot is freed
  and the request fails with ``error="lost completion"`` — the shape
  that retry budgets exist for.

Determinism contract: the injector draws from its *own* seeded RNG (the
simulator's routing/service streams are untouched), all of its events
flow through the engine's ``(t, seq)`` total order, and ``fault_log()``
is a plain event-ordered line list — same seed ⇒ byte-identical fault
log, results, and decision logs. With every knob off (the default
``FaultConfig()``), attaching an injector schedules nothing and draws
nothing: runs are byte-identical to a fault-free simulator (pinned by
``tests/test_faults.py`` against the golden digests recorded before
the chaos layer existed).

``"fault"`` is a *background* event kind (like ``autoscale_tick``):
pending faults never hold the run loop open, and the injector only
re-arms its stochastic processes while real work remains, so ``run()``
still terminates.

Overlap caveat: fault kinds compose freely but naively — a worker
restore scheduled before its zone's outage ends will heal it early.
Scenario authors who need strict containment should use one kind per
experiment (the built-in ``zone_outage`` / ``retry_storm`` scenarios
do).
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class FaultConfig:
    """Declarative fault plan for one run. Everything defaults to *off*:
    a default-constructed config is the wired-but-disabled state the
    byte-identity gate pins."""

    seed: int = 0
    # worker crash/restart: exponential mean time to failure / repair,
    # one independent chain per worker. None disables crashes.
    worker_mttf_s: Optional[float] = None
    worker_mttr_s: float = 2.0
    # zone-correlated outages: Poisson rate (outages/s across the fleet)
    # and exponential outage duration. 0.0 disables random outages.
    zone_outage_rate: float = 0.0
    zone_mttr_s: float = 5.0
    # scripted outages: (at_s, zone, duration_s) triples, injected
    # exactly — the reproducible-experiment form the zone_outage
    # scenario uses.
    scheduled: Tuple[Tuple[float, str, float], ...] = ()
    # transient stragglers: Poisson episode rate, multiplicative factor,
    # fixed episode duration. 0.0 disables.
    straggler_rate: float = 0.0
    straggler_factor: float = 8.0
    straggler_duration_s: float = 2.0
    # per-service-completion drop probability (lost finish events)
    lost_finish_p: float = 0.0
    # injection window: no stochastic fault is *initiated* before
    # start_s or after horizon_s (recoveries still complete)
    start_s: float = 0.0
    horizon_s: Optional[float] = None

    @property
    def enabled(self) -> bool:
        return bool(self.worker_mttf_s is not None
                    or self.zone_outage_rate > 0.0
                    or self.straggler_rate > 0.0
                    or self.lost_finish_p > 0.0
                    or self.scheduled)


@dataclass
class FaultStats:
    """Run-wide injection counters (`FaultInjector.stats`)."""

    crashes: int = 0
    restores: int = 0
    zone_outages: int = 0
    zone_recoveries: int = 0
    stragglers: int = 0
    lost_completions: int = 0

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class FaultInjector:
    """Schedules seeded faults through a simulator's event engine.

    Operates on the same duck-typed simulator surface as the worker
    runtime and control plane: ``now``, ``workers``, ``zone_workers``,
    ``engine.pending_real``, ``_push``, ``_on_fail`` / ``_on_recover``
    (the one crash/heal code path, so the failure semantics the
    bugfix suite pins apply to every injected fault), ``_record_fail``,
    and the runtime's slot accounting for lost completions.
    """

    def __init__(self, sim, config: Optional[FaultConfig] = None):
        self.sim = sim
        self.cfg = config or FaultConfig()
        # independent stream: fault draws never perturb routing/service
        # RNG, which is what keeps faults-off runs byte-identical
        self.rng = random.Random(f"faults-{self.cfg.seed}")
        self.records: List[str] = []
        self.stats = FaultStats()
        self._straggle_prior: dict = {}     # worker -> pre-episode slowdown

    # -------------------------------------------------------------- logging
    def _log(self, line: str) -> None:
        self.records.append(f"t={self.sim.now:.6f} {line}")

    def fault_log(self) -> str:
        """Byte-stable fault log: one line per injected event, in event
        order (same seed ⇒ identical)."""
        return "\n".join(self.records)

    # ------------------------------------------------------------ lifecycle
    def arm(self) -> None:
        """Schedule the first event of every enabled fault process.
        A disabled config arms nothing and draws nothing."""
        cfg = self.cfg
        if not cfg.enabled:
            return
        push = self.sim._push
        for at, zone, duration in cfg.scheduled:
            push(at, "fault", ("zone_down", (zone, duration)))
        if cfg.worker_mttf_s is not None:
            for w in sorted(self.sim.workers):
                push(cfg.start_s + self.rng.expovariate(1.0 / cfg.worker_mttf_s),
                     "fault", ("crash", w))
        if cfg.zone_outage_rate > 0.0:
            push(cfg.start_s + self.rng.expovariate(cfg.zone_outage_rate),
                 "fault", ("zone_outage", None))
        if cfg.straggler_rate > 0.0:
            push(cfg.start_s + self.rng.expovariate(cfg.straggler_rate),
                 "fault", ("straggle", None))

    def _within_horizon(self, t: float) -> bool:
        return self.cfg.horizon_s is None or t <= self.cfg.horizon_s

    def _rearm(self, t: float, payload) -> None:
        """Re-arm a stochastic process — only while real work remains
        (faults are background events: they must never keep ``run()``
        alive on their own) and inside the injection window."""
        if self.sim.engine.pending_real > 0 and self._within_horizon(t):
            self.sim._push(t, "fault", payload)

    # --------------------------------------------------------------- events
    def on_event(self, payload) -> None:
        kind, arg = payload
        getattr(self, "_ev_" + kind)(arg)

    def _ev_crash(self, worker: str) -> None:
        sim = self.sim
        if worker not in sim.workers:
            return                       # scaled away: chain ends
        self.stats.crashes += 1
        self._log(f"crash worker={worker}")
        sim._on_fail(worker)
        sim._push(sim.now + self.rng.expovariate(1.0 / self.cfg.worker_mttr_s),
                  "fault", ("restore", worker))

    def _ev_restore(self, worker: str) -> None:
        sim = self.sim
        if worker not in sim.workers:
            return
        self.stats.restores += 1
        self._log(f"restore worker={worker}")
        sim._on_recover(worker)
        self._rearm(sim.now + self.rng.expovariate(1.0 / self.cfg.worker_mttf_s),
                    ("crash", worker))

    def _ev_zone_outage(self, _arg) -> None:
        """Random zone outage: pick a zone, take it down for an
        exponential duration, re-arm the next outage."""
        sim = self.sim
        zones = sorted(sim.zone_workers)
        if zones:
            zone = self.rng.choice(zones)
            duration = self.rng.expovariate(1.0 / self.cfg.zone_mttr_s)
            self._ev_zone_down((zone, duration))
        self._rearm(sim.now + self.rng.expovariate(self.cfg.zone_outage_rate),
                    ("zone_outage", None))

    def _ev_zone_down(self, arg) -> None:
        zone, duration = arg
        sim = self.sim
        members = [w for w in sim.zone_workers.get(zone, ())
                   if w in sim.workers]
        self.stats.zone_outages += 1
        self._log(f"zone_down zone={zone} workers={len(members)} "
                  f"duration={duration:.3f}")
        for w in members:
            sim._on_fail(w)
        sim._push(sim.now + duration, "fault", ("zone_up", zone))

    def _ev_zone_up(self, zone: str) -> None:
        sim = self.sim
        self.stats.zone_recoveries += 1
        self._log(f"zone_up zone={zone}")
        for w in sim.zone_workers.get(zone, ()):
            if w in sim.workers:
                sim._on_recover(w)

    def _ev_straggle(self, _arg) -> None:
        sim = self.sim
        cfg = self.cfg
        names = sorted(sim.workers)
        # a worker already mid-episode is skipped (the draw still
        # happens, keeping the stream aligned): overlapping episodes
        # would collide in _straggle_prior and strand the factor forever
        if names:
            worker = self.rng.choice(names)
            w = sim.workers[worker]
            if worker not in self._straggle_prior:
                # layer on the existing per-worker slowdown; restore to
                # the *prior* value so configured base stragglers survive
                self._straggle_prior[worker] = w.slowdown
                w.slowdown *= cfg.straggler_factor
                self.stats.stragglers += 1
                self._log(f"straggle worker={worker} "
                          f"factor={cfg.straggler_factor}"
                          f" slowdown={w.slowdown:.2f}")
                sim._push(sim.now + cfg.straggler_duration_s, "fault",
                          ("unstraggle", worker))
        self._rearm(sim.now + self.rng.expovariate(cfg.straggler_rate),
                    ("straggle", None))

    def _ev_unstraggle(self, worker: str) -> None:
        sim = self.sim
        prior = self._straggle_prior.pop(worker, None)
        w = sim.workers.get(worker)
        if w is not None and prior is not None:
            w.slowdown = prior
            self._log(f"unstraggle worker={worker} slowdown={prior:.2f}")

    # ----------------------------------------------------- lost completions
    def drop_finish(self, req, w) -> bool:
        """Called by the worker runtime at service start: True ⇒ this
        service's ``finish`` event is lost. Draws RNG only when the
        fault is enabled, so other fault processes' streams don't shift
        with service volume."""
        p = self.cfg.lost_finish_p
        return p > 0.0 and self.rng.random() < p

    def lose_completion(self, w, inst, req, fn_cfg) -> None:
        """Schedule the delayed fallout of a dropped finish: the slot
        stays busy (zombie execution) until the function's timeout, then
        frees and the request fails as ``lost completion``."""
        sim = self.sim
        self._log(f"lost fn={req.fn} rid={req.rid} worker={w.name} "
                  f"inst={inst.iid}")
        self.stats.lost_completions += 1
        sim._push(sim.now + fn_cfg.timeout_s, "fault",
                  ("lost", (req, w.name, inst.iid)))

    def _ev_lost(self, arg) -> None:
        """The zombie execution hits its timeout: free the slot (the
        platform kills the instance's request) and fail the request —
        which the retry layer may then resurrect."""
        req, wname, iid = arg
        sim = self.sim
        w = sim.workers.get(wname) or sim._draining.get(wname)
        inst = w.iid_index.get(iid) if w is not None else None
        if inst is not None:
            w.note_busy(inst, -1)
            inst.last_used = sim.now
            sim._push(sim.now + sim.store.get(req.fn).idle_timeout_s,
                      "idle_check", (wname, iid))
            if wname in sim.workers:
                sim._dispatch(w)         # the freed slot may serve backlog
        sim._record_fail(req, "lost completion")

    # ------------------------------------------------------------ reporting
    def summary(self) -> dict:
        return self.stats.as_dict()
