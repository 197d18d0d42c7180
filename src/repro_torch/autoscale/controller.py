"""The autoscaler control loop: observe -> decide -> act, once per tick.

The port's own copy of the JAX package's ``autoscale/controller.py``, which holds no
JAX: the port imports nothing of that package.

The :class:`Autoscaler` binds to a :class:`~repro_torch.core.simulator.Simulator`
(``sim.attach_autoscaler``) which then fires a periodic ``autoscale_tick``
event. Each tick the controller:

1. snapshots live workers into the sliding :class:`MetricsWindow`
   (queue depth, inflight, arrival/cold-start deltas),
2. asks its policy for a desired replica count,
3. clamps to ``[min_replicas, max_replicas]``, applies scale-down
   cooldown, and acts through ``sim.add_branch`` / ``sim.remove_branch``
   (which drains safely), prewarming instances on scaled-up workers,
4. appends a :class:`ScalingDecision` to the decision log.

Everything is a deterministic function of simulator state, so the same
seed yields a byte-identical ``decision_log()`` — the regression contract
``tests/test_autoscale.py`` pins.

A replica is one LB branch of ``workers_per_replica`` workers directly
under the tree root — the same unit as the paper's ``replicate()`` recipe,
applied live. The controller only ever removes branches it added itself,
so a pre-built static pool is never scaled below its deploy size.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.autoscale.metrics import (FnSample, LatencyEstimator,
                                           MetricsSample, MetricsWindow)
from repro_torch.autoscale.policy import AutoscalePolicy, get_autoscaler
from repro_torch.core.router import LBNode, build_leaf


def build_pool(branches: int, workers_per_branch: int, *,
               leaf_policy: str = "least_loaded",
               inner_policy: str = "random",
               prefix: str = "pool") -> LBNode:
    """Root LB over ``branches`` identical leaf branches — the autoscaler's
    (and the replicate recipe's) unit of scale, built explicitly."""
    leaves = [build_leaf(f"{prefix}-b{i}",
                         [f"{prefix}-b{i}-w{j}"
                          for j in range(workers_per_branch)],
                         leaf_policy)
              for i in range(branches)]
    return LBNode(f"{prefix}-root", inner_policy, children=leaves)


@dataclass(frozen=True)
class ScalingDecision:
    """One control-loop outcome; ``fmt()`` is the byte-stable log line and
    ``to_record()`` the structured (JSON-able) form the replay tool
    re-applies."""

    t: float
    policy: str
    replicas_before: int
    desired: int                # raw policy output, pre-clamp
    applied: int                # replicas after this tick
    action: str     # hold | up | down | cooldown | bound | floor | outage_hold
    queue: int
    inflight: int
    workers: int
    arrival_rate: float
    # per-function prewarm(+)/reap(-) directives the policy emitted this
    # tick, sorted by fn — the control plane below branch granularity
    fn_deltas: Tuple[Tuple[str, int], ...] = ()

    def fmt(self) -> str:
        acts = ",".join(f"{fn}:{n:+d}" for fn, n in self.fn_deltas) or "-"
        return (f"t={self.t:.3f} policy={self.policy} "
                f"replicas={self.replicas_before}->{self.applied} "
                f"desired={self.desired} action={self.action} "
                f"queue={self.queue} inflight={self.inflight} "
                f"workers={self.workers} arr_rate={self.arrival_rate:.3f} "
                f"fn_actions={acts}")

    def to_record(self) -> dict:
        """Structured form (plain JSON types) for logs and replay."""
        rec = asdict(self)
        rec["fn_deltas"] = [list(d) for d in self.fn_deltas]
        return rec

    @classmethod
    def from_record(cls, rec: dict) -> "ScalingDecision":
        rec = dict(rec)
        rec["fn_deltas"] = tuple((fn, int(n)) for fn, n in rec["fn_deltas"])
        return cls(**rec)


class Autoscaler:
    def __init__(self, policy, *, interval_s: float = 0.5,
                 window_s: float = 4.0, min_replicas: int = 1,
                 max_replicas: int = 8, workers_per_replica: int = 2,
                 cooldown_s: float = 5.0, leaf_policy: str = "least_loaded",
                 prewarm_fns: Optional[Sequence[str]] = ("auto",)):
        """``policy`` is an :class:`AutoscalePolicy` or a registry name.
        ``prewarm_fns``: function names to pre-start one instance of on
        every scaled-up worker; ``("auto",)`` prewarms every registered
        function, ``None`` disables prewarming."""
        self.policy: AutoscalePolicy = (get_autoscaler(policy)
                                        if isinstance(policy, str) else policy)
        self.interval_s = interval_s
        self.window = MetricsWindow(max(1, round(window_s / interval_s)))
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.workers_per_replica = workers_per_replica
        self.cooldown_s = cooldown_s
        self.leaf_policy = leaf_policy
        self.prewarm_fns = prewarm_fns
        self.decisions: List[ScalingDecision] = []
        self.worker_seconds = 0.0       # cost proxy: live workers x time
        self.replica_seconds = 0.0
        self._scaled: List[str] = []    # LIFO of branches this loop added
        self._branch_seq = 0
        self._last_scale_t = -1e30
        self._last_tick_t: Optional[float] = None
        self._last_arrivals = 0
        self._last_results = 0
        self._last_cold = 0
        self._last_fn_arrivals: Dict[str, int] = {}
        self._last_fn_admitted: Dict[str, int] = {}
        self._last_fn_shed: Dict[str, int] = {}
        self._lat_est = LatencyEstimator()
        # rate-based policies need the tick period to convert deltas
        if hasattr(self.policy, "interval_s"):
            self.policy.interval_s = interval_s

    # --------------------------------------------------------- observation
    def _fn_samples(self, sim, workers) -> Tuple[FnSample, ...]:
        """Aggregate the per-function layer of every live worker and feed
        the latency estimator from the results delta — O(workers x fns +
        new results) per tick."""
        new_completions: Dict[str, int] = {}
        new_ok: Dict[str, int] = {}
        for r in sim.results[self._last_results:]:
            new_completions[r.fn] = new_completions.get(r.fn, 0) + 1
            if r.ok:
                new_ok[r.fn] = new_ok.get(r.fn, 0) + 1
                self._lat_est.observe(r.fn, r.latency)
        gw = getattr(sim, "gateway", None)
        rows = []
        for fn in sorted(sim.arrivals_by_fn):
            queue = inflight = warm = 0
            for w in workers:
                queue += w.queue.depth(fn)
                rs = w.replica_sets.get(fn)
                if rs is not None:
                    inflight += rs.inflight()
                    warm += len(rs)
            arr = sim.arrivals_by_fn[fn]
            shed = 0
            if gw is not None:
                # post-gateway demand: rate policies should track what
                # the front door admitted, not the offered flood it shed
                adm = gw.admitted_by_fn.get(fn, 0)
                arr = adm - self._last_fn_admitted.get(fn, 0)
                self._last_fn_admitted[fn] = adm
                sh = gw.shed_by_fn.get(fn, 0)
                shed = sh - self._last_fn_shed.get(fn, 0)
                self._last_fn_shed[fn] = sh
            else:
                arr = arr - self._last_fn_arrivals.get(fn, 0)
                self._last_fn_arrivals[fn] = sim.arrivals_by_fn[fn]
            rows.append(FnSample(
                fn=fn, queue=queue, inflight=inflight,
                arrivals=arr,
                completions=new_completions.get(fn, 0), warm=warm,
                p95_est=self._lat_est.p95(fn), shed=shed,
                goodput=new_ok.get(fn, 0)))
        return tuple(rows)

    def _snapshot(self, sim) -> MetricsSample:
        workers = [sim.workers[w] for w in sim._worker_list
                   if w in sim.workers]
        # partition-aware observation: a crashed/partitioned worker is
        # not capacity — counting it dilutes load_per_worker exactly
        # when pressure on the survivors is spiking
        healthy = sum(1 for w in workers if w.healthy)
        cold = sim.cold_starts_total
        sample = MetricsSample(
            t=sim.now,
            replicas=len(sim.tree.children),
            workers=healthy,
            unhealthy=len(workers) - healthy,
            queue=sum(len(w.queue) for w in workers),
            inflight=sum(w.inflight() for w in workers),
            arrivals=sim.arrivals_seen - self._last_arrivals,
            completions=len(sim.results) - self._last_results,
            cold_starts=cold - self._last_cold,
            fns=self._fn_samples(sim, workers))
        self._last_arrivals = sim.arrivals_seen
        self._last_results = len(sim.results)
        self._last_cold = cold
        return sample

    # --------------------------------------------------------------- tick
    def on_tick(self, sim) -> ScalingDecision:
        if self._last_tick_t is not None:
            dt = sim.now - self._last_tick_t
            self.worker_seconds += len(sim._worker_list) * dt
            self.replica_seconds += len(sim.tree.children) * dt
        self._last_tick_t = sim.now

        sample = self._snapshot(sim)
        self.window.push(sample)
        current = sample.replicas
        desired = self.policy.desired_replicas(self.window, current)
        target = max(self.min_replicas, min(self.max_replicas, desired))

        action = "hold"
        if target > current:
            action = "up"
            for _ in range(target - current):
                self._grow(sim)
        elif target < current:
            if sample.unhealthy > 0:
                # partition-aware tick: with part of the fleet dark the
                # window's completion/queue metrics are stale (stalled
                # work on dead workers reads as vanished load) — never
                # scale down on them; scale-up above stays allowed
                action, target = "outage_hold", current
            elif sim.now - self._last_scale_t < self.cooldown_s:
                action, target = "cooldown", current
            elif not self._scaled:
                action, target = "floor", current   # only shrink own branches
            else:
                action = "down"
                shrink = min(current - target, len(self._scaled))
                for _ in range(shrink):
                    sim.remove_branch(self._scaled.pop())
                target = current - shrink
        elif desired != target:
            action = "bound"
        if action in ("up", "down"):
            self._last_scale_t = sim.now

        # per-function prewarm/reap directives act below branch
        # granularity — the control plane FaaS platforms actually bill at.
        # Prewarms are refused for functions with no outstanding work and
        # no arrivals this tick: each prewarm schedules a future
        # idle_check, so an unconditional one would re-arm the tick chain
        # forever on a drained system (run() would never terminate).
        def _admissible(fn, delta):
            f = sample.fn(fn)
            return delta < 0 or (f is not None
                                 and (f.concurrency > 0 or f.arrivals > 0))
        fn_deltas = tuple(sorted(
            (fn, n) for fn, n in self.policy.fn_actions(self.window).items()
            if _admissible(fn, n)))
        self._apply_fn_actions(sim, fn_deltas)

        decision = ScalingDecision(
            t=sim.now, policy=self.policy.name, replicas_before=current,
            desired=desired, applied=len(sim.tree.children), action=action,
            queue=sample.queue, inflight=sample.inflight,
            workers=sample.workers,
            arrival_rate=sample.arrivals / self.interval_s,
            fn_deltas=fn_deltas)
        self.decisions.append(decision)
        return decision

    def _apply_fn_actions(self, sim, fn_deltas) -> None:
        """Prewarm (+n) and reap (-n) through the simulator's placement
        layer (``place_prewarm``/``place_reap``): the placer bin-packs
        replica starts by memory and picks the reap victim over a
        deterministic coldest/warmest-first candidate order, re-ranked
        after every placed unit (so a multi-unit delta re-packs against
        the updated footprints; for the ±1 deltas every built-in policy
        emits this is exactly the pre-placement order)."""
        for fn, delta in fn_deltas:
            for _ in range(abs(delta)):
                placed = (sim.place_prewarm(fn) if delta > 0
                          else sim.place_reap(fn))
                if placed is None:
                    break

    def _grow(self, sim) -> None:
        bid = self._branch_seq
        self._branch_seq += 1
        name = f"as-b{bid}"
        leaf = build_leaf(name, [f"{name}-w{j}"
                                 for j in range(self.workers_per_replica)],
                          self.leaf_policy)
        sim.add_branch(leaf)
        self._scaled.append(name)
        if self.prewarm_fns is None:
            return
        fns = (sim.store.list() if "auto" in self.prewarm_fns
               else self.prewarm_fns)
        for w in leaf.workers:
            for fn in fns:
                sim.prewarm(w, fn)

    # ------------------------------------------------------------ reporting
    def decision_log(self) -> str:
        """Byte-stable scaling-decision log (same seed => identical)."""
        return "\n".join(d.fmt() for d in self.decisions)

    def decision_records(self) -> List[dict]:
        """Structured decision log — feed to ``repro_torch.autoscale.replay``."""
        return [d.to_record() for d in self.decisions]

    def summary(self) -> dict:
        ups = sum(d.action == "up" for d in self.decisions)
        downs = sum(d.action == "down" for d in self.decisions)
        return {"policy": self.policy.name, "ticks": len(self.decisions),
                "scale_ups": ups, "scale_downs": downs,
                "worker_seconds": self.worker_seconds,
                "replica_seconds": self.replica_seconds,
                "max_replicas_seen": max(
                    (d.applied for d in self.decisions), default=0)}
