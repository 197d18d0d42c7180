"""The control plane: scaling, placement, and decision logging, as a layer.

The port's own copy of the JAX package's ``autoscale/control.py``, which holds no
JAX: the port imports nothing of that package.

The paper's testbed swaps *platform architectures*; the control plane is
the piece a FaaS platform actually differentiates on (scaling policy,
replica placement, prewarming). This facade gathers every control-side
hook that used to live inline in the simulator — autoscaler binding and
tick handling, per-function prewarm/reap, placer-ranked placement, and
the byte-stable placement/routing decision logs — behind one object, so
the simulator proper only *wires* workload → router → workers → control
plane and a different control plane can be dropped in without touching
the data path.

The facade operates on the same duck-typed simulator surface the worker
runtime uses (``repro.core.worker``): ``workers``, ``_worker_list``,
``store``, ``now``, ``_push``, the ``runtime`` (poke/dispatch), and the
``engine`` (pending-event accounting for tick re-arming). The simulator
keeps thin delegate methods (``sim.prewarm`` etc.) for API
compatibility — they are one-line calls into this class.

Determinism: decision logs are plain event-ordered line lists; same
seed ⇒ byte-identical logs (pinned in ``tests/test_placement.py`` and
``tests/test_autoscale.py``).
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.core.placement import Placer, get_placer


class ControlPlane:
    """Autoscaler + placement hooks + decision logs for one simulator."""

    def __init__(self, sim, *, placer="first_fit",
                 record_decisions: bool = False):
        self.sim = sim
        self.placer: Placer = (get_placer(placer) if isinstance(placer, str)
                               else placer)
        # single source of truth for decision recording: the simulator's
        # hot paths read sim._record directly, so write it there and
        # keep no mirror here that could drift
        sim._record = record_decisions
        self.autoscaler = None
        self.placement_records: List[str] = []   # start/reap/idle events
        self.routing_records: List[str] = []     # arrival/reroute choices
        self.gateway_records: List[str] = []     # front-door verdicts
        # the exact ``sim.now`` of each line above (the lines print it to
        # the microsecond): the partitioned runner merges on these
        self.placement_times: List[float] = []
        self.routing_times: List[float] = []
        self.gateway_times: List[float] = []

    # ------------------------------------------------------- decision logs
    def log_placement(self, kind: str, w, fn: str) -> None:
        cap = "inf" if w.memory_mb is None else f"{w.memory_mb:.0f}"
        self.placement_times.append(self.sim.now)
        self.placement_records.append(
            f"t={self.sim.now:.6f} {kind} fn={fn} worker={w.name} "
            f"mem={w.memory_used_mb:.0f}/{cap} inst={w.total_instances}")

    def log_routing(self, kind: str, req, wid: str) -> None:
        self.routing_times.append(self.sim.now)
        self.routing_records.append(
            f"t={self.sim.now:.6f} {kind} rid={req.rid} fn={req.fn} "
            f"worker={wid}")

    def placement_log(self) -> str:
        """Byte-stable placement decision log (``record_decisions=True``):
        one line per replica start/reap/idle-stop, in event order."""
        return "\n".join(self.placement_records)

    def log_gateway(self, kind: str, req, verdict) -> None:
        self.gateway_times.append(self.sim.now)
        self.gateway_records.append(
            f"t={self.sim.now:.6f} {kind} rid={req.rid} fn={req.fn} "
            f"verdict={verdict or 'admit'}")

    def routing_log(self) -> str:
        """Byte-stable routing decision log (``record_decisions=True``):
        one line per arrival/reroute with the worker the tree chose."""
        return "\n".join(self.routing_records)

    def gateway_log(self) -> str:
        """Byte-stable front-door decision log (``record_decisions=True``):
        one line per gateway consult (arrival or retry) with the
        verdict — ``admit`` or the terminal shed error."""
        return "\n".join(self.gateway_records)

    # -------------------------------------------------- per-fn scale units
    def prewarm(self, worker: str, fn: str) -> bool:
        """Proactively start (cold-start now, serve warm later) one
        instance of ``fn`` on a worker — the autoscaler's scale-up
        companion. Returns False if the worker is gone/unhealthy or at
        instance capacity."""
        sim = self.sim
        w = sim.workers.get(worker)
        if w is None or not w.healthy:
            return False
        cfg = sim.store.get(fn)
        inst = sim._maybe_start_instance(w, cfg)
        if inst is None:
            return False
        # instances normally get idle_checks from the finish path; a
        # prewarmed instance that never serves traffic needs its own reap
        # path or it would pin a capacity slot forever
        sim._push(inst.ready_t + cfg.idle_timeout_s, "idle_check",
                  (worker, inst.iid))
        # a prewarm onto a worker already holding queued work for this fn
        # must wake its dispatch when the replica is ready, or that work
        # only drains on the next unrelated enqueue/finish
        if w.queue.depth(fn) > 0:
            sim._poke(w, inst.ready_t)
        return True

    def reap(self, worker: str, fn: str) -> bool:
        """Stop one idle warm instance of ``fn`` on a worker — the
        autoscaler's per-function scale-down companion to :meth:`prewarm`.
        Returns False if the worker is gone/unhealthy or holds no idle
        ready replica of that function."""
        sim = self.sim
        w = sim.workers.get(worker)
        if w is None or not w.healthy:
            return False
        rs = w.replica_sets.get(fn)
        inst = rs.idle_ready(sim.now) if rs is not None else None
        if inst is None:
            return False
        w.remove_instance(inst)
        if sim._record:
            self.log_placement("reap", w, fn)
        if len(w.queue) > 0:       # freed capacity may unblock other fns
            sim._dispatch(w)
        else:
            sim._refresh_view(w)
        return True

    # ------------------------------------------------------ placement layer
    def place_prewarm(self, fn: str) -> Optional[str]:
        """Start one replica of ``fn`` on the worker the placer picks —
        the autoscaler's scale-up entry into the placement layer.

        Candidates are offered coldest-in-``fn`` first (fewest replicas
        of the function, then fewest instances overall, then name — the
        deterministic preference order the control loop always used);
        the placer bin-packs within that order. Returns the worker name,
        or None when no worker has memory/instance headroom."""
        sim = self.sim
        cfg = sim.store.get(fn)
        cands = sorted(
            (sim.workers[n] for n in sim._worker_list
             if n in sim.workers),
            key=lambda w: (w.fn_replicas(fn), w.total_instances, w.name))
        for w in self.placer.place_order(fn, cfg.memory_mb, cands):
            if self.prewarm(w.name, fn):
                return w.name
        return None

    def place_reap(self, fn: str) -> Optional[str]:
        """Stop one idle replica of ``fn`` off the worker the placer
        picks (warmest-in-``fn`` candidates first) — the scale-down
        mirror of :meth:`place_prewarm`. Returns the worker name, or
        None when no worker holds an idle ready replica."""
        sim = self.sim
        cands = sorted(
            (sim.workers[n] for n in sim._worker_list
             if n in sim.workers),
            key=lambda w: (-w.fn_replicas(fn), w.name))
        for w in self.placer.reap_order(fn, cands):
            if self.reap(w.name, fn):
                return w.name
        return None

    def workflow_prewarm(self, fn: str) -> Optional[str]:
        """Stage-lookahead prewarm: the workflow engine calls this when a
        stage is submitted so its *successors'* functions are warm by the
        time the stage completes. Only acts when the fleet holds no
        replica of the function at all — steady traffic keeps its own
        capacity warm; this hook exists to hide the first cold start on
        each DAG edge (and after idle reaping between workflow bursts).
        Returns the worker the placer picked, or None (already warm
        somewhere / no headroom)."""
        sim = self.sim
        for name in sim._worker_list:
            w = sim.workers.get(name)
            if w is not None and w.healthy and w.fn_replicas(fn) > 0:
                return None
        return self.place_prewarm(fn)

    # ------------------------------------------------------ autoscaler loop
    def attach_autoscaler(self, scaler, *, first_tick_s: float = None):
        """Bind an ``repro.autoscale.Autoscaler`` and schedule its periodic
        ``autoscale_tick`` control-loop event. Ticks re-arm themselves only
        while other events remain, so ``run()`` still terminates."""
        sim = self.sim
        self.autoscaler = scaler
        t0 = sim.now + (scaler.interval_s if first_tick_s is None
                        else first_tick_s)
        sim._push(t0, "autoscale_tick", None)
        return scaler

    def on_tick(self) -> None:
        sim = self.sim
        if self.autoscaler is None:
            return
        self.autoscaler.on_tick(sim)
        if sim.engine.pending_real > 0:  # re-arm only while real work remains
            sim._push(sim.now + self.autoscaler.interval_s,
                      "autoscale_tick", None)
