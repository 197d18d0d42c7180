"""The worker runtime: one node's execution mechanics, behind a protocol.

The port's own copy of the JAX package's ``core/worker.py``, which holds no
JAX: the port imports nothing of that package.

Splitting this out of the simulator is the paper's architecture-swapping
requirement applied to our own testbed: the event engine
(``repro.core.events``), the worker runtime (this module), and the
control plane (``repro.autoscale.control``) are separate layers with
narrow interfaces, so any one can be replaced without touching the
others.

Two pieces live here:

- :class:`Worker` — one node's *state*: per-function replica sets
  (``FunctionReplicaSet``), the per-function queue index (``FnQueues``),
  and the incrementally tracked memory / busy-slot / slots-total
  counters the placement layer and routers read in O(1).
- :class:`WorkerRuntime` — one node's *mechanics*: backlog dispatch
  (merge-scan by global arrival order), memory/instance admission,
  service start, service completion, and idle reaping. The runtime
  drives workers but owns no global state; everything global is read
  through the :class:`SimContext` protocol below.

``SimContext`` (duck-typed; ``repro.core.simulator.Simulator`` is the
one implementation) must provide:

==================  ======================================================
``now``             current virtual time
``store``           the function ``ConfigStore``
``model``           service-time model (``sample(cfg, ...)``)
``workers``         live name -> :class:`Worker` map
``_draining``       removed-but-finishing name -> :class:`Worker` map
``cold_default``    platform cold-start default (s)
``cold_starts_total``  run-wide cold-start counter
``results`` / ``telemetry`` / ``_finished``  result-recording surface
``view``            the router ``StateView`` (estimator feed)
``fn_cost(fn)``     static per-token cost proxy
``_push(t, kind, payload)``  schedule an event on the event engine
``_record_fail(req, err)``   record a failed request
``_refresh_view(w)``         publish a worker's state row
``faults``          the chaos layer (``repro.core.faults``) or None;
                    consulted at service start for lost completions
``_dispatch(w)`` / ``_maybe_start_instance(w, cfg)`` /
``_start_service(w, inst, req, cfg, queue_len)`` / ``_poke(w, t)``
                    re-entry hooks — the runtime always re-enters
                    through the simulator-level methods (which delegate
                    straight back here) so tests and custom platforms
                    can intercept them in one place
``control``         the control plane (placement decision logging)
==================  ======================================================

Byte-identity contract: this is a *move*, not a rewrite — dispatch
order, RNG consumption, and every counter update are exactly the
pre-split simulator's, pinned by the golden digests in
``tests/test_scheduling.py`` / ``tests/test_placement.py``.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional

from repro_torch.core.scheduling import (UNLIMITED_SLOTS, FnQueues,
                                   FunctionReplicaSet, Instance)
from repro_torch.core.types import Request


class Worker:
    """One node: per-function replica sets + per-function FIFO queues,
    indexed so every hot-path read is O(affected function). Memory and
    slot totals are tracked incrementally (never recomputed by scanning
    instances) so the placement layer and ``slots_total`` are O(1)."""

    def __init__(self, name: str, capacity_slots: int = 16,
                 memory_mb: Optional[float] = None):
        self.name = name
        self.capacity_slots = capacity_slots   # hardware concurrency of node
        self.memory_mb = memory_mb             # replica memory cap (None=inf)
        self.memory_used_mb = 0.0              # incremental footprint
        self.slowdown = 1.0                    # straggler factor
        self.healthy = True
        self.zone = None                       # failure domain (zones=...)
        self.replica_sets: Dict[str, FunctionReplicaSet] = {}
        self.iid_index: Dict[str, Instance] = {}   # iid -> live instance
        self.total_instances = 0
        self._inflight = 0                 # incremental busy-slot count
        self._slots_total = 0              # incremental slots_total counter
        self.queue = FnQueues()
        self.busy_time = 0.0
        self.cold_starts = 0
        self.instances_started = 0
        self.poke_times: set = set()       # dedupe scheduled pokes

    @property
    def instances(self) -> Dict[str, List[Instance]]:
        """Legacy fn -> instance-list view (tests/examples read this)."""
        return {fn: rs.instances for fn, rs in self.replica_sets.items()
                if rs.instances}

    @staticmethod
    def _slot_contrib(inst: Instance) -> int:
        # an unlimited-concurrency instance (slots == 0) counts its live
        # occupancy (min 1) — matches the old flat recomputation exactly
        return inst.slots if inst.slots > 0 else max(inst.busy, 1)

    def add_instance(self, inst: Instance) -> None:
        rs = self.replica_sets.get(inst.fn)
        if rs is None:
            rs = self.replica_sets[inst.fn] = FunctionReplicaSet(inst.fn)
        rs.add(inst)
        self.iid_index[inst.iid] = inst
        self.total_instances += 1
        self.memory_used_mb += inst.memory_mb
        self._slots_total += self._slot_contrib(inst)

    def remove_instance(self, inst: Instance) -> None:
        self.replica_sets[inst.fn].discard(inst)
        self.iid_index.pop(inst.iid, None)
        self.total_instances -= 1
        self.memory_used_mb -= inst.memory_mb
        self._slots_total -= self._slot_contrib(inst)

    def clear_instances(self) -> None:
        self.replica_sets.clear()
        self.iid_index.clear()
        self.total_instances = 0
        self.memory_used_mb = 0.0
        self._inflight = 0
        self._slots_total = 0

    def note_busy(self, inst: Instance, delta: int) -> None:
        """Move an instance's busy count, keeping ``_slots_total`` exact:
        a slots==0 instance contributes ``max(busy, 1)``, so its share
        shifts as occupancy changes."""
        self._inflight += delta
        if inst.slots > 0:
            inst.busy += delta
            return
        before = max(inst.busy, 1)
        inst.busy += delta
        self._slots_total += max(inst.busy, 1) - before

    def fits(self, memory_mb: float) -> bool:
        """Memory admission for one more ``memory_mb`` replica."""
        return (self.memory_mb is None
                or self.memory_used_mb + memory_mb <= self.memory_mb + 1e-9)

    def mem_free_mb(self) -> float:
        return (float("inf") if self.memory_mb is None
                else self.memory_mb - self.memory_used_mb)

    def fn_replicas(self, fn: str) -> int:
        rs = self.replica_sets.get(fn)
        return len(rs.instances) if rs is not None else 0

    def warm_fns(self) -> frozenset:
        return frozenset(fn for fn, rs in self.replica_sets.items()
                         if rs.instances)

    def inflight(self) -> int:
        return self._inflight

    def slots_total(self) -> int:
        return self._slots_total or 1

    def fn_free_slots(self, now: float) -> Dict[str, int]:
        """Per-function immediately-usable warm slots (router signal)."""
        return {fn: rs.ready_free_slots(now)
                for fn, rs in self.replica_sets.items() if rs.instances}


class WorkerRuntime:
    """Backlog dispatch, admission, service start/completion for workers.

    Owns no global state: time, the config store, the service model, and
    event scheduling are all reached through the ``SimContext`` protocol
    (see module docstring). The simulator's ``_dispatch`` /
    ``_maybe_start_instance`` / ``_start_service`` methods are thin
    delegates onto this class, and the runtime deliberately *re-enters
    through them* for every nested call so a monkeypatch (or subclass
    override) of the simulator-level hook intercepts every path.
    """

    def __init__(self, sim):
        self.sim = sim

    # ------------------------------------------------------------ dispatch
    def enqueue(self, req: Request) -> None:
        sim = self.sim
        w = sim.workers.get(req._worker)
        if w is None:                   # branch removed mid-hop: re-route
            sim._on_reroute(req)
            return
        if not w.healthy:
            sim._record_fail(req, "worker died")
            return
        w.queue.push(req, sim.store.get(req.fn).timeout_s)
        sim._dispatch(w)

    def dispatch(self, w: Worker) -> None:
        """Serve a worker's backlog through the per-function index.

        Queue timeouts are flushed from the deadline heap (the flat scan
        checked every queued request each pass; the heap surfaces exactly
        the expired ones, in the same arrival order). Then only functions
        that can make progress are merge-scanned by global arrival
        sequence, so a saturated function's whole backlog is skipped in
        O(1) while cross-function service order — and hence the service
        model's RNG stream — matches the flat scan byte-for-byte.
        """
        sim = self.sim
        if not w.healthy:
            return
        # the flat scan passed the pre-scan queue length to the service
        # model (the list was only compacted afterwards) — preserve that
        qlen_at_scan = len(w.queue)
        if w.queue.has_expired(sim.now):
            for req in w.queue.pop_expired(sim.now):
                sim._record_fail(req, "queue timeout")
        if len(w.queue):
            self._merge_scan(w, qlen_at_scan)
        sim._refresh_view(w)

    def _merge_scan(self, w: Worker, qlen_at_scan: int) -> None:
        sim = self.sim
        now = sim.now
        q = w.queue
        active = q.active_fns()
        if len(active) == 1:           # overwhelmingly common: no merge
            self._scan_one_fn(w, active[0], qlen_at_scan)
            return
        # per-fn scan state: [cfg, warming-free slots, kept prefix].
        # Warming free slots are counted up front (as the flat scan did):
        # queued requests wait on those before spawning more replicas
        # (c=1 instances expose 0 extra slots, so Lambda-style
        # one-instance-per-request behaviour is preserved). Free ready
        # slots, warming slots, and instance-start headroom only shrink
        # during the scan, so one fully-failed attempt proves every later
        # same-fn attempt fails too: the function drops out of the merge.
        state: dict = {}
        heap = []
        for fn in active:
            head = q.scan_head(fn)
            if head is None:
                continue
            rs = w.replica_sets.get(fn)
            state[fn] = [sim.store.get(fn), rs.warming_free(now)
                         if rs is not None else 0, []]
            heap.append((head._wseq, fn))
        heapq.heapify(heap)
        while heap:
            _, fn = heapq.heappop(heap)
            st = state[fn]
            cfg, kept = st[0], st[2]
            req = q.scan_head(fn)
            q.pop_head(fn)
            rs = w.replica_sets.get(fn)
            inst = rs.pick(now) if rs is not None else None
            saturated = False
            if inst is not None:
                q.mark_served(req)
                sim._start_service(w, inst, req, cfg, qlen_at_scan)
            elif st[1] > 0:
                st[1] -= 1                  # wait on a warming instance
                sim._poke(w, rs.next_ready_after(now))
                kept.append(req)
            else:
                started = sim._maybe_start_instance(w, cfg)
                if started is None:
                    kept.append(req)
                    saturated = True
                    self._maybe_poke_timeout(w, req, cfg)
                elif started.ready_t <= now:
                    # instant start (explicit cold_start_s=0.0): the new
                    # replica is ready capacity, not warming — serve on
                    # it directly (counting it as warming would strand a
                    # later request waiting on a next_ready that never
                    # comes)
                    q.mark_served(req)
                    sim._start_service(w, started, req, cfg, qlen_at_scan)
                else:
                    st[1] += (started.slots if started.slots > 0
                              else UNLIMITED_SLOTS) - 1
                    sim._poke(w, started.ready_t)
                    kept.append(req)
            if not saturated:
                head = q.scan_head(fn)
                if head is not None:
                    heapq.heappush(heap, (head._wseq, fn))
        for fn, st in state.items():
            q.restore(fn, st[2])

    def _scan_one_fn(self, w: Worker, fn: str, qlen_at_scan: int) -> None:
        """Heap-free scan when a single function holds all queued work —
        FIFO order *is* global order, so semantics match the merge."""
        sim = self.sim
        now = sim.now
        q = w.queue
        cfg = sim.store.get(fn)
        rs = w.replica_sets.get(fn)
        warming = rs.warming_free(now) if rs is not None else 0
        kept = []
        while True:
            req = q.scan_head(fn)
            if req is None:
                break
            q.pop_head(fn)
            inst = rs.pick(now) if rs is not None else None
            if inst is not None:
                q.mark_served(req)
                sim._start_service(w, inst, req, cfg, qlen_at_scan)
                continue
            if warming > 0:
                warming -= 1                # wait on a warming instance
                sim._poke(w, rs.next_ready_after(now))
                kept.append(req)
                continue
            started = sim._maybe_start_instance(w, cfg)
            if started is None:
                kept.append(req)
                self._maybe_poke_timeout(w, req, cfg)
                break                       # saturated: rest stays queued
            rs = w.replica_sets[fn]         # created on first start
            if started.ready_t <= now:
                # instant start (explicit cold_start_s=0.0): ready
                # capacity, not warming — serve the trigger directly
                q.mark_served(req)
                sim._start_service(w, started, req, cfg, qlen_at_scan)
                continue
            warming += (started.slots if started.slots > 0
                        else UNLIMITED_SLOTS) - 1
            sim._poke(w, started.ready_t)
            kept.append(req)
        q.restore(fn, kept)

    def _maybe_poke_timeout(self, w: Worker, req: Request, cfg) -> None:
        """A start refused for *memory* can be blocked permanently (no
        finish/idle event need ever touch this worker again), which would
        strand the queued request without even its timeout failure. Poke
        the worker just past the request's queue deadline so the flush
        runs. Slot-saturation refusals are excluded: they always clear
        through a finish, and uncapped runs must stay byte-identical to
        the pre-placement simulator."""
        if not w.fits(cfg.memory_mb):
            self.sim._poke(w, req.arrival_t + cfg.timeout_s + 1e-6)

    def poke(self, w: Worker, t: float) -> None:
        key = round(t, 9)
        if key not in w.poke_times:
            w.poke_times.add(key)
            self.sim._push(t, "poke", w.name)

    def on_poke(self, worker: str) -> None:
        sim = self.sim
        w = sim.workers.get(worker)
        if w is None:
            return
        w.poke_times.discard(round(sim.now, 9))
        sim._dispatch(w)

    # ----------------------------------------------------------- admission
    def maybe_start_instance(self, w: Worker, cfg) -> Optional[Instance]:
        sim = self.sim
        rs = w.replica_sets.get(cfg.name)
        if ((rs is not None and len(rs) >= cfg.max_instances_per_worker)
                or w.total_instances >= w.capacity_slots
                or not w.fits(cfg.memory_mb)):   # placement memory admission
            return None
        # an explicitly configured cold_start_s=0.0 means *instant*, only
        # an unset (None) config falls back to the platform default
        cold = (cfg.cold_start_s if cfg.cold_start_s is not None
                else sim.cold_default)
        inst = Instance(iid=sim._alloc_iid(w), fn=cfg.name,
                        slots=cfg.concurrency,
                        ready_t=sim.now + cold * w.slowdown,
                        last_used=sim.now,
                        memory_mb=cfg.memory_mb)
        w.add_instance(inst)
        w.cold_starts += 1
        w.instances_started += 1
        sim.cold_starts_total += 1
        if sim._record:
            sim.control.log_placement("start", w, cfg.name)
        return inst

    # ------------------------------------------------------------- service
    def start_service(self, w: Worker, inst: Instance, req: Request, cfg,
                      queue_len: int) -> None:
        sim = self.sim
        w.note_busy(inst, +1)
        inst.last_used = sim.now
        cold = inst.ready_t > req.arrival_t
        dur, ok = sim.model.sample(
            cfg, batch_size=inst.busy, queue_len=queue_len,
            prompt=req.size, cold=cold, fn_cost=sim.fn_cost(req.fn))
        dur *= w.slowdown
        # unlimited concurrency: utilization-triggered replica pre-start
        if cfg.concurrency == 0:
            util = inst.busy / max(cfg.max_instances_per_worker, 1)
            if util > cfg.util_scale_threshold:
                sim._maybe_start_instance(w, cfg)
        if sim.collect_telemetry:
            # a retried request that originally failed *before* routing
            # ("no healthy workers" at arrival) has no telemetry row
            idx = getattr(req, "_telemetry_idx", None)
            if idx is not None:
                rec = sim.telemetry[idx]
                rec.batch_size = inst.busy
                rec.cold = cold
        faults = sim.faults
        if faults is not None and faults.drop_finish(req, w):
            # chaos layer: the completion is lost — no finish event; the
            # slot stays busy until the fn timeout (see FaultInjector)
            faults.lose_completion(w, inst, req, cfg)
        else:
            sim._push(sim.now + dur, "finish",
                      (req, w.name, inst.iid, cold, sim.now, ok))
        w.busy_time += dur

    def finish(self, payload) -> None:
        """Service completion: free the slot, record the result, feed the
        estimator, and re-dispatch the freed capacity."""
        sim = self.sim
        req, wname, iid, cold, start_t, ok = payload
        draining = wname not in sim.workers
        # a drained-and-retired (or failed-then-removed) worker may be gone
        # entirely; the result below must still be recorded either way
        w = sim._draining.get(wname) if draining else sim.workers[wname]
        inst = w.iid_index.get(iid) if w is not None else None
        if inst is None and not draining:
            # the worker is live but the instance is gone: only a crash
            # (`clear_instances` in `_on_fail`) removes instances that
            # still hold busy slots — every reap path requires busy == 0,
            # and a pending finish pins busy ≥ 1. This completion died
            # with the worker; recording it as a success was the
            # in-flight-ok bug (a drained-then-retired worker, w is None
            # with draining=True, still completes below as before).
            sim._record_fail(req, "worker died")
            return
        if inst is not None:               # O(1) via the iid index
            w.note_busy(inst, -1)
            inst.last_used = sim.now
            sim._push(sim.now + sim.store.get(req.fn).idle_timeout_s,
                      "idle_check", (wname, iid))
        if draining and w is not None and w.inflight() == 0:
            sim._draining.pop(wname, None)   # retire even if hedge lost
        if not sim.record_result(req, start_t=start_t, ok=ok, cold=cold,
                                 worker=wname, instance=iid):
            return                       # hedge lost the race
        if draining:                     # already retired above if empty
            return
        sim._dispatch(w)

    def idle_check(self, payload) -> None:
        sim = self.sim
        wname, iid = payload
        w = sim.workers.get(wname)
        if w is None:
            # branch scaled away meanwhile, or the worker is draining in
            # sim._draining: draining workers only finish in-flight work,
            # they never reap (pinned by tests/test_core_platform.py)
            return
        inst = w.iid_index.get(iid)        # O(1) via the iid index
        if (inst is not None and inst.busy == 0 and
                sim.now - inst.last_used >=
                sim.store.get(inst.fn).idle_timeout_s - 1e-9):
            w.remove_instance(inst)
            if sim._record:
                sim.control.log_placement("idle", w, inst.fn)
            if len(w.queue) > 0:
                # the freed capacity slot may unblock another function's
                # backlog (the seed left such work stranded until the
                # next unrelated enqueue/finish — or forever)
                sim._dispatch(w)
        # always republish the view: dispatch refreshes it on success,
        # but an unhealthy-worker dispatch returns without refreshing —
        # the early return here used to leave routing blind to the reap
        sim._refresh_view(w)
