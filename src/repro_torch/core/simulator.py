"""Deterministic discrete-event simulator for the HyperFaaS testbed.

The port's own copy of the JAX package's ``core/simulator.py``, which holds no
JAX: the port imports nothing of that package.

This is what lets the platform be *studied under massive load* (paper §I):
thousands of (emulated) workers, tens of millions of requests, virtual
time. The same router tree / config store / concurrency policies run here
as in the real in-process engine (``repro.serving.engine``); only the
worker execution is replaced by a service-time model — either a synthetic
profile or the learned RQ-B worker model (paper Fig. 2 step 3).

The simulator itself is thin *wiring* over three swappable layers:

- **Event engine** (``repro.core.events``) — the hot loop's priority
  queue behind a backend registry: ``single_heap`` (byte-identical
  reference) or ``sharded`` (calendar queue for ≥10M-request probes).
  Pick with ``Simulator(event_backend="sharded")``.
- **Worker runtime** (``repro.core.worker``) — per-node dispatch,
  admission, service start/completion, driven through the
  ``_dispatch`` / ``_maybe_start_instance`` / ``_start_service`` hook
  seam on this class (tests and custom platforms intercept there).
- **Control plane** (``repro.autoscale.control``) — autoscaler binding,
  per-function prewarm/reap, placer-ranked placement, and the
  byte-stable placement/routing decision logs; ``sim.prewarm`` etc.
  delegate to it.

Fault tolerance features exercised here: worker fail/recover injection,
per-worker straggler slowdowns, hedged requests (tail mitigation), queue
timeouts, and live add/remove of tree branches (elastic scaling).
"""
from __future__ import annotations

import itertools
import random
from typing import Dict, List, Optional

from repro_torch.core.config_store import ConfigStore
from repro_torch.core.events import EventEngine
from repro_torch.core.router import LBNode, StateView, WorkerState
from repro_torch.core.scheduling import Instance
from repro_torch.core.types import FunctionConfig, Request, RequestResult, TelemetryRecord
from repro_torch.core.worker import Worker, WorkerRuntime


# ---------------------------------------------------------------------------
# Service-time models
# ---------------------------------------------------------------------------

class SyntheticServiceModel:
    """Deterministic-plus-noise cost: t = t0 + a*(prompt+gen)*fn_cost, scaled by
    slot contention; lognormal jitter. The 'ground truth' worker for RQ-B."""

    def __init__(self, *, t0=0.004, per_token=0.0008, contention=0.30,
                 jitter=0.08, fail_rate=0.002, seed=0):
        self.t0, self.per_token, self.contention = t0, per_token, contention
        self.jitter, self.fail_rate = jitter, fail_rate
        self.rng = random.Random(seed)

    def sample(self, cfg: FunctionConfig, *, batch_size: int, queue_len: int,
               prompt: int, cold: bool, fn_cost: float):
        base = self.t0 + self.per_token * (prompt + cfg.gen_tokens) * fn_cost
        base *= 1.0 + self.contention * max(batch_size - 1, 0)
        base *= self.rng.lognormvariate(0.0, self.jitter)
        ok = self.rng.random() >= self.fail_rate
        return base, ok


# ---------------------------------------------------------------------------
# Simulator
# ---------------------------------------------------------------------------

# LB policies that read the per-function WorkerState layer; the simulator
# only pays for building those snapshots when the tree routes with one
_FN_STATE_POLICIES = frozenset({"warm_least_loaded", "deadline_aware",
                                "workflow_aware"})

# LB policies that additionally price backlogs with the windowed service
# estimator; the simulator only feeds it when the tree routes with one
_DEADLINE_POLICIES = frozenset({"deadline_aware", "workflow_aware"})


def _tree_uses_fn_state(node) -> bool:
    return (node.policy_name in _FN_STATE_POLICIES
            or any(_tree_uses_fn_state(c) for c in node.children))


def _tree_all_stateless(node) -> bool:
    """True when no policy anywhere in the tree reads WorkerState — the
    simulator can then skip state publication entirely (stateless
    platforms shouldn't pay for state freshness; paper §II)."""
    from repro_torch.core.router import STATELESS
    return (node.policy_name in STATELESS
            and all(_tree_all_stateless(c) for c in node.children))


def _tree_uses_deadline(node) -> bool:
    return (node.policy_name in _DEADLINE_POLICIES
            or any(_tree_uses_deadline(c) for c in node.children))

# Re-exported for callers that patched/inspected the old private names
# (the classes themselves now live in ``repro.core.worker`` /
# ``repro.core.scheduling``; these aliases are the same objects, so
# monkeypatching through them still hits every code path).
_Instance = Instance
_Worker = Worker

# failure modes a retry budget may resurrect: infrastructure faults, not
# per-request outcomes ("queue timeout" is the request's own deadline —
# retrying it would double-spend an already-blown budget)
RETRYABLE_ERRORS = frozenset({"worker died", "lost completion",
                              "no healthy workers"})


class Simulator:
    #: every event kind the run loop dispatches (bound once per run())
    _EVENT_KINDS = ("arrival", "enqueue", "reroute", "retry", "maybe_hedge",
                    "fail", "recover", "fault", "poke", "finish",
                    "idle_check", "autoscale_tick", "workflow_done")

    def __init__(self, tree: LBNode, store: ConfigStore, service_model, *,
                 seed: int = 0, state_staleness_s: float = 0.0,
                 hedge_after_s: Optional[float] = None,
                 cold_start_default_s: float = 0.25,
                 network_hop_s: float = 0.0005,
                 worker_capacity_slots: int = 16,
                 worker_memory_mb: Optional[float] = None,
                 placer="first_fit",
                 mem_eta: str = "flat",
                 record_decisions: bool = False,
                 event_backend="single_heap",
                 collect_telemetry: bool = True,
                 zones=None,
                 retry_budget: int = 0,
                 retry_backoff_s: float = 0.05,
                 retry_backoff_cap_s: float = 1.0,
                 retry_storm_cap: int = 512,
                 faults=None,
                 gateway=None,
                 iid_scope: str = "sim"):
        self.tree = tree
        self.store = store
        self.model = service_model
        self.rng = random.Random(seed)
        self.view = StateView(state_staleness_s)
        self.hedge_after_s = hedge_after_s
        self.cold_default = cold_start_default_s
        self.hop_s = network_hop_s
        self.worker_capacity_slots = worker_capacity_slots
        # None => unlimited replica memory per worker: every placement
        # admission passes and behaviour is byte-identical to the
        # pre-placement simulator (pinned in tests/test_placement.py)
        self.worker_memory_mb = worker_memory_mb
        # "flat" keeps deadline_aware's classic ~infinite penalty on
        # memory-blocked cold starts (golden-pinned); "placer" prices
        # them with the placer's graded unblock ETA instead
        if mem_eta not in ("flat", "placer"):
            raise ValueError(f"mem_eta must be 'flat' or 'placer', "
                             f"got {mem_eta!r}")
        self.mem_eta_mode = mem_eta
        # control plane (autoscaler + placement + decision logs) — lazy
        # import so the core layer has no hard autoscale dependency
        from repro_torch.autoscale.control import ControlPlane
        self.control = ControlPlane(self, placer=placer,
                                    record_decisions=record_decisions)
        self.runtime = WorkerRuntime(self)
        # telemetry rows cost real memory at 10M+ requests; lite probes
        # (benchmarks/run.py bench_event_backends) turn them off — the
        # flag changes no event ordering and consumes no RNG
        self.collect_telemetry = collect_telemetry
        self.workers: Dict[str, Worker] = {
            w: Worker(w, capacity_slots=worker_capacity_slots,
                      memory_mb=worker_memory_mb)
            for w in tree.all_workers()}
        self._worker_list = list(self.workers)   # cache (rebuilt on add/remove)
        self._healthy_count = len(self.workers)  # incremental: O(1) arrivals
        # a fully stateless tree never reads WorkerState rows: skip
        # publication (routing results are unaffected — nothing consumes
        # the rows — and no RNG or event ordering is touched)
        self._view_needed = not _tree_all_stateless(tree)
        self._fn_view_needed = _tree_uses_fn_state(tree)
        self._branch_view_needed = False  # aggregate leaf rows for inner LBs
        self._leaf_members: Dict[str, List[str]] = {}
        self._leaf_of: Dict[str, str] = {}
        self._node_workers: Dict[str, List[str]] = {}   # inner-node subtrees
        self._worker_ancestors: Dict[str, List[str]] = {}
        self._node_dirty: set = set()
        self._node_cache: Dict[str, WorkerState] = {}
        self._node_cache_stale_t = -1e30   # stale-snapshot rotation stamp
        # dirty-lazy leaf rows (staleness == 0 fast path): leaf -> time of
        # its last member event / aggregation version / cached row
        self._leaf_dirty_t: Dict[str, float] = {}
        self._leaf_ver: Dict[str, int] = {}
        self._leaf_cache: Dict[str, tuple] = {}
        # failure domains: zones=N assigns each leaf branch a zone
        # (z0..z{N-1}, round-robin in tree walk order, sticky across
        # topology changes); zones={leaf: zone} maps them explicitly.
        # Zones change no routing or service decision by themselves —
        # only spread_zones placement and zone faults read them.
        self.zones = zones
        self._zone_assign: Dict[str, str] = {}
        self.zone_workers: Dict[str, List[str]] = {}
        self._rebuild_leaf_index()
        if _tree_uses_deadline(tree):
            self._enable_service_est()
        self._draining: Dict[str, Worker] = {}  # removed, in-flight finishing
        self.engine = EventEngine(event_backend,
                                  background=("autoscale_tick", "fault"))
        self._push = self.engine.push      # hot path: skip a delegation hop
        # instance-id allocation scope: "sim" (default) numbers instances
        # from one fleet-wide counter — the historical behaviour every
        # golden digest pins; "worker" numbers per worker, making iids a
        # pure function of that worker's own event sequence — required
        # for serial ≡ K-partition byte-equality (repro.parallel), where
        # a fleet-wide counter would leak the global interleaving into
        # instance names
        if iid_scope not in ("sim", "worker"):
            raise ValueError(f"iid_scope must be 'sim' or 'worker', "
                             f"got {iid_scope!r}")
        self._iid = itertools.count()
        self._iid_by_worker = {} if iid_scope == "worker" else None
        self.now = 0.0
        self.events_processed = 0
        self.arrivals_seen = 0
        self.arrivals_by_fn: Dict[str, int] = {}   # per-fn scaling signal
        self.hedges_seen = 0         # hedge clones, counted apart from demand
        self.cold_starts_total = 0   # survives worker removal (scale-down)
        self.results: List[RequestResult] = []
        self.telemetry: List[TelemetryRecord] = []
        self._finished: set = set()
        self._fn_cost: Dict[str, float] = {}
        # per-request retry budget for RETRYABLE_ERRORS, with capped
        # exponential backoff; retry_budget=0 (default) disables the
        # whole path. The storm guard caps *concurrently pending*
        # retries: a mass failure sheds the excess instead of
        # re-offering the entire blast wave at once.
        self.retry_budget = retry_budget
        self.retry_backoff_s = retry_backoff_s
        self.retry_backoff_cap_s = retry_backoff_cap_s
        self.retry_storm_cap = retry_storm_cap
        self._retries_pending = 0
        self.retries_scheduled = 0
        self.retries_shed = 0
        self.retries_dropped = 0   # backoff expired after a hedge settled
        # workflow layer: None until a WorkflowWorkload (or a direct
        # attach_workflows call) binds a WorkflowEngine
        self.workflows = None
        self.workflow_results: List = []   # WorkflowResult per instance
        # chaos layer: None until a FaultConfig/FaultInjector is
        # attached (directly or via a workload's .faults)
        self.faults = None
        if faults is not None:
            self.attach_faults(faults)
        # front-door gateway: None until a GatewayConfig/Gateway is
        # attached (directly or via a workload's .gateway) — gateway-off
        # runs consume no extra RNG and stay byte-identical to the
        # pre-gateway goldens
        self.gateway = None
        if gateway is not None:
            self.attach_gateway(gateway)

    # --------------------------------------------------- control-plane API
    # Thin delegates: the logic lives on repro.autoscale.control.ControlPlane
    # (sim.control); these names are the stable public surface.
    @property
    def placer(self):
        return self.control.placer

    @property
    def autoscaler(self):
        return self.control.autoscaler

    @property
    def placement_records(self) -> List[str]:
        return self.control.placement_records

    @property
    def routing_records(self) -> List[str]:
        return self.control.routing_records

    def placement_log(self) -> str:
        return self.control.placement_log()

    def routing_log(self) -> str:
        return self.control.routing_log()

    def prewarm(self, worker: str, fn: str) -> bool:
        return self.control.prewarm(worker, fn)

    def reap(self, worker: str, fn: str) -> bool:
        return self.control.reap(worker, fn)

    def place_prewarm(self, fn: str) -> Optional[str]:
        return self.control.place_prewarm(fn)

    def place_reap(self, fn: str) -> Optional[str]:
        return self.control.place_reap(fn)

    def attach_autoscaler(self, scaler, *, first_tick_s: float = None):
        return self.control.attach_autoscaler(scaler,
                                              first_tick_s=first_tick_s)

    def _log_placement(self, kind: str, w: Worker, fn: str) -> None:
        self.control.log_placement(kind, w, fn)

    # ------------------------------------------------------ partition hooks
    def _alloc_iid(self, w) -> str:
        """Next instance id on worker ``w`` (see ``iid_scope``)."""
        if self._iid_by_worker is None:
            return f"{w.name}/i{next(self._iid)}"
        c = self._iid_by_worker.get(w.name)
        if c is None:
            c = self._iid_by_worker[w.name] = itertools.count()
        return f"{w.name}/i{next(c)}"

    def occupancy_summary(self) -> dict:
        """Deterministic snapshot the parallel runner exchanges at window
        barriers (``repro.parallel``): outstanding work plus gateway
        occupancy. A pure function of partition state — no RNG, no
        events — so barrier directives derived from it keep same-seed
        runs byte-identical."""
        queued = inflight = 0
        for w in self.workers.values():
            queued += len(w.queue)
            inflight += w.inflight()
        d = {"now": self.now,
             "pending_real": self.engine.pending_real,
             "queued": queued, "inflight": inflight,
             "arrivals": self.arrivals_seen,
             "results": len(self.results)}
        if self.gateway is not None:
            d["gw_inflight"] = self.gateway.inflight
            d["gw_by_pri"] = dict(self.gateway.inflight_by_pri)
        return d

    # ----------------------------------------------------------- event API
    def submit(self, req: Request):
        self._push(req.arrival_t, "arrival", req)

    def inject_failure(self, worker: str, at: float, recover_after: float):
        self._push(at, "fail", worker)
        self._push(at + recover_after, "recover", worker)

    def set_straggler(self, worker: str, factor: float):
        self.workers[worker].slowdown = factor

    def attach_faults(self, faults) -> None:
        """Attach the chaos layer: accepts a ``FaultConfig`` or a
        prebuilt ``FaultInjector`` and arms it. A disabled config arms
        nothing — the run stays byte-identical to a fault-free one."""
        from repro_torch.core.faults import FaultConfig, FaultInjector
        if isinstance(faults, FaultConfig):
            faults = FaultInjector(self, faults)
        self.faults = faults
        faults.arm()

    def fault_log(self) -> str:
        return "" if self.faults is None else self.faults.fault_log()

    def attach_gateway(self, gateway):
        """Attach the front-door stage (``repro.core.gateway``): accepts
        a ``GatewayConfig`` or a prebuilt ``Gateway``. A disabled config
        attaches nothing — the run stays byte-identical to a
        gateway-free one. Verdict recording follows the simulator's
        ``record_decisions`` flag so recorded runs are replayable
        (``repro.autoscale.replay.ReplayGateway``)."""
        from repro_torch.core.gateway import Gateway, GatewayConfig
        if isinstance(gateway, GatewayConfig):
            if not gateway.enabled:
                return None
            gateway = Gateway(gateway)
        if self._record:
            gateway.record = True
        self.gateway = gateway
        return gateway

    def gateway_log(self) -> str:
        return self.control.gateway_log()

    @property
    def gateway_records(self) -> List[str]:
        return self.control.gateway_records

    def attach_workflows(self, engine):
        """Bind the workflow DAG runtime (``repro.workloads.workflows``).
        ``WorkflowWorkload.submit_to`` attaches one automatically; several
        workflow workloads submitted into one simulator share it."""
        self.workflows = engine
        return engine

    # ------------------------------------------------------------ topology
    def add_branch(self, node: LBNode):
        self.tree.add_branch(node)
        for w in node.all_workers():
            self.workers[w] = Worker(
                w, capacity_slots=self.worker_capacity_slots,
                memory_mb=self.worker_memory_mb)
        self._worker_list = list(self.workers)
        self._recount_healthy()
        self._rebuild_leaf_index()
        self._view_needed = (self._view_needed
                             or not _tree_all_stateless(node))
        self._fn_view_needed = (self._fn_view_needed
                                or _tree_uses_fn_state(node))
        if _tree_uses_deadline(node):
            self._enable_service_est()

    def remove_branch(self, name: str):
        """Remove a branch *safely*: queued requests on its workers are
        re-routed through the shrunk tree, in-flight ones drain to
        completion on a parked worker, and the stale ``self.workers``
        entries are dropped so a later ``add_branch`` cannot resurrect
        routing to dead names (the seed left both dangling)."""
        removed = [c for c in self.tree.children if c.name == name]
        self.tree.remove_branch(name)
        self._worker_list = self.tree.all_workers()
        live = set(self._worker_list)
        for node in removed:
            for wname in node.all_workers():
                if wname in live:           # still reachable via another branch
                    continue
                w = self.workers.pop(wname, None)
                if w is None:
                    continue
                for req in w.queue.drain_all():   # re-route queued work
                    self._push(self.now, "reroute", req)
                if w.inflight() > 0:
                    self._draining[wname] = w
        self._recount_healthy()
        self._rebuild_leaf_index()

    def _recount_healthy(self):
        self._healthy_count = sum(
            1 for w in self._worker_list if self.workers[w].healthy)

    # ------------------------------------------------- state-view publication
    def _enable_service_est(self):
        """Attach the windowed service-time estimator deadline-aware
        routing prices backlogs with (idempotent; lazy import keeps the
        core layer free of a hard autoscale dependency). Deadline routing
        is the one stateful policy meant for *inner* LB nodes too — the
        paper's recipe otherwise scatters across branches statelessly —
        so it also turns on aggregated per-branch state rows."""
        if self.view.estimator is None:
            from repro_torch.autoscale.metrics import ServiceEstimator
            self.view.estimator = ServiceEstimator()
        self.view.cold_start_est_s = self.cold_default
        self.view.node_resolver = self._resolve_node_state
        if self.mem_eta_mode == "placer":
            self.view.mem_eta = self.placer.blocked_cold_eta_s
        self._branch_view_needed = True

    def _rebuild_leaf_index(self):
        """Worker -> leaf / inner-ancestor maps for branch-level state
        rows (leaf rows resolve dirty-lazily through
        ``_resolve_node_state``; inner-node rows likewise)."""
        self._leaf_members = {}
        self._leaf_of = {}
        self._leaf_nodes = {}
        self._node_workers = {}
        ancestors: Dict[str, set] = {}

        def walk(node, path):
            if node.is_leaf:
                self._leaf_members[node.name] = list(node.workers)
                self._leaf_nodes[node.name] = node
                for w in node.workers:
                    self._leaf_of[w] = node.name
                    ancestors.setdefault(w, set()).update(path)
                return
            self._node_workers[node.name] = node.all_workers()
            for c in node.children:
                walk(c, path + [node.name])
        walk(self.tree, [])
        if self.zones is not None:
            # per-*branch* zones: every worker of a leaf shares its
            # failure domain, so zone-blind spread (which happily packs
            # one branch) and spread_zones genuinely diverge under a
            # zone outage. Assignments are sticky: a leaf keeps its zone
            # across unrelated add/remove_branch calls.
            for leaf in self._leaf_members:
                if leaf not in self._zone_assign:
                    if isinstance(self.zones, dict):
                        z = self.zones.get(leaf)
                    else:
                        z = f"z{len(self._zone_assign) % self.zones}"
                    if z is not None:
                        self._zone_assign[leaf] = z
            self.zone_workers = {}
            for leaf, members in self._leaf_members.items():
                z = self._zone_assign.get(leaf)
                for wname in members:
                    w = self.workers.get(wname)
                    if w is not None:
                        w.zone = z
                if z is not None:
                    self.zone_workers.setdefault(z, []).extend(members)
        self._worker_ancestors = {w: sorted(a) for w, a in ancestors.items()}
        self._node_dirty = set(self._node_workers)
        self._node_cache = {}
        # leaves that survived a topology change keep their rows (the
        # eager scheme kept them in the StateView across rebuilds)
        live = self._leaf_members
        self._leaf_dirty_t = {k: v for k, v in self._leaf_dirty_t.items()
                              if k in live}
        self._leaf_ver = {k: v for k, v in self._leaf_ver.items() if k in live}
        self._leaf_cache = {k: v for k, v in self._leaf_cache.items()
                            if k in live}

    def _aggregate_state(self, name: str, members,
                         now: Optional[float] = None) -> WorkerState:
        """One aggregated WorkerState row over a set of *live* workers so
        stateful branch-level policies (deadline_aware) can score whole
        leaf branches: sums for queue/inflight/capacity, unions for warm
        sets, and the *best* free memory (a cold start needs one worker
        that fits, not average headroom). ``now`` prices warm-slot
        readiness: the dirty-lazy leaf path passes the leaf's last
        member-event time so a deferred aggregation reproduces the
        eagerly-refreshed row byte-for-byte. Inner-node rows use the
        row-based (staleness-respecting) variant in
        ``_resolve_node_state``."""
        if now is None:
            now = self.now
        q = infl = cap = 0
        qd: Dict[str, int] = {}
        fs: Dict[str, int] = {}
        warm: set = set()
        healthy = False
        mem = 0.0
        for wname in members:
            w = self.workers.get(wname)
            if w is None:
                continue
            q += len(w.queue)
            infl += w.inflight()
            cap += w.slots_total()
            if not w.healthy:
                continue
            healthy = True
            mem = max(mem, w.mem_free_mb())
            warm.update(w.warm_fns())
            for fn, n in w.queue.depths().items():
                qd[fn] = qd.get(fn, 0) + n
            for fn, n in w.fn_free_slots(now).items():
                fs[fn] = fs.get(fn, 0) + n
        return WorkerState(
            worker=name, queue_len=q, inflight=infl, capacity=cap,
            warm_fns=frozenset(warm), healthy=healthy, fn_queue=qd,
            fn_free_slots=fs, mem_free_mb=mem)

    def _refresh_branch_view(self, leaf: str):
        self.view.update(
            self._aggregate_state(leaf, self._leaf_members.get(leaf, ())),
            self.now)

    def _resolve_node_state(self, name: str, t: float):
        """StateView fallback for branch-level node names.

        *Leaf* rows are dirty-lazy: a member event
        only stamps the leaf's dirty time; the O(leaf_size × fns)
        aggregation is deferred to the next routing read and cached
        until the next member event. Aggregating the *live* members at
        the recorded dirty time reproduces exactly what the old eager
        refresh computed then — worker state only changes on member
        events (the one exception, a control-plane ``prewarm`` between
        member events, becomes visible one read earlier, which is
        strictly fresher information). A leaf with no member event yet
        resolves to None (the blind default), as under the eager scheme.

        *Inner* (non-leaf) names aggregate the members' per-worker *view
        rows* — not live workers — so upper-level scoring sees exactly
        the staleness the StateView models; cached until a member
        refreshes (dirty-tracked in ``_refresh_view``) or the stale
        snapshot rotates. 2-level trees, whose scored children are all
        leaves, never pay for the inner-node machinery."""
        dirty_t = self._leaf_dirty_t.get(name)
        if dirty_t is not None:
            ver = self._leaf_ver[name]
            cached = self._leaf_cache.get(name)
            if cached is not None and cached[0] == ver:
                return cached[1]
            row = self._aggregate_state(
                name, self._leaf_members.get(name, ()), now=dirty_t)
            self._leaf_cache[name] = (ver, row)
            return row
        members = self._node_workers.get(name)
        if members is None:
            return None
        if (self.view.staleness_s > 0
                and self._node_cache_stale_t != self.view._stale_t):
            self._node_cache.clear()        # stale snapshot rotated
            self._node_cache_stale_t = self.view._stale_t
        if name in self._node_dirty or name not in self._node_cache:
            q = infl = cap = 0
            qd: Dict[str, int] = {}
            fs: Dict[str, int] = {}
            warm: set = set()
            healthy = False
            mem = 0.0
            for wname in members:
                ws = self.view.get(wname, t)   # staleness-respecting row
                q += ws.queue_len
                infl += ws.inflight
                cap += ws.capacity
                if not ws.healthy:
                    continue
                healthy = True
                mem = max(mem, ws.mem_free_mb)
                warm.update(ws.warm_fns)
                for fn, n in ws.fn_queue.items():
                    qd[fn] = qd.get(fn, 0) + n
                for fn, n in ws.fn_free_slots.items():
                    fs[fn] = fs.get(fn, 0) + n
            self._node_cache[name] = WorkerState(
                worker=name, queue_len=q, inflight=infl, capacity=cap,
                warm_fns=frozenset(warm), healthy=healthy, fn_queue=qd,
                fn_free_slots=fs, mem_free_mb=mem)
            self._node_dirty.discard(name)
        return self._node_cache[name]

    def _refresh_view(self, w: Worker):
        if not self._view_needed:    # stateless tree: nothing reads rows
            return
        if self._fn_view_needed:     # only per-fn routing pays for the dicts
            state = WorkerState(
                worker=w.name, queue_len=len(w.queue), inflight=w.inflight(),
                capacity=w.slots_total(), warm_fns=w.warm_fns(),
                healthy=w.healthy, fn_queue=w.queue.depths(),
                fn_free_slots=w.fn_free_slots(self.now),
                mem_free_mb=w.mem_free_mb())
        else:
            state = WorkerState(
                worker=w.name, queue_len=len(w.queue), inflight=w.inflight(),
                capacity=w.slots_total(), warm_fns=w.warm_fns(),
                healthy=w.healthy)
        self.view.update(state, self.now)
        if self._branch_view_needed:
            leaf = self._leaf_of.get(w.name)
            if leaf is not None:
                if self.view.staleness_s > 0:
                    # the stale-snapshot rotation needs leaf rows stored
                    # in the StateView; keep the eager refresh here (the
                    # dirty-lazy path models staleness == 0 only)
                    self._refresh_branch_view(leaf)
                else:
                    self._leaf_dirty_t[leaf] = self.now
                    self._leaf_ver[leaf] = self._leaf_ver.get(leaf, 0) + 1
            anc = self._worker_ancestors.get(w.name)
            if anc:
                self._node_dirty.update(anc)

    # -------------------------------------------------------------- helpers
    def fn_cost(self, fn: str) -> float:
        if fn not in self._fn_cost:
            from repro_torch.configs import get_config
            try:
                arch = self.store.get(fn).arch
                self._fn_cost[fn] = get_config(arch).param_count() / 1e7
            except Exception:
                self._fn_cost[fn] = 1.0
        return self._fn_cost[fn]

    def load(self, workload) -> int:
        """Submit every request of a ``repro.workloads`` workload;
        returns the request count. A workload carrying a fault plan
        (``workload.faults``, set by chaos scenarios) attaches it,
        unless the simulator already has one."""
        faults = getattr(workload, "faults", None)
        if faults is not None and self.faults is None:
            self.attach_faults(faults)
        gateway = getattr(workload, "gateway", None)
        if gateway is not None and self.gateway is None:
            self.attach_gateway(gateway)
        return workload.submit_to(self)

    def load_bulk(self, workload, *, chunk: int = 1 << 18) -> int:
        """Vectorized counterpart of :meth:`load`: generate the
        workload's columnar ``RequestBatch`` (``generate_bulk``) and
        stream it into the event engine in ``chunk``-sized bulk runs —
        same fault-plan attachment and the same ``(t, seq)`` arrival
        stamps as per-request ``submit`` in arrival order, so the run
        is byte-identical to the submit loop, without the per-request
        scalar RNG walk. Also accepts a pre-built ``RequestBatch``.
        Note the *workload content* follows the bulk determinism
        contract (numpy streams), not the scalar one."""
        from repro_torch.workloads.workload import RequestBatch
        faults = getattr(workload, "faults", None)
        if faults is not None and self.faults is None:
            self.attach_faults(faults)
        gateway = getattr(workload, "gateway", None)
        if gateway is not None and self.gateway is None:
            self.attach_gateway(gateway)
        batch = (workload if isinstance(workload, RequestBatch)
                 else workload.generate_bulk())
        push_bulk = self.engine.push_bulk
        for sub in batch.iter_chunks(chunk):
            push_bulk(sub.arrival_t, "arrival", sub.to_requests())
        return len(batch)

    # ---------------------------------------------------------------- run
    def run(self, until: Optional[float] = None):
        """Drive the event engine until empty (or past ``until``).

        ``engine.pop(until)`` *peeks* before popping, so an event beyond
        the horizon stays in the queue untouched — a segmented
        ``run(until); run()`` is byte-identical to one straight ``run()``
        including ``events_processed`` (pinned in tests/test_events.py);
        there is no pop-and-requeue path left to double-count through."""
        engine = self.engine
        handlers = {k: getattr(self, "_on_" + k) for k in self._EVENT_KINDS}
        get_handler = handlers.get
        while True:
            entry = engine.pop(until)
            if entry is None:
                break
            t, _seq, kind, payload = entry
            self.now = t
            self.events_processed += 1
            h = get_handler(kind)
            if h is None:                  # custom kind pushed by a caller
                h = handlers[kind] = getattr(self, "_on_" + kind)
            h(payload)
        return self.results

    # ------------------------------------------------------------- events
    def _on_autoscale_tick(self, _payload):
        self.control.on_tick()

    def _on_arrival(self, req: Request):
        if req.hedged_from is None:
            self.arrivals_seen += 1
            self.arrivals_by_fn[req.fn] = self.arrivals_by_fn.get(req.fn,
                                                                  0) + 1
            # front door: every offered arrival traverses the gateway
            # before the LB tree; a shed is a terminal answer (not
            # retryable) recorded before any routing/telemetry happens
            if self.gateway is not None:
                verdict = self.gateway.admit(req, self.now)
                if self._record:
                    self.control.log_gateway("arrival", req, verdict)
                if verdict is not None:
                    self._record_fail(req, verdict)
                    return
        else:
            # hedge clones are the platform's own speculation, not
            # offered load: counting them as arrivals fed the autoscaler
            # synthetic demand that grew with its own hedging
            self.hedges_seen += 1
        # healthy set is tracked incrementally; the full list is only
        # materialised on the rare stale-routing re-roll (the seed built
        # it on every arrival: O(fleet) on the hottest event)
        if self._healthy_count == 0:
            self._record_fail(req, "no healthy workers")
            return
        if (self.view.estimator is not None
                and req.fn not in self.view.fn_memory):
            # deadline routing needs the fn's footprint to spot workers
            # where a cold start is memory-blocked
            self.view.fn_memory[req.fn] = self.store.get(req.fn).memory_mb
        wid, hops = self.tree.route(req, self.view, self.rng, self.now)
        rerolled = not self.workers[wid].healthy   # stale routing
        if rerolled:
            wid = self._reroute_healthy(req, wid)
        if self._record:
            self.control.log_routing("arrival_reroll" if rerolled
                                     else "arrival", req, wid)
        w = self.workers[wid]
        cfg = self.store.get(req.fn)
        if self.collect_telemetry:
            self.telemetry.append(TelemetryRecord(
                fn=req.fn, t=self.now, queue_len=len(w.queue),
                inflight=w.inflight(), batch_size=0, cold=False,
                prompt_tokens=req.size, gen_tokens=cfg.gen_tokens,
                fn_cost=self.fn_cost(req.fn), latency=0.0, ok=True))
            req._telemetry_idx = len(self.telemetry) - 1
        req._worker = wid
        self._push(self.now + self.hop_s * hops, "enqueue", req)
        if self.hedge_after_s is not None and req.hedged_from is None:
            self._push(self.now + self.hedge_after_s, "maybe_hedge", req)

    def _on_reroute(self, req: Request):
        """Send a displaced request (its worker's branch was removed)
        through the shrunk tree. Unlike an arrival this reuses the
        request's telemetry record and hedge timer — it is the same
        request, not new offered load."""
        self._route_displaced(req, "reroute")

    def _on_retry(self, req: Request):
        """A retry backoff expired: re-offer the request through the
        tree (it may have finished meanwhile via a hedge — then drop)."""
        self._retries_pending -= 1
        primary = req.hedged_from if req.hedged_from is not None else req.rid
        if primary in self._finished:
            self.retries_dropped += 1
            return
        # the front door is consulted on retries too: re-offering a
        # request into a saturated platform is exactly the storm shape
        # admission control exists to refuse
        if self.gateway is not None:
            verdict = self.gateway.admit(req, self.now, retry=True)
            if self._record:
                self.control.log_gateway("retry", req, verdict)
            if verdict is not None:
                self._record_fail(req, verdict)
                return
        self._route_displaced(req, "retry")

    def _reroute_healthy(self, req: Request, wid: str) -> str:
        """The routed worker turned unhealthy between state publication
        and this hop: re-score the healthy fleet with the *leaf policy*
        that produced the stale pick. The old uniform
        ``rng.choice(healthy)`` re-roll bypassed placement/deadline
        scoring entirely (a deadline_aware tree degraded to random
        exactly when capacity was scarcest). Fault-free runs never take
        this path, so their goldens are untouched."""
        healthy = [w for w in self._worker_list if self.workers[w].healthy]
        leaf = self._leaf_nodes.get(self._leaf_of.get(wid, ""))
        if leaf is None:                 # no owning leaf (defensive)
            return self.rng.choice(healthy)
        return leaf._policy(req, healthy, self.view, self.rng, self.now)

    def _route_displaced(self, req: Request, kind: str):
        if self._healthy_count == 0:
            self._record_fail(req, "no healthy workers")
            return
        wid, hops = self.tree.route(req, self.view, self.rng, self.now)
        rerolled = not self.workers[wid].healthy   # stale routing
        if rerolled:
            wid = self._reroute_healthy(req, wid)
        if self._record:
            # the _reroll suffix records the hop itself, so a decision-log
            # replay/audit can see the displaced pick was policy-scored
            self.control.log_routing(f"{kind}_reroll" if rerolled else kind,
                                     req, wid)
        req._worker = wid
        self._push(self.now + self.hop_s * hops, "enqueue", req)

    def _on_maybe_hedge(self, req: Request):
        if req.rid in self._finished:
            return
        # the clone's rid derives from the primary (-rid - 1), not the
        # process-global counter: workload rids are >= 0 so clone ids
        # cannot collide, and two same-seed runs in one process now
        # produce byte-identical routing logs (the global counter kept
        # advancing across runs). Clones never hedge again, so the
        # mapping needn't nest.
        clone = Request(fn=req.fn, arrival_t=self.now, payload=req.payload,
                        size=req.size, rid=-req.rid - 1,
                        hedged_from=req.rid, deadline_t=req.deadline_t,
                        priority=req.priority,
                        wf=req.wf, stage=req.stage, wf_task=req.wf_task,
                        wf_critical=req.wf_critical,
                        wf_affinity=req.wf_affinity)
        # keep a handle on the primary so record_result can resolve its
        # telemetry row when the clone wins the race
        clone._primary = req
        self._on_arrival(clone)

    def _on_fault(self, payload):
        if self.faults is not None:
            self.faults.on_event(payload)

    def _on_workflow_done(self, payload):
        if self.workflows is not None:
            self.workflows.fire(self, payload)

    def _on_fail(self, worker: str):
        w = self.workers.get(worker)
        if w is None:                   # branch already scaled away
            self._draining.pop(worker, None)
            return
        if w.healthy:
            self._healthy_count -= 1
        w.healthy = False
        for req in w.queue.drain_all():
            self._record_fail(req, "worker died")
        w.clear_instances()
        self._refresh_view(w)

    def _on_recover(self, worker: str):
        w = self.workers.get(worker)
        if w is None:
            return
        if not w.healthy:
            self._healthy_count += 1
        w.healthy = True
        self._refresh_view(w)

    # ------------------------------------------------- worker-runtime seam
    # The mechanics live on repro.core.worker.WorkerRuntime (self.runtime);
    # these methods are the override/patch seam — the runtime re-enters
    # through them, so intercepting here catches every internal path.
    def _on_enqueue(self, req: Request):
        self.runtime.enqueue(req)

    def _on_poke(self, worker: str):
        self.runtime.on_poke(worker)

    def _on_finish(self, payload):
        self.runtime.finish(payload)

    def _on_idle_check(self, payload):
        self.runtime.idle_check(payload)

    def _dispatch(self, w: Worker):
        self.runtime.dispatch(w)

    def _maybe_start_instance(self, w: Worker, cfg) -> Optional[Instance]:
        return self.runtime.maybe_start_instance(w, cfg)

    def _start_service(self, w: Worker, inst: Instance, req: Request, cfg,
                       queue_len: int):
        self.runtime.start_service(w, inst, req, cfg, queue_len)

    def _poke(self, w: Worker, t: float):
        self.runtime.poke(w, t)

    # ------------------------------------------------------ result recording
    def _resolve_telemetry(self, req: Request, ok: bool) -> None:
        """Resolve a request's placeholder telemetry row (created at
        arrival with ``latency=0.0, ok=True``) to its final outcome.
        Guarded: a request that failed *before* routing ("no healthy
        workers" at arrival) never got a row — dereferencing the missing
        index used to crash the retry-after-recovery path. Resolution is
        exactly-once: clearing the index keeps a hedge loser's late
        completion from clobbering the end-to-end outcome the winner
        already stamped on the primary's row."""
        if not self.collect_telemetry:
            return
        idx = getattr(req, "_telemetry_idx", None)
        if idx is None:
            return
        rec = self.telemetry[idx]
        rec.latency = self.now - req.arrival_t
        rec.ok = ok
        req._telemetry_idx = None

    def record_result(self, req: Request, *, start_t: float, ok: bool,
                      cold: bool, worker: str, instance: str) -> bool:
        """Record a completion for ``req`` (resolving hedge races to the
        primary rid); returns False when a faster hedge already won."""
        # rid 0 is falsy, so `or` would misattribute a hedge of request 0
        primary = req.hedged_from if req.hedged_from is not None else req.rid
        if primary in self._finished:
            # hedge lost the race: no result row, but this attempt's own
            # telemetry row still resolves (it used to stay at the
            # placeholder forever)
            self._resolve_telemetry(req, ok)
            return False
        self._finished.add(primary)
        if self.gateway is not None:
            # the slot was taken at the primary's admit; a winning clone
            # carries the primary handle so the release targets the
            # object holding the admit stamp
            self.gateway.release(getattr(req, "_primary", req), self.now)
        res = RequestResult(rid=primary, fn=req.fn, ok=ok,
                            arrival_t=req.arrival_t, start_t=start_t,
                            finish_t=self.now, cold_start=cold,
                            worker=worker, instance=instance,
                            wf=req.wf, stage=req.stage)
        self.results.append(res)
        if self.view.estimator is not None and ok:
            # deadline routing prices backlogs with this windowed
            # observation; fed in result order, so it is deterministic
            self.view.estimator.observe(req.fn, res.service_time)
        self._resolve_telemetry(req, ok)
        if req.hedged_from is not None:
            # the clone won: resolve the primary's row with the same
            # end-to-end outcome (same latency math: now - arrival)
            prim = getattr(req, "_primary", None)
            if prim is not None:
                self._resolve_telemetry(prim, ok)
        if self.workflows is not None and req.wf is not None:
            self.workflows.on_stage_done(self, req, ok, worker)
        return True

    def _record_fail(self, req: Request, err: str):
        primary = req.hedged_from if req.hedged_from is not None else req.rid
        if primary in self._finished:
            # hedge race already settled: no result row, but this losing
            # attempt's own telemetry row still resolves (exactly-once
            # keeps the settled primary row untouched)
            self._resolve_telemetry(req, False)
            return
        # retry budget: resurrect infrastructure failures with capped
        # exponential backoff. Hedge clones don't retry (the primary's
        # own path still stands); the storm guard sheds retries beyond
        # retry_storm_cap concurrently pending so a zone-sized blast
        # wave can't multiply itself back into the queue instantly.
        if (self.retry_budget > 0 and err in RETRYABLE_ERRORS
                and req.hedged_from is None):
            tried = getattr(req, "_retries", 0)
            if tried < self.retry_budget:
                if self._retries_pending >= self.retry_storm_cap:
                    self.retries_shed += 1
                else:
                    req._retries = tried + 1
                    self._retries_pending += 1
                    self.retries_scheduled += 1
                    backoff = min(self.retry_backoff_s * (2.0 ** tried),
                                  self.retry_backoff_cap_s)
                    self._push(self.now + backoff, "retry", req)
                    return
        self._finished.add(primary)
        if self.gateway is not None:
            # terminal failure settles the request: free its admission
            # slot (no-op for gateway-shed requests — never admitted)
            self.gateway.release(getattr(req, "_primary", req), self.now)
        self.results.append(RequestResult(
            rid=primary, fn=req.fn, ok=False, arrival_t=req.arrival_t,
            start_t=self.now, finish_t=self.now, cold_start=False,
            worker=getattr(req, "_worker", "?"), instance="-", error=err,
            wf=req.wf, stage=req.stage))
        # failed rows used to keep their placeholder latency=0.0,
        # ok=True, poisoning the RQ-B training set with "instant
        # successes" — resolve them exactly like completions do
        self._resolve_telemetry(req, False)
        if req.hedged_from is not None:
            prim = getattr(req, "_primary", None)
            if prim is not None:
                self._resolve_telemetry(prim, False)
        if self.workflows is not None and req.wf is not None:
            self.workflows.on_stage_done(self, req, False, None)


# ---------------------------------------------------------------------------
# Load generation + metrics
# ---------------------------------------------------------------------------

def poisson_load(sim: Simulator, *, fn: str, rps: float, duration_s: float,
                 prompt_tokens: int = 16, seed: int = 1):
    """Legacy single-function Poisson load; now a thin shim over the
    workload subsystem (``repro.workloads``). ``rid_base=None`` keeps the
    process-global request-id counter this entry point always used."""
    from repro_torch.workloads import (FunctionProfile, MixedWorkload,
                                 PoissonArrivals, SizeDist)
    wl = MixedWorkload(
        PoissonArrivals(rps),
        [FunctionProfile(fn, size=SizeDist.const(prompt_tokens))],
        duration_s=duration_s, seed=seed, rid_base=None)
    return sim.load(wl)


def stream_digest(sim) -> str:
    """sha256[:16] over a run's full result + telemetry + workflow
    streams — THE byte-identity projection every golden/equivalence
    suite compares (one definition, so the suites can never drift apart
    on which fields "byte-identical" covers). Accepts anything exposing
    ``results`` / ``telemetry`` / ``workflow_results`` — a
    :class:`Simulator` or a ``repro.parallel.MergedRun``."""
    import hashlib
    h = hashlib.sha256()
    for r in sim.results:
        h.update(repr((r.rid, r.fn, r.ok, r.arrival_t, r.start_t, r.finish_t,
                       r.cold_start, r.worker, r.instance, r.error)).encode())
    for t in sim.telemetry:
        h.update(repr((t.fn, t.t, t.queue_len, t.inflight, t.batch_size,
                       t.cold, t.latency, t.ok)).encode())
    for w in getattr(sim, "workflow_results", ()):
        h.update(repr((w.wf, w.name, w.ok, w.arrival_t, w.finish_t,
                       w.tasks, w.error)).encode())
    return h.hexdigest()[:16]


def part_summary(results) -> dict:
    """Mergeable partial of :func:`summarize` over one result stream
    (a partition's share): raw counts plus the ok-latency sample, so
    :func:`merge_part_summaries` reproduces ``summarize`` over the
    union exactly (percentiles are order-invariant)."""
    import numpy as np
    lat, ok, served, cold = [], 0, 0, 0
    t0 = float("inf")
    t1 = -float("inf")
    n = 0
    for r in results:
        n += 1
        t0 = min(t0, r.arrival_t)
        if r.instance != "-":
            served += 1
        if r.cold_start:
            cold += 1
        if r.ok:
            ok += 1
            lat.append(r.latency)
            t1 = max(t1, r.finish_t)
    return {"n": n, "ok": ok, "served": served, "cold": cold,
            "lat": np.asarray(lat, dtype=np.float64),
            "t0": t0, "t1": t1}


def merge_part_summaries(parts) -> dict:
    """Combine :func:`part_summary` partials into the exact dict
    :func:`summarize` computes over the concatenated results."""
    import numpy as np
    parts = [p for p in parts if p["n"]]
    if not parts:
        return {"n": 0}
    n = sum(p["n"] for p in parts)
    ok = sum(p["ok"] for p in parts)
    served = sum(p["served"] for p in parts)
    cold = sum(p["cold"] for p in parts)
    lat = np.concatenate([p["lat"] for p in parts])
    t0 = min(p["t0"] for p in parts)
    t1 = max((p["t1"] for p in parts if p["ok"]), default=t0)
    makespan = t1 - t0
    goodput = ok / max(makespan, 1e-9) if ok else 0.0
    return {
        "n": n, "ok": ok, "fail_rate": 1 - ok / n,
        "cold_rate": cold / served if served else 0.0,
        "p50": float(np.percentile(lat, 50)) if len(lat) else float("nan"),
        "p95": float(np.percentile(lat, 95)) if len(lat) else float("nan"),
        "p99": float(np.percentile(lat, 99)) if len(lat) else float("nan"),
        "mean": float(lat.mean()) if len(lat) else float("nan"),
        "throughput": goodput,
        "goodput": goodput,
    }


def summarize(results: List[RequestResult]) -> dict:
    import numpy as np
    if not results:
        return {"n": 0}
    lat = np.array([r.latency for r in results if r.ok])
    ok = sum(r.ok for r in results)
    # cold_rate over *served* rows only: failures that never reached an
    # instance (gateway sheds, dead-on-arrival routing, queue timeouts —
    # their instance column is "-") can't have had a cold start, so
    # counting them in the denominator understated the rate under load
    served = sum(1 for r in results if r.instance != "-")
    # throughput/goodput over the useful makespan: last *successful*
    # finish minus first arrival. Using failed rows' finish_t let one
    # late queue-timeout tail (arrival + timeout_s) stretch the window
    # and dilute the rate; arrivals still span all rows so a run whose
    # first arrival is at t0 > 0 (daily_cycle offsets, resumed
    # run(until)) isn't credited for the empty [0, t0) prefix
    t0 = min(r.arrival_t for r in results)
    t1 = max((r.finish_t for r in results if r.ok), default=t0)
    makespan = t1 - t0
    goodput = ok / max(makespan, 1e-9) if ok else 0.0
    return {
        "n": len(results), "ok": ok, "fail_rate": 1 - ok / len(results),
        "cold_rate": (sum(r.cold_start for r in results) / served
                      if served else 0.0),
        "p50": float(np.percentile(lat, 50)) if len(lat) else float("nan"),
        "p95": float(np.percentile(lat, 95)) if len(lat) else float("nan"),
        "p99": float(np.percentile(lat, 99)) if len(lat) else float("nan"),
        "mean": float(lat.mean()) if len(lat) else float("nan"),
        "throughput": goodput,
        "goodput": goodput,
    }
