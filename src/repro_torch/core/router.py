"""The load-balancer tree (paper Fig. 1 / §II).

The port's own copy of the JAX package's ``core/router.py``, which holds no
JAX: the port imports nothing of that package.

Every node exposes the same ``route(request) -> leaf worker id`` interface;
inner nodes pick a child, leaves pick a worker. "To scale the system up by a
factor of two, simply replicate the existing servers and add a load balancer
in front to randomly assign requests to one branch" — that recipe is
:func:`replicate`.

Policies are pluggable and split exactly along the paper's stateless/stateful
axis: stateless ones look only at the request; stateful ones read worker-state
snapshots (queue depth, in-flight, warm instances) through a ``StateView`` —
which the testbed can delay/stale-ify to study the cost of state freshness.
"""
from __future__ import annotations

import random
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Sequence

from repro_torch.core.types import Request


@dataclass
class WorkerState:
    """Snapshot a stateful LB reads (possibly stale)."""
    worker: str
    queue_len: int = 0
    inflight: int = 0
    capacity: int = 1                  # slots across warm instances
    warm_fns: frozenset = frozenset()
    healthy: bool = True
    # per-function depth: queued requests and immediately-usable warm
    # slots by fn — what lets least-loaded routing become warm-aware
    fn_queue: Mapping[str, int] = field(default_factory=dict)
    fn_free_slots: Mapping[str, int] = field(default_factory=dict)
    # free replica memory on the worker (inf when uncapped) — the
    # placement layer's routing-visible signal
    mem_free_mb: float = float("inf")

    @property
    def load(self) -> float:
        return (self.queue_len + self.inflight) / max(self.capacity, 1)

    def fn_depth(self, fn: str) -> int:
        """Queued requests for one function on this worker."""
        return self.fn_queue.get(fn, 0)


class StateView:
    """Worker-state source with optional staleness (simulated gRPC lag)."""

    #: fallback per-request service estimate before any completion is seen
    DEFAULT_SERVICE_S = 0.05

    def __init__(self, staleness_s: float = 0.0):
        self.staleness_s = staleness_s
        self._now: Dict[str, WorkerState] = {}
        self._stale: Dict[str, WorkerState] = {}
        self._stale_t: float = -1e30
        # windowed per-fn service-time source (repro.autoscale.metrics.
        # ServiceEstimator); attached by the simulator only when the tree
        # routes with a deadline-aware policy
        self.estimator = None
        self.cold_start_est_s = 0.25   # routing-visible cold-start guess
        # per-function replica footprint (filled by the simulator from the
        # config store): lets deadline routing see that a cold start on a
        # memory-full worker cannot even begin
        self.fn_memory: Dict[str, float] = {}
        # placer-aware pricing of memory-blocked cold starts: when set
        # (Simulator(mem_eta="placer")), deadline routing asks the
        # placement layer for a graded unblock ETA instead of the flat
        # MEM_BLOCKED_PENALTY_S surcharge. None (default) keeps the
        # flat penalty — standalone router use and every pre-existing
        # golden are byte-identical.
        self.mem_eta = None
        # fallback for names with no stored row — the simulator resolves
        # *inner* LB-node names to lazily-aggregated subtree states, so
        # deadline routing stays informed above the leaf level in trees
        # deeper than two levels
        self.node_resolver = None

    def service_est(self, fn: str) -> float:
        """Expected per-request service time for one function (windowed
        observation when an estimator is attached, a flat prior before)."""
        if self.estimator is None:
            return self.DEFAULT_SERVICE_S
        return self.estimator.estimate(fn)

    def update(self, state: WorkerState, t: float = 0.0):
        self._now[state.worker] = state
        if t - self._stale_t >= self.staleness_s:
            self._stale = dict(self._now)
            self._stale_t = t

    def get(self, worker: str, t: float = 0.0) -> WorkerState:
        src = self._now if self.staleness_s == 0 else self._stale
        state = src.get(worker)
        if state is None and self.node_resolver is not None:
            state = self.node_resolver(worker, t)
        # build the empty default lazily: get() runs once per candidate
        # worker on every routing decision
        return state if state is not None else WorkerState(worker)


# ---------------------------------------------------------------------------
# Policies: (request, worker_ids, view, rng, t) -> worker_id
# ---------------------------------------------------------------------------

def random_policy(req, workers, view, rng, t):
    return workers[rng.randrange(len(workers))]


def round_robin_policy():
    state = {"i": 0}

    def policy(req, workers, view, rng, t):
        # post-increment so the very first call lands on workers[0]
        w = workers[state["i"] % len(workers)]
        state["i"] += 1
        return w
    return policy


def hash_policy(req, workers, view, rng, t):
    return workers[hash((req.fn, req.rid // 64)) % len(workers)]


def tenant_index(name: str, n: int) -> int:
    """Stable tenant → bucket assignment (crc32, not Python ``hash`` —
    which is salted per process and would break cross-process
    byte-identity). Shared by :func:`tenant_hash_policy` and the
    parallel partition planner (``repro.parallel``), so a serial tree
    whose root routes with ``tenant_hash`` sends every tenant to
    exactly the branch the partitioned run owns it in."""
    return zlib.crc32(name.encode()) % max(n, 1)


def tenant_hash_policy(req, workers, view, rng, t):
    """Pin each tenant (function) to one child, deterministically and
    with **no RNG and no state**: the exact "tenants don't share
    branches" shape under which partition-local gateway quota splitting
    is equivalent to a global front door (multi_tenant / noisy_neighbor
    / Azure-trace mixes). Consuming no RNG is what makes a serial run
    over the union tree byte-identical to the per-partition runs."""
    return workers[tenant_index(req.fn, len(workers))]


def least_loaded_policy(req, workers, view, rng, t):
    return min(workers, key=lambda w: (view.get(w, t).load, rng.random()))


def pow2_policy(req, workers, view, rng, t):
    """Power of two choices — near-optimal with O(1) state reads."""
    a, b = rng.sample(range(len(workers)), 2) if len(workers) > 1 else (0, 0)
    wa, wb = workers[a], workers[b]
    return wa if view.get(wa, t).load <= view.get(wb, t).load else wb


def warm_affinity_policy(req, workers, view, rng, t):
    """Prefer least-loaded worker holding a warm instance of req.fn."""
    warm = [w for w in workers if req.fn in view.get(w, t).warm_fns]
    pool = warm or workers
    return min(pool, key=lambda w: (view.get(w, t).load, rng.random()))


def warm_least_loaded_policy(req, workers, view, rng, t):
    """Least-loaded among workers with a *free warm slot* for req.fn.

    Sharper than ``warm_affinity`` (which only knows the binary warm set):
    a worker whose replicas of req.fn are all saturated counts as cold
    here, and ties break on the function's own queue depth before the
    worker-wide load — per-function state from the scheduling core."""
    states = [(w, view.get(w, t)) for w in workers]   # one lookup per worker
    warm = [ws for ws in states if ws[1].fn_free_slots.get(req.fn, 0) > 0]
    pool = warm or states
    return min(pool, key=lambda ws: (ws[1].fn_depth(req.fn), ws[1].load,
                                     rng.random()))[0]


# ETA surcharge for a cold start that cannot begin (no replica memory
# free on the worker): finite so a fully-blocked fleet still ranks
# deterministically by backlog, huge so any startable worker wins
MEM_BLOCKED_PENALTY_S = 1e6


def deadline_aware_policy(req, workers, view, rng, t):
    """Route to the branch most likely to meet the request's deadline.

    Predicted completion time on a worker combines warm-replica
    availability with the function's queued backlog priced at the
    windowed per-request service estimate (``view.service_est``, fed by
    ``repro.autoscale.metrics.ServiceEstimator``):

    - free warm slots: own service + backlog draining across those slots
    - warm but saturated: wait a full service turn per queued request
    - no warm replica: the same, plus one cold start

    A cold start on a worker without free replica memory for the
    function cannot even begin until something idles out there — those
    workers take a large ETA penalty instead of masquerading as lightly
    loaded (idle big-footprint replicas otherwise *attract* traffic
    they can never serve).

    The ETA is scored against the request's ``slo_p95_s``-derived
    absolute deadline: workers predicted to *meet* it beat workers
    predicted to blow it, then lower ETA wins, then lower worker-wide
    load. Requests with no deadline degrade to pure ETA routing."""
    svc = view.service_est(req.fn)
    need_mb = view.fn_memory.get(req.fn, 0.0)
    slack = (req.deadline_t - t if req.deadline_t is not None
             else float("inf"))
    scored = []
    for w in workers:
        ws = view.get(w, t)
        free = ws.fn_free_slots.get(req.fn, 0)
        depth = ws.fn_depth(req.fn)
        if free > 0:
            eta = svc * (1.0 + depth / free)
        else:
            eta = svc * (depth + 2.0)
            if req.fn not in ws.warm_fns:
                eta += view.cold_start_est_s
                if ws.mem_free_mb < need_mb:
                    # flat penalty by default; with a placer-aware hook
                    # attached, price the *wait until the deficit frees*
                    # instead — a nearly-free idle worker can then beat
                    # a startable-but-drowning one (carried ROADMAP
                    # follow-on, A/B'd in tests/test_placement.py)
                    if view.mem_eta is None:
                        eta += MEM_BLOCKED_PENALTY_S
                    else:
                        eta += view.mem_eta(need_mb, ws.mem_free_mb, svc,
                                            depth, ws.inflight)
        scored.append((eta > slack, eta, ws.load, rng.random(), w))
    return min(scored)[-1]


# workflow_aware knob: price of a cold start on the DAG's critical
# path, as a multiple of the plain cold-start estimate. A queueing
# delay on the critical path is inherited by every successor stage,
# while a cold start is paid once and buys a replica that serves the
# rest of the run — so the critical path buys capacity *eagerly*
# (multiplier < 1) instead of piling onto the warm hotspot. Measured
# on ml_pipeline/etl_fanout across seeds: 0.2 beats both the neutral
# price (1.0) and wait-for-warm over-pricing (4.0) on e2e p95.
WF_CRITICAL_COLD_MULT = 0.2


def workflow_aware_policy(req, workers, view, rng, t):
    """``deadline_aware`` with DAG context: critical-path-slack routing
    for workflow stage tasks.

    Same ETA model as :func:`deadline_aware_policy`, with three
    workflow-specific asymmetries read off the request's stamped DAG
    context (plain requests carry none of it and degrade to exactly
    the deadline score shape):

    - a stage on the workflow's *critical path* (``wf_critical``)
      prices cold starts at ``WF_CRITICAL_COLD_MULT``× (< 1): queueing
      delay there is inherited one-for-one by every successor stage,
      while a cold start is paid once — the critical path buys fresh
      capacity eagerly rather than stacking onto the warm hotspot;
    - the worker (and leaf branch) that served the triggering
      predecessor (``wf_affinity``) wins *ties*: at equal predicted
      ETA and load, chained stages co-locate onto the already-warm
      path instead of scattering by RNG tiebreak. Affinity never
      overrides a genuine ETA difference — a multiplicative discount
      was tried and herds chains onto stale-view hotspots;
    - fan-out siblings (``wf_task`` = k > 0) place by *waterfill*:
      a map wave's tasks route back-to-back at one timestamp on an
      identical frozen state snapshot (worker rows only refresh after
      the enqueue hop), so stage-blind min-ETA herds the entire
      fan-out onto one worker and the join waits on that self-made
      hotspot. Because every sibling sees the same snapshot and the
      same deterministic rule, sibling k re-derives where siblings
      0..k-1 landed, charges each landing a virtual queue slot, and
      takes the k-th greedy pick — spreading the wave exactly as a
      sequential scheduler with perfect information would.
    """
    svc = view.service_est(req.fn)
    need_mb = view.fn_memory.get(req.fn, 0.0)
    slack = (req.deadline_t - t if req.deadline_t is not None
             else float("inf"))
    cold_price = view.cold_start_est_s * (WF_CRITICAL_COLD_MULT
                                          if req.wf_critical else 1.0)
    aff = req.wf_affinity
    rows = []
    for w in workers:
        ws = view.get(w, t)
        rows.append((w, ws, ws.fn_free_slots.get(req.fn, 0),
                     ws.fn_depth(req.fn), req.fn in ws.warm_fns,
                     ws.mem_free_mb < need_mb, rng.random()))

    def eta_of(row, extra):
        _w, _ws, free, depth, warm, blocked, _r = row
        if free > 0 and depth + extra < free:
            return svc * (1.0 + (depth + extra) / free)
        eta = svc * (depth + extra + 2.0)
        if not warm:
            eta += cold_price
            if blocked:
                eta += MEM_BLOCKED_PENALTY_S
        return eta

    def key_of(row, extra):
        eta = eta_of(row, extra)
        near = 0 if (aff is not None and row[0] in aff) else 1
        return (eta > slack, eta, row[1].load, near, row[6])

    if req.wf_task:
        extra = dict.fromkeys((r[0] for r in rows), 0)
        pick = rows[0][0]
        for _ in range(req.wf_task + 1):
            pick = min(rows, key=lambda r: key_of(r, extra[r[0]]))[0]
            extra[pick] += 1
        return pick
    return min(rows, key=lambda r: key_of(r, 0))[0]


POLICIES: Dict[str, Callable] = {
    "random": lambda: random_policy,
    "round_robin": round_robin_policy,
    "hash": lambda: hash_policy,
    "tenant_hash": lambda: tenant_hash_policy,
    "least_loaded": lambda: least_loaded_policy,
    "pow2": lambda: pow2_policy,
    "warm_affinity": lambda: warm_affinity_policy,
    "warm_least_loaded": lambda: warm_least_loaded_policy,
    "deadline_aware": lambda: deadline_aware_policy,
    "workflow_aware": lambda: workflow_aware_policy,
}

STATELESS = {"random", "round_robin", "hash", "tenant_hash"}


# ---------------------------------------------------------------------------
# Tree
# ---------------------------------------------------------------------------

@dataclass
class LBNode:
    name: str
    policy_name: str
    children: List["LBNode"] = field(default_factory=list)
    workers: List[str] = field(default_factory=list)     # leaf only
    _policy: Callable = None

    def __post_init__(self):
        self._policy = POLICIES[self.policy_name]()
        self._child_names: List[str] = [c.name for c in self.children]
        self._child_idx: Dict[str, "LBNode"] = {c.name: c
                                                for c in self.children}

    @property
    def is_leaf(self) -> bool:
        return bool(self.workers)

    def route(self, req: Request, view: StateView, rng: random.Random,
              t: float = 0.0, _hops: int = 0) -> tuple:
        """Returns (worker_id, hops)."""
        if self.is_leaf:
            return self._policy(req, self.workers, view, rng, t), _hops + 1
        child = self._policy(req, self._child_names, view, rng, t)
        return self._child_idx[child].route(req, view, rng, t, _hops + 1)

    def all_workers(self) -> List[str]:
        if self.is_leaf:
            return list(self.workers)
        out = []
        for c in self.children:
            out.extend(c.all_workers())
        return out

    # ---- elasticity (paper's scaling recipe + live add/remove) ----------
    def add_branch(self, node: "LBNode"):
        assert not self.is_leaf, "cannot add a branch to a leaf"
        self.children.append(node)
        self._child_names.append(node.name)
        self._child_idx[node.name] = node

    def remove_branch(self, name: str):
        self.children = [c for c in self.children if c.name != name]
        self._child_names = [c.name for c in self.children]
        self._child_idx = {c.name: c for c in self.children}


def build_leaf(name: str, workers: Sequence[str],
               policy: str = "least_loaded") -> LBNode:
    return LBNode(name, policy, workers=list(workers))


def build_tree(n_workers: int, fanout: int = 8, *,
               leaf_policy: str = "least_loaded",
               inner_policy: str = "random",
               prefix: str = "lb") -> LBNode:
    """Balanced tree: leaves hold ≤ fanout workers; inner nodes ≤ fanout kids."""
    leaves = []
    for i in range(0, n_workers, fanout):
        ws = [f"w{j}" for j in range(i, min(i + fanout, n_workers))]
        leaves.append(build_leaf(f"{prefix}-leaf{i // fanout}", ws, leaf_policy))
    level = 0
    nodes = leaves
    while len(nodes) > 1:
        level += 1
        nxt = []
        for i in range(0, len(nodes), fanout):
            group = nodes[i:i + fanout]
            nxt.append(LBNode(f"{prefix}-l{level}n{i // fanout}", inner_policy,
                              children=group))
        nodes = nxt
    root = nodes[0]
    if root.is_leaf:
        # always have an inner root LB so branches can be added/removed live
        root = LBNode(f"{prefix}-root", inner_policy, children=[root])
    return root


def replicate(tree: LBNode, times: int = 2, *,
              inner_policy: str = "random") -> LBNode:
    """The paper's scale-by-k recipe: clone the subtree k-1 times (with fresh
    worker ids) and put a stateless LB in front."""
    def clone(node: LBNode, tag: str) -> LBNode:
        if node.is_leaf:
            return LBNode(f"{node.name}-{tag}", node.policy_name,
                          workers=[f"{w}-{tag}" for w in node.workers])
        return LBNode(f"{node.name}-{tag}", node.policy_name,
                      children=[clone(c, tag) for c in node.children])
    branches = [tree] + [clone(tree, f"r{i}") for i in range(1, times)]
    return LBNode("lb-root", inner_policy, children=branches)
