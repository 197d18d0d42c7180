"""Workflow layer: stage DAGs composed on top of the workload substrate.

The port's own copy of the JAX package's ``workloads/workflows.py``, which holds no
JAX: the port imports nothing of that package.

Real platform traffic is composed *workflows*, not single invocations —
chains, parallel fan-out/fan-in with map-reduce joins, and conditional
branches are exactly where routing and cold-start policy diverge
(paper §I; "Characterizing FaaS Workflows on Public Clouds"). This
module adds that layer without touching the data path:

- :class:`StageSpec` / :class:`WorkflowSpec` — a workflow is a DAG of
  named stages, each invoking one function with its own prompt-size
  distribution, fan-out width, and path weight. Specs validate
  structure up front (stages declared after their dependencies, so
  declaration order is a topological order) and precompute the
  longest-weight-path decomposition: per-stage critical-path membership
  and the fraction of the end-to-end SLO each stage's subpath earns.
- :class:`WorkflowWorkload` — binds an arrival process to a spec:
  each arrival is one workflow *instance* with deterministically
  pre-drawn task sizes, conditional-branch activations, and a
  contiguous rid block (same seed ⇒ byte-identical streams, the same
  contract as :class:`~repro_torch.workloads.workload.MixedWorkload`).
- :class:`WorkflowEngine` — the runtime: stage completions arrive as
  ``workflow_done`` simulator events, joins count down deterministically,
  and successor stages are submitted as ordinary :class:`Request`\\ s
  stamped with DAG context (``wf``/``stage``/``wf_critical``/
  ``wf_affinity`` + the stage's share of the workflow deadline) that
  ``workflow_aware`` routing and the control plane's stage-lookahead
  prewarm consume.

End-to-end outcomes land in ``sim.workflow_results`` (one
:class:`WorkflowResult` per instance); ``summarize_workflows`` reduces
them to the latency summary ``bench_workflows`` reports.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.core.types import Request
from repro_torch.workloads.arrivals import ArrivalProcess
from repro_torch.workloads.workload import FunctionProfile, SizeDist


@dataclass(frozen=True)
class StageSpec:
    """One stage of a workflow DAG: which function it invokes, which
    stages must complete first, and how wide it fans out.

    ``fanout`` submits that many parallel tasks for the stage; the stage
    completes (and its successors' joins count down) only when *all* of
    them finish — the map side of a map-reduce. ``prob`` makes the stage
    a conditional branch: each workflow instance draws once at
    generation time, and an inactive stage completes instantly without
    running (its successors still join through it). ``weight`` is the
    stage's relative duration on the DAG's longest-path decomposition —
    it prices the critical path and the stage's share of the end-to-end
    SLO, it does not change service times."""

    name: str
    fn: str
    deps: Tuple[str, ...] = ()
    fanout: int = 1
    size: SizeDist = field(default_factory=lambda: SizeDist.const(16))
    weight: float = 1.0
    prob: float = 1.0
    memory_mb: Optional[int] = None


@dataclass
class WorkflowSpec:
    """A validated stage DAG plus its precomputed critical-path math.

    Stages must be declared after every stage they depend on, so the
    declaration order *is* a topological order (and cycles are
    impossible by construction). ``slo_s`` is the end-to-end workflow
    latency objective; it is decomposed over the longest weighted path:
    a stage whose longest root-path carries fraction ``f`` of the total
    critical-path weight gets the absolute deadline ``arrival + slo_s *
    f`` stamped onto its tasks.
    """

    name: str
    stages: Tuple[StageSpec, ...]
    slo_s: Optional[float] = None

    def __post_init__(self):
        self.stages = tuple(self.stages)
        if not self.stages:
            raise ValueError("a workflow needs at least one stage")
        if self.slo_s is not None and self.slo_s <= 0:
            raise ValueError("slo_s must be positive")
        self._by_name: Dict[str, StageSpec] = {}
        for s in self.stages:
            if s.name in self._by_name:
                raise ValueError(f"duplicate stage name {s.name!r}")
            if s.fanout < 1:
                raise ValueError(f"stage {s.name!r}: fanout must be >= 1")
            if s.weight <= 0:
                raise ValueError(f"stage {s.name!r}: weight must be > 0")
            if not 0.0 < s.prob <= 1.0:
                raise ValueError(f"stage {s.name!r}: prob must be in (0, 1]")
            for d in s.deps:
                if d not in self._by_name:
                    raise ValueError(
                        f"stage {s.name!r} depends on {d!r}, which is not "
                        f"declared before it (declare stages after their "
                        f"dependencies; cycles are impossible that way)")
            self._by_name[s.name] = s
        self.roots: Tuple[str, ...] = tuple(
            s.name for s in self.stages if not s.deps)
        self.successors: Dict[str, Tuple[str, ...]] = {
            s.name: tuple(t.name for t in self.stages if s.name in t.deps)
            for s in self.stages}
        # longest-weight-path decomposition: l_in includes the stage
        # itself (fan-out tasks run in parallel, so a stage counts its
        # weight once regardless of width)
        l_in: Dict[str, float] = {}
        for s in self.stages:
            l_in[s.name] = s.weight + max(
                (l_in[d] for d in s.deps), default=0.0)
        l_out: Dict[str, float] = {}
        for s in reversed(self.stages):
            l_out[s.name] = s.weight + max(
                (l_out[c] for c in self.successors[s.name]), default=0.0)
        self.path_weight: float = max(l_in.values())
        # a stage is critical iff some longest path runs through it
        self.critical: frozenset = frozenset(
            n for n, li in l_in.items()
            if li + l_out[n] - self._by_name[n].weight
            >= self.path_weight - 1e-9)
        self.deadline_frac: Dict[str, float] = {
            n: li / self.path_weight for n, li in l_in.items()}
        # contiguous per-instance rid block: stage tasks get
        # rid = instance_base + rid_offset[stage] + task_index
        self.rid_offset: Dict[str, int] = {}
        off = 0
        for s in self.stages:
            self.rid_offset[s.name] = off
            off += s.fanout
        self.tasks_per_instance: int = off

    def stage(self, name: str) -> StageSpec:
        return self._by_name[name]


@dataclass(frozen=True)
class WorkflowResult:
    """End-to-end outcome of one workflow instance."""

    wf: int
    name: str
    ok: bool
    arrival_t: float
    finish_t: float
    tasks: int                  # stage tasks that actually ran
    error: str = ""

    @property
    def latency(self) -> float:
        return self.finish_t - self.arrival_t


@dataclass
class WorkflowInstance:
    """Runtime state of one in-flight workflow (engine-internal)."""

    wf: int                              # instance id == its rid block base
    spec: WorkflowSpec
    arrival_t: float
    sizes: Dict[str, Tuple[int, ...]]    # stage -> per-task prompt sizes
    active: frozenset                    # conditional stages drawn "taken"

    def __post_init__(self):
        self.deps_left = {s.name: len(s.deps) for s in self.spec.stages}
        self.tasks_left = {s.name: s.fanout for s in self.spec.stages}
        self.remaining = len(self.spec.stages)
        self.tasks_run = 0
        self.failed = False
        self.finished = False


class WorkflowEngine:
    """Deterministic DAG runtime bound to one simulator.

    Stage *task* completions are reported synchronously by the
    simulator's result-recording paths (:meth:`on_stage_done`); when a
    stage's last task lands, the engine pushes a ``workflow_done``
    event, and the handler (:meth:`fire`) advances the DAG — so stage
    triggering rides the event engine's deterministic ordering, never a
    side channel. Inactive conditional stages complete instantly in the
    same event (their successors still join through them). A failed
    task fails the whole instance (remaining in-flight siblings still
    drain through the simulator but no successors are submitted).
    """

    def __init__(self, *, prewarm_next: bool = True):
        self.instances: Dict[int, WorkflowInstance] = {}
        #: byte-stable stage event log (submit/skip/done/fail lines in
        #: event order) — the determinism projection the property
        #: driver compares across same-seed runs
        self.stage_log: List[str] = []
        #: prewarm stage N+1's function while stage N runs
        self.prewarm_next = prewarm_next
        self.tasks_submitted = 0
        self.prewarms = 0

    def add_instance(self, inst: WorkflowInstance) -> None:
        if inst.wf in self.instances:
            raise ValueError(f"duplicate workflow instance id {inst.wf} "
                             f"(overlapping rid_base blocks?)")
        self.instances[inst.wf] = inst

    # ------------------------------------------------- simulator callbacks
    def fire(self, sim, payload) -> None:
        """Handle one ``workflow_done`` event: ``(wf, None, None)`` is
        the instance's arrival (submit its root stages); ``(wf, stage,
        worker)`` is a stage completion (advance the joins)."""
        wf, stage, worker = payload
        inst = self.instances.get(wf)
        if inst is None or inst.finished:
            return
        if stage is None:
            for s in inst.spec.roots:
                self._trigger(sim, inst, s, None)
            return
        self._complete_stage(sim, inst, stage, worker)

    def on_stage_done(self, sim, req: Request, ok: bool,
                      worker: Optional[str]) -> None:
        """One stage *task* finished (called from the simulator's result
        paths, once per primary — hedge races are already resolved)."""
        inst = self.instances.get(req.wf)
        if inst is None or inst.finished:
            return
        if not ok:
            inst.failed = True
            inst.finished = True
            self._log(sim, inst.wf, req.stage, "fail")
            sim.workflow_results.append(WorkflowResult(
                wf=inst.wf, name=inst.spec.name, ok=False,
                arrival_t=inst.arrival_t, finish_t=sim.now,
                tasks=inst.tasks_run,
                error=f"stage {req.stage} failed"))
            return
        inst.tasks_run += 1
        inst.tasks_left[req.stage] -= 1
        if inst.tasks_left[req.stage] == 0:
            # the join is full: trigger successors through the event
            # engine (deterministic ordering with everything else at now)
            sim._push(sim.now, "workflow_done", (inst.wf, req.stage, worker))

    # ------------------------------------------------------- DAG mechanics
    def _complete_stage(self, sim, inst: WorkflowInstance, stage: str,
                        worker: Optional[str]) -> None:
        self._log(sim, inst.wf, stage, "done")
        inst.remaining -= 1
        for succ in inst.spec.successors[stage]:
            inst.deps_left[succ] -= 1
            if inst.deps_left[succ] == 0:
                self._trigger(sim, inst, succ, worker)
        if inst.remaining == 0 and not inst.finished:
            inst.finished = True
            sim.workflow_results.append(WorkflowResult(
                wf=inst.wf, name=inst.spec.name, ok=True,
                arrival_t=inst.arrival_t, finish_t=sim.now,
                tasks=inst.tasks_run))

    def _trigger(self, sim, inst: WorkflowInstance, stage: str,
                 worker: Optional[str]) -> None:
        spec = inst.spec.stage(stage)
        if stage not in inst.active:
            # conditional branch not taken: completes instantly, in the
            # same event, so successors join through it deterministically
            self._log(sim, inst.wf, stage, "skip")
            self._complete_stage(sim, inst, stage, worker)
            return
        self._log(sim, inst.wf, stage, "submit")
        affinity = (None if worker is None
                    else (worker, sim._leaf_of.get(worker)))
        deadline = (inst.arrival_t
                    + inst.spec.slo_s * inst.spec.deadline_frac[stage]
                    if inst.spec.slo_s is not None else None)
        rid0 = inst.wf + inst.spec.rid_offset[stage]
        critical = stage in inst.spec.critical
        sizes = inst.sizes[stage]
        for k in range(spec.fanout):
            sim.submit(Request(
                fn=spec.fn, arrival_t=sim.now, size=sizes[k], rid=rid0 + k,
                deadline_t=deadline, wf=inst.wf, stage=stage, wf_task=k,
                wf_critical=critical, wf_affinity=affinity))
        self.tasks_submitted += spec.fanout
        if self.prewarm_next:
            # stage-lookahead: warm the successors' functions while this
            # stage runs, so the DAG edge doesn't eat a cold start
            for succ in inst.spec.successors[stage]:
                if succ in inst.active:
                    if sim.control.workflow_prewarm(
                            inst.spec.stage(succ).fn) is not None:
                        self.prewarms += 1

    def _log(self, sim, wf: int, stage: Optional[str], event: str) -> None:
        self.stage_log.append(
            f"t={sim.now:.6f} wf={wf} stage={stage} {event}")


class WorkflowWorkload:
    """Workflow instances over an arrival process (the composed-traffic
    sibling of :class:`~repro_torch.workloads.workload.MixedWorkload`).

    Determinism contract: two RNG streams are derived from one seed —
    arrival times vs. per-instance draws (task sizes, conditional-branch
    activations) — and request ids come in contiguous per-instance
    blocks from ``rid_base``, so the same seed yields byte-identical
    request, result, and stage-log streams. ``submit_to`` counts as one
    unit per *instance* (stage tasks are generated by the engine as the
    DAG advances, not up front).
    """

    def __init__(self, arrivals: ArrivalProcess, spec: WorkflowSpec, *,
                 duration_s: Optional[float], seed: int = 1,
                 rid_base: int = 0, prewarm_next: bool = True):
        self.arrivals = arrivals
        self.spec = spec
        self.duration_s = duration_s
        self.seed = seed
        self.rid_base = rid_base
        self.prewarm_next = prewarm_next
        self.faults = None              # chaos scenarios may attach a plan

    def fns(self) -> List[str]:
        out: List[str] = []
        for s in self.spec.stages:
            if s.fn not in out:
                out.append(s.fn)
        return out

    @property
    def profiles(self) -> List[FunctionProfile]:
        """Per-function profiles derived from the stages (first-declared
        size shape; the *tightest* per-stage deadline share when several
        stages invoke one function) — what ``install_demo_configs`` and
        SLO-aware autoscaling consume."""
        seen: Dict[str, FunctionProfile] = {}
        for s in self.spec.stages:
            share = (self.spec.slo_s * self.spec.deadline_frac[s.name]
                     if self.spec.slo_s is not None else None)
            p = seen.get(s.fn)
            if p is None:
                seen[s.fn] = FunctionProfile(s.fn, size=s.size,
                                             slo_p95_s=share,
                                             memory_mb=s.memory_mb)
            elif share is not None and (p.slo_p95_s is None
                                        or share < p.slo_p95_s):
                seen[s.fn] = FunctionProfile(s.fn, size=p.size,
                                             slo_p95_s=share,
                                             memory_mb=p.memory_mb)
        return list(seen.values())

    def slo_targets(self) -> dict:
        return {p.fn: p.slo_p95_s for p in self.profiles
                if p.slo_p95_s is not None}

    def instances(self) -> Iterator[WorkflowInstance]:
        arr_rng = random.Random(self.seed)
        mix_rng = random.Random(f"wfmix-{self.seed}")
        spec = self.spec
        for i, t in enumerate(self.arrivals.times(self.duration_s, arr_rng)):
            # fixed-shape draws per instance (every stage, active or
            # not) keep the mix stream alignment independent of the
            # activation outcomes
            sizes = {s.name: tuple(s.size.sample(mix_rng)
                                   for _ in range(s.fanout))
                     for s in spec.stages}
            active = frozenset(
                s.name for s in spec.stages
                if s.prob >= 1.0 or mix_rng.random() < s.prob)
            yield WorkflowInstance(
                wf=self.rid_base + i * spec.tasks_per_instance, spec=spec,
                arrival_t=t, sizes=sizes, active=active)

    def generate(self) -> List[WorkflowInstance]:
        return list(self.instances())

    def submit_to(self, sim) -> int:
        """Register every instance with the simulator's workflow engine
        (attaching one if needed) and schedule its arrival; returns the
        instance count."""
        engine = sim.workflows
        if engine is None:
            engine = sim.attach_workflows(
                WorkflowEngine(prewarm_next=self.prewarm_next))
        n = 0
        for inst in self.instances():
            engine.add_instance(inst)
            sim._push(inst.arrival_t, "workflow_done", (inst.wf, None, None))
            n += 1
        return n


def summarize_workflows(results: List[WorkflowResult]) -> dict:
    """End-to-end workflow latency summary (nearest-rank percentiles —
    byte-stable, no numpy dependency on this path)."""
    import math
    out: dict = {"n": len(results)}
    if not results:
        return out
    ok = [r for r in results if r.ok]
    out["ok"] = len(ok)
    out["fail_rate"] = 1.0 - len(ok) / len(results)
    out["tasks"] = sum(r.tasks for r in results)
    if ok:
        lats = sorted(r.latency for r in ok)

        def pct(p: float) -> float:
            return lats[max(0, math.ceil(p / 100.0 * len(lats)) - 1)]

        out.update(p50=pct(50.0), p95=pct(95.0), p99=pct(99.0),
                   mean=sum(lats) / len(lats))
    return out
