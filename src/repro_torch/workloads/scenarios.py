"""Named workload scenarios — the testbed's one-line experiment menu.

The port's own copy of the JAX package's ``workloads/scenarios.py``, which holds no
JAX: the port imports nothing of that package.

Each scenario is a factory registered under a short name; overrides are
plain keyword arguments, so configs / CLIs can build any shape with one
call::

    wl = build_scenario("flash_crowd", duration_s=20.0, seed=3)
    wl.submit_to(sim)

Scenario -> paper mapping: ``steady``/``flash_crowd``/``daily_cycle``
stress RQ-A's within-instance concurrency policies under shapes where
cold-start amortisation differs; ``multi_tenant`` gives the RQ-B worker
model heterogeneous (fn, prompt-size) cost classes to learn;
``trace_replay`` grounds both in recorded production traffic.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from repro_torch.core.types import FunctionConfig
from repro_torch.workloads.arrivals import (BurstyArrivals, DiurnalArrivals,
                                            PoissonArrivals, TraceArrivals)
from repro_torch.workloads.workload import FunctionProfile, MixedWorkload, SizeDist

SCENARIOS: Dict[str, Callable[..., MixedWorkload]] = {}


def register_scenario(name: str):
    def deco(fn):
        SCENARIOS[name] = fn
        return fn
    return deco


def build_scenario(name: str, **overrides) -> MixedWorkload:
    if name not in SCENARIOS:
        raise KeyError(f"scenario {name!r} not registered "
                       f"(have: {sorted(SCENARIOS)})")
    return SCENARIOS[name](**overrides)


def list_scenarios() -> List[str]:
    return sorted(SCENARIOS)


@register_scenario("steady")
def steady(*, fn: str = "fn", rps: float = 200.0, duration_s: float = 30.0,
           prompt_tokens: int = 16, seed: int = 1, slo_p95_s: float = 0.5,
           rid_base: Optional[int] = 0) -> MixedWorkload:
    """Baseline homogeneous Poisson load on a single function."""
    return MixedWorkload(
        PoissonArrivals(rps),
        [FunctionProfile(fn, size=SizeDist.const(prompt_tokens),
                         slo_p95_s=slo_p95_s)],
        duration_s=duration_s, seed=seed, rid_base=rid_base)


@register_scenario("flash_crowd")
def flash_crowd(*, fn: str = "fn", base_rps: float = 50.0,
                burst_rps: float = 1500.0, mean_burst_s: float = 2.0,
                mean_calm_s: float = 10.0, duration_s: float = 30.0,
                seed: int = 1, slo_p95_s: float = 1.0,
                rid_base: Optional[int] = 0) -> MixedWorkload:
    """MMPP on/off: calm background traffic punctured by sharp spikes —
    the shape that punishes slow cold starts and stale LB state."""
    return MixedWorkload(
        BurstyArrivals(rate_on=burst_rps, rate_off=base_rps,
                       mean_on_s=mean_burst_s, mean_off_s=mean_calm_s),
        [FunctionProfile(fn, size=SizeDist.lognormal(24, 0.5),
                         slo_p95_s=slo_p95_s)],
        duration_s=duration_s, seed=seed, rid_base=rid_base)


@register_scenario("daily_cycle")
def daily_cycle(*, fn: str = "fn", mean_rps: float = 150.0,
                amplitude: float = 0.9, period_s: float = 60.0,
                duration_s: float = 60.0, seed: int = 1,
                slo_p95_s: float = 0.8,
                rid_base: Optional[int] = 0) -> MixedWorkload:
    """Sinusoidal diurnal envelope, compressed to ``period_s`` per "day"
    so a full peak/trough cycle fits in one simulator run."""
    return MixedWorkload(
        DiurnalArrivals(base_rate=mean_rps, amplitude=amplitude,
                        period_s=period_s),
        [FunctionProfile(fn, size=SizeDist.const(16), slo_p95_s=slo_p95_s)],
        duration_s=duration_s, seed=seed, rid_base=rid_base)


@register_scenario("multi_tenant")
def multi_tenant(*, rps: float = 300.0, duration_s: float = 30.0,
                 seed: int = 1, memory_skew: bool = False,
                 rid_base: Optional[int] = 0) -> MixedWorkload:
    """Three tenants with distinct cost classes: chat (frequent, small),
    embed (mid), batch (rare, huge prompts). Feeds RQ-B two+ cost
    classes and exercises warm-affinity routing. ``memory_skew=True``
    additionally gives the tenants heterogeneous replica footprints
    (chat small, batch huge) — the shape where placement quality shows."""
    # per-tenant SLOs: interactive chat is tight, embedding mid, batch loose
    mem = {"chat": 256, "embed": 512, "batch": 1536} if memory_skew else {}
    profiles = [
        FunctionProfile("chat", weight=6.0, size=SizeDist.lognormal(32, 0.6),
                        slo_p95_s=0.5, memory_mb=mem.get("chat")),
        FunctionProfile("embed", weight=3.0, size=SizeDist.uniform(8, 64),
                        slo_p95_s=1.0, memory_mb=mem.get("embed")),
        FunctionProfile("batch", weight=1.0,
                        size=SizeDist.choice([256, 512, 1024],
                                             [0.5, 0.3, 0.2]),
                        slo_p95_s=5.0, memory_mb=mem.get("batch")),
    ]
    return MixedWorkload(PoissonArrivals(rps), profiles,
                         duration_s=duration_s, seed=seed, rid_base=rid_base)


@register_scenario("multi_tenant_memory")
def multi_tenant_memory(**overrides) -> MixedWorkload:
    """The memory-skewed ``multi_tenant`` variant as a first-class name:
    heterogeneous per-tenant replica footprints for placement studies."""
    overrides.setdefault("memory_skew", True)
    return multi_tenant(**overrides)


@register_scenario("zone_outage")
def zone_outage(*, rps: float = 150.0, duration_s: float = 12.0,
                seed: int = 1, outage_at: float = 4.0,
                outage_zone: str = "z0", outage_duration_s: float = 4.0,
                slo_p95_s: float = 1.0, lost_finish_p: float = 0.0,
                rid_base: Optional[int] = 0) -> MixedWorkload:
    """Chaos scenario: steady two-tenant traffic with one failure domain
    scripted to go dark mid-run. The workload carries its fault plan as
    ``wl.faults`` (a ``FaultConfig``), which ``Simulator.load`` attaches
    — run it against a ``Simulator(zones=...)`` so ``outage_zone``
    exists. The canonical A/B: ``spread_zones`` placement + a retry
    budget rides through the outage; zone-blind ``spread`` + no retries
    loses its warm capacity and its in-flight work in one event."""
    from repro_torch.core.faults import FaultConfig
    profiles = [
        FunctionProfile("chat", weight=4.0, size=SizeDist.const(24),
                        slo_p95_s=slo_p95_s),
        FunctionProfile("embed", weight=1.0, size=SizeDist.const(32),
                        slo_p95_s=2 * slo_p95_s),
    ]
    wl = MixedWorkload(PoissonArrivals(rps), profiles,
                       duration_s=duration_s, seed=seed, rid_base=rid_base)
    wl.faults = FaultConfig(
        seed=seed, lost_finish_p=lost_finish_p,
        scheduled=((outage_at, outage_zone, outage_duration_s),))
    return wl


@register_scenario("retry_storm")
def retry_storm(*, rps: float = 400.0, duration_s: float = 10.0,
                seed: int = 1, outage_at: float = 3.0,
                outage_zones: tuple = ("z0", "z1"),
                outage_duration_s: float = 2.0, slo_p95_s: float = 1.0,
                rid_base: Optional[int] = 0) -> MixedWorkload:
    """Chaos scenario: high-rate traffic with *most* of the fleet
    (every zone named in ``outage_zones``) failing at once — the shape
    where a retry budget without a storm guard re-offers the whole
    blast wave back into the survivors. Exercises the simulator's
    ``retry_storm_cap`` shedding."""
    from repro_torch.core.faults import FaultConfig
    wl = MixedWorkload(
        PoissonArrivals(rps),
        [FunctionProfile("chat", size=SizeDist.const(24),
                         slo_p95_s=slo_p95_s)],
        duration_s=duration_s, seed=seed, rid_base=rid_base)
    wl.faults = FaultConfig(
        seed=seed,
        scheduled=tuple((outage_at, z, outage_duration_s)
                        for z in outage_zones))
    return wl


@register_scenario("noisy_neighbor")
def noisy_neighbor(*, rps: float = 120.0, flood_x: float = 10.0,
                   duration_s: float = 12.0, seed: int = 1,
                   gateway: bool = True, flood_rate: float = 40.0,
                   flood_burst: float = 20.0, max_inflight: int = 64,
                   batch_share: float = 0.5,
                   rid_base: Optional[int] = 0) -> MixedWorkload:
    """Front-door scenario: two well-behaved interactive tenants plus a
    ``flood`` batch tenant offering ``flood_x`` times their combined
    load. Without a gateway the flood queues the shared fleet to its
    timeout horizon and everyone's p95 blows through SLO; with the
    carried :class:`~repro_torch.core.gateway.GatewayConfig` (``wl.gateway``,
    attached by ``Simulator.load`` like a fault plan) the flood is
    rate-limited to ``flood_rate`` rps and the admission ceiling sheds
    batch first, so the interactive tenants ride through within SLO.
    ``gateway=False`` builds the no-gateway baseline for the A/B."""
    from repro_torch.core.gateway import GatewayConfig, TenantQuota
    profiles = [
        FunctionProfile("chat", weight=3.0, size=SizeDist.const(24),
                        slo_p95_s=0.5, priority="interactive"),
        FunctionProfile("embed", weight=1.0, size=SizeDist.const(32),
                        slo_p95_s=1.0, priority="interactive"),
        FunctionProfile("flood", weight=4.0 * flood_x,
                        size=SizeDist.const(24), slo_p95_s=5.0,
                        priority="batch"),
    ]
    wl = MixedWorkload(PoissonArrivals(rps * (1.0 + flood_x)), profiles,
                       duration_s=duration_s, seed=seed, rid_base=rid_base)
    if gateway:
        wl.gateway = GatewayConfig(
            quotas={"flood": TenantQuota(rate=flood_rate,
                                         burst=flood_burst,
                                         priority="batch")},
            max_inflight=max_inflight, batch_share=batch_share)
    return wl


@register_scenario("ml_pipeline")
def ml_pipeline(*, rps: float = 30.0, duration_s: float = 20.0,
                seed: int = 1, slo_s: float = 2.0, audit_prob: float = 0.3,
                rid_base: int = 0, prewarm_next: bool = True):
    """Workflow scenario: the canonical inference chain. ``preprocess →
    infer → postprocess`` is the critical path (``infer`` dominates);
    ``audit`` is a conditional side branch off ``preprocess`` that only
    some instances take. The shape where critical-path-aware routing
    diverges from stage-blind deadline routing: warm capacity for the
    heavy middle stage is scarce, and a cold start there moves the
    end-to-end deadline one-for-one."""
    from repro_torch.workloads.workflows import (StageSpec, WorkflowSpec,
                                                 WorkflowWorkload)
    spec = WorkflowSpec("ml_pipeline", stages=(
        StageSpec("preprocess", fn="preprocess",
                  size=SizeDist.uniform(8, 24), weight=1.0),
        StageSpec("infer", fn="infer", deps=("preprocess",),
                  size=SizeDist.lognormal(48, 0.4), weight=4.0),
        StageSpec("postprocess", fn="postprocess", deps=("infer",),
                  size=SizeDist.const(16), weight=1.0),
        StageSpec("audit", fn="audit", deps=("preprocess",),
                  size=SizeDist.const(8), weight=0.5, prob=audit_prob),
    ), slo_s=slo_s)
    return WorkflowWorkload(PoissonArrivals(rps), spec,
                            duration_s=duration_s, seed=seed,
                            rid_base=rid_base, prewarm_next=prewarm_next)


@register_scenario("etl_fanout")
def etl_fanout(*, rps: float = 12.0, duration_s: float = 20.0,
               seed: int = 1, maps: int = 8, slo_s: float = 2.5,
               rid_base: int = 0, prewarm_next: bool = True):
    """Workflow scenario: map-reduce. ``split`` fans out to ``maps``
    parallel ``map`` tasks whose join gates ``reduce`` — end-to-end
    latency is the *slowest* map task, so one straggling cold start on
    the fan-out blows the whole instance's deadline."""
    from repro_torch.workloads.workflows import (StageSpec, WorkflowSpec,
                                                 WorkflowWorkload)
    spec = WorkflowSpec("etl_fanout", stages=(
        StageSpec("split", fn="split", size=SizeDist.const(32), weight=1.0),
        StageSpec("map", fn="map", deps=("split",), fanout=maps,
                  size=SizeDist.uniform(16, 64), weight=2.0),
        StageSpec("reduce", fn="reduce", deps=("map",),
                  size=SizeDist.const(48), weight=1.5),
    ), slo_s=slo_s)
    return WorkflowWorkload(PoissonArrivals(rps), spec,
                            duration_s=duration_s, seed=seed,
                            rid_base=rid_base, prewarm_next=prewarm_next)


@register_scenario("trace_replay")
def trace_replay(*, path: str, fn: str = "fn", fmt: str = "iat",
                 duration_s: Optional[float] = None, loop: bool = False,
                 prompt_tokens: int = 16, seed: int = 1,
                 function: Optional[str] = None, time_scale: float = 1.0,
                 aggregate: bool = False,
                 rid_base: Optional[int] = 0) -> MixedWorkload:
    """Replay a recorded trace file exactly.

    ``fmt="iat"`` reads one inter-arrival time per line; ``fmt="azure"``
    ingests the Azure Functions public-trace CSV (per-minute invocation
    counts) through ``repro_torch.workloads.azure`` — pick a function by hash
    prefix with ``function=``, replay the whole file's load shape with
    ``aggregate=True``, and compress the traced day with ``time_scale``.
    """
    if fmt == "iat":
        if function is not None or aggregate or time_scale != 1.0:
            raise ValueError(
                "function=/aggregate=/time_scale= only apply to the Azure "
                "trace format — pass fmt='azure' (fmt='iat' would silently "
                "replay the wrong stream)")
        arrivals = TraceArrivals.from_file(path, loop=loop)
    elif fmt == "azure":
        from repro_torch.workloads.azure import azure_trace_arrivals
        arrivals = azure_trace_arrivals(path, function=function,
                                        time_scale=time_scale,
                                        aggregate=aggregate, loop=loop)
    else:
        raise ValueError(f"unknown trace format {fmt!r} "
                         f"(have: 'iat', 'azure')")
    return MixedWorkload(
        arrivals,
        [FunctionProfile(fn, size=SizeDist.const(prompt_tokens))],
        duration_s=duration_s, seed=seed, rid_base=rid_base)


# defaults used when a scenario function name has no explicit config:
# (arch, concurrency, cold_start_s) per well-known tenant name.
_DEMO_CFG = {
    "chat": ("tiny_lm", 4, 0.15),
    "embed": ("tiny_lm", 8, 0.10),
    "batch": ("small_lm", 1, 0.40),
    # noisy_neighbor's flooding batch tenant
    "flood": ("tiny_lm", 4, 0.20),
    # workflow stage functions (ml_pipeline / etl_fanout): the heavy
    # middle stages carry the expensive cold starts
    "preprocess": ("tiny_lm", 4, 0.15),
    "infer": ("small_lm", 2, 0.45),
    "postprocess": ("tiny_lm", 4, 0.15),
    "audit": ("tiny_lm", 2, 0.25),
    "split": ("tiny_lm", 4, 0.20),
    "map": ("tiny_lm", 4, 0.30),
    "reduce": ("tiny_lm", 2, 0.35),
}


def install_demo_configs(store, workload: MixedWorkload) -> None:
    """Register a sensible FunctionConfig for every fn in the mix that the
    store does not already know — lets examples/benches run any scenario
    without per-function boilerplate. A profile's ``memory_mb`` (if set)
    carries through to the config, so memory-skewed scenarios reach the
    placement layer with no extra wiring."""
    for p in workload.profiles:
        try:
            store.get(p.fn)
            continue
        except KeyError:
            pass
        arch, conc, cold = _DEMO_CFG.get(p.fn, ("tiny_lm", 4, 0.2))
        mem = {} if p.memory_mb is None else {"memory_mb": p.memory_mb}
        store.put(FunctionConfig(name=p.fn, arch=arch, concurrency=conc,
                                 cold_start_s=cold, **mem))
