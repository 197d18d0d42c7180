"""Shared types for the HyperFaaS platform layer (paper Fig. 1 vocabulary).

The port's own copy of the JAX package's ``core/types.py``, which holds no
JAX: the port imports nothing of that package.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Optional

_req_ids = itertools.count()


@dataclass(frozen=True)
class FunctionConfig:
    """What the paper's config store holds per function.

    ``concurrency`` is RQ-A's within-instance concurrency policy:
      1   -> AWS-Lambda-style (one request per instance)
      k>1 -> Knative-style hard limit
      0   -> Azure/GCF-style "unlimited": requests pack into the instance and
             resource-based scaling adds replicas when utilization trips.
    """
    name: str
    arch: str                          # key into the image registry
    concurrency: int = 1
    timeout_s: float = 30.0            # request timeout (failure beyond this)
    idle_timeout_s: float = 10.0       # instance stop after idleness
    # None => platform default (simulator's cold_start_default_s; the real
    # engine measures compile+load). An explicit 0.0 means *instant* —
    # the seed's falsy-or check silently replaced it with the default.
    cold_start_s: Optional[float] = None
    memory_mb: int = 512
    max_instances_per_worker: int = 8
    util_scale_threshold: float = 0.8  # "unlimited" mode replica trigger
    gen_tokens: int = 8                # tokens generated per invocation (LM fns)


@dataclass
class Request:
    fn: str
    arrival_t: float
    payload: Any = None
    size: int = 16                     # prompt tokens (the cost factor)
    rid: int = field(default_factory=lambda: next(_req_ids))
    hedged_from: Optional[int] = None  # straggler-mitigation clone marker
    # gateway priority class ("interactive" | "batch"), stamped from
    # FunctionProfile.priority by the workload layer; None falls back to
    # the tenant quota's class at the front door (core/gateway.py)
    priority: Optional[str] = None
    # absolute completion deadline (arrival + the function's slo_p95_s —
    # or, for a workflow stage, the stage's share of the end-to-end
    # workflow SLO), stamped by the workload layer; None => no latency
    # objective. deadline_aware routing scores branches against the
    # remaining slack.
    deadline_t: Optional[float] = None
    # ---- workflow identity (repro.workloads.workflows) --------------
    # None/False for plain invocations: a request that is one stage task
    # of a composed workflow carries its DAG context so workflow_aware
    # routing can see the critical path.
    wf: Optional[int] = None           # workflow instance id
    stage: Optional[str] = None        # stage name within the DAG
    wf_task: int = 0                   # task index within the stage fan-out
    wf_critical: bool = False          # stage lies on the DAG critical path
    # (worker, leaf-branch) that served the completion triggering this
    # stage — the co-location target for chained stages
    wf_affinity: Optional[tuple] = None


@dataclass
class RequestResult:
    rid: int
    fn: str
    ok: bool
    arrival_t: float
    start_t: float                     # service start (after queue + cold)
    finish_t: float
    cold_start: bool
    worker: str
    instance: str
    error: str = ""
    # workflow identity carried through from the request (None for
    # plain invocations) — lets analysis group stage tasks per instance
    wf: Optional[int] = None
    stage: Optional[str] = None

    @property
    def latency(self) -> float:
        return self.finish_t - self.arrival_t

    @property
    def service_time(self) -> float:
        return self.finish_t - self.start_t


@dataclass
class TelemetryRecord:
    """One row of the RQ-B worker-model training set (paper Fig. 2 step 1)."""
    fn: str
    t: float
    queue_len: int                     # worker queue at arrival
    inflight: int                      # busy slots at arrival
    batch_size: int                    # slot occupancy of the serving instance
    cold: bool
    prompt_tokens: int
    gen_tokens: int
    fn_cost: float                     # static per-token cost proxy (params)
    latency: float
    ok: bool

    def features(self):
        return [self.queue_len, self.inflight, self.batch_size,
                1.0 if self.cold else 0.0, self.prompt_tokens,
                self.gen_tokens, self.fn_cost]

    FEATURE_NAMES = ("queue_len", "inflight", "batch_size", "cold",
                     "prompt_tokens", "gen_tokens", "fn_cost")
