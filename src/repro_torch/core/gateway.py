"""Front-door gateway: per-tenant rate limiting, admission control,
priority classes.

The port's own copy of the JAX package's ``core/gateway.py``, which holds no
JAX: the port imports nothing of that package.

The related FaaS engine design puts a gateway (rate limiter / admission /
auth) *ahead* of the orchestrator; without one this testbed routes
straight into the LB tree, so a single flooding tenant can queue the
whole platform to its timeout horizon. This layer is that missing stage:
every non-hedge arrival traverses it before the LB tree, and requests it
sheds fail immediately with a terminal error instead of queueing —

- ``"rate limited"``        the tenant's token bucket is empty
  (per-tenant quotas: ``burst`` tokens of headroom refilled at the
  sustained ``rate`` per second),
- ``"admission rejected"``  platform-wide outstanding work is at the
  concurrency ceiling (``max_inflight``), with priority classes: *batch*
  traffic is shed first, at ``batch_share * max_inflight``, so
  interactive tenants keep headroom under pressure.

Determinism contract: the gateway consumes **no RNG** and schedules no
events — a verdict is a pure function of the request stream and virtual
time, so same seed ⇒ byte-identical admit/shed sequences (pinned by
``tests/_prop_drivers.run_gateway_ops``), and a simulator with no
gateway attached is byte-identical to every pre-gateway golden.

Wiring (see ``repro_torch.core.simulator``): the simulator consults
:meth:`Gateway.admit` in ``_on_arrival`` and on retries, releases the
concurrency slot when the request settles (ok, terminal failure, or
hedge resolution), and mirrors every verdict into the control plane's
gateway decision log. Recorded verdicts replay byte-for-byte through
``repro_torch.autoscale.replay.ReplayGateway``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple

#: priority classes, in shed order: batch is dropped first under pressure
PRIORITIES = ("interactive", "batch")

#: terminal error strings the gateway produces (deliberately NOT in
#: ``simulator.RETRYABLE_ERRORS``: a shed is a final platform answer,
#: retrying it would re-offer exactly the load the gateway just refused)
RATE_LIMITED = "rate limited"
ADMISSION_REJECTED = "admission rejected"


@dataclass(frozen=True)
class TenantQuota:
    """One tenant's rate contract: ``burst`` tokens of instantaneous
    headroom, refilled continuously at ``rate`` requests/second. A
    request spends one token; an empty bucket means ``rate limited``.
    ``priority`` is the tenant's default class when its requests carry
    none (``Request.priority`` — stamped by ``FunctionProfile.priority``
    — wins when set)."""

    rate: float
    burst: float = 1.0
    priority: str = "interactive"


@dataclass(frozen=True)
class GatewayConfig:
    """Declarative gateway shape a scenario can carry (``wl.gateway``,
    attached by ``Simulator.load`` exactly like a fault plan).

    ``quotas`` maps tenant (function) name → :class:`TenantQuota`;
    tenants without an entry fall back to ``default_quota`` (None ⇒
    unlimited rate). ``max_inflight`` turns on admission control (None
    ⇒ off): per-class concurrency ceilings — *interactive* outstanding
    admitted work is capped at ``max_inflight`` and *batch* at
    ``batch_share * max_inflight``, so a batch flood can never occupy
    the interactive class's headroom (total outstanding is bounded by
    their sum). Capping the batch class's *outstanding* work — not just
    its rate — is what bounds a flooding tenant's replica footprint:
    instances spawn to cover queued work, so ``batch_limit / conc``
    replicas is all a shed-early flood can ever pin. An
    ``enabled=False`` config attaches nothing — the run stays
    byte-identical to a gateway-free one."""

    quotas: Mapping[str, TenantQuota] = field(default_factory=dict)
    default_quota: Optional[TenantQuota] = None
    max_inflight: Optional[int] = None
    batch_share: float = 0.5
    enabled: bool = True


class TokenBucket:
    """Continuous-refill token bucket (the classic shaper, virtual-time
    edition). Never negative: ``take`` only spends when a full token is
    available. Floats keep partial refills exact across arbitrary
    inter-arrival gaps."""

    __slots__ = ("rate", "burst", "level", "last_t")

    def __init__(self, rate: float, burst: float, t0: float = 0.0):
        self.rate = float(rate)
        self.burst = float(burst)
        self.level = float(burst)      # start full: burst headroom at t0
        self.last_t = t0

    def refill(self, now: float) -> None:
        if now > self.last_t:
            self.level = min(self.burst,
                             self.level + (now - self.last_t) * self.rate)
            self.last_t = now

    def take(self, now: float) -> bool:
        self.refill(now)
        if self.level >= 1.0:
            self.level -= 1.0
            return True
        return False


class Gateway:
    """The admission stage itself: verdicts plus per-tenant accounting.

    :meth:`admit` returns ``None`` (admitted) or a terminal error string;
    an admitted request holds one concurrency slot until the simulator
    calls :meth:`release` when it settles. Custom admission policies
    subclass this and override :meth:`decide` — the bookkeeping
    (slot accounting, per-tenant counters, the replayable verdict
    record) stays in :meth:`admit`, so a policy override cannot desync
    the counters the autoscaler metrics read.
    """

    def __init__(self, config: Optional[GatewayConfig] = None, *,
                 record: bool = False):
        self.config = config or GatewayConfig()
        self.record = record             # keep structured verdicts for replay
        self.inflight = 0                # admitted, not yet settled
        self.inflight_by_pri = {p: 0 for p in PRIORITIES}
        self.admitted_total = 0
        self.shed_total = 0
        self.admitted_by_fn: Dict[str, int] = {}
        self.shed_by_fn: Dict[str, int] = {}
        self.shed_by_error: Dict[str, int] = {}
        self._buckets: Dict[str, TokenBucket] = {}
        self._records: List[Tuple[int, str]] = []   # (rid, verdict) in order

    # ------------------------------------------------------------ policy
    def priority_of(self, req) -> str:
        """Effective class: the request's stamped priority, else its
        tenant quota's, else interactive."""
        pri = getattr(req, "priority", None)
        if pri is not None:
            return pri
        q = self._quota(req.fn)
        return q.priority if q is not None else "interactive"

    def _quota(self, fn: str) -> Optional[TenantQuota]:
        return self.config.quotas.get(fn, self.config.default_quota)

    def _bucket(self, fn: str, quota: TenantQuota,
                now: float) -> TokenBucket:
        b = self._buckets.get(fn)
        if b is None:
            b = self._buckets[fn] = TokenBucket(quota.rate, quota.burst,
                                                t0=now)
        return b

    def set_ceiling(self, max_inflight: Optional[int]) -> None:
        """Re-point the platform-wide concurrency ceiling (the config
        itself is frozen). This is the window-barrier knob the parallel
        runner turns (``repro_torch.parallel``): a global ``max_inflight`` is
        split across partition-local gateways and re-apportioned from
        exchanged occupancy summaries at each barrier. Already-admitted
        work is never evicted — a lowered ceiling only gates *new*
        admits, exactly like a config push on a live front door."""
        from dataclasses import replace
        self.config = replace(self.config, max_inflight=max_inflight)

    def _limit(self, pri: str) -> Optional[int]:
        cap = self.config.max_inflight
        if cap is None:
            return None
        if pri == "batch":
            return int(cap * self.config.batch_share)
        return cap

    def decide(self, req, now: float, *, retry: bool) -> Optional[str]:
        """The admission policy: verdict for one consult (``None`` =
        admit). Override point for custom gateways; must stay a pure
        function of gateway state + the request (no RNG, no events) to
        keep the byte-identity contract."""
        pri = self.priority_of(req)
        limit = self._limit(pri)
        occupied = self.inflight_by_pri.get(pri, 0)
        if retry:
            # the request already holds its slot and already paid its
            # token at arrival; a retry is only refused when its class
            # is saturated (shed early instead of re-queueing into an
            # overloaded platform)
            if limit is not None and occupied > limit:
                return ADMISSION_REJECTED
            return None
        # concurrency admission first: an over-capacity reject must not
        # burn the tenant's rate tokens as well. Per-class occupancy:
        # batch saturating its own ceiling cannot consume interactive's
        if limit is not None and occupied >= limit:
            return ADMISSION_REJECTED
        quota = self._quota(req.fn)
        if quota is not None and not self._bucket(
                req.fn, quota, now).take(now):
            return RATE_LIMITED
        return None

    # ----------------------------------------------------------- wiring
    def admit(self, req, now: float, *, retry: bool = False) -> Optional[str]:
        """One front-door consult; returns None (admitted) or the
        terminal error. Arrival admits take a concurrency slot (released
        by :meth:`release` when the request settles); retry consults
        only re-check saturation."""
        verdict = self.decide(req, now, retry=retry)
        if verdict is None:
            if not retry:
                req._gw_admitted = True
                pri = req._gw_pri = self.priority_of(req)
                self.inflight += 1
                self.inflight_by_pri[pri] = \
                    self.inflight_by_pri.get(pri, 0) + 1
                self.admitted_total += 1
                self.admitted_by_fn[req.fn] = \
                    self.admitted_by_fn.get(req.fn, 0) + 1
        else:
            self.shed_total += 1
            self.shed_by_fn[req.fn] = self.shed_by_fn.get(req.fn, 0) + 1
            self.shed_by_error[verdict] = \
                self.shed_by_error.get(verdict, 0) + 1
        if self.record:
            self._records.append((req.rid, verdict or "admit"))
        return verdict

    def release(self, req, now: float) -> None:
        """A previously admitted request settled (result row recorded or
        terminal failure) — free its concurrency slot. Exactly-once:
        guarded by the admit stamp, so hedge losers and gateway-shed
        requests (never admitted) cannot double-free."""
        if getattr(req, "_gw_admitted", False):
            req._gw_admitted = False
            self.inflight -= 1
            pri = getattr(req, "_gw_pri", "interactive")
            self.inflight_by_pri[pri] = self.inflight_by_pri.get(pri, 1) - 1

    # -------------------------------------------------------- reporting
    def decision_records(self) -> List[dict]:
        """Structured verdict log (plain JSON types), in consult order —
        feed to ``repro_torch.autoscale.replay.ReplayGateway`` (and the same
        ``save_decision_log``/``load_decision_log`` helpers)."""
        return [{"rid": rid, "verdict": v} for rid, v in self._records]

    def summary(self) -> dict:
        return {"admitted": self.admitted_total, "shed": self.shed_total,
                "inflight": self.inflight,
                "shed_by_fn": dict(sorted(self.shed_by_fn.items())),
                "shed_by_error": dict(sorted(self.shed_by_error.items()))}
