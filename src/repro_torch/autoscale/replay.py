"""Counterfactual replay of recorded scaling decisions.

The port's own copy of the JAX package's ``autoscale/replay.py``, which holds no
JAX: the port imports nothing of that package.

A run's structured decision log (``Autoscaler.decision_records()``) is a
complete record of *what the control loop did*: the raw policy output per
tick plus the per-function prewarm/reap directives. :func:`replay` turns
that record back into a controller whose "policy" simply re-emits the
recorded outputs tick by tick, so the same decision sequence can be
re-applied —

- on the same seed/workload, which must reproduce the original decision
  log byte-for-byte (the regression contract
  ``tests/test_autoscale.py`` pins), or
- on a *different* seed, workload shape, or service model: the
  counterfactual question "what would last Tuesday's scaling have done
  under today's traffic?".

Records are plain JSON types; :func:`save_decision_log` /
:func:`load_decision_log` round-trip them through a file.
"""
from __future__ import annotations

import json
from typing import List, Sequence

from repro_torch.autoscale.controller import Autoscaler
from repro_torch.autoscale.policy import AutoscalePolicy
from repro_torch.core.gateway import Gateway, GatewayConfig


class ReplayPolicy(AutoscalePolicy):
    """Re-emits a recorded decision sequence instead of deciding.

    Each tick consumes one record: ``desired_replicas`` returns the raw
    recorded policy output (the controller re-applies its own clamp /
    cooldown exactly as the original did) and ``fn_actions`` the recorded
    per-function directives. Past the end of the recording it holds
    steady. The policy reports the *recorded* policy's name so a replayed
    decision log is byte-identical to the original.
    """

    def __init__(self, records: Sequence[dict]):
        self.records: List[dict] = list(records)
        self.name = self.records[0]["policy"] if self.records else "replay"
        self._i = 0
        self._current: dict = {}

    def desired_replicas(self, window, current):
        if self._i >= len(self.records):
            self._current = {}
            return current
        self._current = self.records[self._i]
        self._i += 1
        return self._current["desired"]

    def fn_actions(self, window):
        return {fn: int(n)
                for fn, n in self._current.get("fn_deltas", ())}


def replay(records: Sequence[dict], **autoscaler_kwargs) -> Autoscaler:
    """Build an :class:`Autoscaler` that re-applies ``records``.

    Pass the same controller kwargs (interval, bounds, cooldown,
    workers_per_replica, ...) as the recording run, then attach to a
    simulator with ``sim.attach_autoscaler(...)`` as usual.
    """
    return Autoscaler(ReplayPolicy(records), **autoscaler_kwargs)


class ReplayGateway(Gateway):
    """Re-emits a recorded front-door verdict sequence
    (``Gateway.decision_records()``) instead of deciding.

    Only :meth:`Gateway.decide` is overridden, so the slot accounting,
    per-tenant counters, and release bookkeeping run exactly as live —
    the replayed run's result stream is byte-identical to the recording
    run's on the same seed/workload (consult order is deterministic).
    Past the end of the recording it admits everything. Records are the
    same plain-JSON shape ``save_decision_log``/``load_decision_log``
    round-trip.
    """

    def __init__(self, records: Sequence[dict], config=None, *,
                 record: bool = False):
        super().__init__(config or GatewayConfig(), record=record)
        self._replay: List[tuple] = [(r["rid"], r["verdict"])
                                     for r in records]
        self._ri = 0

    def decide(self, req, now, *, retry):
        if self._ri >= len(self._replay):
            return None
        rid, verdict = self._replay[self._ri]
        if rid != req.rid:
            raise ValueError(
                f"gateway replay diverged: consult #{self._ri} saw "
                f"rid={req.rid}, recording has rid={rid} (replaying "
                "against a different workload/seed?)")
        self._ri += 1
        return None if verdict == "admit" else verdict


def save_decision_log(records: Sequence[dict], path: str) -> None:
    with open(path, "w") as fh:
        json.dump({"decisions": list(records)}, fh, indent=1)


def load_decision_log(path: str) -> List[dict]:
    with open(path) as fh:
        return json.load(fh)["decisions"]
