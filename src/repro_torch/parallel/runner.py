"""Partitioned simulation runner: conservative lookahead + deterministic merge.

The port's own copy of the JAX package's ``parallel/runner.py``, which holds no
JAX: the port imports nothing of that package.

The coordinator drives K independent :class:`Simulator` instances — one
per tenant-stream / LB-branch partition, built by a user callback — and
merges their result/telemetry/decision/fault streams back into one
byte-stable ``(t, seq)``-ordered record (:class:`MergedRun`). Two
execution modes share one driver protocol, so they are byte-identical
by construction:

- ``inline``   — partitions advance in-process, one after another (the
  reference; ``parallelism=1`` degenerates to a plain serial run).
- ``process``  — each partition runs in a forked worker process and the
  coordinator speaks a small message protocol over a pipe. The *fork*
  start method is required: the builder closure is inherited, never
  pickled.

Two synchronization regimes:

- **Fast path (no global coupling).** With no platform-wide
  ``max_inflight`` and no forced window, partitions share nothing:
  per-tenant token buckets are partition-local by construction (a
  tenant lives in exactly one partition), so every partition free-runs
  to completion and only the merge is serial. This is the documented
  "partition-local quota split" — *exactly* equivalent to the serial
  run whenever tenants don't share branches, which is the common
  multi_tenant / noisy_neighbor / Azure-trace shape.
- **Windowed barriers (global coupling).** A platform-wide
  ``max_inflight`` (or an explicit ``window_s``) switches to
  conservative-lookahead rounds: every partition advances to the next
  window edge, reports its deterministic occupancy summary, and the
  coordinator re-apportions the global ceiling across partition-local
  gateways (largest-remainder on demand — ``partition.split_ceiling``)
  before the next round. The window is the natural lookahead — no
  capacity directive can take effect sooner than the shortest cold
  start or the autoscale tick period (``partition.conservative_window``)
  — so exchanging once per window never misses an interaction.

Merge determinism: every per-partition stream is nondecreasing in time,
so a k-way merge keyed ``(t, partition, position)`` is a total order
independent of process scheduling; same seed + same partition count ⇒
byte-identical merged output, and ``stream_digest`` applies to a
:class:`MergedRun` exactly as to a :class:`Simulator`.
"""
from __future__ import annotations

import heapq
import multiprocessing
from typing import Callable, List, Optional

from repro_torch.parallel.partition import (combined_digest, conservative_window,
                                            demand_of, maybe_attach_sink,
                                            split_ceiling, window_summary)


# ------------------------------------------------------------ collection
def _collect(sim, mode: str, sink) -> dict:
    """One partition's final payload: counters, decision/fault logs, the
    mergeable summary partial, the stream digest, and (``mode="full"``)
    the raw result/telemetry/workflow streams."""
    from repro_torch.core.simulator import part_summary, stream_digest
    counters = {
        "events_processed": sim.events_processed,
        "arrivals_seen": sim.arrivals_seen,
        "hedges_seen": sim.hedges_seen,
        "cold_starts_total": sim.cold_starts_total,
        "retries_scheduled": sim.retries_scheduled,
        "retries_shed": sim.retries_shed,
        "retries_dropped": sim.retries_dropped,
        "results": len(sim.results),
        "arrivals_by_fn": dict(sim.arrivals_by_fn),
    }
    if sim.gateway is not None:
        counters["gw_admitted"] = sim.gateway.admitted_total
        counters["gw_shed"] = sim.gateway.shed_total
    payload = {
        "counters": counters,
        "fault_log": sim.fault_log(),
        "placement": list(sim.placement_records),
        "routing": list(sim.routing_records),
        "gateway": list(sim.gateway_records),
    }
    if sink is not None:
        payload["part"] = sink.part()
        payload["digest"] = sink.digest()
    else:
        payload["part"] = part_summary(sim.results)
        payload["digest"] = stream_digest(sim)
    if mode == "full":
        payload["results"] = list(sim.results)
        payload["telemetry"] = list(sim.telemetry)
        payload["workflow_results"] = list(sim.workflow_results)
    return payload


# ------------------------------------------------------- driver protocol
# One protocol, two transports. Ops: run_until(t) -> summary,
# run_all/drain -> summary, set_ceiling(c) -> None, collect(mode) ->
# payload, close. ``start`` issues an op, ``finish`` returns its reply —
# split so the coordinator can issue one op to *every* partition before
# waiting on any (that concurrency is the whole point of process mode).

class _InlineDriver:
    """Reference transport: the partition simulator lives in-process and
    every op executes synchronously in ``start`` (``finish`` just hands
    the stored reply back). Byte-identical to process mode because both
    run exactly this op sequence against identical simulators."""

    def __init__(self, build, k: int, n: int, collect_mode: str):
        self.sim = build(k, n)
        self.sink = (maybe_attach_sink(self.sim)
                     if collect_mode == "summary" else None)
        self.window = conservative_window(self.sim)
        self._reply = None

    def start(self, op: str, *a) -> None:
        sim = self.sim
        if op == "run_until":
            sim.run(until=a[0])
            self._reply = window_summary(sim)
        elif op in ("run_all", "drain"):
            sim.run()
            self._reply = window_summary(sim)
        elif op == "set_ceiling":
            if sim.gateway is not None:
                sim.gateway.set_ceiling(a[0])
            self._reply = None
        elif op == "collect":
            self._reply = _collect(sim, a[0], self.sink)
        else:
            raise ValueError(f"unknown driver op {op!r}")

    def finish(self):
        reply, self._reply = self._reply, None
        return reply

    def close(self) -> None:
        pass


def _worker_main(conn, build, k: int, n: int, collect_mode: str) -> None:
    """Process-mode partition loop: build the simulator, report the
    lookahead window, then serve coordinator ops until ``close``. Any
    exception is shipped back as an ``("error", traceback)`` reply so
    the coordinator can surface it instead of hanging on a dead pipe."""
    try:
        sim = build(k, n)
        sink = maybe_attach_sink(sim) if collect_mode == "summary" else None
        conn.send(("ready", conservative_window(sim)))
        while True:
            msg = conn.recv()
            op = msg[0]
            if op == "run_until":
                sim.run(until=msg[1])
                conn.send(("ok", window_summary(sim)))
            elif op in ("run_all", "drain"):
                sim.run()
                conn.send(("ok", window_summary(sim)))
            elif op == "set_ceiling":
                if sim.gateway is not None:
                    sim.gateway.set_ceiling(msg[1])
                conn.send(("ok", None))
            elif op == "collect":
                conn.send(("ok", _collect(sim, msg[1], sink)))
            elif op == "close":
                conn.send(("ok", None))
                conn.close()
                return
            else:
                conn.send(("error", f"unknown driver op {op!r}"))
    except BaseException as e:           # noqa: BLE001 — shipped to coordinator
        import traceback
        try:
            conn.send(("error",
                       f"{type(e).__name__}: {e}\n{traceback.format_exc()}"))
        except Exception:
            pass


class _ProcessDriver:
    """Pipe transport to a forked partition worker (``_worker_main``)."""

    def __init__(self, ctx, build, k: int, n: int, collect_mode: str):
        self.k = k
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=_worker_main,
                                args=(child, build, k, n, collect_mode),
                                daemon=True)
        self.proc.start()
        child.close()
        tag, val = self.conn.recv()
        if tag != "ready":
            raise RuntimeError(f"partition {k} failed to build:\n{val}")
        self.window = val

    def start(self, op: str, *a) -> None:
        self.conn.send((op,) + a)

    def finish(self):
        tag, val = self.conn.recv()
        if tag == "error":
            raise RuntimeError(f"partition {self.k} failed:\n{val}")
        return val

    def close(self) -> None:
        try:
            self.start("close")
            self.finish()
        except Exception:
            pass
        self.proc.join(timeout=30)
        if self.proc.is_alive():
            self.proc.terminate()
        try:
            self.conn.close()
        except Exception:
            pass


# ------------------------------------------------------------------ merge
def _merge_stream(parts: List[list], key) -> list:
    """k-way merge of per-partition streams, each nondecreasing under
    ``key``, into the total order ``(key, partition, position)`` — the
    ``(t, seq)`` contract. Ties across partitions break toward the lower
    partition index; the decorated tuples are unique, so the payload
    objects themselves are never compared."""
    runs = [((key(x), k, i, x) for i, x in enumerate(lst))
            for k, lst in enumerate(parts)]
    return [e[3] for e in heapq.merge(*runs)]


def _line_t(line: str) -> float:
    """Timestamp of one decision/fault log line — every record layer
    writes ``t=<float> ...`` as its prefix."""
    return float(line[2:line.index(" ", 2)])


def _merge_lines(parts: List[List[str]]) -> List[str]:
    return _merge_stream(parts, _line_t)


def _merge_counters(parts: List[dict]) -> dict:
    out: dict = {}
    by_fn: dict = {}
    for c in parts:
        for k, v in c.items():
            if k == "arrivals_by_fn":
                for fn, n in v.items():
                    by_fn[fn] = by_fn.get(fn, 0) + n
            else:
                out[k] = out.get(k, 0) + v
    out["arrivals_by_fn"] = by_fn
    return out


class MergedRun:
    """The deterministic union of K partition runs.

    Exposes the same reporting surface a :class:`Simulator` does —
    ``results`` / ``telemetry`` / ``workflow_results`` streams (full
    collects), ``placement_log()`` / ``routing_log()`` /
    ``gateway_log()`` / ``fault_log()``, and ``summary()`` — so golden
    and equivalence suites (``stream_digest``) apply unchanged. Also
    carries the merge provenance: per-partition ``digests``, summed
    ``counters``, and the barrier exchange history (``barriers``)."""

    def __init__(self, payloads: List[dict], *, window_s, mode: str,
                 collect: str, barriers: List[dict]):
        self.n_partitions = len(payloads)
        self.window_s = window_s
        self.mode = mode
        self.collect = collect
        self.barriers = barriers
        self.digests = [p["digest"] for p in payloads]
        self._parts = [p["part"] for p in payloads]
        self.counters = _merge_counters([p["counters"] for p in payloads])
        self.placement_records = _merge_lines(
            [p["placement"] for p in payloads])
        self.routing_records = _merge_lines([p["routing"] for p in payloads])
        self.gateway_records = _merge_lines([p["gateway"] for p in payloads])
        self._fault_lines = _merge_lines(
            [p["fault_log"].splitlines() for p in payloads])
        if collect == "full":
            self.results = _merge_stream(
                [p["results"] for p in payloads], lambda r: r.finish_t)
            self.telemetry = _merge_stream(
                [p["telemetry"] for p in payloads], lambda t: t.t)
            self.workflow_results = _merge_stream(
                [p["workflow_results"] for p in payloads],
                lambda w: w.finish_t)
        else:
            self.results = []
            self.telemetry = []
            self.workflow_results = []

    # ------------------------------------------------ simulator-shaped API
    def placement_log(self) -> str:
        return "\n".join(self.placement_records)

    def routing_log(self) -> str:
        return "\n".join(self.routing_records)

    def gateway_log(self) -> str:
        return "\n".join(self.gateway_records)

    def fault_log(self) -> str:
        return "\n".join(self._fault_lines)

    def summary(self) -> dict:
        """Exactly ``summarize()`` over the union of all partitions'
        results, computed from mergeable partials (works for summary
        collects too, where the raw rows were never shipped)."""
        from repro_torch.core.simulator import merge_part_summaries
        return merge_part_summaries(self._parts)

    def digest(self) -> str:
        """Byte-identity projection: ``stream_digest`` of the merged
        streams (full collects), else the order-sensitive combination
        of the per-partition stream digests."""
        if self.collect == "full":
            from repro_torch.core.simulator import stream_digest
            return stream_digest(self)
        return combined_digest(self.digests)


# ------------------------------------------------------------ coordinator
def _fork_available() -> bool:
    return "fork" in multiprocessing.get_all_start_methods()


def run_partitioned(build: Callable, n_partitions: int, *,
                    window_s: Optional[float] = None,
                    mode: str = "auto",
                    processes: Optional[int] = None,
                    max_inflight: Optional[int] = None,
                    collect: str = "full") -> MergedRun:
    """Run a K-partitioned scenario and merge the streams.

    ``build(k, n_partitions)`` must return a fully *loaded* Simulator
    for partition ``k`` — its own LB subtree, config store, and its
    disjoint share of the tenant streams (``partition.partition_streams``
    buckets them the way ``tenant_hash`` routing would). The callback
    runs inside the worker process in process mode, so generation
    parallelises with everything else.

    ``max_inflight`` turns on the barrier-coupled regime: partition
    gateways are treated as shards of one platform-wide ceiling,
    re-apportioned from exchanged occupancy at every window barrier.
    ``window_s=None`` derives the lookahead from the scenario
    (``conservative_window``); setting it forces barrier cadence even
    uncoupled (useful for invariants tests). With neither, the
    partition-local fast path free-runs every partition to completion.

    ``collect="summary"`` skips shipping raw result/telemetry rows and
    (when no autoscaler is bound) folds results through a
    ``ResultSink`` in the worker — the 10M-row memory/IPC path;
    ``summary()``, ``counters``, decision logs, and per-partition
    digests still work. ``processes`` caps concurrently-live partitions
    on the fast path (waves); barrier-coupled runs keep all partitions
    live, as the exchange requires.
    """
    if n_partitions < 1:
        raise ValueError("n_partitions must be >= 1")
    if collect not in ("full", "summary"):
        raise ValueError(f"collect must be 'full' or 'summary', "
                         f"got {collect!r}")
    if mode == "auto":
        mode = ("process" if n_partitions > 1 and _fork_available()
                else "inline")
    if mode not in ("inline", "process"):
        raise ValueError(f"mode must be 'auto', 'inline' or 'process', "
                         f"got {mode!r}")
    ctx = multiprocessing.get_context("fork") if mode == "process" else None

    def make(k: int):
        if mode == "process":
            return _ProcessDriver(ctx, build, k, n_partitions, collect)
        return _InlineDriver(build, k, n_partitions, collect)

    K = n_partitions
    coupled = max_inflight is not None
    windowed = coupled or window_s is not None
    barriers: List[dict] = []
    payloads: List[Optional[dict]] = [None] * K

    if not windowed:
        # fast path: nothing is shared, so partitions free-run in waves
        wave = K if processes is None else max(1, int(processes))
        for lo in range(0, K, wave):
            ks = list(range(lo, min(lo + wave, K)))
            drivers = [make(k) for k in ks]
            try:
                for d in drivers:
                    d.start("run_all")
                for d in drivers:
                    d.finish()
                for d in drivers:
                    d.start("collect", collect)
                for d, k in zip(drivers, ks):
                    payloads[k] = d.finish()
            finally:
                for d in drivers:
                    d.close()
        return MergedRun(payloads, window_s=None, mode=mode,
                         collect=collect, barriers=barriers)

    drivers = [make(k) for k in range(K)]
    try:
        w = (float(window_s) if window_s is not None
             else min(d.window for d in drivers))
        if coupled:
            # pre-run split: no occupancy yet, so apportion evenly
            ceilings = split_ceiling(max_inflight, [1.0] * K)
            for d, c in zip(drivers, ceilings):
                d.start("set_ceiling", c)
            for d in drivers:
                d.finish()
        target = w
        while True:
            for d in drivers:
                d.start("run_until", target)
            summaries = [d.finish() for d in drivers]
            rec = {"t": target,
                   "pending": [s["pending_real"] for s in summaries]}
            if coupled:
                demands = [demand_of(s) for s in summaries]
                ceilings = split_ceiling(max_inflight, demands)
                for d, c in zip(drivers, ceilings):
                    d.start("set_ceiling", c)
                for d in drivers:
                    d.finish()
                rec["demands"] = demands
                rec["ceilings"] = ceilings
            barriers.append(rec)
            if all(s["pending_real"] == 0 for s in summaries):
                break
            # skip idle gaps: jump the barrier clock when every live
            # partition's next event is beyond the next window edge
            # (exchanges across a dead gap would re-derive identical
            # directives from unchanged summaries)
            nxt = target + w
            nts = [s["next_t"] for s in summaries
                   if s["pending_real"] > 0 and s["next_t"] is not None]
            if nts and min(nts) > nxt:
                nxt = min(nts) + w
            target = nxt
        for d in drivers:
            d.start("drain")            # settle background events
        for d in drivers:
            d.finish()
        for d in drivers:
            d.start("collect", collect)
        for k, d in enumerate(drivers):
            payloads[k] = d.finish()
    finally:
        for d in drivers:
            d.close()
    return MergedRun(payloads, window_s=w, mode=mode, collect=collect,
                     barriers=barriers)
