"""Azure Functions public-trace ingestion → replayable arrival streams.

The port's own copy of the JAX package's ``workloads/azure.py``, which holds no
JAX: the port imports nothing of that package.

The Azure Functions 2019 trace (Shahrad et al., ATC'20 — the dataset
both SeBS and the FaaS-benchmarking literature replay) ships per-function
*invocation counts per minute*: CSV rows of

    HashOwner,HashApp,HashFunction,Trigger,1,2,...,1440

with one integer column per minute of the day. This module converts that
format into the testbed's exact-IAT replay substrate
(:class:`~repro_torch.workloads.arrivals.TraceArrivals`):

- :func:`load_azure_trace` — parse the CSV into per-function minute
  vectors (comment/blank tolerant, header optional).
- :func:`azure_trace_iats` — deterministically expand one function's
  minute counts into inter-arrival times: ``n`` invocations in a minute
  are spread evenly across its 60 seconds (the maximum-entropy placement
  given only a count — and deterministic, so the same CSV always yields
  the same stream). ``time_scale`` compresses wall time (0.01 ⇒ a full
  traced day replays in ~14.4 min of virtual time).
- :func:`azure_trace_arrivals` — the one-call converter to a
  ``TraceArrivals`` process, wired into the ``trace_replay`` scenario
  via ``build_scenario("trace_replay", path=..., fmt="azure")``.

Determinism contract: no RNG anywhere — the expansion is a pure function
of the CSV bytes, so replay is byte-identical across runs and machines.
"""
from __future__ import annotations

import csv
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.workloads.arrivals import TraceArrivals

#: seconds per trace bin (the Azure trace bins by minute)
BIN_S = 60.0


@dataclass(frozen=True)
class AzureTraceRow:
    """One function's day of traffic: identity hashes + minute counts."""

    owner: str
    app: str
    func: str
    trigger: str
    counts: tuple                      # invocations per minute bin

    @property
    def total(self) -> int:
        return sum(self.counts)

    def key(self) -> str:
        """Short stable id (func-hash prefix) for selection/reporting."""
        return self.func[:8]


def load_azure_trace(path: str) -> List[AzureTraceRow]:
    """Parse an Azure-format invocations CSV into trace rows.

    Tolerates the official header row (detected by non-numeric minute
    columns), ``#`` comment lines, and blank lines. Raises ValueError on
    rows with no minute columns — silently dropping malformed traffic
    would skew every replay built on the file."""
    rows: List[AzureTraceRow] = []
    with open(path, newline="") as fh:
        for lineno, rec in enumerate(csv.reader(fh), start=1):
            if not rec or rec[0].lstrip().startswith("#"):
                continue
            if rec[0].strip().lower() == "hashowner":
                continue                   # the official header row (its
                                           # minute columns are "1","2",…
                                           # — numeric, so detect by name)
            if len(rec) < 5:
                raise ValueError(
                    f"{path}:{lineno}: expected HashOwner,HashApp,"
                    f"HashFunction,Trigger,<minute counts...>, got {rec!r}")
            head, mins = rec[:4], rec[4:]
            try:
                counts = tuple(int(c or 0) for c in mins)
            except ValueError:
                raise ValueError(
                    f"{path}:{lineno}: non-integer minute count in {rec!r}")
            rows.append(AzureTraceRow(owner=head[0], app=head[1],
                                      func=head[2], trigger=head[3],
                                      counts=counts))
    if not rows:
        raise ValueError(f"{path}: no trace rows found")
    return rows


def select_function(rows: List[AzureTraceRow],
                    function: Optional[str] = None) -> AzureTraceRow:
    """Pick one function's row: by func-hash prefix when ``function`` is
    given, else the busiest function (ties broken by hash for
    determinism)."""
    if function is not None:
        matches = [r for r in rows if r.func.startswith(function)]
        if not matches:
            raise KeyError(f"no function hash starts with {function!r} "
                           f"(have: {sorted(r.key() for r in rows)})")
        if len(matches) > 1:
            raise KeyError(f"function prefix {function!r} is ambiguous: "
                           f"{sorted(r.key() for r in matches)}")
        return matches[0]
    return max(rows, key=lambda r: (r.total, r.func))


def minute_counts_to_iats(counts, *, time_scale: float = 1.0,
                          bin_s: float = BIN_S) -> List[float]:
    """Expand per-minute counts into deterministic inter-arrival times.

    A minute holding ``n`` invocations places them at the centres of
    ``n`` equal slices of the (scaled) minute — even spacing is the
    maximum-entropy reconstruction given only a count, and keeps the
    instantaneous rate inside every bin equal to the traced rate."""
    if time_scale <= 0:
        raise ValueError(f"time_scale must be positive, got {time_scale}")
    width = bin_s * time_scale
    times: List[float] = []
    for b, n in enumerate(counts):
        if n <= 0:
            continue
        start = b * width
        slot = width / n
        for i in range(n):
            times.append(start + (i + 0.5) * slot)
    iats: List[float] = []
    prev = 0.0
    for t in times:
        iats.append(t - prev)
        prev = t
    return iats


def _trace_counts(path: str, function: Optional[str],
                  aggregate: bool) -> List[int]:
    rows = load_azure_trace(path)
    if aggregate:
        n_bins = max(len(r.counts) for r in rows)
        counts = [0] * n_bins
        for r in rows:
            for b, n in enumerate(r.counts):
                counts[b] += n
        return counts
    return list(select_function(rows, function).counts)


def azure_trace_iats(path: str, *, function: Optional[str] = None,
                     time_scale: float = 1.0,
                     aggregate: bool = False) -> List[float]:
    """CSV → IAT list for one function (or ``aggregate=True``: the whole
    file's traffic summed per minute — the app-level load shape)."""
    return minute_counts_to_iats(_trace_counts(path, function, aggregate),
                                 time_scale=time_scale)


def azure_trace_arrivals(path: str, *, function: Optional[str] = None,
                         time_scale: float = 1.0, aggregate: bool = False,
                         loop: bool = False) -> TraceArrivals:
    """One-call converter: Azure CSV → exact-replay arrival process.

    ``loop=True`` tiles whole traced *days*: the cycle period is the
    full bin horizon (``n_bins × 60 s × time_scale``), so the idle tail
    after the day's last invocation is preserved and the looped rate
    equals the traced rate (a prefix-only tiling would replay sparse
    functions at a multiple of their real load)."""
    counts = _trace_counts(path, function, aggregate)
    return TraceArrivals(
        iats=minute_counts_to_iats(counts, time_scale=time_scale),
        loop=loop,
        period_s=len(counts) * BIN_S * time_scale)


#: trigger type → (priority class, p95 SLO seconds) heuristic for
#: per-row profiles: user-facing triggers get interactive latency
#: objectives, pipeline/background triggers run as batch with loose or
#: no objectives. Unknown triggers fall back to interactive/1.0 s.
TRIGGER_CLASSES: Dict[str, tuple] = {
    "http": ("interactive", 0.5),
    "event": ("interactive", 1.0),
    "queue": ("batch", 5.0),
    "storage": ("batch", 5.0),
    "timer": ("batch", None),
    "orchestration": ("batch", None),
    "others": ("batch", None),
}


def azure_trace_streams(path: str, *, time_scale: float = 1.0,
                        loop: bool = False,
                        duration_s: Optional[float] = None,
                        min_total: int = 1,
                        max_functions: Optional[int] = None,
                        rid_stride: Optional[int] = None,
                        seed: int = 1):
    """CSV → one per-row tenant stream each: a list of single-profile
    ``MixedWorkload``s, so one trace file yields a multi-function mix.

    Each trace row becomes its own workload — exact-IAT replay of that
    function's minute counts (:func:`azure_trace_arrivals` semantics),
    a :class:`~repro_torch.workloads.workload.FunctionProfile` named by the
    row's stable ``key()`` with ``weight=row.total`` and a
    trigger-derived priority class / p95 SLO (:data:`TRIGGER_CLASSES`),
    and a disjoint request-id range: stream ``i`` gets
    ``rid_base = i * rid_stride`` (stride defaults to the next power of
    ten above the busiest row's total, so ids also *read* as
    stream-tagged). Disjoint per-stream rid ranges and per-stream seeds
    are exactly the shape ``repro_torch.parallel.partition_streams`` buckets
    across partitions — every stream is self-contained, so any subset
    replays identically.

    Rows are ordered busiest-first (ties by function hash) for
    determinism; ``min_total`` drops all-idle rows and
    ``max_functions`` truncates to the heaviest N. ``duration_s``
    overrides each stream's generation horizon (defaults to the traced
    day — required when ``loop=True``, which otherwise never ends).
    """
    from repro_torch.workloads.workload import FunctionProfile, MixedWorkload
    rows = [r for r in load_azure_trace(path) if r.total >= min_total]
    rows.sort(key=lambda r: (-r.total, r.func))
    if max_functions is not None:
        rows = rows[:max_functions]
    if not rows:
        raise ValueError(f"{path}: no rows with >= {min_total} invocations")
    if rid_stride is None:
        rid_stride = 10
        while rid_stride <= max(r.total for r in rows):
            rid_stride *= 10
    streams = []
    for i, row in enumerate(rows):
        pri, slo = TRIGGER_CLASSES.get(row.trigger.strip().lower(),
                                       ("interactive", 1.0))
        n_bins = len(row.counts)
        horizon = n_bins * BIN_S * time_scale
        arrivals = TraceArrivals(
            iats=minute_counts_to_iats(row.counts, time_scale=time_scale),
            loop=loop, period_s=horizon)
        profile = FunctionProfile(
            fn=row.key(), weight=float(row.total),
            slo_p95_s=None if slo is None else slo * time_scale,
            priority=pri)
        streams.append(MixedWorkload(
            arrivals, [profile],
            duration_s=horizon if duration_s is None else duration_s,
            seed=seed + i, rid_base=i * rid_stride))
    return streams


def trace_functions(path: str) -> Dict[str, int]:
    """func-hash prefix → total invocations (exploration helper)."""
    return {r.key(): r.total for r in load_azure_trace(path)}
