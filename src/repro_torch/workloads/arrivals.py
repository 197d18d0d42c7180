"""Pluggable arrival processes for the testbed's load generator.

The port's own copy of the JAX package's ``workloads/arrivals.py``, which holds no
JAX: the port imports nothing of that package.

The paper's testbed exists to "quickly evaluate the impact of different
architectures" — but architectures only diverge under realistic traffic
shapes (SeBS; Barcelona-Pons & Garcia-Lopez). This module supplies the
shapes: steady Poisson, bursty MMPP on/off, diurnal rate envelopes, and
exact replay of inter-arrival-time (IAT) traces, Azure-Functions-style.

Determinism contract: every process is a pure function of its parameters
and the ``random.Random`` handed to :meth:`ArrivalProcess.times` — the
same seed always yields the same arrival stream, byte for byte. Processes
never hold hidden RNG state of their own.

Each process also has a vectorized batch path,
:meth:`ArrivalProcess.times_array`, drawing from a
``numpy.random.Generator`` instead. The numpy stream cannot reproduce
the Mersenne scalar stream, so the batch path carries its *own*
determinism contract (same seed ⇒ byte-identical array, pinned by the
``RequestBatch`` golden digests in tests/test_bulk.py) while matching
the scalar path in distribution; the scalar contract is untouched.

All processes yield absolute arrival times strictly inside
``[0, duration_s)`` — except :class:`TraceArrivals`, which replays its
trace verbatim (pass ``duration_s=None`` to replay everything).
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Type

import numpy as np

ARRIVALS: Dict[str, Type["ArrivalProcess"]] = {}


def register_arrival(cls):
    """Class decorator: add an ArrivalProcess subclass to the registry."""
    ARRIVALS[cls.kind] = cls
    return cls


def get_arrival(kind: str, **params) -> "ArrivalProcess":
    """Construct a registered arrival process by name: the config hook."""
    if kind not in ARRIVALS:
        raise KeyError(f"arrival process {kind!r} not registered "
                       f"(have: {sorted(ARRIVALS)})")
    return ARRIVALS[kind](**params)


def _poisson_times(rate: float, span: float, np_rng) -> np.ndarray:
    """Arrival times of a homogeneous Poisson(rate) process on
    ``[0, span)``, drawn in vectorized chunks: overdraw the expected
    count by ~4 sigma, cumsum, and top up from the last arrival on the
    (rare) shortfall — memorylessness makes the continuation exact."""
    if rate <= 0.0 or span <= 0.0:
        return np.empty(0, dtype=np.float64)
    scale = 1.0 / rate
    chunks = []
    t_last = 0.0
    while True:
        lam = rate * (span - t_last)
        m = int(lam + 4.0 * math.sqrt(lam + 1.0)) + 16
        ts = t_last + np.cumsum(np_rng.exponential(scale, m))
        if ts[-1] >= span:
            chunks.append(ts[ts < span])
            break
        chunks.append(ts)
        t_last = float(ts[-1])
    return chunks[0] if len(chunks) == 1 else np.concatenate(chunks)


class ArrivalProcess:
    """Base interface: yield absolute arrival times given an RNG."""

    kind = "base"

    def times(self, duration_s: Optional[float],
              rng: random.Random) -> Iterator[float]:
        raise NotImplementedError

    def times_array(self, duration_s: Optional[float],
                    np_rng: np.random.Generator) -> np.ndarray:
        """Vectorized counterpart of :meth:`times`: the full arrival
        stream as one ascending float64 array, drawn from a numpy
        ``Generator`` (the bulk path's own determinism contract — it
        does not reproduce the scalar Mersenne stream, only its
        distribution). Subclasses must override to join the bulk
        generation fast path (``MixedWorkload.generate_bulk``)."""
        raise NotImplementedError(
            f"{type(self).__name__} has no vectorized times_array; "
            "implement it to use the bulk generation fast path")

    def mean_rate(self) -> float:
        """Long-run average arrivals/s (for envelope sanity checks)."""
        raise NotImplementedError


@register_arrival
@dataclass
class PoissonArrivals(ArrivalProcess):
    """Homogeneous Poisson process: i.i.d. exponential inter-arrivals."""

    rate: float
    kind = "poisson"

    def times(self, duration_s, rng):
        t = 0.0
        while True:
            t += rng.expovariate(self.rate)
            if duration_s is not None and t >= duration_s:
                return
            yield t

    def times_array(self, duration_s, np_rng):
        if duration_s is None:
            raise ValueError("times_array needs a finite duration_s")
        return _poisson_times(self.rate, duration_s, np_rng)

    def mean_rate(self):
        return self.rate


@register_arrival
@dataclass
class BurstyArrivals(ArrivalProcess):
    """MMPP on/off: Poisson bursts at ``rate_on`` during exponentially
    distributed ON dwells, background ``rate_off`` between them.

    This is the canonical two-state Markov-modulated Poisson process;
    Poisson memorylessness lets each dwell restart its own exponential
    clock without biasing the stream.
    """

    rate_on: float
    rate_off: float = 0.0
    mean_on_s: float = 1.0
    mean_off_s: float = 9.0
    start_on: bool = False
    kind = "bursty"

    def times(self, duration_s, rng):
        on = self.start_on
        seg_start = 0.0
        while duration_s is None or seg_start < duration_s:
            dwell = rng.expovariate(
                1.0 / (self.mean_on_s if on else self.mean_off_s))
            seg_end = seg_start + dwell
            rate = self.rate_on if on else self.rate_off
            if rate > 0.0:
                t = seg_start
                while True:
                    t += rng.expovariate(rate)
                    if t >= seg_end or (duration_s is not None
                                        and t >= duration_s):
                        break
                    yield t
            seg_start = seg_end
            on = not on

    def times_array(self, duration_s, np_rng):
        # per-phase segments: each dwell is one exponential draw, each
        # ON/OFF span one vectorized Poisson batch (memorylessness lets
        # every dwell restart its own clock, exactly like the scalar
        # path)
        if duration_s is None:
            raise ValueError("times_array needs a finite duration_s")
        out = []
        on = self.start_on
        seg_start = 0.0
        while seg_start < duration_s:
            dwell = float(np_rng.exponential(
                self.mean_on_s if on else self.mean_off_s))
            rate = self.rate_on if on else self.rate_off
            span = min(seg_start + dwell, duration_s) - seg_start
            if rate > 0.0 and span > 0.0:
                seg = _poisson_times(rate, span, np_rng)
                if len(seg):
                    out.append(seg_start + seg)
            seg_start += dwell
            on = not on
        if not out:
            return np.empty(0, dtype=np.float64)
        return out[0] if len(out) == 1 else np.concatenate(out)

    def mean_rate(self):
        tot = self.mean_on_s + self.mean_off_s
        return (self.rate_on * self.mean_on_s
                + self.rate_off * self.mean_off_s) / tot


@register_arrival
@dataclass
class DiurnalArrivals(ArrivalProcess):
    """Non-homogeneous Poisson with a sinusoidal rate envelope:

        rate(t) = base_rate * (1 + amplitude * sin(2*pi*t/period + phase))

    Generated by Lewis-Shedler thinning against the peak rate, so the
    instantaneous intensity tracks the envelope exactly.
    """

    base_rate: float
    amplitude: float = 0.8             # 0..1; 1 => troughs reach zero
    period_s: float = 86400.0          # one "day" (compress for studies)
    phase: float = 0.0
    kind = "diurnal"

    def rate_at(self, t: float) -> float:
        return self.base_rate * (
            1.0 + self.amplitude
            * math.sin(2.0 * math.pi * t / self.period_s + self.phase))

    def times(self, duration_s, rng):
        peak = self.base_rate * (1.0 + abs(self.amplitude))
        t = 0.0
        while True:
            t += rng.expovariate(peak)
            if duration_s is not None and t >= duration_s:
                return
            if rng.random() * peak < self.rate_at(t):
                yield t

    def times_array(self, duration_s, np_rng):
        # batch Lewis-Shedler thinning: one Poisson(peak) candidate
        # batch, the sinusoidal envelope evaluated vectorized, one
        # uniform accept batch
        if duration_s is None:
            raise ValueError("times_array needs a finite duration_s")
        peak = self.base_rate * (1.0 + abs(self.amplitude))
        cand = _poisson_times(peak, duration_s, np_rng)
        if not len(cand):
            return cand
        rate = self.base_rate * (1.0 + self.amplitude * np.sin(
            2.0 * np.pi * cand / self.period_s + self.phase))
        keep = np_rng.random(len(cand)) * peak < rate
        return cand[keep]

    def mean_rate(self):
        return self.base_rate


@register_arrival
@dataclass
class TraceArrivals(ArrivalProcess):
    """Replay an inter-arrival-time trace exactly (Azure-Functions-style:
    one IAT in seconds per line; blank lines and ``#`` comments skipped).

    The replay is verbatim — no RNG is consumed — so a written trace
    round-trips to the identical arrival stream. ``loop=True`` tiles the
    trace until ``duration_s``; ``period_s`` (optional) is the full
    cycle length for looping — without it, tiling restarts immediately
    after the *last arrival*, silently dropping any idle tail between
    that arrival and the end of the traced window (and inflating the
    replayed rate for traces with sparse late traffic, e.g. most Azure
    day traces). Converters that know the trace horizon should set it.
    """

    iats: Sequence[float] = field(default_factory=list)
    loop: bool = False
    period_s: Optional[float] = None
    kind = "trace"

    @classmethod
    def from_file(cls, path: str, *, loop: bool = False,
                  period_s: Optional[float] = None) -> "TraceArrivals":
        return cls(iats=read_trace(path), loop=loop, period_s=period_s)

    def times(self, duration_s, rng):
        t = 0.0
        while True:
            start = t
            for iat in self.iats:
                t += iat
                if duration_s is not None and t >= duration_s:
                    return
                yield t
            if not self.loop or not self.iats:
                return
            if self.period_s is not None:
                # restore the cycle's idle tail (never move backwards if
                # a caller passed a period shorter than the trace span)
                t = max(t, start + self.period_s)

    def times_array(self, duration_s, np_rng=None):
        # verbatim replay consumes no RNG; looping tiles cycle offsets
        # (cycle = max(trace span, period_s), matching the scalar
        # idle-tail restoration). Absolute times come from per-cycle
        # offset + cumsum rather than one running float sum, so the two
        # paths can differ in the last ulp — covered by the bulk
        # contract, not the scalar goldens.
        base = np.cumsum(np.asarray(self.iats, dtype=np.float64))
        if not self.loop or not len(base):
            return base if duration_s is None else base[base < duration_s]
        if duration_s is None:
            raise ValueError("looped trace replay needs a finite "
                             "duration_s")
        cycle = (base[-1] if self.period_s is None
                 else max(float(base[-1]), self.period_s))
        if cycle <= 0.0:
            raise ValueError("looped trace with zero span never advances")
        reps = int(math.ceil(duration_s / cycle)) + 1
        tiled = (np.arange(reps, dtype=np.float64)[:, None] * cycle
                 + base[None, :]).ravel()
        return tiled[tiled < duration_s]

    def mean_rate(self):
        total = (self.period_s if self.loop and self.period_s is not None
                 else sum(self.iats))
        return len(self.iats) / total if total > 0 else 0.0


def read_trace(path: str) -> List[float]:
    """Read one IAT (seconds) per line; '#' comments and blanks skipped."""
    iats: List[float] = []
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if line:
                iats.append(float(line))
    return iats


def write_trace(path: str, iats: Sequence[float]) -> None:
    """Write IATs with full float precision so replay is bit-exact."""
    with open(path, "w") as fh:
        for iat in iats:
            fh.write(f"{iat!r}\n")


def iats_from_times(times: Sequence[float]) -> List[float]:
    """Convert absolute arrival times back into an IAT trace."""
    out: List[float] = []
    prev = 0.0
    for t in times:
        out.append(t - prev)
        prev = t
    return out
