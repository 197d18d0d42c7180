"""The service-time estimator that deadline-aware routing reads.

A partial copy of the JAX package's ``autoscale/metrics.py``, which holds no
JAX: the port imports nothing of that package. Only :class:`ServiceEstimator`
is here, since the simulator attaches it to the routing view; the metrics
window, its samples and the latency estimator that the autoscaling
controller reads come with that controller.
"""
from __future__ import annotations

from collections import deque


class ServiceEstimator:
    """Windowed per-function mean *service-time* estimate.

    Fed one observation per completed request (in result order, so it is a pure
    function of the deterministic result stream), read by
    ``deadline_aware`` routing to price a worker's queued backlog. A
    running sum over a bounded deque keeps both ``observe`` and
    ``estimate`` O(1) — this sits on the per-arrival routing hot path.
    """

    def __init__(self, maxlen: int = 128, default_s: float = 0.05):
        self.maxlen = maxlen
        self.default_s = default_s
        self._win: dict = {}       # fn -> deque[float]
        self._sum: dict = {}       # fn -> running sum over the deque

    def observe(self, fn: str, service_s: float) -> None:
        d = self._win.get(fn)
        if d is None:
            d = self._win[fn] = deque(maxlen=self.maxlen)
            self._sum[fn] = 0.0
        if len(d) == self.maxlen:
            self._sum[fn] -= d[0]
        d.append(service_s)
        self._sum[fn] += service_s

    def estimate(self, fn: str) -> float:
        d = self._win.get(fn)
        if not d:
            return self.default_s
        return self._sum[fn] / len(d)
