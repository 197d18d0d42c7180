"""Result summaries, ported from the JAX package's ``core/simulator.py``.

Only :func:`summarize` is ported so far (``launch/serve.py`` prints it); the
discrete-event simulator itself is a later slice of the port.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.core.types import RequestResult


def summarize(results: List[RequestResult]) -> dict:
    if not results:
        return {"n": 0}
    lat = np.array([r.latency for r in results if r.ok])
    ok = sum(r.ok for r in results)
    # cold_rate over *served* rows only: failures that never reached an
    # instance (gateway sheds, dead-on-arrival routing, queue timeouts —
    # their instance column is "-") can't have had a cold start
    served = sum(1 for r in results if r.instance != "-")
    # throughput/goodput over the useful makespan: last *successful*
    # finish minus first arrival
    t0 = min(r.arrival_t for r in results)
    t1 = max((r.finish_t for r in results if r.ok), default=t0)
    makespan = t1 - t0
    goodput = ok / max(makespan, 1e-9) if ok else 0.0
    return {
        "n": len(results), "ok": ok, "fail_rate": 1 - ok / len(results),
        "cold_rate": (sum(r.cold_start for r in results) / served
                      if served else 0.0),
        "p50": float(np.percentile(lat, 50)) if len(lat) else float("nan"),
        "p95": float(np.percentile(lat, 95)) if len(lat) else float("nan"),
        "p99": float(np.percentile(lat, 99)) if len(lat) else float("nan"),
        "mean": float(lat.mean()) if len(lat) else float("nan"),
        "throughput": goodput,
        "goodput": goodput,
    }
