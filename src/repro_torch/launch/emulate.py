"""Worker emulation on the port (paper §III.B, Fig. 2), end to end.

Step 1 runs a real worker (the port's serving engine, on the card) under the
artificial load of ``examples/emulate_workers.py``: 24 requests, 80% tiny_lm
and 20% small_lm, drained now and then. Step 2 fits the ridge and MLP worker
models to its telemetry, step 4 reports their per-row error, and step 3
serves many emulated workers from the ridge model in the simulator.

  PYTHONPATH=src python -m repro_torch.launch.emulate          # on the card
  PYTHONPATH=src python -m repro_torch.launch.emulate --device cpu \
      --workers 64 --rps 500 --duration 1

The defaults are the example's: 1024 workers (fanout 16), 5000 requests/s
for 4 s.
"""
from __future__ import annotations

import argparse
from typing import List

import numpy as np

from repro_torch.core.config_store import ConfigStore, ImageRegistry
from repro_torch.core.emulation import (EmulatedServiceModel, MLPWorkerModel,
                                        RidgeWorkerModel, telemetry_matrix)
from repro_torch.core.router import build_tree
from repro_torch.core.simulator import Simulator, poisson_load, summarize
from repro_torch.core.types import FunctionConfig, Request, TelemetryRecord


def demo_store() -> ConfigStore:
    store = ConfigStore()
    for fn, arch, c in (("tiny-gen", "tiny_lm", 4), ("small-gen", "small_lm", 2)):
        store.put(FunctionConfig(name=fn, arch=arch, concurrency=c,
                                 gen_tokens=4, idle_timeout_s=60.0))
    return store


def profile_worker(store: ConfigStore, device=None) -> List[TelemetryRecord]:
    """Step 1: 24 requests of the example's mix (seed 0) on one real worker;
    the telemetry rows that carry a latency."""
    from repro_torch.serving.engine import Worker
    w = Worker("w-real", store, ImageRegistry(), max_len=64, device=device)
    rng = np.random.default_rng(0)
    for _ in range(24):
        fn = "tiny-gen" if rng.random() < 0.8 else "small-gen"
        w.submit(Request(fn=fn, arrival_t=0.0, size=int(rng.integers(4, 24))))
        if rng.random() < 0.4:
            w.drain()
    w.drain()
    return [t for t in w.telemetry if t.latency > 0]


def row_errors(model, X: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Step 4: relative error of one prediction on every third row (noise
    from seed 7)."""
    rng = np.random.default_rng(7)
    errs = []
    for i in range(0, len(X), 3):
        pred, _ = model.predict(X[i], rng)
        errs.append(abs(pred - y[i]) / max(y[i], 1e-9))
    return np.array(errs)


def emulate(store: ConfigStore, model, *, workers: int = 1024, rps: float = 5000,
            duration_s: float = 4):
    """Step 3: ``workers`` emulated workers (fanout 16) served from
    ``model``. Returns the simulator (after its run), the request count and
    the summary."""
    sim = Simulator(build_tree(workers, fanout=16), store,
                    EmulatedServiceModel(model, seed=2), seed=4)
    n = poisson_load(sim, fn="tiny-gen", rps=rps, duration_s=duration_s, seed=6)
    return sim, n, summarize(sim.run())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--workers", type=int, default=1024)
    ap.add_argument("--rps", type=float, default=5000)
    ap.add_argument("--duration", type=float, default=4)
    args = ap.parse_args(argv)

    store = demo_store()
    recs = profile_worker(store, args.device)
    print(f"step 1: {len(recs)} telemetry rows from a real worker "
          f"(features: {recs[0].FEATURE_NAMES})")
    X, y, ok = telemetry_matrix(recs)
    ridge = RidgeWorkerModel.fit(X, y, ok, device=args.device)
    mlp = MLPWorkerModel.fit(X, y, ok, steps=300, device=args.device)
    print(f"step 2: ridge resid_std={ridge.resid_std:.3f}  "
          f"mlp resid_std={mlp.resid_std:.3f}")
    for name, model in (("ridge", ridge), ("mlp", mlp)):
        errs = row_errors(model, X, y)
        print(f"step 4 [{name:5s}]: per-row median rel err {np.median(errs):.2%}  "
              f"(p90 {np.percentile(errs, 90):.2%})")
    sim, n, s = emulate(store, ridge, workers=args.workers, rps=args.rps,
                        duration_s=args.duration)
    print(f"step 3 at scale: {n} requests over {args.workers} emulated workers -> "
          f"p50={s['p50'] * 1e3:.1f}ms p99={s['p99'] * 1e3:.1f}ms "
          f"fail={s['fail_rate']:.3f} events={sim.events_processed}")
    return 0


if __name__ == "__main__":
    main()
