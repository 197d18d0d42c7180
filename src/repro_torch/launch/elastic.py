"""Elasticity controller: drives scale-up/down + fault injection scenarios
against the simulator and reports SLO impact. The training-side analogue
(re-mesh via elastic checkpoint restore) is exercised in
tests/test_distributed_8dev.py::test_checkpoint_elastic_remesh.

The port's own copy of the JAX package's ``launch/elastic.py``, which holds no
JAX: the port imports nothing of that package.

  PYTHONPATH=src python -m repro_torch.launch.elastic --scenario scale_out
"""
from __future__ import annotations

import argparse

from repro_torch.core.config_store import ConfigStore
from repro_torch.core.router import build_leaf, build_tree
from repro_torch.core.simulator import (Simulator, SyntheticServiceModel,
                                        poisson_load, summarize)
from repro_torch.core.types import FunctionConfig

SCENARIOS = ("scale_out", "scale_in", "node_failure", "stragglers")


def run(scenario: str):
    store = ConfigStore()
    store.put(FunctionConfig(name="fn", arch="tiny_lm", concurrency=4,
                             cold_start_s=0.2))
    sim = Simulator(build_tree(8, fanout=4), store,
                    SyntheticServiceModel(seed=2), seed=7,
                    hedge_after_s=0.4 if scenario == "stragglers" else None)
    poisson_load(sim, fn="fn", rps=500, duration_s=12, seed=3)

    if scenario == "scale_out":
        sim.run(until=4.0)
        sim.add_branch(build_leaf("leaf-x", [f"wx{i}" for i in range(8)]))
    elif scenario == "scale_in":
        sim.run(until=4.0)
        sim.remove_branch("lb-leaf1")
    elif scenario == "node_failure":
        sim.inject_failure("w0", at=3.0, recover_after=4.0)
        sim.inject_failure("w1", at=3.5, recover_after=4.0)
    elif scenario == "stragglers":
        sim.set_straggler("w2", 8.0)
        sim.set_straggler("w5", 8.0)
    sim.run()
    s = summarize(sim.results)
    print(f"[elastic:{scenario}] n={s['n']} fail={s['fail_rate']:.3f} "
          f"p50={s['p50']*1e3:.1f}ms p99={s['p99']*1e3:.1f}ms "
          f"workers_end={len(sim.tree.all_workers())}")
    return s


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="all",
                    choices=list(SCENARIOS) + ["all"])
    args = ap.parse_args(argv)
    for sc in (SCENARIOS if args.scenario == "all" else [args.scenario]):
        run(sc)


if __name__ == "__main__":
    main()
