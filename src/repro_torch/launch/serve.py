"""Serving launcher of the port: stand up the platform on the card and drive it.

  PYTHONPATH=src python -m repro_torch.launch.serve --workers 2 --requests 16 \
      --fn-arch tiny_lm --concurrency 4

Runs on the CUDA card; ``--device cpu`` runs the plain versions on the CPU.
"""
from __future__ import annotations

import argparse

from repro_torch.core.config_store import ConfigStore, ImageRegistry
from repro_torch.core.router import build_tree
from repro_torch.core.simulator import summarize
from repro_torch.core.types import FunctionConfig, Request
from repro_torch.serving.engine import Engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--fn-arch", default="tiny_lm")
    ap.add_argument("--concurrency", type=int, default=4)
    ap.add_argument("--gen-tokens", type=int, default=6)
    ap.add_argument("--policy", default="least_loaded")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    store = ConfigStore()
    store.put(FunctionConfig(name="fn", arch=args.fn_arch,
                             concurrency=args.concurrency,
                             gen_tokens=args.gen_tokens))
    engine = Engine(build_tree(args.workers, fanout=4,
                               leaf_policy=args.policy),
                    store, ImageRegistry(), max_len=64, device=args.device)
    for i in range(args.requests):
        engine.submit(Request(fn="fn", arrival_t=0.0, size=8 + 8 * (i % 3)))
    res = engine.run()
    s = summarize(res)
    print(f"[serve] device={engine.device} ok={s['ok']}/{s['n']} "
          f"p50={s['p50']*1e3:.0f}ms p99={s['p99']*1e3:.0f}ms "
          f"cold_rate={s['cold_rate']:.2f}")
    return 0


if __name__ == "__main__":
    main()
