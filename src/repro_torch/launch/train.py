"""Training launcher of the port: the JAX package's ``launch/train.py`` on one card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch train_100m \
      --steps 30 --seq 1024 --batch 8 --accum 2 --ckpt artifacts/train_100m

Trains a config at full width and depth on the CUDA card (``--device cpu``:
on the CPU with the kernels' plain versions; ``--reduced`` cuts the config to
smoke-test size): the synthetic token stream, AdamW (or ``--optimizer``)
under a 20-step warmup and cosine decay, gradient accumulation over
``--accum`` microbatches, checkpoints every ``--ckpt-every`` steps with the
last three kept, and a restart from the latest checkpoint. The log lines are
the JAX launcher's.

A checkpoint is named by the number of steps taken (``step_000000010``
holds the state after 10 updates) and a resumed run takes the next batch.
The JAX launcher names the state after step index i (i + 1 updates) ``i``
and resumes at index i, which trains on batch i twice; the port does not
copy that. ``--model-axis`` other than 1 (the JAX launcher's model-parallel
mesh) is ROADMAP A6.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import get_config
from repro_torch.configs import reduced as reduce_cfg
from repro_torch.data.pipeline import DataConfig, Prefetcher, TokenStream
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.models import build_model
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.schedule import warmup_cosine
from repro_torch.train.trainer import make_train_step


def main(argv=None):
    """Runs the training; returns the run's record: per-step ``losses`` and
    ``grad_norms`` (floats), the ``start`` step, ``seconds`` of wall time
    and ``tokens`` trained on."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="train_100m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--accum", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor", "sgdm"])
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.model_axis != 1:
        raise NotImplementedError(f"--model-axis {args.model_axis}: the model-parallel mesh is "
                                  f"ROADMAP A6; the port trains on one card")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    model = build_model(cfg, device=args.device, seed=0, attn_block=max(64, args.seq // 4))
    params = {n: p.detach() for n, p in model.params().items()}
    opt = make_optimizer(args.optimizer, warmup_cosine(args.lr, 20, args.steps), cfg)
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt, accum=args.accum)

    mgr = CheckpointManager(args.ckpt, keep=3) if args.ckpt else None
    start = 0
    if mgr:
        s, restored = mgr.restore_latest({"p": params, "o": opt_state})
        if restored is not None:
            params, opt_state, start = restored["p"], restored["o"], s
            print(f"[train] resumed at step {start}")

    stream = TokenStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                    global_batch=args.batch, seed=0))
    pf = Prefetcher(stream, start_step=start)
    end = start + args.steps
    t0, tokens = time.time(), 0
    losses, gnorms = [], []
    try:
        for i in range(start, end):
            params, opt_state, m = step_fn(params, opt_state, pf.next())
            losses.append(m["loss"])
            gnorms.append(m["grad_norm"])
            tokens += args.batch * args.seq
            if i % 10 == 0 or i == end - 1:
                print(f"[train] step {i:5d} loss={float(m['loss']):.4f} "
                      f"gnorm={float(m['grad_norm']):.3f} "
                      f"tok/s={tokens/(time.time()-t0):.0f}", flush=True)
            if mgr and (i + 1) % args.ckpt_every == 0:
                mgr.save(i + 1, {"p": params, "o": opt_state})
    finally:
        pf.stop()
    seconds = time.time() - t0          # the last step's loss was read: the card is done
    if mgr:
        if end % args.ckpt_every:
            mgr.save(end, {"p": params, "o": opt_state})
        mgr.wait()
    print("[train] done")
    return {"losses": [float(x) for x in losses], "grad_norms": [float(x) for x in gnorms],
            "start": start, "seconds": seconds, "tokens": tokens}


if __name__ == "__main__":
    main()
