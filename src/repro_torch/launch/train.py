"""Training launcher of the port: the JAX package's ``launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch train_100m \
      --steps 30 --seq 1024 --batch 8 --accum 2 --ckpt artifacts/train_100m

  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 8 \
      -m repro_torch.launch.train --device cpu --arch qwen3_32b --reduced --model-axis 2

Trains a config at full width and depth on the CUDA card (``--device cpu``:
on the CPU with the kernels' plain versions; ``--reduced`` cuts the config to
smoke-test size): the synthetic token stream, AdamW (or ``--optimizer``)
under a 20-step warmup and cosine decay, gradient accumulation over
``--accum`` microbatches, checkpoints every ``--ckpt-every`` steps with the
last three kept, and a restart from the latest checkpoint. The log lines are
the JAX launcher's, printed by rank 0.

On more than one rank (``torch.distributed.run``: NCCL on the cards, gloo
with ``--device cpu``) it trains on a ``(world / model_axis, model_axis)``
``("data", "model")`` mesh: the parameters and the optimizer state are
DTensors placed by ``TRAIN_RULES`` and the optimizer's ``state_axes``, each
microbatch is sharded over ``data``, the step runs under the rules'
activation constraints, and checkpoints are written shard by shard and
restored onto the run's own mesh, so a run resumed on another
``--model-axis`` re-meshes. One rank trains on plain tensors, as a mesh of
one device shards nothing, unless the caller has started a process group:
then it trains on a ``(1, 1)`` mesh.

A checkpoint is named by the number of steps taken (``step_000000010``
holds the state after 10 updates) and a resumed run takes the next batch.
The JAX launcher names the state after step index i (i + 1 updates) ``i``
and resumes at index i, which trains on batch i twice; the port does not
copy that.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.configs import reduced as reduce_cfg
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import DataConfig, Prefetcher, TokenStream
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.distributed.sharding import TRAIN_RULES, make_resolver, place, tree_shardings
from repro_torch.launch.mesh import init_process_group, make_local_mesh
from repro_torch.models import build_model
from repro_torch.models.layers import sharding_context
from repro_torch.models.transformer import input_specs
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
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.model_axis < 1 or world % args.model_axis:
        raise ValueError(f"--model-axis {args.model_axis} does not divide {world} ranks")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    meshed = world > 1 or torch.distributed.is_initialized()
    device = init_process_group(args.device) if meshed else args.device
    mesh = make_local_mesh(model_axis=args.model_axis, device=device) if meshed else None
    rank0 = not meshed or torch.distributed.get_rank() == 0
    model = build_model(cfg, device=device, seed=0, attn_block=max(64, args.seq // 4))
    opt = make_optimizer(args.optimizer, warmup_cosine(args.lr, 20, args.steps), cfg)
    params, opt_state, step_fn, context, shardings = setup_training(
        model, opt, mesh, rows=args.batch // args.accum, seq=args.seq, accum=args.accum)

    mgr = CheckpointManager(args.ckpt, keep=3) if args.ckpt else None
    start = 0
    if mgr:
        s, restored = mgr.restore_latest({"p": params, "o": opt_state}, shardings=shardings)
        if restored is not None:
            params, opt_state, start = restored["p"], restored["o"], s
            if rank0:
                print(f"[train] resumed at step {start}")

    stream = TokenStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                    global_batch=args.batch, seed=0))
    pf = Prefetcher(stream, start_step=start)
    end = start + args.steps
    t0, tokens = time.time(), 0
    losses, gnorms = [], []
    try:
        with context:
            for i in range(start, end):
                params, opt_state, m = step_fn(params, opt_state, pf.next())
                losses.append(m["loss"])
                gnorms.append(m["grad_norm"])
                tokens += args.batch * args.seq
                if rank0 and (i % 10 == 0 or i == end - 1):
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
    if rank0:
        print("[train] done")
    return {"losses": [float(x) for x in losses], "grad_norms": [float(x) for x in gnorms],
            "start": start, "seconds": seconds, "tokens": tokens}


def flat_axes(tree, prefix: str = "") -> dict:
    """The logical axes of ``param_axes``' tree by parameter name
    (``slots.0.wq``), as ``LM.params()`` names the parameters."""
    if isinstance(tree, dict):
        return {n: a for k, v in tree.items() for n, a in flat_axes(v, f"{prefix}{k}.").items()}
    if isinstance(tree, list):
        return {n: a for i, v in enumerate(tree)
                for n, a in flat_axes(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def place_tree(tree, shardings):
    """Every tensor of ``tree`` (held whole on every rank) placed by the
    ``NamedSharding`` at its place in ``shardings``."""
    if isinstance(tree, dict):
        return {k: place_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [place_tree(v, s) for v, s in zip(tree, shardings)]
    return place(tree, shardings)


class Training(NamedTuple):
    """What :func:`setup_training` gives: the state, the step and how to run
    it. ``shardings`` (``{"p": ..., "o": ...}``, None on plain tensors)
    restores a checkpoint onto the mesh."""
    params: dict
    opt_state: dict
    step: Callable
    context: contextlib.AbstractContextManager
    shardings: Optional[dict]


def setup_training(model, opt, mesh=None, *, rows: int, seq: int, accum: int,
                   grad_transform=None, rules=TRAIN_RULES) -> Training:
    """``model``'s parameters, ``opt``'s state for them and the train step
    over ``accum`` microbatches of ``rows`` x ``seq`` tokens, on plain
    tensors or, with ``mesh``, on it: the parameters placed by ``rules``
    (``TRAIN_RULES``; the dry run's per-arch ones) and their logical axes,
    the optimizer state by its ``state_axes``, each microbatch's rows over
    ``data`` where they divide, and the step run under the rules'
    activation constraints (the ``context``)."""
    params = {n: p.detach() for n, p in model.params().items()}
    opt_state = opt.init(params)
    if mesh is None:
        step = make_train_step(model, opt, accum=accum, grad_transform=grad_transform)
        return Training(params, opt_state, step, contextlib.nullcontext(), None)
    axes = flat_axes(model.param_axes())
    shardings = {"p": tree_shardings(mesh, params, axes, rules),
                 "o": tree_shardings(mesh, opt_state, opt.state_axes(axes), rules)}
    specs, batch_axes = input_specs(model.cfg, ShapeConfig("microbatch", seq, rows, "train"))
    batch_sh = tree_shardings(mesh, specs, batch_axes, rules)
    step = make_train_step(model, opt, accum=accum, grad_transform=grad_transform,
                           place_batch=lambda mb: {k: place(torch.as_tensor(v), batch_sh[k])
                                                   for k, v in mb.items()})
    return Training(place_tree(params, shardings["p"]), place_tree(opt_state, shardings["o"]),
                    step, sharding_context(make_resolver(mesh, rules)), shardings)


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
