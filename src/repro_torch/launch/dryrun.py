"""The dry run of the port: the counterpart of the JAX package's
``launch/dryrun.py``, one (arch x shape x mesh) cell a call.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_32b \
      --shape train_4k --mesh single [--out artifacts/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --list

The JAX dry run compiles each cell for 256 (``single``) or 512 (``multi``)
placeholder devices and reads XLA's analyses. The port runs the cell's step
eagerly, on one process, as rank 0 of a fake process group of that size
(``torch.testing._internal.distributed.fake_pg``: every collective a
no-op), on fake tensors (``FakeTensorMode``: shapes and dtypes, no
storage): the parameters, the optimizer state, the batch and the cache are
DTensors of the production mesh placed by the rules of the cell's mode
(``rules_for_cfg``), and the step runs under their activation constraints,
as on the cards. ``telemetry.roofline``'s three counters watch it run: the
FLOPs, bytes and collectives each rank issues on its local shards, and the
peak of its live storage.

The fake tensors are ``cpu`` ones, so ``kernels/ops.py`` sends every kernel
call to its plain version (a CUDA kernel cannot run on a fake tensor): the
port's dry run counts the plain path, as the JAX dry run counts its
``attn_impl="ref"`` path. Where the plain version holds more than the
kernel (prefill attention's ``[B, KV, G, S, S]`` float32 scores), the peak
is the plain path's.

Modes (``build_cell``): ``train``, the train step of ``make_train_step``
with the config's optimizer and its ``state_axes``; ``prefill``, with the
encoder case (full-sequence logits, no cache); ``decode`` and
``long_decode``, the cache donated (written in place). Eager PyTorch runs
every layer, so the whole depth is counted directly (no shallow probes).
A train step of ``accum`` microbatches runs two of them (one where
``accum`` is 1): its peak is that of every later microbatch, and its costs
up to the mean gradients are scaled to ``accum`` microbatches, the
optimizer's update counted once (``probe_costs``).

An artifact (``<out>/<arch>__<shape>__<mesh>.json``) keeps the JAX
package's keys: ``lower_s`` is the seconds to build the cell, ``compile_s``
those of the counted run and ``probe_s`` 0 (the costs come from that run),
all of the host's CPU, not of the card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from dataclasses import replace

import torch

from repro_torch.configs import SHAPES, applicable_shapes, assigned_archs, get_config
from repro_torch.distributed.sharding import (NamedSharding, make_resolver, mesh_shape,
                                              resolve_spec, rules_for_cfg, tree_shardings)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.train import flat_axes, place_tree, setup_training
from repro_torch.models.layers import sharding_context
from repro_torch.models.transformer import LM, input_specs
from repro_torch.telemetry import roofline
from repro_torch.train.optimizer import make_optimizer

HBM_PER_CHIP_GIB = 80.0   # H100 80GB HBM3
ART = "artifacts/dryrun_torch"
# microbatches a train cell runs: the second repeats the first's peak and
# adds the accumulation; their costs are scaled to the cell's ``accum``
MICRO_RUN = 2


def grad_accum(cfg, shape, mesh) -> int:
    """The train cell's microbatch count: the config's, at most the batch
    rows each data-parallel rank holds."""
    sizes = mesh_shape(mesh).shape
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    return max(1, min(cfg.grad_accum, shape.global_batch // dp))


def _host_batch(cfg, shape):
    """A batch of the shape's input specs, whole (the host's): token ids
    drawn below the vocabulary's size, frames and patches drawn, masks ones."""
    specs, _ = input_specs(cfg, shape)
    out = {}
    for k, s in specs.items():
        if s.dtype in (torch.int32, torch.int64):
            out[k] = torch.randint(0, cfg.vocab_size, s.shape, dtype=s.dtype)
        elif k == "loss_mask":
            out[k] = torch.ones(s.shape, dtype=s.dtype)
        else:
            out[k] = torch.randn(s.shape).to(s.dtype)
    if "pos" in out:
        out["pos"] = torch.full(out["pos"].shape, shape.seq_len - 1, dtype=torch.int32)
    return out


def _like(tree, shardings):
    """Each DTensor of ``tree`` redistributed to its sharding's placements
    (JAX's ``out_shardings``)."""
    if isinstance(tree, dict):
        return {k: _like(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_like(v, s) for v, s in zip(tree, shardings))
    pl = tuple(shardings.placements)
    return tree if tuple(tree.placements) == pl else tree.redistribute(shardings.mesh, pl)


def _cache_shardings(model, shape, mesh, rules):
    specs, axes = model.cache_specs(shape.global_batch, shape.seq_len)
    meta = {"slots": [{n: torch.empty(sh, dtype=dt, device="meta") for n, (sh, dt) in s.items()}
                      for s in specs["slots"]]}
    return tree_shardings(mesh, meta, axes, rules)


def build_cell(cfg, shape, mesh, rules, model=None, *, grad_transform=None):
    """Returns (fn, args, donate, out_shardings): the cell's step and its
    inputs, DTensors of ``mesh`` placed by ``rules``, made from ``model``'s
    own parameters (by default an ``LM`` on the CPU: under
    ``FakeTensorMode``, fake ones). A train step runs ``min(MICRO_RUN,
    accum)`` of its microbatches; ``grad_transform`` is its hook on the mean
    gradients."""
    model = model or LM(cfg, device="cpu")
    resolver = make_resolver(mesh, rules)
    if shape.mode == "train":
        accum = grad_accum(cfg, shape, mesh)
        n = min(MICRO_RUN, accum)
        micro = shape.global_batch // accum
        opt = make_optimizer("auto", 1e-4, cfg)
        tr = setup_training(model, opt, mesh, rows=micro, seq=shape.seq_len, accum=n,
                            grad_transform=grad_transform, rules=rules)
        batch = _host_batch(cfg, replace(shape, global_batch=micro * n))

        def train(params, opt_state):
            with sharding_context(resolver):
                return tr.step(params, opt_state, batch)
        return train, (tr.params, tr.opt_state), (0, 1), tr.shardings

    params = {n: p.detach() for n, p in model.params().items()}
    psh = tree_shardings(mesh, params, flat_axes(model.param_axes()), rules)
    params = place_tree(params, psh)
    specs, batch_axes = input_specs(cfg, shape)
    batch_sh = tree_shardings(mesh, specs, batch_axes, rules)
    batch = place_tree(_host_batch(cfg, shape), batch_sh)
    logits_sh = NamedSharding(mesh, resolve_spec(mesh_shape(mesh),
                                                 (shape.global_batch, cfg.vocab_size),
                                                 ("act_batch", "act_vocab"), rules))

    if shape.mode == "prefill":
        if not cfg.causal:
            # encoder: full-sequence logits, no decode cache
            logits3_sh = NamedSharding(mesh, roofline_spec(mesh, rules, shape, cfg))

            @torch.no_grad()
            def enc(params, batch):
                with sharding_context(resolver), _replicated():
                    x, _ = model.forward_seq(batch, want_cache=False, params=params)
                    return _like(model.logits(x, params), logits3_sh)
            return enc, (params, batch), (), logits3_sh
        cache_sh = _cache_shardings(model, shape, mesh, rules)

        def prefill(params, batch):
            with sharding_context(resolver):
                logits, cache = model.prefill(batch, params=params)
                return _like((logits, cache), (logits_sh, cache_sh))
        return prefill, (params, batch), (), (logits_sh, cache_sh)

    # decode / long_decode: the cache is donated, written in place
    cache_sh = _cache_shardings(model, shape, mesh, rules)
    cache = place_tree(model.init_cache(shape.global_batch, shape.seq_len), cache_sh)

    def decode(params, cache, batch):
        with sharding_context(resolver):
            logits, cache = model.decode_step(cache, batch, params=params)
            return _like(logits, logits_sh), cache
    return decode, (params, cache, batch), (1,), (logits_sh, cache_sh)


def _replicated():
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def roofline_spec(mesh, rules, shape, cfg):
    return resolve_spec(mesh_shape(mesh), (shape.global_batch, shape.seq_len, cfg.vocab_size),
                        ("act_batch", "act_seq", "act_vocab"), rules)


def _scale(c, f):
    return {"flops": c["flops"] * f, "bytes": c["bytes"] * f,
            "link_bytes": c["link_bytes"] * f,
            "ops": {o: int(v * f) for o, v in c["ops"].items()},
            "raw_bytes": {o: v * f for o, v in c["raw_bytes"].items()}}


def _add(a, b):
    return {"flops": a["flops"] + b["flops"], "bytes": a["bytes"] + b["bytes"],
            "link_bytes": a["link_bytes"] + b["link_bytes"],
            "ops": {o: a["ops"].get(o, 0) + b["ops"].get(o, 0)
                    for o in set(a["ops"]) | set(b["ops"])},
            "raw_bytes": {o: a["raw_bytes"].get(o, 0.0) + b["raw_bytes"].get(o, 0.0)
                          for o in set(a["raw_bytes"]) | set(b["raw_bytes"])}}


def probe_costs(cfg, shape, mesh, rules, model=None):
    """(the cost dict, the memory dict) of one device for the cell, counted
    while its step runs once at full depth (see the module's docstring):
    a train step's costs up to the mean gradients scaled from the
    microbatches run to ``accum``, plus the optimizer's update once."""
    counters = {}

    def mark(grads):
        counters["micro"] = roofline.cost_dict(counters["cost"], counters["coll"])
        return grads

    fn, args, donate, _ = build_cell(cfg, shape, mesh, rules, model=model,
                                     grad_transform=mark if shape.mode == "train" else None)
    mem = roofline.count_memory(args)
    with mem, roofline.count_collectives() as coll, roofline.count_costs() as cost:
        counters.update(cost=cost, coll=coll)
        out = fn(*args)
    total = roofline.cost_dict(cost, coll)
    if shape.mode == "train":
        accum = grad_accum(cfg, shape, mesh)
        total = _add(total, _scale(counters["micro"], accum / min(MICRO_RUN, accum) - 1))
        total["accum"] = accum
    alias = mem.bytes_of([args[i] for i in donate])
    return total, roofline.mem_dict(mem.argument_bytes, mem.bytes_of(out), alias, mem.peak)


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             rules_override=None) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    skip = applicable_shapes(cfg).get(shape_name)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "status": "skip", "reason": skip}
    if skip:
        print(f"[dryrun] SKIP {arch} x {shape_name}: {skip}")
        return result

    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = 512 if mesh_kind == "multi" else 256
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
        rules = rules_override or rules_for_cfg(shape.mode, cfg)
        with FakeTensorMode():
            t0 = time.time()
            model = LM(cfg, device="cpu")
            t_build = time.time() - t0
            t0 = time.time()
            cost, mem = probe_costs(cfg, shape, mesh, rules, model=model)
            t_run = time.time() - t0
    finally:
        dist.destroy_process_group()
    rep = roofline.analyze_from_parts(mem=mem, cost=cost, arch=arch, shape=shape,
                                      mesh_name=mesh_kind, n_devices=world, cfg=cfg)
    fits = rep.mem["peak_gib"] <= HBM_PER_CHIP_GIB
    result.update(status="ok", fits=fits, lower_s=round(t_build, 2),
                  compile_s=round(t_run, 2), probe_s=0.0,
                  report=json.loads(rep.to_json()))
    if out_dir:                         # first: a closed stdout cannot lose a long run
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_kind}.json")
        with open(path, "w") as f:
            json.dump(result, f, indent=1, sort_keys=True)
    print({k: v for k, v in cost.items() if k in ("flops", "bytes")})
    print(mem)                          # the peak against the card's HBM
    print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: "
          f"peak={rep.mem['peak_gib']:.2f}GiB fits={fits} "
          f"compute={rep.t_compute*1e3:.2f}ms memory={rep.t_memory*1e3:.2f}ms "
          f"collective={rep.t_collective*1e3:.2f}ms bottleneck={rep.bottleneck} "
          f"useful={rep.useful_flops_ratio:.3f} roofline_frac={rep.roofline_fraction:.3f}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description="Multi-pod dry-run harness of the port")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--out", default=ART)
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    if args.list:
        for a in assigned_archs():
            cfg = get_config(a)
            for s, reason in applicable_shapes(cfg).items():
                print(f"{a:22s} {s:12s} {'RUN' if reason is None else 'SKIP: ' + reason}")
        return 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape required (or --list)")
    try:
        res = run_cell(args.arch, args.shape, args.mesh, args.out)
        return 0 if res["status"] in ("ok", "skip") else 1
    except Exception:
        traceback.print_exc()
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            path = os.path.join(args.out, f"{args.arch}__{args.shape}__{args.mesh}.json")
            with open(path, "w") as f:
                json.dump({"arch": args.arch, "shape": args.shape,
                           "mesh": args.mesh, "status": "error",
                           "error": traceback.format_exc()[-2000:]}, f, indent=1)
        return 1


if __name__ == "__main__":
    sys.exit(main())
