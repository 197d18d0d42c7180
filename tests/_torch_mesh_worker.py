"""One rank of the port's multi-rank CPU checks; run by tests/test_torch_mesh.py
as

    python -m torch.distributed.run --standalone --nproc-per-node 8 \\
        tests/_torch_mesh_worker.py <dir>

Each rank joins a gloo group and runs the four jobs in turn; rank 0 writes
their results into <dir> (``train.json``, ``ckpt.json``, :func:`save_run`'s
files, ``pods.json``, ``serve.json``).

* ``train``: for each of :data:`RUNS`, trains the config ``<arch>.json`` from
  the weights ``<arch>.npz`` in <dir> on a ``(8 / model axis, model axis)``
  mesh (lr 1e-3, the run's steps and optimizer, accumulation 2, 8 x 32
  tokens of the seeded stream), and records every step's loss and gradient
  norm, the first step's mean gradients, the parameters after 3 steps, and
  each rank's offset and local shape of every parameter; then the same runs
  on one process each (plain tensors), the references, one run a rank
  (``single_*`` files, written by their rank). Also every
  dispatch function of ``kernels.ops`` and ``shard_act`` on DTensors, the
  refusals of a model axis of 3, ``sharding.redistribute``'s moves
  (:func:`move_checks`) and its backward where nothing moves
  (:func:`backward_checks`), the logsumexp routes with kv heads that do not
  split with q's (:func:`lse_checks`), reduced deepseek's 7 heads over 2
  ranks (:func:`heads_checks`) and a grok step under Adafactor
  (:func:`grok_step_checks`).
* ``ckpt``: saves a tree on a ``(4, 2)`` mesh and restores it on ``(2, 4)``
  under other placements; restores the checkpoint the JAX package writes
  into <dir>/jax from 8 devices the same way (waiting for it); runs the
  train launcher for 6 steps with a checkpoint every 3 on ``--model-axis
  2``, then resumes it from step 3 on ``--model-axis 4``.
* ``pods``: ``make_pod_grad_sync`` over a ``("pod",)`` mesh of the 8 ranks,
  each rank its pod's gradient (row ``rank`` of <dir>/pod_grads.npy), two
  rounds (the second from the first's error) of each scheme; and DTensor
  leaves split over ``data`` on a ``(2, 4)`` ``("pod", "data")`` mesh
  (``pods.json``).
* ``serve``: for :data:`SERVE_ARCHS`, a prefill on the ``(4, 2)`` mesh under
  ``PREFILL_RULES`` and 3 decode steps under ``DECODE_RULES`` (gemma3's
  under ``LONG_DECODE_RULES``: every cache split over its slots on both
  mesh dims, so that its ring writes land in one rank's shard and each
  rank attends over its own slots) against the same run on plain tensors,
  and the local cache tensors that hold all of a layer's slots (none); and :func:`count_cells` on
  real tensors, which tests/test_torch_mesh.py holds to the same count on
  fake tensors of a fake group (``serve.json``).
"""
import json
import os
import shutil
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from dataclasses import replace

from repro_torch.bridge import params_from_numpy
from repro_torch.configs import SHAPES, ModelConfig, get_config, reduced
from repro_torch.data.pipeline import DataConfig, TokenStream
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.distributed.sharding import (DECODE_RULES, LONG_DECODE_RULES, PREFILL_RULES,
                                              TRAIN_RULES,
                                              NamedSharding, make_resolver, place,
                                              placements_spec, rules_for_cfg, tree_shardings)
from repro_torch.launch import train as launcher
from repro_torch.launch.mesh import init_process_group, make_local_mesh
from repro_torch.models import LM
from repro_torch.models.layers import sharding_context
from repro_torch.telemetry import roofline as R
from repro_torch.train.optimizer import SGDM, Adafactor, AdamW

# name: (arch, steps, optimizer, model axis). moonshot's experts split over
# "model" (EP); grok's config in <dir> has 6 experts, which do not split 4
# ways, so the rules split the expert FFN's width instead (w_moe_mlp: TP, as
# grok's 8 experts on a model axis of 16 do).
RUNS = {"qwen3_32b": ("qwen3_32b", 6, "adamw", 2),
        "moonshot_v1_16b": ("moonshot_v1_16b", 3, "adamw", 2),
        "moonshot_v1_16b/sgdm": ("moonshot_v1_16b", 3, "sgdm", 2),
        "falcon_mamba_7b": ("falcon_mamba_7b", 3, "adamw", 2),
        "qwen3_32b/adafactor": ("qwen3_32b", 3, "adafactor", 2),
        "grok1_314b/tp": ("grok1_314b", 3, "adamw", 4)}
# the runs whose parameters after 3 steps are not held to the single-process
# run's: AdamW's first update of a gradient far below its eps of 1e-8 (5.8e-10
# in one run, -1.7e-10 in the other, their summation orders apart) moves one
# of moonshot's parameters 7.2e-5 apart, as
# tests/test_torch_train.py::test_jamba_train_steps_match_jax found for
# jamba; moonshot's parameters are held after SGDM's steps instead
NO_PARAM_CHECK = {"moonshot_v1_16b"}
ARCHS = sorted({arch for arch, *_ in RUNS.values()})
OPTIMIZERS = {"adamw": AdamW, "adafactor": Adafactor, "sgdm": SGDM}


def model_of(out: str, arch: str) -> LM:
    """The config ``<arch>.json`` with the weights ``<arch>.npz`` in ``out``."""
    with open(os.path.join(out, f"{arch}.json")) as f:
        lm = LM(ModelConfig.from_json(f.read()), device="cpu", attn_block=16)
    lm.load_state_dict(params_from_numpy(dict(np.load(os.path.join(out, f"{arch}.npz")))))
    return lm


def run_steps(out: str, name: str, mesh=None) -> dict:
    """:data:`RUNS`' ``name`` on ``mesh`` (None: on plain tensors): every
    step's loss and gradient norm, the first step's mean gradients and the
    parameters after 3 steps (whole), and the shardings (on a mesh)."""
    arch, steps, opt_name, _ = RUNS[name]
    lm = model_of(out, arch)
    grads = {}

    def keep_first(g):
        if not grads:
            grads.update({n: _full(t).numpy().copy() for n, t in g.items()})
        return g
    params, state, step, context, shardings = launcher.setup_training(
        lm, OPTIMIZERS[opt_name](lr=1e-3), mesh, rows=4, seq=32, accum=2,
        grad_transform=keep_first)
    stream = TokenStream(DataConfig(vocab_size=lm.cfg.vocab_size, seq_len=32, global_batch=8,
                                    seed=0))
    rec = {"losses": [], "grad_norms": [], "grads": grads, "shardings": shardings}
    with context:
        for i in range(steps):
            params, state, m = step(params, state, stream.batch(i))
            rec["losses"].append(float(m["loss"]))
            rec["grad_norms"].append(float(m["grad_norm"]))
            if i == 2:
                rec["after3"] = {n: _full(t).numpy().copy() for n, t in params.items()}
    rec["params"] = params
    return rec


def save_run(out: str, prefix: str, rec: dict) -> None:
    """A run's record as ``<prefix>.json`` (losses, gradient norms) and
    ``<prefix>_grads.npz``, ``<prefix>_after3.npz`` in ``out``."""
    prefix = os.path.join(out, prefix.replace("/", "_"))
    with open(f"{prefix}.json", "w") as f:
        json.dump({"losses": rec["losses"], "grad_norms": rec["grad_norms"]}, f)
    np.savez(f"{prefix}_grads.npz", **rec["grads"])
    np.savez(f"{prefix}_after3.npz", **rec["after3"])


def load_run(out: str, prefix: str) -> dict:
    """What :func:`save_run` wrote."""
    prefix = os.path.join(out, prefix.replace("/", "_"))
    with open(f"{prefix}.json") as f:
        rec = json.load(f)
    rec["grads"] = dict(np.load(f"{prefix}_grads.npz"))
    rec["after3"] = dict(np.load(f"{prefix}_after3.npz"))
    return rec


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _placed(gen, shape, mesh, spec, grad=False):
    """(a seeded tensor every rank draws alike, its DTensor under ``spec``)."""
    t = torch.randn(shape, generator=gen)
    d = place(t, NamedSharding(mesh, spec))
    if grad:
        t.requires_grad_()
        d.requires_grad_()
    return t, d


def _err(got, want) -> float:
    return (_full(got).detach() - want.detach()).abs().max().item()


def ops_checks(mesh) -> dict:
    """Every dispatch function of ``kernels.ops`` on DTensors against the same
    call on whole tensors (the plain versions here): the max abs error of
    each output and, where autograd records, each input's gradient."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.mamba_scan import state_chunk
    from repro_torch.models.attention import attend_blocked
    gen = torch.Generator().manual_seed(0)
    errs = {}
    # (label, H, KV, q spec, kv spec): kv split with q; one kv head for a
    # rank's q heads; kv heads repeated (KV 3 does not split 2 ways and a
    # rank's 6 q heads straddle groups of 4); q's head dim split (gathered)
    for label, H, KV, qs, ks in (("kv_split", 8, 4, ("data", None, "model"), ("data", None, "model")),
                                 ("one_kv_head", 8, 1, ("data", None, "model"), ("data",)),
                                 ("kv_repeated", 12, 3, ("data", None, "model"), ("data",)),
                                 ("hd_split", 4, 2, ("data", None, None, "model"), ("model",))):
        q, dq = _placed(gen, (4, 16, H, 16), mesh, qs, grad=True)
        k, dk = _placed(gen, (4, 16, KV, 16), mesh, ks, grad=True)
        v, dv = _placed(gen, (4, 16, KV, 16), mesh, ks, grad=True)
        g = torch.randn(4, 16, H, 16, generator=gen)
        errs[f"flash_attention/{label}"] = _err(ops.flash_attention(dq, dk, dv, window=6),
                                                ops.flash_attention(q, k, v, window=6))
        (o, lse), (do, dlse) = (ops.flash_attention_lse(q, k, v, block=8),
                                ops.flash_attention_lse(dq, dk, dv, block=8))
        # on DTensors the lse is [B, S, H], the plain call's [B, S, KV, G] flattened
        errs[f"flash_attention_lse/{label}"] = max(
            _err(do, o), _err(dlse.full_tensor().reshape(lse.shape), lse))
        dg = place(g, NamedSharding(mesh, qs))
        want = ops.flash_attention_bwd(q, k, v, o, lse, g, block=8)
        got = ops.flash_attention_bwd(dq, dk, dv, do, dlse, dg, block=8)
        errs[f"flash_attention_bwd/{label}"] = max(_err(a, b) for a, b in zip(got, want))
        out, dout = attend_blocked(q, k, v, causal=True, block=8), attend_blocked(
            dq, dk, dv, causal=True, block=8)
        (out * g).sum().backward()
        (dout.full_tensor() * g).sum().backward()
        errs[f"attend_blocked/{label}"] = max(_err(dout, out), *(
            _err(d.grad, t.grad) for d, t in ((dq, q), (dk, k), (dv, v))))
        qd, dqd = _placed(gen, (4, H, 16), mesh, ("data", "model"))
        kc, dkc = _placed(gen, (4, 32, KV, 16), mesh, ("data", "model"))   # W split: gathered
        vc, dvc = _placed(gen, (4, 32, KV, 16), mesh, ("data", "model"))
        pos = torch.tensor([3, 31, 17, 40])
        for ring in (False, True):
            errs[f"decode_attention/{label}/ring={ring}"] = _err(
                ops.decode_attention(dqd, dkc, dvc, pos, ring=ring),
                ops.decode_attention(qd, kc, vc, pos, ring=ring))
    # the scan: batch over data, channels over model
    B, S, DI, N = 4, 32, 16, 8
    sh = {"dt": ("data", None, "model"), "x": ("data", None, "model"), "B": ("data",),
          "C": ("data",), "A": ("model",), "D": ("model",), "h0": ("data", "model")}
    shapes = {"dt": (B, S, DI), "x": (B, S, DI), "B": (B, S, N), "C": (B, S, N),
              "A": (DI, N), "D": (DI,), "h0": (B, DI, N)}
    plain, dist_ = {}, {}
    for n, shape in shapes.items():
        plain[n], dist_[n] = _placed(gen, shape, mesh, sh[n], grad=True)
    with torch.no_grad():
        for a in (plain, dist_):
            a["dt"].abs_().mul_(0.1)
            a["A"].copy_(-a["A"].abs())
    y, h = ops.mamba_scan(*(plain[n] for n in shapes))
    dy, dh = ops.mamba_scan(*(dist_[n] for n in shapes))
    gy = torch.randn(B, S, DI, generator=gen)
    ((y * gy).sum() + h.sum()).backward()
    ((dy.full_tensor() * gy).sum() + dh.full_tensor().sum()).backward()
    errs["mamba_scan"] = max(_err(dy, y), _err(dh, h),
                             *(_err(dist_[n].grad, plain[n].grad) for n in shapes))
    with torch.no_grad():
        args = [plain[n].detach() for n in ("dt", "x", "B", "C", "A", "D")]
        states = ops._mamba_scan_states(*args, plain["h0"].detach())[2]
        want = ops.mamba_scan_bwd(*args, states, gy)
        dargs = [place(a, NamedSharding(mesh, sh[n])) for a, n in
                 zip(args, ("dt", "x", "B", "C", "A", "D"))]
        dstates = place(states, NamedSharding(mesh, ("data", None, "model")))
        got = ops.mamba_scan_bwd(*dargs, dstates, place(gy, NamedSharding(mesh, sh["x"])))
        errs["mamba_scan_bwd"] = max(_err(a, b) for a, b in zip(got, want))
    assert states.shape[1] == S // state_chunk(N)
    # the grouped matmul: F split (kept), E split (gathered)
    bmap = torch.tensor([0, 2, 1, 3, 3], dtype=torch.int32)
    for label, wspec in (("F_split", (None, None, "model")), ("E_split", ("model",))):
        x, dx = _placed(gen, (80, 16), mesh, (), grad=True)
        w, dw = _placed(gen, (4, 16, 32), mesh, wspec, grad=True)
        y = ops.grouped_matmul(x, w, bmap, 16)
        dy = ops.grouped_matmul(dx, dw, bmap, 16)
        gy = torch.randn(80, 32, generator=gen)
        (y * gy).sum().backward()
        (dy.full_tensor() * gy).sum().backward()
        errs[f"grouped_matmul/{label}"] = max(_err(dy, y), _err(dx.grad, x.grad),
                                              _err(dw.grad, w.grad))
        want = ops.grouped_matmul_bwd(x.detach(), w.detach(), gy, bmap, 16)
        got = ops.grouped_matmul_bwd(dx.detach(), dw.detach(),
                                     place(gy, NamedSharding(mesh, (None, wspec[-1]))), bmap, 16)
        errs[f"grouped_matmul_bwd/{label}"] = max(_err(a, b) for a, b in zip(got, want))
    return errs


def shard_act_checks(mesh) -> dict:
    """``shard_act`` under the training rules on a (4, 2) mesh: a dim the
    rules fail to split keeps its split (unconstrained), a named dim is
    split and an unnamed one gathered, a ``Partial`` is reduced; outside a
    context, and on a plain tensor, the identity."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

    from repro_torch.models.layers import shard_act
    x = torch.randn(4, 3, 8, generator=torch.Generator().manual_seed(1))
    dx = distribute_tensor(x, mesh, [Shard(0), Shard(1)])       # 3 rows split 2 ways: uneven
    partial = DTensor.from_local(x.clone(), mesh, [Replicate(), Partial()], run_check=False)
    res = {"outside": shard_act(dx, ("act_batch", None, "act_mlp")) is dx}
    with sharding_context(make_resolver(mesh, TRAIN_RULES)):
        kept = shard_act(dx, ("act_batch", "act_heads", None))
        moved = shard_act(dx, ("act_batch", None, "act_mlp"))
        reduced = shard_act(partial, ("act_batch", None, None))
        res["plain"] = shard_act(x, ("act_batch", None, "act_mlp")) is x
    res["kept"] = [repr(tuple(kept.placements)), _err(kept, x)]
    res["moved"] = [repr(tuple(moved.placements)), _err(moved, x)]
    res["reduced"] = [repr(tuple(reduced.placements)), _err(reduced, 2 * x)]
    return res


class _Holding(R._Counter):
    """The local tensors a rank makes whose shape ``has`` accepts (the
    dry run's counter: DTensor's shape propagation left out)."""

    def __init__(self, has):
        super().__init__()
        self.has, self.seen = has, []

    def op(self, func, args, kwargs, out):
        self.seen += [[str(func), list(t.shape)] for t in R._tensors(out) if self.has(t.shape)]


def vocab_checks(mesh) -> dict:
    """The label log-prob of logits split over the vocabulary (``model``)
    and batch (``data``), forward and backward, against the single-process
    run, at a vocabulary of 200 (100 a rank) and of 201 (split unevenly, as
    hubert's 504 classes over 16 ranks): each error over the reference's
    largest magnitude; the local tensors with the whole vocabulary in a dim
    (none; no other dim of the check is 200 or 201), and whether the
    replicated ``log_softmax`` and ``gather`` on the same DTensors make any
    (they do)."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.models import transformer as T
    from repro_torch.models.layers import shard_act
    res = {}
    for V in (200, 201):
        gen = torch.Generator().manual_seed(V)
        x = torch.randn(4, 16, 32, generator=gen, requires_grad=True)
        head = (torch.randn(V, 32, generator=gen) * 0.3).requires_grad_()
        labels = torch.randint(0, V, (4, 16), generator=gen)
        labels[0, :2] = torch.tensor([0, V - 1])         # the first and the last column
        g = torch.randn(4, 16, generator=gen)
        lp = T._label_logprob(x, head, labels)
        (lp * g).sum().backward()
        dx = place(x.detach(), NamedSharding(mesh, ("data",))).requires_grad_()
        dh = distribute_tensor(head.detach(), mesh, [Shard(1), Shard(0)]).requires_grad_()
        dg = place(g, NamedSharding(mesh, ("data",)))
        whole = lambda shape: V in shape  # noqa: E731
        with sharding_context(make_resolver(mesh, TRAIN_RULES)):
            with _Holding(whole) as split:
                dlp = T._label_logprob(dx, dh, labels)
                (dlp * dg).sum().backward()
            with _Holding(whole) as replicated:
                lg = shard_act(dx.detach() @ dh.detach().T, ("act_batch", "act_seq", "act_vocab"))
                lg.requires_grad_()
                lab = place(labels, NamedSharding(mesh, ("data",)))
                rl = torch.gather(torch.log_softmax(lg.float(), -1), -1, lab[..., None])[..., 0]
                (rl * dg).sum().backward()
        rel = lambda got, want: _err(got, want) / want.abs().max().item()  # noqa: E731
        res[V] = {"lp": rel(dlp, lp), "dx": rel(dx.grad, x.grad),
                  "dhead": rel(dh.grad, head.grad), "logits": repr(tuple(lg.placements)),
                  "placements": repr(tuple(dlp.placements)), "whole": split.seen,
                  "whole_replicated": len(replicated.seen)}
    return res


class _Largest(R._Counter):
    """The most elements of a local tensor that a rank's ops make, and the
    all-to-alls and all-gathers among them."""

    def __init__(self):
        super().__init__()
        self.numel, self.all_to_all, self.all_gather = 0, 0, 0

    def op(self, func, args, kwargs, out):
        self.numel = max([self.numel] + [t.numel() for t in R._tensors(out)])
        self.all_to_all += func._opname == "all_to_all_single"
        self.all_gather += func._opname.startswith("all_gather")


MOVE_SHAPE = (8, 10, 9)     # dims 1 and 2 split unevenly 4 ways (3, 3, 3, 1 and 3, 3, 3, 0)


def move_checks(mesh) -> dict:
    """``sharding.redistribute`` against ``DTensor.redistribute`` for every
    move of a split between two dims of :data:`MOVE_SHAPE` on each mesh dim
    of ``mesh``, the other mesh dim replicated or splitting any dim, and
    the gradient of each move: whether the local results are bit-equal,
    the largest local tensor the move makes over the larger of its input's
    and its result's shards, the all-to-alls and all-gathers it issues, and
    whether the other mesh dim nests a split inside the moved dims (it then
    steps aside to the third dim and back: three all-to-alls)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distributed.sharding import redistribute
    x = torch.randn(MOVE_SHAPE, generator=torch.Generator().manual_seed(3))
    w = torch.randn(MOVE_SHAPE, generator=torch.Generator().manual_seed(4))
    res = {}
    for m in range(mesh.ndim):
        for a in range(3):
            for b in range(3):
                if a == b:
                    continue
                for other in [Replicate()] + [Shard(k) for k in range(3)]:
                    src, dst = [other, other], [other, other]
                    src[m], dst[m] = Shard(a), Shard(b)
                    d = distribute_tensor(x, mesh, src).requires_grad_()
                    ref = distribute_tensor(x, mesh, src).requires_grad_()
                    with _Largest() as big:
                        got = redistribute(d, dst)
                    want = ref.redistribute(mesh, dst)
                    (got.to_local() * w[:got.to_local().shape[0]].sum()).sum().backward()
                    (want.to_local() * w[:want.to_local().shape[0]].sum()).sum().backward()
                    shards = max(d.to_local().numel(), got.to_local().numel(), 1)
                    res[f"{m}:{a}->{b}/{other}"] = {
                        "equal": bool(torch.equal(got.to_local(), want.to_local())
                                      and tuple(got.placements) == tuple(dst)
                                      and torch.equal(d.grad.to_local(), ref.grad.to_local())),
                        "largest": big.numel / shards, "all_to_all": big.all_to_all,
                        "all_gather": big.all_gather,
                        "nested": m == 0 and isinstance(other, Shard) and other.dim in (a, b)}
    return res


def backward_checks(mesh) -> dict:
    """``sharding.redistribute`` where no split moves between dims and the
    gradient arrives ``Partial`` on a mesh dim that the result replicates,
    against ``DTensor.redistribute``: whether the input's gradients are
    bit-equal (values and placements), and the collectives each issues,
    forward and backward. DTensor reduces such a gradient once, straight
    into the input's layout (a reduce-scatter where the input is split)."""
    from torch.distributed.tensor import Partial, Replicate, Shard, distribute_tensor

    from repro_torch.distributed.sharding import redistribute
    x = torch.randn(MOVE_SHAPE, generator=torch.Generator().manual_seed(6))
    res = {}
    for name, src, dst, gpl in (
            ("split on model", [Shard(0), Shard(1)], [Shard(0), Replicate()],
             [Shard(0), Partial()]),
            ("split on data", [Shard(2), Replicate()], [Replicate(), Replicate()],
             [Partial(), Replicate()])):
        got = {}
        for label in ("port", "dtensor"):
            d = distribute_tensor(x, mesh, src).requires_grad_()
            with R.count_collectives() as coll:
                y = redistribute(d, dst) if label == "port" else d.redistribute(mesh, dst)
                y.to_local(grad_placements=gpl).sum().backward()
            got[label] = (d.grad, coll.stats.ops)
        (gp, port), (gd, ref) = got["port"], got["dtensor"]
        res[name] = {"equal": bool(torch.equal(gp.to_local(), gd.to_local())
                                   and tuple(gp.placements) == tuple(gd.placements)),
                     "port": port, "dtensor": ref}
    return res


def lse_checks(mesh) -> dict:
    """``flash_attention_lse`` and ``flash_attention_bwd`` on DTensors of
    ``mesh`` (``(2, 4)``) whose kv heads do not split with q's (H 8, KV 2,
    heads over the 4 ``model`` ranks, batch over ``data``) against the
    plain calls: the max abs error of out, lse, dq, dk and dv, the
    collectives the two calls issue, and the q heads a rank's kernel takes."""
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(5)
    q, dq = _placed(gen, (4, 16, 8, 16), mesh, ("data", None, "model"))
    k, dk = _placed(gen, (4, 16, 2, 16), mesh, ("data",))
    v, dv = _placed(gen, (4, 16, 2, 16), mesh, ("data",))
    g = torch.randn(4, 16, 8, 16, generator=gen)
    o, lse = ops.flash_attention_lse(q, k, v, window=6, block=8)
    want = ops.flash_attention_bwd(q, k, v, o, lse, g, window=6, block=8)
    dg = place(g, NamedSharding(mesh, ("data", None, "model")))
    with R.count_collectives() as coll:
        do, dlse = ops.flash_attention_lse(dq, dk, dv, window=6, block=8)
        got = ops.flash_attention_bwd(dq, dk, dv, do, dlse, dg, window=6, block=8)
    return {"out": _err(do, o), "lse": _err(dlse.full_tensor().reshape(lse.shape), lse),
            "grads": [_err(a, b) for a, b in zip(got, want)],
            "lse_shape": list(dlse.shape), "collectives": coll.stats.ops,
            "local_heads": dq.to_local().shape[2], "out_local_heads": do.to_local().shape[2]}


def _deepseek():
    """Reduced deepseek_coder_33b in float32: 7 q heads, one kv head."""
    return replace(reduced(get_config("deepseek_coder_33b")), dtype="float32")


def heads_checks(mesh) -> dict:
    """Reduced deepseek_coder_33b (7 heads on a ``model`` axis of 2) on
    ``mesh`` under ``TRAIN_RULES``: the loss and every gradient against the
    single-process run (max abs error over the reference's largest
    magnitude), and the q heads each rank's attention kernel took in each
    call (its plain version's calls, forward and backward), by rank."""
    from unittest import mock

    from repro_torch.kernels import flash_attention_bwd as FB
    from repro_torch.kernels import ops
    cfg = _deepseek()
    lm = LM(cfg, device="cpu", seed=0, attn_block=16)
    stream = TokenStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8,
                                    seed=0))
    batch = {k: torch.as_tensor(v) for k, v in stream.batch(0).items()}
    params = {n: p.detach().requires_grad_() for n, p in lm.params().items()}
    loss, _ = lm.loss_fn(params, batch)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    axes = launcher.flat_axes(lm.param_axes())
    sh = tree_shardings(mesh, params, axes, TRAIN_RULES)
    dparams = {n: place(p.detach(), sh[n]).requires_grad_() for n, p in params.items()}
    dbatch = {k: place(v, NamedSharding(mesh, ("data",))) for k, v in batch.items()}
    heads = []
    fwd, bwd = FB.attend_fwd_plain, FB.flash_attention_bwd_plain

    def seen(fn):
        def call(q, *a, **kw):
            heads.append(q.shape[2])
            return fn(q, *a, **kw)
        return call
    from torch.distributed.tensor.experimental import implicit_replication
    with sharding_context(make_resolver(mesh, TRAIN_RULES)), implicit_replication(), \
            mock.patch.object(ops._flash_bwd, "attend_fwd_plain", seen(fwd)), \
            mock.patch.object(ops._flash_bwd, "flash_attention_bwd_plain", seen(bwd)):
        dloss, _ = lm.loss_fn(dparams, dbatch)
        dgrads = dict(zip(dparams, torch.autograd.grad(dloss, list(dparams.values()))))
    rel = lambda got, want: _err(got, want) / max(want.abs().max().item(), 1e-30)  # noqa: E731
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, heads)
    return {"loss": rel(dloss, loss), "grads": {n: rel(dgrads[n], g) for n, g in grads.items()},
            "heads": every, "num_heads": cfg.num_heads}


def grok_step_checks(out: str, mesh) -> dict:
    """One train step (accumulation 2) of reduced grok1_314b with 4 layers
    and 6 experts, in float32, under Adafactor (grok's optimizer) on
    ``mesh`` (``(2, 4)``: the stacked layer dim splits over ``model`` as
    grok's 64 over 16 does) against the same step on one process: the max
    abs error of the loss and the new parameters, and the local tensors a
    rank makes of the whole expert stack's shape (none)."""
    with open(os.path.join(out, "grok1_314b.json")) as f:
        cfg = replace(ModelConfig.from_json(f.read()), num_layers=4)
    stream = TokenStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8,
                                    seed=0))
    res = {}
    for m in (None, mesh):
        lm = LM(cfg, device="cpu", seed=0, attn_block=16)
        tr = launcher.setup_training(lm, Adafactor(lr=1e-3), m, rows=4, seq=32, accum=2)
        stack = tuple(lm.params()["slots.0.moe_wi"].shape)
        whole = lambda shape: tuple(shape) in (stack, stack[:2] + stack[:1:-1])  # noqa: E731
        with tr.context, _Holding(whole) as held:
            p, _, metrics = tr.step(tr.params, tr.opt_state, stream.batch(0))
        res["mesh" if m else "single"] = ({n: _full(t) for n, t in p.items()},
                                          float(metrics["loss"]), held.seen)
    (want, loss, _), (got, dloss, seen) = res["single"], res["mesh"]
    return {"loss": abs(dloss - loss), "params": max(_err(got[n], w) for n, w in want.items()),
            "whole": seen, "stack": list(stack)}


def _took(what: str, t0: float) -> None:
    if dist.get_rank() == 0:
        print(f"[worker] {what}: {time.monotonic() - t0:.1f} s", flush=True)


def train_job(out: str, meshes: dict) -> None:
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    mesh = meshes[2]
    rank = dist.get_rank()
    t0 = time.monotonic()
    res = {"coord": mesh.get_coordinate(), "ops": ops_checks(mesh),
           "shard_act": shard_act_checks(mesh), "vocab": vocab_checks(mesh)}
    _took("kernels.ops, shard_act and the vocab-parallel log-prob on DTensors", t0)
    t0 = time.monotonic()
    res.update(moves=move_checks(mesh), backward=backward_checks(mesh),
               lse=lse_checks(meshes[4]), heads=heads_checks(mesh),
               grok_step=grok_step_checks(out, meshes[4]))
    _took("the all-to-all moves, the lse routes, the uneven heads, grok's step", t0)
    for name, (arch, steps, opt_name, axis) in RUNS.items():
        t0 = time.monotonic()
        rec = run_steps(out, name, meshes[axis])
        _took(f"{name}, {steps} steps", t0)
        shards = {}
        for n, p in rec["params"].items():
            shape, offset = compute_local_shape_and_global_offset(p.shape, p.device_mesh,
                                                                  p.placements)
            assert tuple(p.to_local().shape) == tuple(shape), n
            shards[n] = [list(offset), list(shape), repr(rec["shardings"]["p"][n].spec)]
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, [meshes[axis].get_coordinate(), shards])
        kept = all(tuple(p.placements) == tuple(rec["shardings"]["p"][n].placements)
                   for n, p in rec["params"].items())
        if rank == 0:
            res[name] = {"shards": every, "placements_kept": kept}
            save_run(out, f"mesh_{name}", rec)
    # the single-process references, one run a rank (each alone, on plain
    # tensors, one thread)
    t0 = time.monotonic()
    for name in list(RUNS)[rank::dist.get_world_size()]:
        save_run(out, f"single_{name}", run_steps(out, name))
    dist.barrier()
    _took("the single-process runs", t0)
    refusals = {}
    try:
        make_local_mesh(model_axis=3, device="cpu")
    except ValueError as e:
        refusals["make_local_mesh"] = str(e)
    try:
        launcher.main(["--device", "cpu", "--reduced", "--steps", "1", "--model-axis", "3"])
    except ValueError as e:
        refusals["launcher"] = str(e)
    res["refusals"] = refusals
    res["backend"] = dist.get_backend()
    if rank == 0:
        with open(os.path.join(out, "train.json"), "w") as f:
            json.dump(res, f)


def _leaf_record(t):
    return {"placements": repr(tuple(t.placements)),
            "spec": repr(placements_spec(t.device_mesh, t.placements, t.dim())),
            "values": _full(t).float().numpy().tolist()}


def ckpt_job(out: str, meshes: dict) -> None:
    m1, m2 = meshes[2], meshes[4]                           # (4, 2), (2, 4)
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    tree = {"w": place(x, NamedSharding(m1, ("data", "model"))),
            "b": place((x / 7).to(torch.bfloat16), NamedSharding(m1, ("model", None))),
            "r": place(x[0], NamedSharding(m1, ()))}
    port_dir = os.path.join(out, "port")
    mgr = CheckpointManager(port_dir)                       # async: files and markers
    mgr.save(1, tree)
    mgr.save(2, tree)
    mgr.wait()
    target = {"w": NamedSharding(m2, ("model", "data")), "b": NamedSharding(m2, (None, "data")),
              "r": NamedSharding(m2, ("model",))}
    res = {}
    restored = mgr.restore(2, tree, shardings=target)
    res["port"] = {k: _leaf_record(v) for k, v in restored.items()}
    res["port_local"] = {k: list(v.to_local().shape) for k, v in restored.items()}
    jtree = {"w": tree["w"]}
    _wait_for(os.path.join(out, "jax", "step_000000001", "MANIFEST.json"))
    got = CheckpointManager(os.path.join(out, "jax")).restore(1, jtree,
                                                                shardings={"w": target["w"]})
    res["jax"] = {k: _leaf_record(v) for k, v in got.items()}
    res["steps"] = mgr.all_steps()
    # the launcher: 6 steps on (4, 2) with a checkpoint every 3, then a run
    # resumed from step 3 on (2, 4)
    ck = os.path.join(out, "train")
    args = ["--device", "cpu", "--arch", "qwen3_32b", "--reduced", "--seq", "32",
            "--ckpt", ck, "--ckpt-every", "3"]
    t0 = time.monotonic()
    res["full"] = launcher.main(args + ["--model-axis", "2", "--steps", "6"])
    _took("the launcher, 6 steps", t0)
    res["steps_after_full"] = sorted(os.listdir(ck))
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(os.path.join(ck, "step_000000006"))
    dist.barrier()
    t0 = time.monotonic()
    res["resumed"] = launcher.main(args + ["--model-axis", "4", "--steps", "3"])
    _took("the launcher resumed, 3 steps", t0)
    if dist.get_rank() == 0:
        with open(os.path.join(out, "ckpt.json"), "w") as f:
            json.dump(res, f)


SCHEMES = ("int8", "topk", "none")


def pods_job(out: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.compression import make_pod_grad_sync
    t0 = time.monotonic()
    rank = dist.get_rank()
    g = np.load(os.path.join(out, "pod_grads.npy"))          # [8 pods, 64]
    mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("pod",))
    res = {}
    for scheme in SCHEMES:
        sync = make_pod_grad_sync(mesh, scheme)
        s1, e1 = sync({"w": torch.as_tensor(g[rank])}, {"w": torch.zeros(64)})
        s2, e2 = sync({"w": torch.as_tensor(g[rank])}, e1)
        res[scheme] = [t["w"].tolist() for t in (s1, e1, s2, e2)]
    # a leaf split over data on (2, 4): pod p's ranks hold g[p]'s quarters
    m2 = init_device_mesh("cpu", (2, 4), mesh_dim_names=("pod", "data"))
    from torch.distributed.tensor import DTensor, Replicate, Shard
    p, d = m2.get_coordinate()
    local = torch.as_tensor(g[p, d * 16:(d + 1) * 16])
    leaf = DTensor.from_local(local, m2, [Replicate(), Shard(0)], run_check=False,
                              shape=(64,), stride=(1,))
    err = DTensor.from_local(torch.zeros(16), m2, [Replicate(), Shard(0)], run_check=False,
                             shape=(64,), stride=(1,))
    s, e = make_pod_grad_sync(m2, "int8")([leaf], [err])
    res["dtensor"] = {"coord": [p, d], "placements": repr(tuple(s[0].placements)),
                      "err_placements": repr(tuple(e[0].placements)),
                      "synced": s[0].to_local().tolist(), "err": e[0].to_local().tolist()}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, res)
    _took("the pod syncs", t0)
    if rank == 0:
        with open(os.path.join(out, "pods.json"), "w") as f:
            json.dump(every, f)


SERVE_ARCHS = ("qwen3_32b", "falcon_mamba_7b", "gemma3_12b")
PROMPT, MAX_LEN, BATCH = 24, 32, 4


def _f32(arch: str):
    return replace(reduced(get_config(arch)), dtype="float32")


def _tree_err(a, b) -> float:
    return max(_err(x, y) for sa, sb in zip(a["slots"], b["slots"]) for x, y in
               zip(sa.values(), sb.values()))


def _padded(lm: LM, cache: dict) -> dict:
    """A prefill's cache copied into one of ``MAX_LEN`` slots."""
    big = lm.init_cache(BATCH, MAX_LEN)
    for sb, sp in zip(big["slots"], cache["slots"]):
        for n, t in sb.items():
            t[:, :, :sp[n].shape[2]].copy_(sp[n])
    return big


def _decode_rules(arch: str):
    """The decode rules of the run: gemma3 under ``LONG_DECODE_RULES`` (the
    long_500k cell's context parallelism), which split every cache's slots
    over both mesh dims, its local layers' rings of 16 and its global
    layers' 32 (under ``DECODE_RULES`` its 4 kv heads take the model axis
    and the constraint in ``attn_decode`` moves a slot-split cache to them)."""
    return LONG_DECODE_RULES if arch == "gemma3_12b" else DECODE_RULES


def _cache_shardings(lm: LM, mesh, arch: str):
    """The decode rules' cache shardings."""
    specs, axes = lm.cache_specs(BATCH, MAX_LEN)
    meta = {"slots": [{n: torch.empty(sh, dtype=dt, device="meta") for n, (sh, dt) in sl.items()}
                      for sl in specs["slots"]]}
    return tree_shardings(mesh, meta, axes, _decode_rules(arch))


def serve_run(mesh, arch: str) -> dict:
    """Prefill and 3 decode steps on plain tensors and on ``mesh``: each
    step's max abs error of the logits and the caches."""
    cfg = _f32(arch)
    lm = LM(cfg, device="cpu", seed=0, attn_block=16)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                           generator=torch.Generator().manual_seed(1))
    params = {n: p.detach() for n, p in lm.params().items()}
    axes = launcher.flat_axes(lm.param_axes())
    logits, cache = lm.prefill({"tokens": tokens})
    pp = launcher.place_tree(params, tree_shardings(mesh, params, axes, PREFILL_RULES))
    with sharding_context(make_resolver(mesh, PREFILL_RULES)):
        dlogits, dcache = lm.prefill({"tokens": tokens}, params=pp)
    res = {"prefill": [_err(dlogits, logits), _tree_err(dcache, cache)]}
    cache = _padded(lm, cache)
    sh = _cache_shardings(lm, mesh, arch)
    dcache = launcher.place_tree(cache, sh)
    res["cache_placements"] = sorted({repr(tuple(t.placements)) for sl in dcache["slots"]
                                      for t in sl.values()})
    rules = _decode_rules(arch)
    dp = launcher.place_tree(params, tree_shardings(mesh, params, axes, rules))
    tok, res["decode"] = logits.argmax(-1), []
    # a cache tensor [B, W, KV, hd] with all of its MAX_LEN slots on a rank
    whole = lambda shape: len(shape) == 4 and shape[1] == MAX_LEN and \
        shape[3] == cfg.head_dim  # noqa: E731
    res["whole_cache"] = []
    for i in range(3):
        batch = {"token": tok, "pos": torch.full((BATCH,), PROMPT + i)}
        logits, cache = lm.decode_step(cache, batch)
        with sharding_context(make_resolver(mesh, rules)), _Holding(whole) as held:
            dlogits, dcache = lm.decode_step(dcache, batch, params=dp)
        res["whole_cache"] += held.seen
        res["decode"].append([_err(dlogits, logits), _tree_err(dcache, cache)])
        tok = logits.argmax(-1)
    return res


COUNT_SHAPES = {"train": replace(SHAPES["train_4k"], global_batch=8, seq_len=64),
                "prefill": replace(SHAPES["prefill_32k"], global_batch=8, seq_len=32),
                "decode": replace(SHAPES["decode_32k"], global_batch=8, seq_len=32)}


def count_cells(mesh) -> dict:
    """The dry run's counts (``launch.dryrun.build_cell`` under the three
    counters) of one train step of qwen3, and one prefill and 3 decode steps
    of each of :data:`SERVE_ARCHS` (falcon for the Mamba cache, gemma3 for
    the rings), reduced, on ``mesh``: on real tensors, or fake ones under
    ``FakeTensorMode``."""
    from repro_torch.launch import dryrun
    from repro_torch.telemetry import roofline as R
    torch.manual_seed(0)
    res = {}
    for arch in SERVE_ARCHS:
        cfg = _f32(arch)
        model = LM(cfg, device="cpu", attn_block=16)
        for mode, shape in COUNT_SHAPES.items():
            if mode == "train" and arch != "qwen3_32b":
                continue
            fn, args, _, _ = dryrun.build_cell(cfg, shape, mesh, rules_for_cfg(shape.mode, cfg),
                                               model=model)
            mem = R.count_memory(args)
            with mem, R.count_collectives() as coll, R.count_costs() as cost:
                for _ in range(3 if mode == "decode" else 1):
                    fn(*args)
            res[f"{arch}/{mode}"] = {"flops": cost.flops, "bytes": cost.bytes,
                                     "ops": coll.stats.ops, "raw_bytes": coll.stats.raw_bytes,
                                     "link_bytes": coll.stats.link_bytes, "peak": mem.peak,
                                     "argument": mem.argument_bytes}
    return res


def serve_job(out: str, mesh) -> None:
    t0 = time.monotonic()
    res = {arch: serve_run(mesh, arch) for arch in SERVE_ARCHS}
    _took("meshed prefill and decode", t0)
    t0 = time.monotonic()
    res["counts"] = count_cells(mesh)
    _took("the dry run's counts on real tensors", t0)
    if dist.get_rank() == 0:
        with open(os.path.join(out, "serve.json"), "w") as f:
            json.dump(res, f)


def _wait_for(path: str, timeout: float = 300) -> None:
    """Waits for ``path`` (a file another process writes) to appear."""
    t = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t > timeout:
            raise TimeoutError(f"{path} did not appear in {timeout} s")
        time.sleep(0.2)


def main():
    out = sys.argv[1]
    init_process_group("cpu")
    try:
        meshes = {a: make_local_mesh(model_axis=a, device="cpu") for a in (2, 4)}
        train_job(out, meshes)
        ckpt_job(out, meshes)
        pods_job(out)
        serve_job(out, meshes[2])
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
