"""The port on a device mesh against the JAX package, on 8 CPU ranks.

The port's ranks are 8 gloo processes (``tests/_torch_mesh_worker.py`` under
``torch.distributed.run``, one launch for every multi-rank check); the JAX
package runs as tests/test_distributed_8dev.py runs it, in a subprocess with
8 virtual CPU devices. Each subprocess has its own timeout, so a hung
collective fails a test instead of the whole run.

* Placements: every parameter of reduced qwen3_32b, moonshot_v1_16b and
  falcon_mamba_7b on a ``(4, 2)`` mesh has, on each rank, the global offset
  and local shape that JAX's ``NamedSharding.devices_indices_map`` gives the
  device at the same mesh coordinate.
* The optimizers' ``state_axes`` trees, and the production meshes (worlds 256
  and 512 under the fake process group) against the JAX ones.
* The sharded step: reduced qwen3_32b in float32 on ``(4, 2)`` (the setup of
  ``test_sharded_train_step_runs``: AdamW lr 1e-3, accumulation 2, 8 x 32
  tokens, attention block 16) from the JAX package's ``init_params(PRNGKey(0))``
  trains 6 steps: losses and gradient norms within 2e-3 of the port's
  single-process run and of the JAX package's sharded run, the first step's
  gradients within rtol 1e-3, atol 1e-4 and the parameters after 3 steps
  within rtol 5e-4, atol 5e-5 of the single-process run (the tolerances of
  tests/test_torch_train.py). The same 3-step comparison, the JAX sharded
  run included, for moonshot (experts over ``model``) and falcon
  (``d_inner`` over ``model``); moonshot's parameters are held after SGDM's
  steps (``_torch_mesh_worker.NO_PARAM_CHECK``). Against the single-process
  run also: qwen3 under Adafactor (its factored statistics on DTensors) and
  grok with 6 experts on ``(2, 4)`` (the expert FFN's width over ``model``).
* Every dispatch function of ``kernels.ops`` on DTensors, the GQA cases
  where kv heads do not split with q's among them; the logsumexp routes
  with q's heads split where kv's are whole, with no collective.
* ``sharding.redistribute``: a split moved between two dims by all-to-all,
  bit-equal to ``DTensor.redistribute`` and never gathered, and DTensor's
  own backward where nothing moves; reduced
  deepseek's 7 heads split 4 and 3 over ``model`` against the
  single-process loss and gradients; a grok step under Adafactor with its
  layer dim split that holds no expert stack whole.
* Sharded checkpoints, mirroring tests/test_distributed_8dev.py::
  test_checkpoint_elastic_remesh across the two packages and two meshes: the
  port's 8 ranks save an ``[8, 8]`` leaf on ``(4, 2)`` under
  ``P("data", "model")`` (and a bfloat16 leaf split over ``model`` only, and
  a replicated one), each rank writing only the shards it owns, and restore
  them on ``(2, 4)`` under ``P("model", "data")``; the JAX package's
  ``CheckpointManager`` restores that directory bit-equal; a directory the
  JAX package wrote from 8 virtual devices restores in the port on ``(2, 4)``.
* The train launcher on the 8 ranks: reduced qwen3_32b with a checkpoint at
  step 3 on ``--model-axis 2``, resumed from it on ``--model-axis 4``, gives
  the uninterrupted run's later losses within 2e-3 (the config's bfloat16:
  the two meshes sum their partial products in different orders); only
  rank 0 prints.
* The refusals: a model axis of 3 on 8 ranks, a production mesh on the wrong
  world, a process group other than NCCL on CUDA.
* The cross-pod gradient sync (``distributed.compression``) over the 8
  ranks' ``pod`` dim against the JAX package's ``shard_map`` over 8 devices
  (the oracle subprocess), and on DTensor leaves.
* ``LM.prefill`` and ``LM.decode_step`` on DTensor parameters and caches
  against the plain run (qwen3, falcon's Mamba cache, gemma3's rings).
* The dry run's counters: one reduced step counted on the ranks' real
  tensors equals the same step counted on fake tensors of a fake 8-rank
  group (a third subprocess, started with the other two).
"""
import json
import os
import re
import textwrap
from pathlib import Path
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import reduced  # noqa: E402
from repro.distributed.checkpoint import CheckpointManager as JaxManager  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from _torch_mesh_worker import (ARCHS, NO_PARAM_CHECK, RUNS, SCHEMES, SERVE_ARCHS,  # noqa: E402
                                load_run)
from _torch_subprocs import finish, python_sub, stop, torch_ranks  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402

TESTS = str(Path(__file__).resolve().parent)
LOSS_TOL = 2e-3
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4
PARAM_RTOL, PARAM_ATOL = 5e-4, 5e-5


X = np.arange(64, dtype=np.float32).reshape(8, 8)
# each arch's mesh: its first run's model axis
MODEL_AXIS = {arch: next(a for r, _, _, a in RUNS.values() if r == arch) for arch in ARCHS}

JAX_ORACLE = """
    import json
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import ModelConfig
    from repro.distributed.checkpoint import CheckpointManager
    from repro.models import build_model
    from repro.distributed.sharding import TRAIN_RULES, make_resolver, tree_shardings
    from repro.models.layers import sharding_context
    from repro.train.optimizer import AdamW
    from repro.train.trainer import make_train_step
    from repro.data.pipeline import DataConfig, TokenStream

    def make_mesh(model):
        return jax.make_mesh((8 // model, model), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)

    # first the checkpoint the port's ranks restore: an [8, 8] leaf on (4, 2)
    x = jnp.arange(64, dtype=jnp.float32).reshape(8, 8)
    w = jax.device_put(x, NamedSharding(make_mesh(2), P("data", "model")))
    assert len(w.addressable_shards) == 8
    CheckpointManager(CKPT, async_save=False).save(1, {"w": w})

    out = {"indices": {}}

    def flat(tree, prefix, acc):
        if isinstance(tree, dict):
            for k, v in tree.items():
                flat(v, f"{prefix}{k}.", acc)
        elif isinstance(tree, (list, tuple)) and not isinstance(tree, jax.sharding.Sharding):
            for i, v in enumerate(tree):
                flat(v, f"{prefix}{i}.", acc)
        else:
            acc[prefix[:-1]] = tree
        return acc

    def model_of(arch):
        with open(f"{DIR}/{arch}.json") as f:
            return build_model(ModelConfig.from_json(f.read()), attn_block=16)

    for arch, model_axis in MODEL_AXIS.items():
        mesh = make_mesh(model_axis)
        model = model_of(arch)
        abstract = model.abstract_params()
        psh = tree_shardings(mesh, abstract, model.param_axes(), TRAIN_RULES)
        shapes = flat(abstract, "", {})
        per = {}
        for name, sh in flat(psh, "", {}).items():
            idx = sh.devices_indices_map(shapes[name].shape)
            per[name] = {}
            for coord in np.ndindex(mesh.devices.shape):
                sl = idx[mesh.devices[coord]]
                per[name][str(list(coord))] = [
                    [s.start or 0, s.stop if s.stop is not None else n]
                    for s, n in zip(sl, shapes[name].shape)]
        out["indices"][arch] = per

    mesh = make_mesh(2)
    for arch, steps in SHARDED.items():
        model = model_of(arch)
        params = model.init_params(jax.random.PRNGKey(0))
        psh = tree_shardings(mesh, model.abstract_params(), model.param_axes(), TRAIN_RULES)
        params = jax.device_put(params, psh)
        opt = AdamW(lr=1e-3)
        rep = NamedSharding(mesh, P())
        state = jax.device_put(opt.init(params), {"step": rep, "m": psh, "v": psh})
        stream = TokenStream(DataConfig(vocab_size=model.cfg.vocab_size, seq_len=32,
                                        global_batch=8, seed=0))
        step = jax.jit(make_train_step(model, opt, accum=2))
        losses, gnorms = [], []
        with mesh, sharding_context(make_resolver(mesh, TRAIN_RULES)):
            for i in range(steps):
                params, state, m = step(params, state, stream.batch(i))
                losses.append(float(m["loss"]))
                gnorms.append(float(m["grad_norm"]))
        out[arch] = {"losses": losses, "grad_norms": gnorms}
    # the pod sync of tests/test_distributed_8dev.py::test_compressed_pod_psum_numerics:
    # each pod's gradient a row of pod_grads.npy, two rounds of each scheme
    from functools import partial
    from repro.distributed.compression import make_pod_grad_sync
    pmesh = jax.make_mesh((8,), ("pod",), axis_types=(jax.sharding.AxisType.Auto,))
    g = jnp.asarray(np.load(f"{DIR}/pod_grads.npy"))
    out["pods"] = {}
    for scheme in ("int8", "topk", "none"):
        sync = make_pod_grad_sync(pmesh, scheme)

        @partial(jax.shard_map, mesh=pmesh, in_specs=(P("pod"), P("pod")),
                 out_specs=(P("pod"), P("pod")))
        def run(g, e):
            s, ne = sync({"w": g[0]}, {"w": e[0]})
            return s["w"][None], ne["w"][None]
        s1, e1 = run(g, jnp.zeros((8, 64)))
        s2, e2 = run(g, e1)
        out["pods"][scheme] = [np.asarray(t).tolist() for t in (s1, e1, s2, e2)]
    with open(OUT, "w") as f:
        json.dump(out, f)
"""

# the dry run's counts on fake tensors of a fake 8-rank group, for the ranks'
# counts on real ones
FAKE_COUNTS = """
    import json, sys
    sys.path.insert(0, TESTS)
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from _torch_mesh_worker import count_cells
    from repro_torch.launch.mesh import make_local_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    mesh = make_local_mesh(model_axis=2, device="cpu")
    with FakeTensorMode():
        got = count_cells(mesh)
    dist.destroy_process_group()
    with open(OUT, "w") as f:
        json.dump(got, f)
"""
# the JAX package's sharded runs (AdamW) the port's are held to: arch -> steps
SHARDED = {"qwen3_32b": 6, "moonshot_v1_16b": 3, "falcon_mamba_7b": 3}


def _cfg(arch):
    """The reduced config in float32; grok's with 6 experts, which do not
    split over a model axis of 4, so that its expert FFN's width does
    (``w_moe_mlp``), and its gradients summed in float32 as the others'."""
    cfg = replace(reduced(jax_config(arch)), dtype="float32")
    if arch == "grok1_314b":
        cfg = replace(cfg, moe=replace(cfg.moe, num_experts=6), opt_state_dtype="float32")
    return cfg


def _flat_np(tree, prefix="", acc=None):
    acc = {} if acc is None else acc
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat_np(v, f"{prefix}{k}.", acc)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flat_np(v, f"{prefix}{i}.", acc)
    else:
        acc[prefix[:-1]] = np.asarray(tree)
    return acc


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the JAX oracle (which first writes a checkpoint from 8 devices)
    and the 8 port ranks (which also make the single-process references)
    together, then gathers everything."""
    d = tmp_path_factory.mktemp("mesh")
    for arch in ARCHS:
        jcfg = _cfg(arch)
        params = jax_build(jcfg, attn_block=16).init_params(jax.random.PRNGKey(0))
        np.savez(d / f"{arch}.npz", **_flat_np(jax.tree.map(np.asarray, params)))
        with open(d / f"{arch}.json", "w") as f:
            f.write(jcfg.to_json())
    np.save(d / "pod_grads.npy", np.asarray(jax.random.normal(jax.random.PRNGKey(0), (8, 64))))
    oracle = python_sub(f"OUT = {str(d / 'jax.json')!r}\nCKPT = {str(d / 'jax')!r}\n"
                        f"DIR = {str(d)!r}\nMODEL_AXIS = {MODEL_AXIS!r}\n"
                        f"SHARDED = {SHARDED!r}\n" + textwrap.dedent(JAX_ORACLE),
                        str(d / "jax.log"), devices=8)
    ranks = torch_ranks(str(d))
    fake = python_sub(f"OUT = {str(d / 'fake_counts.json')!r}\nTESTS = {TESTS!r}\n"
                      + textwrap.dedent(FAKE_COUNTS), str(d / "fake.log"))
    try:
        finish(oracle)
        finish(fake)
        ranks_log = finish(ranks)
    finally:
        stop(oracle, ranks, fake)
    with open(d / "jax.json") as f:
        jax_res = json.load(f)
    with open(d / "train.json") as f:
        port = json.load(f)
    for name in RUNS:
        port[name].update(load_run(str(d), f"mesh_{name}"))
    single = {name: load_run(str(d), f"single_{name}") for name in RUNS}
    with open(d / "ckpt.json") as f:
        ckpt = json.load(f)
    with open(d / "pods.json") as f:
        pods = json.load(f)
    with open(d / "serve.json") as f:
        serve = json.load(f)
    with open(d / "fake_counts.json") as f:
        fake_counts = json.load(f)
    return {"jax": jax_res, "port": port, "single": single, "dir": d, "ckpt": ckpt,
            "log": ranks_log, "pods": pods, "serve": serve, "fake_counts": fake_counts,
            "pod_grads": np.load(d / "pod_grads.npy")}


@pytest.mark.parametrize("arch", ARCHS)
def test_placements_equal_the_jax_shardings(runs, arch):
    """Each rank's global offset and local shape of every parameter equal the
    index JAX gives the device at the same mesh coordinate of a (4, 2) mesh
    (grok's: (2, 4))."""
    want = runs["jax"]["indices"][arch]
    got = runs["port"][next(n for n, r in RUNS.items() if r[0] == arch)]
    every = got["shards"]
    assert len(every) == 8
    coords = set()
    for coord, shards in every:
        coords.add(tuple(coord))
        assert set(shards) == set(want)
        for name, (offset, shape, spec) in shards.items():
            index = [[o, o + n] for o, n in zip(offset, shape)]
            assert index == want[name][str(coord)], (name, coord, spec)
    model = MODEL_AXIS[arch]
    assert coords == {(i, j) for i in range(8 // model) for j in range(model)}
    # something is split over each mesh axis, and a step keeps every placement
    specs = " ".join(s for _, shards in every for _, _, s in shards.values())
    assert "'data'" in specs and "'model'" in specs
    assert got["placements_kept"]


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor", "sgdm"])
def test_state_axes_match_jax(opt_name):
    for arch in ARCHS:
        jcfg = _cfg(arch)
        jaxes = jax_build(jcfg, attn_block=16).param_axes()
        taxes = LM(ModelConfig.from_json(jcfg.to_json()), device="cpu").param_axes()
        want = jopt.make_optimizer(opt_name, 1e-3, jcfg).state_axes(jaxes)
        got = topt.make_optimizer(opt_name, 1e-3, jcfg).state_axes(taxes)

        def flat(tree, prefix=""):
            if isinstance(tree, dict):
                return {n: a for k, v in tree.items() for n, a in flat(v, f"{prefix}{k}.").items()}
            if isinstance(tree, list):
                return {n: a for i, v in enumerate(tree)
                        for n, a in flat(v, f"{prefix}{i}.").items()}
            return {prefix[:-1]: tuple(tree)}
        assert flat(got) == flat(want), (arch, opt_name)
        assert len(flat(got)) > 10


@pytest.fixture(scope="module")
def production(tmp_path_factory):
    d = tmp_path_factory.mktemp("production")
    port = python_sub("""
        import json
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from torch.distributed.tensor import DTensor
        from repro_torch.configs import get_config
        from repro_torch.distributed.sharding import TRAIN_RULES, tree_shardings, with_shardings
        from repro_torch.launch.mesh import make_production_mesh
        from repro_torch.launch.train import flat_axes
        from repro_torch.models.transformer import abstract_params, param_axes
        out = {}
        for world, multi in ((256, False), (512, True)):
            dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
            m = make_production_mesh(multi_pod=multi)
            out[world] = {"shape": list(m.mesh.shape), "names": list(m.mesh_dim_names)}
            cfg = get_config("qwen3_32b")
            pa = abstract_params(cfg)
            dt = with_shardings(pa, tree_shardings(m, pa, param_axes(cfg), TRAIN_RULES))
            local = {n: [type(t).__name__, str(t.to_local().device), list(t.to_local().shape)]
                     for n, t in flat_axes(dt).items()}
            out[world]["local"] = local
            try:
                make_production_mesh(multi_pod=not multi)
            except ValueError as e:
                out[world]["refused"] = str(e)
            dist.destroy_process_group()
        print("PORT", json.dumps(out))
    """, str(d / "port.log"))
    ref = python_sub("""
        import json
        import jax
        from repro.configs import get_config
        from repro.distributed.sharding import TRAIN_RULES, tree_shardings
        from repro.launch.mesh import make_production_mesh
        from repro.models import build_model
        out = {}
        for world, multi in ((256, False), (512, True)):
            m = make_production_mesh(multi_pod=multi)
            out[world] = {"shape": list(m.devices.shape), "names": list(m.axis_names)}
            model = build_model(get_config("qwen3_32b"))
            pa = model.abstract_params()
            sh = tree_shardings(m, pa, model.param_axes(), TRAIN_RULES)
            paths = jax.tree_util.tree_flatten_with_path(pa)[0]
            out[world]["local"] = {
                ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
                    list(s.shard_shape(a.shape))
                for (path, a), s in zip(paths, jax.tree.leaves(sh))}
        print("JAX", json.dumps(out))
    """, str(d / "jax.log"), devices=512)

    def read(p, tag):
        line = [x for x in finish(p, 300).splitlines() if x.startswith(tag)][-1]
        return json.loads(line[len(tag) + 1:])
    try:
        return read(port, "PORT"), read(ref, "JAX")
    finally:
        stop(port, ref)


@pytest.mark.parametrize("world", ["256", "512"])
def test_production_mesh_matches_jax(production, world):
    """The mesh's shape and axis names; ``with_shardings``' ``meta`` DTensors
    of qwen3_32b's parameters (built with no collective) have, on rank 0,
    the local shape of JAX's ``NamedSharding.shard_shape``."""
    port, ref = production
    assert {k: port[world][k] for k in ("shape", "names")} == \
        {k: ref[world][k] for k in ("shape", "names")}
    assert "needs" in port[world]["refused"]            # the other mesh on this world
    local = port[world]["local"]
    assert set(local) == set(ref[world]["local"]) and len(local) > 10
    for n, (kind, device, shape) in local.items():
        assert (kind, device, shape) == ("DTensor", "meta", ref[world]["local"][n]), n


@pytest.mark.parametrize("n", [1, 5, 8, 13, 201, 504])
def test_local_ranges_split_as_dtensor_splits_even_or_not(n):
    """``local_ranges`` (and ``split_range``) give each coordinate of a
    ``(4, 2)`` mesh of a fake 8-rank group the range ``torch.chunk`` gives
    it, as DTensor splits a dim, the first mesh dim outermost: even splits,
    uneven ones (the vocab-parallel log-prob's 201 classes) and empty
    shares."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.distributed.sharding import local_ranges
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
        for pl in ([Shard(0), Shard(0)], [Shard(0), Replicate()], [Replicate(), Shard(0)]):
            for coord in [(a, b) for a in range(4) for b in range(2)]:
                items = torch.arange(n)
                for i, p in enumerate(pl):
                    if isinstance(p, Shard):
                        parts = torch.chunk(items, mesh.size(i))
                        items = parts[coord[i]] if coord[i] < len(parts) else items[:0]
                (a, b), = local_ranges((n,), mesh, pl, coord)
                assert b - a == len(items), (pl, coord)
                assert len(items) == 0 or (a, b) == (int(items[0]), int(items[-1]) + 1)
    finally:
        dist.destroy_process_group()


def test_sharded_qwen3_steps_match_the_single_process_run_and_jax(runs):
    got, single = runs["port"]["qwen3_32b"], runs["single"]["qwen3_32b"]
    ref = runs["jax"]["qwen3_32b"]
    assert got["losses"][-1] < got["losses"][0], got["losses"]
    for key in ("losses", "grad_norms"):
        np.testing.assert_allclose(got[key], single[key], rtol=0, atol=LOSS_TOL, err_msg=key)
        np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=LOSS_TOL, err_msg=key)


@pytest.mark.parametrize("arch", list(RUNS))
def test_sharded_gradients_and_parameters_match_the_single_process_run(runs, arch):
    """Each run of ``_torch_mesh_worker.RUNS`` on its mesh against the same
    run on one process: the first 3 steps' losses and gradient norms (and,
    for moonshot and falcon, against the JAX package's sharded run too), the
    first step's mean gradients and the parameters after 3 steps."""
    got, single = runs["port"][arch], runs["single"][arch]
    for key in ("losses", "grad_norms"):
        np.testing.assert_allclose(got[key][:3], single[key][:3], rtol=0, atol=LOSS_TOL,
                                   err_msg=key)
        if arch in SHARDED:
            np.testing.assert_allclose(got[key][:3], runs["jax"][arch][key][:3], rtol=0,
                                       atol=LOSS_TOL, err_msg=key)
    if arch == "grok1_314b/tp":
        # the experts are whole on every rank and their FFN's width split over model
        _, shards = got["shards"][0]
        moe = {n: s for n, (_, _, s) in shards.items() if n.endswith(("wg", "wi", "wo"))}
        assert moe and all("'model'" in s for s in moe.values()), moe
    assert set(got["grads"]) == set(single["grads"])
    for n, g in single["grads"].items():
        np.testing.assert_allclose(got["grads"][n], g, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=n)
    if arch in NO_PARAM_CHECK:
        return
    for n, p in single["after3"].items():
        np.testing.assert_allclose(got["after3"][n], p, rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=n)


def test_every_dispatch_function_takes_dtensors(runs):
    """``kernels.ops`` on DTensors of a (4, 2) mesh against the same calls on
    whole tensors, within the f32 kernel tolerance 2e-4: B1, B1's logsumexp,
    B1b, ``attend_blocked`` with its gradients and B2 with kv heads split
    with q's, one kv head for a rank's q heads, kv heads repeated, the head
    dim split (and B2's cache width split); B3 with its gradients and B3b,
    channels over ``model``; B4 with its gradients and B4b, F split or E
    split (gathered)."""
    errs = runs["port"]["ops"]
    assert len(errs) == 30
    for case, err in errs.items():
        assert err <= 2e-4, (case, err)


@pytest.mark.parametrize("mesh_dim", [0, 1])
def test_a_split_moves_between_dims_by_all_to_all(runs, mesh_dim):
    """``sharding.redistribute`` moves a split from tensor dim a to tensor
    dim b of an ``(8, 10, 9)`` tensor (dims 1 and 2 split unevenly) on
    each mesh dim of the ``(4, 2)`` mesh, for every pair (a, b), the other
    mesh dim replicated or splitting any dim: bit-equal to
    ``DTensor.redistribute``, values, placements and gradients, by
    all-to-all alone (three where the other mesh dim's split nests inside a
    or b and steps aside), with no all-gather and no local tensor over 1.5x
    the larger shard (gathering over the mesh dim's 4 or 2 ranks makes
    one 4x or 2x)."""
    cases = {k: v for k, v in runs["port"]["moves"].items() if k.startswith(f"{mesh_dim}:")}
    assert len(cases) == 24
    for case, got in cases.items():
        assert got["equal"], case
        assert got["all_gather"] == 0 and got["largest"] < 1.5, (case, got)
        assert got["all_to_all"] == (3 if got["nested"] else 1), (case, got)
    assert any(got["nested"] for got in cases.values()) == (mesh_dim == 0)


def test_a_redistribution_that_moves_no_split_keeps_dtensors_backward(runs):
    """``sharding.redistribute`` where no split moves between dims, its
    gradient arriving ``Partial`` on the mesh dim that the result
    replicates (as ``ops.run_local`` hands a kernel's input gradient back):
    the input's gradient bit-equal to ``DTensor.redistribute``'s, by the
    same collectives forward and backward, the gradient reduce-scattered
    into the input's split once. Carried through the result's layout, it
    was all-reduced and then sliced: the dry run's train cells turned
    their reduce-scatters into all-reduces (grok1_314b's collective term
    5.1 s to 6.6 s)."""
    got = runs["port"]["backward"]
    for name, case in got.items():
        assert case["equal"], (name, case)
        assert case["port"] == case["dtensor"], (name, case)
    assert "reduce-scatter" in got["split on model"]["port"], got


def test_the_logsumexp_routes_keep_q_heads_split(runs):
    """``flash_attention_lse`` and ``flash_attention_bwd`` on DTensors whose
    2 kv heads do not split over the 4 ``model`` ranks (H 8): within 2e-4
    of the plain calls (f32), q's heads split (2 a rank, in and out), the
    lse ``[B, S, H]``, and no collective: nothing gathers q."""
    got = runs["port"]["lse"]
    for err in [got["out"], got["lse"], *got["grads"]]:
        assert err <= 2e-4, got
    assert got["local_heads"] == got["out_local_heads"] == 2
    assert got["lse_shape"] == [4, 16, 8]
    assert got["collectives"] == {}


def test_heads_the_model_axis_does_not_divide_split_unevenly(runs):
    """Reduced deepseek_coder_33b's 7 heads on a ``model`` axis of 2: the
    loss and every gradient within 1e-6 of the single-process run (over
    the reference's largest magnitude), each rank's attention taking its
    own heads, 4 or 3 (at most ceil(7 / 2)), in every call."""
    got = runs["port"]["heads"]
    assert got["loss"] <= 1e-6
    assert got["grads"] and max(got["grads"].values()) <= 1e-6, got["grads"]
    assert got["num_heads"] == 7
    by_rank = got["heads"]
    assert len(by_rank) == 8 and all(by_rank)
    assert {frozenset(h) for h in by_rank} == {frozenset([4]), frozenset([3])}


def test_a_grok_adafactor_step_holds_no_expert_stack_whole(runs):
    """One step of reduced grok1_314b (4 layers, 6 experts) under Adafactor
    on ``(2, 4)``, its layer dim split over ``model`` as grok's 64 layers
    are over 16: the loss and the new parameters within 1e-6 of the
    single-process step, and no rank makes a local tensor of the whole
    expert stack's shape (the factored second moment is made on each
    rank's shard, as the gradient lies, so the update needs no move)."""
    got = runs["port"]["grok_step"]
    assert got["loss"] <= 1e-6 and got["params"] <= 1e-6, got
    assert got["stack"] == [4, 6, 64, 128] and got["whole"] == []


def test_shard_act_constrains_as_with_sharding_constraint(runs):
    """An unconstrained dim keeps its split, a named one is split and the
    rest gathered, a Partial is reduced; the identity outside a context and
    on a plain tensor."""
    got = runs["port"]["shard_act"]
    assert got["outside"] and got["plain"]
    assert got["kept"] == ["(Shard(dim=0), Shard(dim=1))", 0.0]
    assert got["moved"] == ["(Shard(dim=0), Shard(dim=2))", 0.0]
    assert got["reduced"] == ["(Shard(dim=0), Replicate())", 0.0]


def test_a_model_axis_that_does_not_divide_the_ranks_is_refused(runs):
    port = runs["port"]
    assert port["backend"] == "gloo"
    assert "--model-axis 3 does not divide 8 ranks" in port["refusals"]["make_local_mesh"]
    assert "--model-axis 3 does not divide 8 ranks" in port["refusals"]["launcher"]


def test_cuda_takes_nccl_and_nothing_else(monkeypatch):
    """The backend follows the device; asking for CUDA without a card raises
    rather than starting gloo on the CPU."""
    import torch.distributed as dist

    from repro_torch.launch import mesh
    assert mesh.backend_for("cuda") == "nccl" and mesh.backend_for("cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.init_process_group("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.init_process_group()
    assert not dist.is_initialized()


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def test_the_ports_ranks_save_on_one_mesh_and_restore_on_another(runs):
    got = runs["ckpt"]["port"]
    assert runs["ckpt"]["steps"] == [1, 2]
    np.testing.assert_array_equal(np.asarray(got["w"]["values"]), X)
    np.testing.assert_array_equal(np.asarray(got["b"]["values"]), _bf16(X / 7))
    np.testing.assert_array_equal(np.asarray(got["r"]["values"]), X[0])
    # (2, 4) ("data", "model"): w's rows over model, columns over data
    assert got["w"]["placements"] == "(Shard(dim=1), Shard(dim=0))"
    assert got["w"]["spec"] == "('model', 'data')"
    assert got["b"]["spec"] == "(None, 'data')" and got["r"]["spec"] == "('model',)"
    assert runs["ckpt"]["port_local"] == {"w": [2, 4], "b": [8, 4], "r": [2]}
    # one file per unique shard, written by the rank that owns it
    man = json.load(open(runs["dir"] / "port" / "step_000000002" / "MANIFEST.json"))
    counts = {k: len(v["shards"]) for k, v in man["leaves"].items()}
    assert counts == {"w": 8, "b": 2, "r": 1}
    for name, leaf in man["leaves"].items():
        files = sorted(f for f in os.listdir(runs["dir"] / "port" / "step_000000002" / name))
        assert files == sorted(e["file"] for e in leaf["shards"])
    assert not [f for f in os.listdir(runs["dir"] / "port") if f.startswith(".")]


def test_the_jax_package_restores_the_ports_sharded_checkpoint_bit_equal(runs):
    target = {"w": jnp.zeros((8, 8), jnp.float32), "b": jnp.zeros((8, 8), jnp.bfloat16),
              "r": jnp.zeros((8,), jnp.float32)}
    got = JaxManager(str(runs["dir"] / "port")).restore(2, target)
    assert np.asarray(got["w"]).tobytes() == X.tobytes()
    assert np.asarray(got["r"]).tobytes() == X[0].tobytes()
    want_b = np.asarray(jnp.asarray(X / 7, jnp.bfloat16))
    assert got["b"].dtype == jnp.bfloat16
    assert np.asarray(got["b"]).view(np.uint16).tobytes() == want_b.view(np.uint16).tobytes()


def test_the_port_restores_what_jax_wrote_from_8_devices(runs):
    man = json.load(open(runs["dir"] / "jax" / "step_000000001" / "MANIFEST.json"))
    assert len(man["leaves"]["w"]["shards"]) == 8
    got = runs["ckpt"]["jax"]["w"]
    np.testing.assert_array_equal(np.asarray(got["values"]), X)
    assert got["spec"] == "('model', 'data')"


def test_the_launcher_trains_on_8_ranks_and_resumes_on_another_model_axis(runs):
    """The launcher on the 8 ranks that ``torch.distributed.run`` started
    trains on --model-axis 2; a run resumed from the step-3 checkpoint on
    --model-axis 4 gives the uninterrupted run's losses at steps 3-5 within
    2e-3; only rank 0 prints."""
    got = runs["ckpt"]
    full, resumed = got["full"]["losses"], got["resumed"]["losses"]
    assert got["steps_after_full"] == ["step_000000003", "step_000000006"]
    assert len(full) == 6 and full[5] < full[0], full
    assert got["resumed"]["start"] == 3 and len(resumed) == 3
    np.testing.assert_allclose(resumed, full[3:], rtol=0, atol=LOSS_TOL)
    logged = re.findall(r"\[train\] step\s+(\d+) loss=(\S+)", runs["log"])
    assert [int(i) for i, _ in logged] == [0, 5, 5], logged   # each run's first and last
    np.testing.assert_allclose([float(v) for _, v in logged], [full[0], full[5], resumed[2]],
                               rtol=0, atol=5e-5)
    assert runs["log"].count("[train] done") == 2          # two runs; only rank 0 prints
    assert runs["log"].count("[train] resumed at step 3") == 1


@pytest.mark.parametrize("scheme", SCHEMES)
def test_pod_grad_sync_on_8_ranks_matches_the_jax_shard_map(runs, scheme):
    """``make_pod_grad_sync`` over the 8 ranks' ``pod`` dim against the JAX
    package's inside ``shard_map`` over 8 devices, on the gradients of
    tests/test_distributed_8dev.py::test_compressed_pod_psum_numerics: each
    pod's synced mean and new error, two rounds (the second from the first's
    error), within 1e-6 (the same payloads, summed in another order)."""
    want = runs["jax"]["pods"][scheme]
    for rank, got in enumerate(runs["pods"]):
        for k, (a, b) in enumerate(zip(got[scheme], want)):
            np.testing.assert_allclose(a, b[rank], rtol=0, atol=1e-6, err_msg=f"{rank} {k}")
    g = runs["pod_grads"]
    synced = np.asarray(runs["pods"][0][scheme][0])
    err = float(np.abs(synced - g.mean(0)).max())
    assert err < (1e-6 if scheme == "none" else 0.05 if scheme == "int8" else 1.0), err
    if scheme == "none":
        assert not np.any(runs["pods"][3][scheme][1])      # the error is kept (zeros)


def test_pod_grad_sync_keeps_a_dtensors_placements(runs):
    """A leaf split over ``data`` on a ``(2, 4)`` ``("pod", "data")`` mesh is
    synced through its local shard: the synced mean and the new error keep
    the leaf's placements, and equal the mean over the 2 pods of each
    shard's own int8 compression."""
    from repro_torch.distributed import compression as C
    g = runs["pod_grads"]
    for res in runs["pods"]:
        got = res["dtensor"]
        p, d = got["coord"]
        assert got["placements"] == got["err_placements"] == "(Replicate(), Shard(dim=0))"
        pods = [torch.as_tensor(g[q, d * 16:(d + 1) * 16]) for q in (0, 1)]
        sent = [C.ef_compress_int8(x, torch.zeros(16)) for x in pods]
        mean = sum(C.dequantize_int8(q, s) for q, s, _ in sent) / 2
        np.testing.assert_allclose(got["synced"], mean.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["err"], sent[p][2].numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_meshed_prefill_and_decode_equal_the_single_process_run(runs, arch):
    """``LM.prefill`` on DTensor parameters under ``PREFILL_RULES`` and 3
    ``LM.decode_step``s on a DTensor cache under ``DECODE_RULES`` (on the
    ranks' (4, 2) mesh) give the plain run's logits and caches within 1e-5
    in float32. qwen3's cache is split over its slots by the rules (one kv
    head), batch over ``data``; gemma3's over both mesh dims by
    ``LONG_DECODE_RULES`` (its rings of 16 and global caches of 32), so its
    ring writes land in one rank's shard; falcon's Mamba cache is split over
    its channels."""
    got = runs["serve"][arch]
    assert max(got["prefill"]) <= 1e-5, got["prefill"]
    assert len(got["decode"]) == 3
    for step in got["decode"]:
        assert max(step) <= 1e-5, got["decode"]
    if arch == "qwen3_32b":
        assert got["cache_placements"] == ["(Shard(dim=1), Shard(dim=2))"]
    elif arch == "gemma3_12b":
        assert got["cache_placements"] == ["(Shard(dim=2), Shard(dim=2))"]
    else:
        assert "(Shard(dim=1), Shard(dim=3))" in got["cache_placements"]


@pytest.mark.parametrize("arch", ["qwen3_32b", "gemma3_12b"])
def test_slot_split_decode_never_gathers_the_slots(runs, arch):
    """The caches split over their slots (qwen3's over ``model``, gemma3's
    rings and global caches over both mesh dims) are attended where they lie: each
    rank takes its slots' partial softmax and the ranks combine them
    (flash-decoding across ranks), so no rank makes a cache tensor that
    holds all of a layer's slots; the logits are the plain run's (the test
    above)."""
    got = runs["serve"][arch]
    assert got["whole_cache"] == []


def test_the_vocab_parallel_log_prob_matches_and_never_holds_the_vocab(runs):
    """The label log-prob of logits split over the vocabulary (``model``)
    and the batch (``data``), and its gradients through the head and the
    hidden state, against the single-process run within 1e-6 of the
    reference's largest magnitude, at a vocabulary of 200 and of 201 (split
    unevenly, 101 and 100); no rank makes a local tensor with the whole
    vocabulary, where the replicated ``log_softmax`` and ``gather`` on the
    same DTensors do."""
    for V, got in runs["port"]["vocab"].items():
        for k in ("lp", "dx", "dhead"):
            assert got[k] <= 1e-6, (V, k, got[k])
        assert got["logits"] == "(Shard(dim=0), Shard(dim=2))", V
        assert got["placements"] == "(Shard(dim=0), Replicate())", V
        assert got["whole"] == [] and got["whole_replicated"] > 0, V
    assert sorted(runs["port"]["vocab"]) == ["200", "201"]


@pytest.mark.parametrize("cell", ["qwen3_32b/train", "qwen3_32b/prefill", "qwen3_32b/decode",
                                  "falcon_mamba_7b/prefill", "falcon_mamba_7b/decode",
                                  "gemma3_12b/prefill", "gemma3_12b/decode"])
def test_the_fake_group_counts_what_the_real_ranks_count(runs, cell):
    """The dry run's counters on a reduced step (``_torch_mesh_worker.
    count_cells``: one train step, one prefill, 3 decode steps) under a fake
    8-rank group on fake tensors count exactly the FLOPs, bytes,
    collectives, peak and argument bytes that the 8 gloo ranks count on
    real tensors of the same (4, 2) mesh."""
    fake, real = runs["fake_counts"][cell], runs["serve"]["counts"][cell]
    assert fake == real
    assert real["flops"] > 0 and real["peak"] > real["argument"] > 0 and real["ops"]