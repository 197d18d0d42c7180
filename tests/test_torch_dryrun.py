"""The port's dry run (``repro_torch.launch.dryrun`` and ``sweep``) against the
JAX package's.

* ``--list`` prints the JAX dry run's list, line for line, and
  ``LM.cache_specs`` gives the JAX cache's shapes, dtypes and logical axes
  for every assigned arch at full size.
* The counterpart of tests/test_distributed_8dev.py::
  test_mini_dryrun_probe_consistency: on a fake 8-rank ``(4, 2)`` mesh the
  per-device FLOPs of reduced deepseek_coder_33b's train step at 4 layers
  against 1 + 3 * (2 - 1) layers' (eager PyTorch counts every layer, so the
  count is linear in depth).
* The per-device FLOPs of reduced deepseek_coder_33b train_4k and qwen3_32b
  decode (8 x 64 tokens) on that mesh against JAX's
  ``cost_analysis()["flops"]`` of the same cells on 8 XLA CPU devices
  (unrolled, ``attn_block`` 16), within 5% (the JAX package's own probe
  tolerance of depth). Both count the matmuls by their products and one
  FLOP an element of elementwise work, transcendentals apart, and the port
  counts the plain path it runs, DTensor's local ops included. They were
  1.25 and 1.54 before ``shard_act`` constrained the gradient, a
  ``Partial`` residual was reduced before the norm, the cache's slots were
  attended where they lie and transcendentals left the count; train was
  1.091 while its 7 heads ran whole on both model ranks (they split 4 and
  3 since). The bytes of the same cells are read against JAX's, with no
  band.
* The dry run's peak of a cell past 8192 tokens comes from two shallow
  probes at the JAX model's 512 rows (``dryrun.probe_peak``): at the
  counted run's own block the probes give the full depth's peak within 1%;
  a placed shard holds its own storage, not a view of the whole tensor.
* Reduced falcon's prefill makes no tensor of a rank's tokens with d_inner
  whole; reduced qwen3's prefill gives each layer's cache split as the
  cache's axes split it.
* One production cell (phi3_vision decode_32k on 256 fake ranks) runs end
  to end through the CLI and writes an ``ok`` artifact with the JAX
  package's keys; ``sweep`` writes the skips itself, resumes, and records
  a cell that outlives ``--timeout`` as an error.
"""
import json
import os
import subprocess
import sys
import textwrap
from dataclasses import fields

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as jget  # noqa: E402
from repro.models.transformer import LM as JLM  # noqa: E402
from _torch_subprocs import SRC, finish, python_sub, stop  # noqa: E402
from repro_torch.configs import assigned_archs, get_config  # noqa: E402
from repro_torch.telemetry.roofline import RooflineReport  # noqa: E402

# port FLOPs over JAX's (see the module's docstring)
BANDS = {"deepseek_coder_33b/train": (0.95, 1.05), "qwen3_32b/decode": (0.95, 1.05)}
# reduced cells whose peak the two shallow probes extrapolate: (arch, shape, layers)
PEAK_CELLS = (("qwen3_32b", "prefill_32k", 6), ("gemma3_12b", "prefill_32k", 18),
              ("deepseek_coder_33b", "train_4k", 4))

PORT = """
    import json
    from dataclasses import replace
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import SHAPES, get_config, reduced
    from repro_torch.distributed.sharding import rules_for_cfg
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import LM
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    mesh = make_local_mesh(model_axis=2, device="cpu")
    out = {"linear": {}, "flops": {}, "bytes": {}, "cells": {}, "peaks": {}}

    def count(cfg, shape):
        with FakeTensorMode():
            model = LM(cfg, device="cpu", attn_block=16)
            cost, mem = dryrun.probe_costs(cfg, shape, mesh, rules_for_cfg(shape.mode, cfg),
                                           model=model)
        return cost, mem

    train = replace(SHAPES["train_4k"], global_batch=8, seq_len=64)
    cfg = replace(reduced(get_config("deepseek_coder_33b")), num_layers=4, grad_accum=1)
    for nl in (1, 2, 4):
        out["linear"][nl] = count(replace(cfg, num_layers=nl), train)[0]["flops"]
    for arch, shape in (("deepseek_coder_33b", train),
                        ("qwen3_32b", replace(SHAPES["decode_32k"], global_batch=8,
                                              seq_len=64))):
        cost, mem = count(replace(reduced(get_config(arch)), dtype="float32"), shape)
        out["flops"][f"{arch}/{shape.mode}"] = cost["flops"]
        out["bytes"][f"{arch}/{shape.mode}"] = cost["bytes"]
    # the peak: the full depth's counted run against the two shallow probes
    for arch, name, layers in PEAK_CELLS:
        cfg = replace(reduced(get_config(arch)), num_layers=layers)
        shape = replace(SHAPES[name], global_batch=8, seq_len=64)
        rules = rules_for_cfg(shape.mode, cfg)
        _, mem = count(cfg, shape)
        with FakeTensorMode():
            probed = dryrun.probe_peak(cfg, shape, mesh, rules, block=16)
        out["peaks"][f"{arch}/{name}"] = [mem["peak_gib"] * 2 ** 30, probed]
    # a shard that is a contiguous slice of the whole tensor (a one-period
    # probe's stacked expert weights, one expert a rank and the embed dim split)
    import torch
    from repro_torch.distributed.sharding import NamedSharding, place
    loc = place(torch.zeros(1, 4, 8, 6), NamedSharding(mesh, (None, "data", "model"))).to_local()
    out["place"] = [list(loc.shape), loc.untyped_storage().nbytes(), loc.numel() * 4]
    # reduced falcon's prefill: the local tensors of the rank's 2 x 32 tokens
    # that hold d_inner whole
    from repro_torch.telemetry import roofline as R
    cfg = replace(reduced(get_config("falcon_mamba_7b")), dtype="float32")
    DI = cfg.mamba.d_inner

    class Held(R._Counter):
        def __init__(self):
            super().__init__()
            self.seen = []

        def op(self, func, args, kwargs, res):
            self.seen += [[str(func), list(t.shape)] for t in R._tensors(res)
                          if t.dim() >= 2 and t.shape[-1] == DI and t.numel() == 2 * 32 * DI]
    with FakeTensorMode():
        shape = replace(SHAPES["prefill_32k"], global_batch=8, seq_len=32)
        fn, args, _, _ = dryrun.build_cell(cfg, shape, mesh, rules_for_cfg("prefill", cfg),
                                           model=LM(cfg, device="cpu", attn_block=16))
        with Held() as held:
            fn(*args)
    out["whole_d_inner"] = held.seen
    # reduced qwen3's prefill: the stacked cache as LM.prefill gives it
    from repro_torch.distributed.sharding import make_resolver
    from repro_torch.models.layers import sharding_context
    cfg = replace(reduced(get_config("qwen3_32b")), num_layers=3, dtype="float32")
    rules = rules_for_cfg("prefill", cfg)
    with FakeTensorMode():
        lm = LM(cfg, device="cpu", attn_block=16)
        _, (params, batch), _, _ = dryrun.build_cell(cfg, shape, mesh, rules, model=lm)
        with sharding_context(make_resolver(mesh, rules)):
            _, cache = lm.prefill(batch, params=params)
    k = cache["slots"][0]["k"]
    out["prefill_cache"] = [list(k.shape), list(k.to_local().shape), repr(tuple(k.placements))]
    # build_cell's modes: what each donates and gives back
    for arch, name in (("hubert_xlarge", "prefill_32k"), ("qwen3_32b", "prefill_32k"),
                       ("qwen3_32b", "decode_32k"), ("falcon_mamba_7b", "long_500k"),
                       ("qwen3_32b", "train_4k")):
        cfg = replace(reduced(get_config(arch)), dtype="float32")
        shape = replace(SHAPES[name], global_batch=8, seq_len=32)
        with FakeTensorMode():
            fn, args, donate, _ = dryrun.build_cell(cfg, shape, mesh,
                                                    rules_for_cfg(shape.mode, cfg),
                                                    model=LM(cfg, device="cpu", attn_block=16))
            res = fn(*args)
        first = res[0] if isinstance(res, tuple) else res
        out["cells"][f"{arch}/{name}"] = {"donate": list(donate), "n_args": len(args),
                                          "first": list(first.shape) if hasattr(first, "shape")
                                          else sorted(first)}
    dist.destroy_process_group()
    with open(OUT, "w") as f:
        json.dump(out, f)
"""

JAX = """
    import json
    import jax
    from dataclasses import replace
    from repro.configs import DECODE_32K, TRAIN_4K, get_config, reduced
    from repro.distributed.sharding import make_resolver, rules_for_cfg
    from repro.launch.dryrun import build_cell
    from repro.models.layers import sharding_context
    from repro.models.transformer import LM
    mesh = jax.make_mesh((4, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}
    for arch, shape in (("deepseek_coder_33b", replace(TRAIN_4K, global_batch=8, seq_len=64)),
                        ("qwen3_32b", replace(DECODE_32K, global_batch=8, seq_len=64))):
        cfg = replace(reduced(get_config(arch)), dtype="float32")
        rules = rules_for_cfg(shape.mode, cfg)
        fn, args, donate, out_sh = build_cell(cfg, shape, mesh, rules,
                                              model=LM(cfg, unroll=True, attn_block=16))
        with mesh, sharding_context(make_resolver(mesh, rules)):
            comp = jax.jit(fn, donate_argnums=donate, out_shardings=out_sh).lower(*args).compile()
        ca = comp.cost_analysis()
        out[f"{arch}/{shape.mode}"] = ca["flops"]
        out[f"{arch}/{shape.mode}/bytes"] = ca["bytes accessed"]
    with open(OUT, "w") as f:
        json.dump(out, f)
"""


@pytest.fixture(scope="module")
def counted(tmp_path_factory):
    """The port's counts on a fake 8-rank group and JAX's cost analysis on 8
    devices, in two subprocesses started together."""
    d = tmp_path_factory.mktemp("dryrun")
    port = python_sub(f"OUT = {str(d / 'port.json')!r}\nPEAK_CELLS = {PEAK_CELLS!r}\n"
                      + textwrap.dedent(PORT),
                      str(d / "port.log"))
    ref = python_sub(f"OUT = {str(d / 'jax.json')!r}\n" + textwrap.dedent(JAX),
                     str(d / "jax.log"), devices=8)
    try:
        finish(port)
        finish(ref)
    finally:
        stop(port, ref)
    with open(d / "port.json") as f, open(d / "jax.json") as g:
        return json.load(f), json.load(g)


def _env():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


def test_list_prints_the_jax_list():
    def listed(module):
        return subprocess.run([sys.executable, "-m", module, "--list"], env=_env(), text=True,
                              capture_output=True, timeout=300, check=True).stdout
    got, want = listed("repro_torch.launch.dryrun"), listed("repro.launch.dryrun")
    assert got.splitlines() == want.splitlines() and len(got.splitlines()) == 40


@pytest.mark.parametrize("arch", assigned_archs())
def test_cache_specs_give_the_jax_shapes_dtypes_and_axes(arch):
    """At full size (the port's model on fake tensors: no storage)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import LM
    with FakeTensorMode():
        specs, axes = LM(get_config(arch), device="cpu").cache_specs(8, 4096)
    jspecs, jaxes = JLM(jget(arch)).cache_specs(8, 4096)
    assert axes == jaxes
    assert len(specs["slots"]) == len(jspecs["slots"]) > 0
    for got, want in zip(specs["slots"], jspecs["slots"]):
        assert set(got) == set(want)
        for n, (shape, dtype) in got.items():
            assert tuple(shape) == tuple(want[n].shape), n
            assert str(dtype).removeprefix("torch.") == str(want[n].dtype), n


def test_the_count_is_linear_in_depth(counted):
    """f(4) against f(1) + 3 (f(2) - f(1)): under 5%, as the JAX test holds
    its probes (eager PyTorch gives 0 up to rounding)."""
    f = counted[0]["linear"]
    f1, f2, f4 = f["1"], f["2"], f["4"]
    assert f1 < f2 < f4
    assert abs(f1 + 3 * (f2 - f1) - f4) / f4 < 0.05


@pytest.mark.parametrize("cell", list(BANDS))
def test_per_device_flops_against_jax_cost_analysis(counted, cell):
    port, ref = counted
    ratio = port["flops"][cell] / ref[cell]
    print(f"[flops] {cell}: port {port['flops'][cell]:.0f} / JAX {ref[cell]:.0f} = {ratio:.4f}")
    lo, hi = BANDS[cell]
    assert lo <= ratio <= hi, (port["flops"][cell], ref[cell], ratio)


@pytest.mark.parametrize("cell", list(BANDS))
def test_per_device_bytes_against_jax_cost_analysis_are_read(counted, cell):
    """The port's per-device bytes over JAX's ``cost_analysis()["bytes
    accessed"]`` for the same cells: a reading with no band (XLA fuses, the
    port counts its unfused ops), printed for ``-s``."""
    port, ref = counted
    ratio = port["bytes"][cell] / ref[f"{cell}/bytes"]
    print(f"[bytes] {cell}: port {port['bytes'][cell]:.0f} / JAX "
          f"{ref[f'{cell}/bytes']:.0f} = {ratio:.3f}")
    assert ratio > 0


@pytest.mark.parametrize("cell", [f"{a}/{s}" for a, s, _ in PEAK_CELLS])
def test_the_peak_probes_extrapolate_to_the_full_depth(counted, cell):
    """``dryrun.probe_peak``'s two shallow probes (one and two periods of
    the layer pattern) extrapolated linearly give, at the counted run's own
    block, the full-depth run's peak within 1%: reduced qwen3_32b prefill
    at 6 layers, gemma3_12b prefill at 18 (3 periods of 6), deepseek train
    at 4, on the fake 8-rank mesh. The dry run takes a prefill_32k peak
    that way at the JAX model's 512 rows."""
    full, probed = counted[0]["peaks"][cell]
    assert full > 0 and abs(probed - full) / full < 0.01, (full, probed)


def test_a_placed_shard_holds_only_its_own_storage(counted):
    """``sharding.place`` of a ``(1, 4, 8, 6)`` tensor with dim 1 over
    ``data`` and dim 2 over ``model``: the rank's ``(1, 1, 4, 6)`` shard is
    a contiguous slice, and it holds a storage of its own size, not a view
    of the whole tensor. As a view, each of jamba15_large's one-period
    probes held every stacked expert weight whole (6 GiB each), and the
    two probes extrapolated its prefill_32k peak to -299.92 GiB."""
    shape, nbytes, own = counted[0]["place"]
    assert shape == [1, 1, 4, 6] and nbytes == own, (shape, nbytes, own)


def test_falcons_prefill_never_makes_d_inner_whole(counted):
    """Reduced falcon_mamba_7b's prefill on the fake ``(4, 2)`` mesh: no
    rank makes a tensor of its tokens with d_inner whole. The ``x_proj``
    product, a partial sum over d_inner's split, is reduced before ``dt @
    dt_proj`` (as XLA reduces it); left partial, DTensor made ``dt`` with
    the whole d_inner on every rank (at full size ``(65536, 8192)`` bf16,
    1 GiB of falcon's prefill_32k peak, and a gather of the whole batch to
    split it again)."""
    assert counted[0]["whole_d_inner"] == []


def test_prefill_caches_leave_each_period_sharded(counted):
    """Reduced qwen3_32b's prefill (3 layers, 8 x 32 tokens, one kv head)
    on the fake ``(4, 2)`` mesh under the prefill rules: each period's k/v
    cache is constrained to the cache's axes as it leaves the period (its
    rows over ``data``, its slots over ``model``: the kv head does not
    split), as the JAX scan writes its out-sharded cache, so the stacked
    cache that ``LM.prefill`` gives holds a rank's share of every layer,
    not each layer whole (deepseek_coder_33b's prefill_32k held 256 MiB a
    layer and a second copy in the stack: 32.12 GiB a rank)."""
    shape, local, placements = counted[0]["prefill_cache"]
    assert shape == [3, 8, 32, 1, 16] and local == [3, 2, 16, 1, 16], (shape, local)
    assert placements == "(Shard(dim=1), Shard(dim=2))"


def test_build_cell_gives_each_modes_step(counted):
    """Train donates the parameters and the optimizer state, decode the
    cache, prefill nothing; the encoder's prefill gives full-sequence
    logits, a decoder's the last token's (and a cache)."""
    cells = counted[0]["cells"]
    assert cells["qwen3_32b/train_4k"]["donate"] == [0, 1]
    assert "slots.0.wq" in cells["qwen3_32b/train_4k"]["first"]   # the new parameters
    assert cells["qwen3_32b/decode_32k"] == {"donate": [1], "n_args": 3, "first": [8, 128]}
    assert cells["falcon_mamba_7b/long_500k"]["donate"] == [1]
    assert cells["qwen3_32b/prefill_32k"] == {"donate": [], "n_args": 2, "first": [8, 128]}
    assert cells["hubert_xlarge/prefill_32k"] == {"donate": [], "n_args": 2,
                                                  "first": [8, 32, 128]}


def test_a_production_cell_runs_end_to_end(tmp_path):
    """phi3_vision decode_32k on the 256 fake ranks of the production mesh,
    through the CLI: an ``ok`` artifact with the JAX package's keys and a
    report of 256 devices."""
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                        "phi3_vision", "--shape", "decode_32k", "--out", str(tmp_path)],
                       env=_env(), text=True, capture_output=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    with open(tmp_path / "phi3_vision__decode_32k__single.json") as f:
        art = json.load(f)
    assert set(art) == {"arch", "shape", "mesh", "status", "reason", "fits", "lower_s",
                        "compile_s", "probe_s", "report"}
    assert art["status"] == "ok" and art["fits"] is True
    rep = art["report"]
    assert set(rep) == {f.name for f in fields(RooflineReport)}
    assert rep["n_devices"] == 256 and rep["flops_pd"] > 0 and rep["coll_ops"]
    assert 0 < rep["mem"]["peak_gib"] < 80 and rep["mem"]["alias_gib"] > 0
    assert "[dryrun] phi3_vision x decode_32k x single" in p.stdout


def test_sweep_writes_skips_and_resumes(tmp_path, monkeypatch):
    """Each cell runs as a subprocess of the port's dry run; a skip is
    written without one; a cell with an ok or skip artifact is not run
    again."""
    from repro_torch.launch import sweep
    monkeypatch.chdir(tmp_path)
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        arch, shape, mesh = (cmd[cmd.index(k) + 1] for k in ("--arch", "--shape", "--mesh"))
        os.makedirs(sweep.ART, exist_ok=True)
        with open(os.path.join(sweep.ART, f"{arch}__{shape}__{mesh}.json"), "w") as f:
            json.dump({"status": "ok"}, f)
        return subprocess.CompletedProcess(cmd, 0, "[dryrun] done\n", "")
    monkeypatch.setattr(sweep.subprocess, "run", fake_run)
    monkeypatch.setattr(sys, "argv", ["sweep", "--meshes", "single", "--archs", "hubert_xlarge"])
    sweep.main()
    assert [c[2:4] for c in calls] == [["repro_torch.launch.dryrun", "--arch"]] * 2
    assert sorted(os.listdir(sweep.ART)) == sorted(
        f"hubert_xlarge__{s}__single.json" for s in ("train_4k", "prefill_32k", "decode_32k",
                                                     "long_500k"))
    sweep.main()
    assert len(calls) == 2


def test_sweep_records_a_cell_that_outlives_its_timeout(tmp_path, monkeypatch, capsys):
    """A cell killed at ``--timeout`` leaves an error artifact with the
    reason, and the sweep goes on to the next cell."""
    from repro_torch.launch import sweep
    monkeypatch.chdir(tmp_path)

    def slow_run(cmd, **kw):
        raise subprocess.TimeoutExpired(cmd, kw["timeout"])
    monkeypatch.setattr(sweep.subprocess, "run", slow_run)
    monkeypatch.setattr(sys, "argv", ["sweep", "--meshes", "single", "--archs", "qwen3_32b",
                                      "--timeout", "7"])
    sweep.main()
    with open(os.path.join(sweep.ART, "qwen3_32b__train_4k__single.json")) as f:
        art = json.load(f)
    assert art == {"arch": "qwen3_32b", "shape": "train_4k", "mesh": "single",
                   "status": "error", "error": "timed out after 7 s (--timeout)"}
    out = capsys.readouterr().out
    assert out.count("FAIL") == 3 and "fail=3 skip/cached=1" in out
