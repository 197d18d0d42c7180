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
  (unrolled, ``attn_block`` 16). Both count the matmuls by their products
  and one FLOP an element of elementwise work (XLA leaves transcendentals
  out, the port counts every pointwise op), and the port counts the plain
  path it runs, DTensor's local ops included. The measured bands, port
  over JAX: train 1.24-1.26 and decode 1.53-1.55. Both are over 10%:
  ROADMAP.md queue C (C5) holds them as a finding, with what was found of
  their cause.
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

# port FLOPs over JAX's, as measured (see the module's docstring)
BANDS = {"deepseek_coder_33b/train": (1.24, 1.26), "qwen3_32b/decode": (1.53, 1.55)}

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
    out = {"linear": {}, "flops": {}, "cells": {}}

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
        out[f"{arch}/{shape.mode}"] = comp.cost_analysis()["flops"]
    with open(OUT, "w") as f:
        json.dump(out, f)
"""


@pytest.fixture(scope="module")
def counted(tmp_path_factory):
    """The port's counts on a fake 8-rank group and JAX's cost analysis on 8
    devices, in two subprocesses started together."""
    d = tmp_path_factory.mktemp("dryrun")
    port = python_sub(f"OUT = {str(d / 'port.json')!r}\n" + textwrap.dedent(PORT),
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
    lo, hi = BANDS[cell]
    assert lo <= ratio <= hi, (port["flops"][cell], ref[cell], ratio)


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
