"""The port's roofline (``repro_torch.telemetry.roofline``), report and compare
against the JAX package's, and its three counters on known programs.

* ``model_flops`` equals the JAX function for every assigned arch and shape;
  ``RooflineReport.derive`` on inputs scaled to each package's constants
  (the H100's here, TPU v5e's there) gives the same bottleneck, useful-FLOPs
  ratio and roofline fraction; ``CollectiveStats.add`` fed what
  ``parse_collectives`` reads from tests/test_roofline.py's HLO gives its
  ops, raw bytes and link bytes.
* The counters: FLOPs by the matmul formulas, one a pointwise output
  element and a reduction input element; the bytes of views, gathers and
  in-place scatters; the memory counter's peak on a known program; and on a
  fake 16-rank ``(4, 4)`` mesh the per-device FLOPs of a sharded matmul
  equal the global FLOPs over the split (``FlopCounterMode`` counts the
  global ones), a redistribution is one all-gather (``wait_tensor`` not
  counted) and DTensor's sharding propagation is not counted.
* ``report.main`` and ``compare.main`` on the same two artifact directories
  print the JAX package's text, but for the HBM figure (80 GiB, not 16).
"""
import json
import math
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import assigned_archs as jassigned  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.telemetry import roofline as JR  # noqa: E402
from repro_torch.configs import SHAPES, assigned_archs, get_config  # noqa: E402
from repro_torch.telemetry import roofline as R  # noqa: E402

HLO = """
ENTRY %main {
  %ag = bf16[16,2048]{1,0} all-gather(bf16[2,2048]{1,0} %p0), replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}
  %ar = f32[1024]{0} all-reduce(f32[1024]{0} %p1), replica_groups=[16,16]<=[256], to_apply=%add
  %rs = f32[128,64]{1,0} reduce-scatter(f32[1024,64]{1,0} %p2), replica_groups={{0,1}}, dimensions={0}
  %cp = bf16[64]{0} collective-permute(bf16[64]{0} %p3), source_target_pairs={{0,1}}
  %a2a = s32[256]{0} all-to-all(s32[256]{0} %p4), replica_groups={{0,1,2,3}}
}
"""


def test_constants_are_the_h100s():
    assert (R.PEAK_FLOPS, R.HBM_BW, R.LINK_BW) == (989e12, 3.35e12, 450e9)


@pytest.mark.parametrize("arch", assigned_archs())
def test_model_flops_equal_jax(arch):
    assert list(assigned_archs()) == list(jassigned())
    for name, shape in SHAPES.items():
        assert R.model_flops(get_config(arch), shape) == JR.model_flops(jget(arch), JSHAPES[name])


def test_derive_matches_jax_on_inputs_scaled_to_each_packages_constants():
    def rep(mod):
        return mod.RooflineReport(
            arch="a", shape="train_4k", mesh="single", n_devices=256,
            flops_pd=mod.PEAK_FLOPS, bytes_pd=mod.HBM_BW * 2,
            coll_link_bytes_pd=mod.LINK_BW * 0.5, coll_ops={}, coll_raw_bytes={},
            mem={"peak_gib": 1.0}, model_flops=mod.PEAK_FLOPS * 256 * 0.5).derive()
    got, want = rep(R), rep(JR)
    assert (got.t_compute, got.t_memory, got.t_collective) == pytest.approx((1.0, 2.0, 0.5))
    assert got.bottleneck == want.bottleneck == "memory"
    assert got.useful_flops_ratio == pytest.approx(want.useful_flops_ratio)
    assert got.roofline_fraction == pytest.approx(want.roofline_fraction)
    assert json.loads(got.to_json()).keys() == json.loads(want.to_json()).keys()


def test_collective_stats_fed_the_hlos_collectives_equal_parse_collectives():
    want = JR.parse_collectives(HLO)
    got = R.CollectiveStats()
    for kind, nbytes, group in (("all-gather", 16 * 2048 * 2, 8), ("all-reduce", 1024 * 4, 16),
                                ("reduce-scatter", 128 * 64 * 4, 2),
                                ("collective-permute", 64 * 2, 2), ("all-to-all", 256 * 4, 4)):
        got.add(kind, nbytes, group)
    assert got.ops == want.ops and got.raw_bytes == want.raw_bytes
    assert got.link_bytes == pytest.approx(want.link_bytes)


def test_costs_count_products_pointwise_reductions_and_moved_bytes():
    x, w = torch.randn(128, 256), torch.randn(256, 512)
    cache, idx = torch.zeros(8, 64, 16), torch.tensor([1, 5, 7])
    with R.count_costs() as c:
        y = torch.tanh(x @ w)
    assert c.flops == 2 * 128 * 256 * 512 + 128 * 512
    assert c.bytes == 4 * (128 * 256 + 256 * 512 + 128 * 512) + 2 * 4 * 128 * 512
    with R.count_costs() as c:
        y.sum()
    assert c.flops == 128 * 512 and c.bytes == 4 * (128 * 512 + 1)
    with R.count_costs() as c:
        y.t().reshape(-1)[:10]                           # views move nothing... the reshape copies
    assert c.flops == 0 and c.bytes == 2 * 4 * 128 * 512
    with R.count_costs() as c:
        rows = cache[idx]                                # a gather: what it gathers
        cache[idx] = rows + 1                            # an in-place scatter: what it writes
    n = 3 * 64 * 16
    assert c.bytes == (2 * 4 * n + 8 * 3) + (4 * n + 4 * n) + (2 * 4 * n + 8 * 3)
    assert c.flops == n


def test_memory_counter_follows_live_storages_to_their_peak():
    x, w = torch.randn(100, 100), torch.randn(100, 50)

    def f(x, w):
        y = x @ w                 # 20000 bytes
        z = torch.tanh(y)         # 20000
        del y
        return z.sum()            # 4
    out, cost, mem = R.run_counted(f, (x, w))
    g = 2 ** 30
    assert mem["argument_gib"] * g == 60000 and mem["peak_gib"] * g == 100000
    assert mem["output_gib"] * g == 4 and mem["alias_gib"] == 0
    assert mem["temp_gib"] * g == 100000 - 60000 - 4
    assert cost["flops"] == 2 * 100 * 100 * 50 + 5000 + 5000 and cost["ops"] == {}
    # an argument written in place and returned is donated: counted once
    _, _, mem = R.run_counted(lambda c: c.add_(1.0), (torch.zeros(256),), donated=(0,))
    assert mem["peak_gib"] * g == 1024 and mem["alias_gib"] * g == 1024
    assert mem["temp_gib"] == 0


def test_analyze_reports_a_small_program_end_to_end():
    def f(x, w):
        return torch.tanh(x @ w).sum()
    rep = R.analyze(f, (torch.randn(128, 256), torch.randn(256, 512)), arch="tiny_lm",
                    shape=SHAPES["decode_32k"], mesh_name="single", n_devices=1,
                    cfg=get_config("tiny_lm"))
    assert rep.flops_pd >= 2 * 128 * 256 * 512
    assert rep.t_compute > 0 and rep.bottleneck in ("compute", "memory", "collective")
    assert set(rep.mem) == {"argument_gib", "output_gib", "temp_gib", "alias_gib", "peak_gib"}


@pytest.fixture
def fake_mesh():
    """A (4, 4) ("data", "model") mesh of a fake 16-rank process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
    try:
        yield init_device_mesh("cpu", (4, 4), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_counters_see_each_ranks_local_ops(fake_mesh):
    """On DTensors the FLOPs are one device's: the global FLOPs of a matmul
    split 4 ways by rows and 4 by columns, over 16, where FlopCounterMode
    sees the DTensor-level op and counts the global FLOPs. Gathering the
    product is two all-gathers (one a mesh dim) and no wait_tensor; the ops
    DTensor runs on global shapes to propagate shardings are not counted,
    so a first call (nothing cached) counts what a second one does."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode
    m, k, n = 64, 48, 80
    with FakeTensorMode():
        a = DTensor.from_local(torch.empty(m // 4, k), fake_mesh, [Shard(0), Replicate()],
                               run_check=False, shape=(m, k), stride=(k, 1))
        w = DTensor.from_local(torch.empty(k, n // 4), fake_mesh, [Replicate(), Shard(1)],
                               run_check=False, shape=(k, n), stride=(n, 1))
        counts = []
        for _ in range(2):
            with R.count_costs() as c, R.count_collectives() as coll:
                (a @ w).redistribute(fake_mesh, [Replicate(), Replicate()])
            counts.append((c.flops, c.bytes, coll.stats.ops, coll.stats.raw_bytes,
                           coll.stats.link_bytes))
        with FlopCounterMode(display=False) as fc:
            a @ w
    assert counts[0] == counts[1]
    flops, _, ops, raw, link = counts[0]
    assert flops == 2 * m * k * n / 16
    assert fc.get_total_flops() == 2 * m * k * n
    assert ops == {"all-gather": 2}
    first, second = m * (n // 4) * 4, m * n * 4          # rows gathered, then columns
    assert raw == {"all-gather": first + second}
    assert link == pytest.approx((first + second) * 3 / 4)


def test_memory_counter_sees_local_shards_and_an_all_reduce(fake_mesh):
    """A Partial reduced over ``model`` is one all-reduce of the local
    bytes, ring factor 2 (n-1)/n; the memory counted is the local shards'."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Partial, Shard
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(8, 32), fake_mesh, [Shard(0), Partial()],
                               run_check=False, shape=(32, 32), stride=(32, 1))
        out, cost, mem = R.run_counted(lambda x: x.redistribute(fake_mesh, [Shard(0), Shard(1)])
                                       * 2, (x,))
    assert cost["ops"] == {"reduce-scatter": 1}
    assert cost["raw_bytes"] == {"reduce-scatter": 8 * 8 * 4}
    assert mem["argument_gib"] * 2 ** 30 == 8 * 32 * 4
    assert out.to_local().shape == (8, 8)
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(8, 32), fake_mesh, [Shard(0), Partial()],
                               run_check=False, shape=(32, 32), stride=(32, 1))
        with R.count_collectives() as coll:
            x.full_tensor()
    assert coll.stats.ops == {"all-reduce": 1, "all-gather": 1}
    assert coll.stats.raw_bytes["all-reduce"] == 8 * 32 * 4


def _artifacts(tmp_path, name, scale):
    """A directory of dry-run artifacts: ok cells on both meshes, a skip, an
    error; the rest of the table missing."""
    d = tmp_path / name
    d.mkdir()
    cells = [("qwen3_32b", "train_4k", "single"), ("qwen3_32b", "decode_32k", "single"),
             ("gemma3_12b", "prefill_32k", "single"), ("qwen3_32b", "train_4k", "multi"),
             ("falcon_mamba_7b", "long_500k", "single")]
    for i, (arch, shape, mesh) in enumerate(cells):
        rep = {"t_compute": 0.5 * (i + 1) * scale, "t_memory": 0.25 * (i + 2),
               "t_collective": 0.125 * (i + 1) * scale ** 2, "bottleneck": "compute",
               "useful_flops_ratio": 0.3 + 0.1 * i, "roofline_fraction": 0.01 * (i + 1) * scale,
               "coll_ops": {"all-gather": 3 + i, "all-reduce": 1},
               "mem": {"peak_gib": 10.0 * (i + 1) * scale}}
        d_ = {"arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
              "fits": i % 2 == 0, "compile_s": 12.3 * (i + 1), "report": rep}
        (d / f"{arch}__{shape}__{mesh}.json").write_text(json.dumps(d_))
    (d / "hubert_xlarge__decode_32k__single.json").write_text(json.dumps(
        {"arch": "hubert_xlarge", "shape": "decode_32k", "mesh": "single", "status": "skip",
         "reason": "encoder-only: no decode step"}))
    (d / "grok1_314b__train_4k__single.json").write_text(json.dumps(
        {"arch": "grok1_314b", "shape": "train_4k", "mesh": "single", "status": "error",
         "error": "boom"}))
    return d


def _printed(main, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", argv)
    main()
    return capsys.readouterr().out


def test_report_and_compare_print_the_jax_packages_text(tmp_path, monkeypatch, capsys):
    from repro.telemetry import compare as jcompare
    from repro.telemetry import report as jreport
    from repro_torch.telemetry import compare, report
    base, new = _artifacts(tmp_path, "base", 1.0), _artifacts(tmp_path, "new", 1.5)
    want = _printed(jreport.main, ["report", str(base)], monkeypatch, capsys)
    got = _printed(report.main, ["report", str(base)], monkeypatch, capsys)
    assert "fit 16GiB" in want and "fit 80GiB" in got
    assert got == want.replace("fit 16GiB", "fit 80GiB")
    assert "| qwen3_32b | train_4k | ok | 10.00 | ✓ | 12 |" in got and "MISSING" in got
    want = _printed(jcompare.main, ["compare", str(base), str(new)], monkeypatch, capsys)
    got = _printed(compare.main, ["compare", str(base), str(new)], monkeypatch, capsys)
    assert got == want and got.count("roofline frac") == 5


def test_the_report_reads_the_ports_own_artifact_directory():
    from repro_torch.launch import dryrun
    assert dryrun.ART == "artifacts/dryrun_torch" and dryrun.HBM_PER_CHIP_GIB == 80.0
    assert math.isclose(R.HBM_BW, 3.35e12) and np.isfinite(R.LINK_BW)
