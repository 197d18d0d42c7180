"""The PyTorch port stands alone: no JAX, nothing of the JAX package, no Triton,
and no silent CPU path."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|repro|triton)(?:\.|\s|$)", re.M)


def _modules():
    names = set()
    for p in PKG.rglob("*.py"):
        parts = ("repro_torch", *p.relative_to(PKG).with_suffix("").parts)
        names.add(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return sorted(names)


def test_import_leaves_jax_repro_and_triton_out():
    assert "repro_torch.serving.engine" in _modules()
    code = ("import importlib, json, sys\n"
            f"for m in {_modules()!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'triton'))\n"
            "print(json.dumps(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", [*sorted(PKG.rglob("*.py")), ROOT / "chip_smoke.py"],
                         ids=lambda p: str(Path(p).relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    assert not _IMPORT.findall(Path(path).read_text())


def test_port_never_calls_a_library_attention():
    for path in PKG.rglob("*.py"):
        text = path.read_text()
        assert "scaled_dot_product_attention" not in text, path
        assert "torch.compile" not in text, path


def test_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.core.config_store import ConfigStore, ImageRegistry
    from repro_torch.core.router import build_tree
    from repro_torch.models import LM
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import Engine, Worker

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(build_tree(2, fanout=2), ConfigStore(), ImageRegistry())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Worker("w0", ConfigStore(), ImageRegistry())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM(get_config("tiny_lm"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LM(get_config("tiny_lm"), device="cuda")


def test_serve_cli_raises_without_a_card(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--requests", "1"])


def test_kernel_wrappers_refuse_non_cuda_tensors():
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    q = torch.zeros(1, 16, 2, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA kernel"):
        fa.flash_attention(q, q[:, :, :1], q[:, :, :1])
    with pytest.raises(ValueError, match="CUDA kernel"):
        ops.flash_attention(q, q[:, :, :1], q[:, :, :1])
    qd = torch.zeros(1, 2, 16)
    kc = torch.zeros(1, 8, 1, 16)
    with pytest.raises(ValueError, match="CUDA kernel"):
        dec.decode_attention(qd, kc, kc, torch.zeros(1, dtype=torch.int32))
    assert fa.flash_attention.launches == 0 and dec.decode_attention.launches == 0


def test_kernels_build_for_sm90a_from_package_sources():
    from repro_torch.kernels import build

    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").exists()
        path = build.library_path(name)
        assert path.parent == build.BUILD_DIR and path == build.library_path(name)
    ignored = (ROOT / ".gitignore").read_text()
    assert "src/repro_torch/_build/" in ignored


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Run without a card, and run alone outside a checkout: non-zero, no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(alone)], env=env, capture_output=True,
                         text=True, timeout=120, cwd=tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_mamba_scan_wrapper_refuses_non_cuda_tensors():
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ops

    x = torch.zeros(1, 4, 8, device="meta")
    Bc = torch.zeros(1, 4, 16, device="meta")
    A, D = torch.zeros(8, 16, device="meta"), torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="CUDA kernel"):
        ms.mamba_scan(x, x, Bc, Bc, A, D)
    with pytest.raises(ValueError, match="CUDA kernel"):
        ops.mamba_scan(x, x, Bc, Bc, A, D)
    xc, Bcc = torch.zeros(1, 4, 8), torch.zeros(1, 4, 16)
    with pytest.raises(ValueError, match="CUDA kernel"):
        ms.mamba_scan(xc, xc, Bcc, Bcc, torch.zeros(8, 16), torch.zeros(8))
    assert ms.mamba_scan.launches == 0


def test_serve_cli_takes_falcon_mamba_on_the_cpu(monkeypatch, capsys):
    """``--fn-arch falcon_mamba_7b`` needs no other flag; the registered
    config is cut here to keep the CPU run short."""
    from dataclasses import replace

    from repro_torch.configs import base
    from repro_torch.launch import serve

    cfg = base.get_config("falcon_mamba_7b")
    assert (cfg.num_layers, cfg.d_model, cfg.mamba.d_inner, cfg.vocab_size) == (
        64, 4096, 8192, 65024)
    monkeypatch.setitem(base._REGISTRY, "falcon_mamba_7b",
                        replace(base.reduced(cfg), name="falcon_mamba_7b"))
    serve.main(["--fn-arch", "falcon_mamba_7b", "--requests", "3", "--gen-tokens", "2",
                "--device", "cpu"])
    assert "ok=3/3" in capsys.readouterr().out


def test_grouped_matmul_wrapper_refuses_non_cuda_tensors():
    from repro_torch.kernels import moe_gmm, ops

    x, w = torch.zeros(16, 64), torch.zeros(2, 64, 64)
    bmap = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA kernel"):
        moe_gmm.grouped_matmul(x, w, bmap, 8)
    with pytest.raises(ValueError, match="CUDA kernel"):
        ops.grouped_matmul(x.to("meta"), w.to("meta"), bmap.to("meta"), 8)
    with pytest.raises(ValueError, match="CUDA kernel"):
        ops.moe_expert_ffn(x.to("meta"), w.to("meta"), w.to("meta"), w.to("meta"),
                           bmap.to("meta"), 8)
    assert moe_gmm.grouped_matmul.launches == 0


def test_serve_cli_takes_moonshot_on_the_cpu(monkeypatch, capsys):
    """``--fn-arch moonshot_v1_16b`` needs no other flag; the registered
    config is cut here to keep the CPU run short."""
    from dataclasses import replace

    from repro_torch.configs import base
    from repro_torch.launch import serve

    cfg = base.get_config("moonshot_v1_16b")
    assert (cfg.num_layers, cfg.d_model, cfg.moe.num_experts, cfg.moe.top_k,
            cfg.moe.expert_ff, cfg.vocab_size) == (48, 2048, 64, 6, 1408, 163840)
    monkeypatch.setitem(base._REGISTRY, "moonshot_v1_16b",
                        replace(base.reduced(cfg), name="moonshot_v1_16b"))
    serve.main(["--fn-arch", "moonshot_v1_16b", "--requests", "3", "--gen-tokens", "2",
                "--device", "cpu"])
    assert "ok=3/3" in capsys.readouterr().out
