"""The port's CUDA kernels and engine on the card (marker ``cuda``).

They skip without a card; on the H100 run them with
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``. Whether a
card is there is decided inside the ``card`` fixture, never at import.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}   # tests/test_kernels.py


@pytest.fixture
def card():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs a CUDA card of compute capability 9.0 (the kernels are sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", [
    (1, 32, 8, 4, 32, True, 0),
    (1, 100, 8, 8, 64, True, 0),       # ragged: S not a multiple of the tiles
    (2, 96, 4, 2, 16, True, 40),
    (1, 64, 4, 4, 128, False, 0),
])
def test_flash_kernel_matches_plain(card, B, S, H, KV, hd, causal, window, dtype):
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=card).manual_seed(S)
    q = _randn(gen, (B, S, H, hd), dtype, card)
    kv = _randn(gen, (B, S, 2 * KV, hd), dtype, card)
    k, v = kv[:, :, :KV], kv[:, :, KV:]            # strided views, no copy
    n = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n + 1
    ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,W,H,KV,hd,ring", [
    (4, 64, 8, 4, 32, False),
    (2, 256, 8, 8, 64, False),
    (3, 128, 4, 4, 32, True),
    (1, 512, 16, 2, 128, False),
])
def test_decode_kernel_matches_plain(card, B, W, H, KV, hd, ring, dtype):
    from repro_torch.kernels import decode_attention as dec
    gen = torch.Generator(device=card).manual_seed(W)
    q = _randn(gen, (B, H, hd), dtype, card)
    cache = _randn(gen, (2, B, W, KV, hd), dtype, card)   # a stacked cache
    pos = np.random.default_rng(W).integers(0, 2 * W if ring else W + 8, B)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=card)
    out = dec.decode_attention(q, cache[0], cache[1], pos, ring=ring)
    ref = dec.decode_attention_plain(q, cache[0], cache[1], pos, ring=ring)
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    q = torch.zeros(1, 16, 4, 48, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q[:, :, :2], q[:, :, :2])
    q = torch.zeros(1, 16, 4, 32, device=card, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q[:, :, :2], q[:, :, :2])
    q = torch.zeros(1, 16, 4, 64, device=card)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, q[:, :, :2], q[:, :, :2])
    qd = torch.zeros(2, 4, 32, device=card)
    kc = torch.zeros(2, 8, 2, 32, device=card)
    with pytest.raises(ValueError, match="positions"):
        dec.decode_attention(qd, kc, kc, torch.zeros(3, dtype=torch.int32, device=card))


def test_engine_on_the_card_goes_through_both_kernels(card):
    from repro_torch.core.config_store import ConfigStore, ImageRegistry
    from repro_torch.core.router import build_tree
    from repro_torch.core.types import FunctionConfig, Request
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serving.engine import Engine

    store = ConfigStore()
    store.put(FunctionConfig(name="gen", arch="tiny_lm", concurrency=4, gen_tokens=4))
    engine = Engine(build_tree(2, fanout=2), store, ImageRegistry(), max_len=64)
    assert engine.device.type == "cuda"
    fa.flash_attention.launches = dec.decode_attention.launches = 0
    for size in (4, 9, 17, 23, 30):
        engine.submit(Request(fn="gen", arrival_t=0.0, size=size))
    res = engine.run()
    assert len(res) == 5 and all(r.ok for r in res)
    assert fa.flash_attention.launches > 0 and dec.decode_attention.launches > 0


SCAN_TOL = {torch.float32: 2e-3, torch.bfloat16: 5e-2}   # tests/test_kernels.py:78-79


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bt,S,DI,N,with_h0", [
    (1, 32, 8192, 16, True),           # the falcon_mamba_7b prefill
    (2, 128, 64, 8, False),            # the JAX sweep
    (2, 77, 100, 4, True),             # ragged: S past a chunk, DI not a block multiple
    (3, 5, 48, 32, True),
])
def test_mamba_scan_kernel_matches_plain(card, Bt, S, DI, N, with_h0, dtype):
    from repro_torch.kernels import mamba_scan as ms
    gen = torch.Generator(device=card).manual_seed(S + DI)
    dt = (torch.nn.functional.softplus(torch.randn(Bt, S, DI, generator=gen, device=card))
          * 0.1).to(dtype)
    x = _randn(gen, (Bt, S, DI), dtype, card)
    proj = _randn(gen, (Bt, S, 8 + 2 * N), dtype, card)
    Bc, Cc = proj[..., 8:8 + N], proj[..., 8 + N:]           # strided views, no copy
    A = -torch.exp(0.2 * torch.randn(DI, N, generator=gen, device=card))
    D = torch.randn(DI, generator=gen, device=card)
    h0 = torch.randn(Bt, DI, N, generator=gen, device=card) if with_h0 else None
    n = ms.mamba_scan.launches
    y, h = ms.mamba_scan(dt, x, Bc, Cc, A, D, h0)
    torch.cuda.synchronize()
    assert ms.mamba_scan.launches == n + 1
    assert y.dtype == dtype and h.dtype == torch.float32
    ry, rh = ms.mamba_scan_plain(dt, x, Bc, Cc, A, D, h0)
    tol = SCAN_TOL[dtype]
    torch.testing.assert_close(y.float(), ry.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(h, rh, rtol=tol, atol=tol)


def test_mamba_scan_wrapper_rejects_what_the_kernel_does_not_take(card):
    from repro_torch.kernels import mamba_scan as ms
    x = torch.zeros(1, 8, 32, device=card)
    Bc = torch.zeros(1, 8, 16, device=card)
    A = torch.zeros(32, 16, device=card)
    D = torch.zeros(32, device=card)
    with pytest.raises(ValueError, match="d_state"):
        ms.mamba_scan(x, x, Bc[..., :6], Bc[..., :6], A[:, :6].contiguous(), D)
    with pytest.raises(TypeError):
        ms.mamba_scan(x.half(), x.half(), Bc.half(), Bc.half(), A, D)
    with pytest.raises(TypeError, match="float32 A"):
        ms.mamba_scan(x, x, Bc, Bc, A.bfloat16(), D)
    with pytest.raises(ValueError, match="h0"):
        ms.mamba_scan(x, x, Bc, Bc, A, D, torch.zeros(2, 32, 16, device=card))
    with pytest.raises(ValueError, match="contiguous"):
        ms.mamba_scan(x, x, Bc, Bc, torch.zeros(16, 32, device=card).T, D)


def test_engine_on_the_card_serves_falcon_mamba_through_b3(card, monkeypatch):
    """falcon_mamba_7b at full width, depth cut to 2 layers under its own name."""
    from dataclasses import replace

    from repro_torch.configs import base as port_configs
    from repro_torch.core.config_store import ConfigStore, ImageRegistry
    from repro_torch.core.router import build_tree
    from repro_torch.core.types import FunctionConfig, Request
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.serving.engine import Engine

    cfg = replace(port_configs.get_config("falcon_mamba_7b"), name="falcon_mamba_7b_l2",
                  num_layers=2)
    monkeypatch.setitem(port_configs._REGISTRY, cfg.name, cfg)
    store = ConfigStore()
    store.put(FunctionConfig(name="ssm", arch=cfg.name, concurrency=2, gen_tokens=4))
    engine = Engine(build_tree(2, fanout=2), store, ImageRegistry(), max_len=64)
    ms.mamba_scan.launches = 0
    for size in (4, 9, 17, 23):
        engine.submit(Request(fn="ssm", arrival_t=0.0, size=size))
    res = engine.run()
    assert len(res) == 4 and all(r.ok for r in res)
    assert ms.mamba_scan.launches >= 2 * 4      # a launch per layer per prefill
    insts = [i for w in engine.workers.values() for i in w.instances.get("ssm", [])]
    assert all(len(t) == 5 for i in insts for t in i.generated.values())


def _routed_layout(card, gen, B, S, E=64, k=6, cf=1.25):
    """moonshot_v1_16b's dispatch (64 experts, top-6) from a random routing."""
    from repro_torch.models import moe as tmoe
    gate, eidx = torch.softmax(torch.randn(B, S, E, generator=gen, device=card), -1).topk(k)
    C = tmoe.capacity(S, k, E, cf)
    return tmoe.build_layout(eidx, gate / gate.sum(-1, keepdim=True), C,
                             tmoe.block_rows(B, C), E)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,D,F", [
    (2, 1, 2048, 1408),                # decode with 2 slots: wg/wi, then wo
    (2, 1, 1408, 2048),
    (1, 32, 2048, 1408),               # the S32 prefill bucket
    (1, 16, 1408, 2048),
])
def test_grouped_matmul_kernel_matches_plain_on_routed_layouts(card, B, S, D, F, dtype):
    from repro_torch.kernels import moe_gmm
    gen = torch.Generator(device=card).manual_seed(S + D)
    lay = _routed_layout(card, gen, B, S)
    x = torch.cat([_randn(gen, (B * S, D), dtype, card),
                   torch.zeros(1, D, dtype=dtype, device=card)])[lay.row_token]
    w = (torch.randn(2, 64, D, F, generator=gen, device=card) / D ** 0.5).to(dtype)
    n = moe_gmm.grouped_matmul.launches
    out = moe_gmm.grouped_matmul(x, w[1], lay.block_to_expert, lay.block_t)   # a period slice
    torch.cuda.synchronize()
    assert moe_gmm.grouped_matmul.launches == n + 1
    ref = moe_gmm.grouped_matmul_plain(x, w[1], lay.block_to_expert, lay.block_t)
    assert out.dtype == dtype and out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])
    pad = lay.row_token == B * S
    assert out[pad].abs().max() == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,D,F,E,bt", [
    (512, 128, 256, 4, 64),            # the JAX sweep (tests/test_kernels.py:86-89)
    (256, 64, 128, 8, 32),
    (256, 128, 128, 4, 128),
    (96, 64, 192, 3, 16),
    (64, 64, 64, 2, 8),
])
def test_grouped_matmul_kernel_matches_plain_on_sweeps(card, T, D, F, E, bt, dtype):
    from repro_torch.kernels import moe_gmm
    gen = torch.Generator(device=card).manual_seed(T + bt)
    x = _randn(gen, (T, 2 * D), dtype, card)[:, D:]          # rows through a stride
    w = _randn(gen, (E, D, F), dtype, card)
    bmap = torch.randint(0, E, (T // bt,), generator=gen, device=card, dtype=torch.int32)
    out = moe_gmm.grouped_matmul(x, w, bmap, bt)
    ref = moe_gmm.grouped_matmul_plain(x, w, bmap, bt)
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])


def test_grouped_matmul_wrapper_rejects_what_the_kernel_does_not_take(card):
    from repro_torch.kernels import moe_gmm
    x = torch.zeros(32, 64, device=card)
    w = torch.zeros(2, 64, 128, device=card)
    bmap = torch.zeros(4, dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        moe_gmm.grouped_matmul(x.half(), w.half(), bmap, 8)
    with pytest.raises(TypeError, match="int32"):
        moe_gmm.grouped_matmul(x, w, bmap.long(), 8)
    with pytest.raises(ValueError, match="block_t"):
        moe_gmm.grouped_matmul(x, w, bmap, 24)
    with pytest.raises(ValueError, match="multiple of block_t"):
        moe_gmm.grouped_matmul(x[:28], w, bmap, 8)
    with pytest.raises(ValueError, match="block_to_expert"):
        moe_gmm.grouped_matmul(x, w, bmap[:3], 8)
    with pytest.raises(ValueError, match="multiples of 64"):
        moe_gmm.grouped_matmul(x[:, :48], w[:, :48], bmap, 8)
    with pytest.raises(ValueError, match="contiguous"):
        moe_gmm.grouped_matmul(x, torch.zeros(2, 128, 64, device=card).transpose(1, 2), bmap, 8)
    with pytest.raises(ValueError, match="aligned"):
        moe_gmm.grouped_matmul(torch.zeros(32, 66, device=card)[:, 2:], w, bmap, 8)


def test_engine_on_the_card_serves_moonshot_through_b4(card, monkeypatch):
    """moonshot_v1_16b at full width, depth cut to 2 layers under its own name:
    B4 three times per layer per model call, B1 in prefill, B2 in decode."""
    from dataclasses import replace

    from repro_torch.configs import base as port_configs
    from repro_torch.core.config_store import ConfigStore, ImageRegistry
    from repro_torch.core.router import build_tree
    from repro_torch.core.types import FunctionConfig, Request
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import moe_gmm
    from repro_torch.models import LM
    from repro_torch.serving.engine import Engine

    cfg = replace(port_configs.get_config("moonshot_v1_16b"), name="moonshot_v1_16b_l2",
                  num_layers=2)
    monkeypatch.setitem(port_configs._REGISTRY, cfg.name, cfg)
    calls = {"prefill": 0, "decode_step": 0}
    for name in calls:
        def counted(self, *a, _f=getattr(LM, name), _n=name):
            calls[_n] += 1
            return _f(self, *a)
        monkeypatch.setattr(LM, name, counted)
    store = ConfigStore()
    store.put(FunctionConfig(name="moe", arch=cfg.name, concurrency=2, gen_tokens=4))
    engine = Engine(build_tree(2, fanout=2), store, ImageRegistry(), max_len=64)
    moe_gmm.grouped_matmul.launches = fa.flash_attention.launches = 0
    dec.decode_attention.launches = ms.mamba_scan.launches = 0
    for size in (4, 9, 17, 23):
        engine.submit(Request(fn="moe", arrival_t=0.0, size=size))
    res = engine.run()
    assert len(res) == 4 and all(r.ok for r in res)
    assert moe_gmm.grouped_matmul.launches == 3 * 2 * (calls["prefill"] + calls["decode_step"])
    assert fa.flash_attention.launches > 0 and dec.decode_attention.launches > 0
    assert ms.mamba_scan.launches == 0
    insts = [i for w in engine.workers.values() for i in w.instances.get("moe", [])]
    assert all(len(t) == 5 for i in insts for t in i.generated.values())
