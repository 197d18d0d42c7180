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


def _routed_layout(card, gen, B, S, E=64, k=6, cf=1.25, block_t=None, hot=0):
    """moonshot_v1_16b's dispatch (64 experts, top-6) from a random routing,
    at the layout's own block_t unless one is given. ``hot`` > 0: that many
    experts take nearly every token's top k, so that capacity drops most
    assignments (as moonshot's router did at its training start)."""
    from repro_torch.models import moe as tmoe
    logits = torch.randn(B, S, E, generator=gen, device=card)
    if hot:
        logits[..., :hot] += 8.0
    gate, eidx = torch.softmax(logits, -1).topk(k)
    C = tmoe.capacity(S, k, E, cf)
    return tmoe.build_layout(eidx, gate / gate.sum(-1, keepdim=True), C,
                             block_t or tmoe.block_rows(B, C), E)


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("S", [1, 15, 17, 33, 256])
def test_flash_routes_match_plain_at_ragged_lengths(card, S, hd, dtype):
    """Each route (bf16: tensor cores, f32: FMA) against the plain version at
    S off the 16-row tiles: causal, windowed (whole kv tiles masked for some
    rows of a q tile) and bidirectional, with GQA groups of 1, 2 and 4."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=card).manual_seed(S * hd)
    for causal, window, G in ((True, 0, 1), (True, 7, 2), (False, 0, 4), (True, 0, 4),
                              (False, 5, 2)):
        q = _randn(gen, (2, S, 2 * G, hd), dtype, card)
        k = _randn(gen, (2, S, 2, hd), dtype, card)
        v = _randn(gen, (2, S, 2, hd), dtype, card)
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype],
                                   msg=lambda m: f"causal={causal} window={window} G={G}: {m}")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D,F", [(2048, 1408), (1408, 2048)])    # moonshot's wg/wi, wo
@pytest.mark.parametrize("bt", [8, 16, 32, 64, 128])
def test_grouped_matmul_routes_match_plain_with_padding_blocks(card, bt, D, F, dtype):
    """Each route at moonshot's widths and every block_t: three experts' groups
    padded with zero rows to whole blocks, then two all-padding blocks that
    repeat the last expert, as build_layout leaves them."""
    from repro_torch.kernels import moe_gmm
    gen = torch.Generator(device=card).manual_seed(bt + D)
    groups = ((2, bt + 3), (5, 1), (7, 2 * bt))              # (expert, rows)
    bmap, x = [], []
    for e, rows in groups:
        nblk = -(-rows // bt)
        bmap += [e] * nblk
        x += [_randn(gen, (rows, D), dtype, card),
              torch.zeros(nblk * bt - rows, D, dtype=dtype, device=card)]
    bmap += [groups[-1][0]] * 2
    x = torch.cat(x + [torch.zeros(2 * bt, D, dtype=dtype, device=card)])
    bmap = torch.tensor(bmap, dtype=torch.int32, device=card)
    w = (torch.randn(8, D, F, generator=gen, device=card) / D ** 0.5).to(dtype)
    out = moe_gmm.grouped_matmul(x, w, bmap, bt)
    ref = moe_gmm.grouped_matmul_plain(x, w, bmap, bt)
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])
    assert out[(x == 0).all(1)].abs().max() == 0


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", [
    (1, 256, 16, 16, 128, True, 0),    # two q tiles a block, kv over 4 splits (moonshot S256)
    (1, 512, 16, 16, 128, True, 0),    # ... 2 splits
    (1, 512, 16, 4, 128, True, 100),   # ... a window: whole kv tiles masked for some rows
    (1, 256, 4, 2, 128, False, 0),     # one q tile a block, 4 splits, bidirectional
    (1, 256, 8, 4, 32, True, 0),       # ... 4 splits
    (1, 64, 8, 8, 64, True, 0),        # ... 2 splits
    (2, 512, 16, 8, 128, True, 0),     # ... a grid that fills the card: 1 split
    (4, 512, 8, 2, 64, True, 100),     # ... 1 split, a window
])
def test_flash_bf16_block_shapes_match_plain(card, B, S, H, KV, hd, causal, window):
    """The bf16 route's block shapes (q tiles a block, kv splits), which the
    launcher picks from the kv tiles a q tile visits and the grid's size
    against the card's 132 SMs, each against the plain version."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=card).manual_seed(S + H + hd)
    q = _randn(gen, (B, S, H, hd), torch.bfloat16, card)
    k = _randn(gen, (B, S, KV, hd), torch.bfloat16, card)
    v = _randn(gen, (B, S, KV, hd), torch.bfloat16, card)
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", [
    (1, 100, 16, 16, 80, False, 0),      # hubert_xlarge: bidirectional
    (1, 77, 32, 32, 96, True, 0),        # phi3_vision
    (1, 256, 16, 8, 256, True, 0),       # gemma3_12b, global layers
    (1, 1100, 16, 8, 256, True, 1024),   # gemma3_12b, local layers: window 1024 at S past it
    (1, 2048, 16, 8, 256, True, 0),      # gemma3_12b served: the 2048 prefill bucket, global
    (1, 2048, 16, 8, 256, True, 1024),   # and local
    (2, 640, 32, 32, 96, True, 0),       # phi3_vision: 576 patch positions and 64 tokens
])
def test_flash_kernel_matches_plain_at_the_configs_head_dims(card, B, S, H, KV, hd, causal,
                                                             window, dtype):
    """Both routes of B1 at the head dims of hubert_xlarge, phi3_vision and
    gemma3_12b (at hd 256 the bf16 route takes at most 2 kv splits)."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=card).manual_seed(S + hd)
    q = _randn(gen, (B, S, H, hd), dtype, card)
    k = _randn(gen, (B, S, KV, hd), dtype, card)
    v = _randn(gen, (B, S, KV, hd), dtype, card)
    n = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n + 1
    ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,W,H,KV,hd,ring,route", [
    (2, 64, 16, 16, 80, False, "one launch"),   # hubert_xlarge's heads
    (2, 64, 32, 32, 96, True, "one launch"),    # phi3_vision
    (2, 64, 16, 8, 256, False, "one launch"),   # gemma3_12b
    (2, 1024, 16, 8, 256, True, "split"),       # gemma3_12b's local ring of 1024
    (1, 1024, 16, 16, 80, False, "split"),
    (2, 600, 32, 32, 96, False, "split"),
    (2, 64, 56, 8, 128, False, "one launch"),   # G = 7 (deepseek_coder_33b): one padded group
    (1, 300, 96, 8, 128, True, "split"),        # G = 12 (mistral_large_123b): two groups
    (2, 2048, 16, 8, 256, False, "split"),      # gemma3_12b served: global layers, max_len 2048
    (2, 1024, 32, 32, 96, False, "split"),      # phi3_vision: a SlotCache of 1024
])
def test_decode_kernel_matches_plain_on_both_routes(card, B, W, H, KV, hd, ring, route, dtype):
    from repro_torch.kernels import decode_attention as dec
    assert dec.decode_route(B, KV, W, hd, dtype.itemsize)[0] == route
    gen = torch.Generator(device=card).manual_seed(W + hd)
    q = _randn(gen, (B, H, hd), dtype, card)
    cache = _randn(gen, (2, B, W, KV, hd), dtype, card)   # a stacked cache
    pos = np.random.default_rng(W + H).integers(0, 2 * W if ring else W + 8, B)
    pos[0] = W - 1                                        # one sequence fills the cache
    pos = torch.as_tensor(pos, dtype=torch.int64, device=card)
    n = dec.decode_attention.launches
    out = dec.decode_attention(q, cache[0], cache[1], pos, ring=ring)
    torch.cuda.synchronize()
    assert dec.decode_attention.launches == n + 1
    ref = dec.decode_attention_plain(q, cache[0], cache[1], pos, ring=ring)
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_route_counts_the_keys_the_kernel_steps_over(card, dtype):
    """decode_route's keys per block step (WARPS * keys_per_step) are the
    compiled kernel's own, at every head dim it takes."""
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as dec
    fn = build.load("decode_attention").decode_keys_per_block_step
    for hd in dec.HEAD_DIMS:
        assert (fn(dec._DTYPES[dtype], hd)
                == dec.WARPS * dec.keys_per_step(hd, dtype.itemsize)), hd


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("Bt,S,DI,N", [
    (1, 16, 8192, 16),                 # falcon_mamba_7b's prefill buckets
    (1, 32, 8192, 16),
    (1, 64, 8192, 16),
    (1, 256, 8192, 16),
    (2, 128, 64, 8),                   # the JAX sweep (tests/test_kernels.py:63-67)
    (1, 64, 128, 16),
    (2, 96, 32, 4),
    (3, 33, 8192, 8),                  # 384 blocks: about three a SM
    (5, 20, 8192, 32),                 # 640 blocks: about five a SM
])
def test_mamba_scan_kernel_matches_plain_at_the_serving_shapes(card, Bt, S, DI, N, with_h0,
                                                               dtype):
    """B3 from and to a carried state, through 16-byte copies (dt, x; B and C
    are column slices of one projection, as mamba_forward's split leaves
    them)."""
    from repro_torch.kernels import mamba_scan as ms
    gen = torch.Generator(device=card).manual_seed(S + DI + N)
    dt = (torch.nn.functional.softplus(torch.randn(Bt, S, DI, generator=gen, device=card))
          * 0.1).to(dtype)
    x = _randn(gen, (Bt, S, DI), dtype, card)
    proj = _randn(gen, (Bt, S, 8 + 2 * N), dtype, card)
    Bc, Cc = proj[..., 8:8 + N], proj[..., 8 + N:]
    A = -torch.exp(0.2 * torch.randn(DI, N, generator=gen, device=card))
    D = torch.randn(DI, generator=gen, device=card)
    h0 = torch.randn(Bt, DI, N, generator=gen, device=card) if with_h0 else None
    ry, rh = ms.mamba_scan_plain(dt, x, Bc, Cc, A, D, h0)
    tol = SCAN_TOL[dtype]
    n = ms.mamba_scan.launches
    y, h = ms.mamba_scan(dt, x, Bc, Cc, A, D, h0)
    torch.cuda.synchronize()
    assert ms.mamba_scan.launches == n + 1
    torch.testing.assert_close(y.float(), ry.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(h, rh, rtol=tol, atol=tol)


@pytest.mark.parametrize("hd", [96, 256])
def test_lm_on_the_card_matches_the_cpu_at_wide_head_dims(card, hd):
    """The port's LM from a reduced demo config with head_dim 96 or 256, f32:
    a prefill and 4 decode steps through B1/B2 on the card against the same
    weights on the CPU (plain versions), logits within 2e-3, greedy tokens
    equal."""
    import copy
    from dataclasses import replace

    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import LM

    cfg = replace(reduced(get_config("tiny_lm")), head_dim=hd, dtype="float32")
    B, S0, W = 2, 16, 32
    gpu = LM(cfg, device="cuda", seed=5)
    cpu = copy.deepcopy(gpu).to("cpu")
    toks = np.random.default_rng(hd).integers(0, cfg.vocab_size, (B, S0)).astype(np.int32)
    caches, logits = {}, {}
    fa.flash_attention.launches = dec.decode_attention.launches = 0
    for name, lm in (("gpu", gpu), ("cpu", cpu)):
        lg, pc = lm.prefill({"tokens": torch.as_tensor(toks, device=lm.device)})
        cache = lm.init_cache(B, W)
        for cs, ps in zip(cache["slots"], pc["slots"]):
            for n in cs:
                cs[n][:, :, :ps[n].shape[2]] = ps[n]
        caches[name], logits[name] = cache, lg
    for t in range(S0, S0 + 5):
        g, c = logits["gpu"].float().cpu(), logits["cpu"]
        torch.testing.assert_close(g, c, rtol=2e-3, atol=2e-3)
        assert torch.equal(g.argmax(-1), c.argmax(-1))
        if t == S0 + 4:
            break
        for name, lm in (("gpu", gpu), ("cpu", cpu)):
            batch = {"token": c.argmax(-1).to(torch.int32).to(lm.device),
                     "pos": torch.full((B,), t, dtype=torch.int32, device=lm.device)}
            logits[name], caches[name] = lm.decode_step(caches[name], batch)
    assert fa.flash_attention.launches == cfg.num_layers
    assert dec.decode_attention.launches == 4 * cfg.num_layers


# ------------------------------------------- worker emulation (Fig. 2, steps 2-3)
def _emulation_rows(n=2000, seed=0):
    """Telemetry shaped as the engine writes it (``inflight = batch_size - 1``),
    with a known log-linear latency."""
    rng = np.random.default_rng(seed)
    q, b = rng.integers(0, 10, n), rng.integers(1, 8, n)
    cold, pt = rng.random(n) < 0.1, rng.integers(8, 64, n)
    X = np.stack([q, b - 1, b, cold, pt, np.full(n, 8), np.ones(n)], 1).astype(np.float32)
    y = (np.exp(0.02 * q + 0.08 * b + 1.2 * cold + 0.01 * pt + rng.normal(0, 0.05, n))
         * 0.01).astype(np.float32)
    return X, y, (rng.random(n) > 0.01).astype(np.float32)


def test_tf32_is_off_by_default_with_the_port_imported(card):
    """The fits' float32 matmuls stay IEEE on the card: importing the port
    turns TF32 on nowhere."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    code = ("import torch, repro_torch.core.emulation, repro_torch.launch.emulate\n"
            "print(torch.backends.cuda.matmul.allow_tf32, "
            "torch.get_float32_matmul_precision())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=300,
                         env=dict(os.environ,
                                  PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src")))
    assert out.stdout.split() == ["False", "highest"]


def test_ridge_fit_on_the_card_matches_the_cpu(card):
    from repro_torch.core.emulation import RidgeWorkerModel
    X, y, ok = _emulation_rows()
    cpu, gpu = (RidgeWorkerModel.fit(X, y, ok, device=d) for d in ("cpu", card))
    xs = np.concatenate([(X - cpu.mu) / cpu.sd, np.ones((len(X), 1), np.float32)], 1)
    np.testing.assert_allclose(xs @ gpu.w, xs @ cpu.w, atol=1e-4, rtol=0)
    assert gpu.resid_std == pytest.approx(cpu.resid_std, rel=1e-3)


def test_mlp_fit_on_the_card_matches_the_cpu(card):
    from repro_torch.core.emulation import MLPWorkerModel
    X, y, ok = _emulation_rows()
    init = {n: p.cpu().numpy() for n, p in MLPWorkerModel.init_params(7, 32, 0, "cpu").items()}
    cpu, gpu = (MLPWorkerModel.fit(X, y, ok, steps=20, device=d, init=init)
                for d in ("cpu", card))
    assert gpu.net.w1.device.type == "cuda"
    for name, w in cpu.params.items():
        np.testing.assert_allclose(gpu.params[name], w, atol=1e-5, rtol=0, err_msg=name)
    rng = np.random.default_rng(0)
    lat, _ = gpu.predict(X[0], rng)
    assert np.isfinite(lat) and lat > 0


def test_card_fitted_ridge_drives_64_emulated_workers(card):
    from repro_torch.core.emulation import RidgeWorkerModel
    from repro_torch.launch import emulate
    ridge = RidgeWorkerModel.fit(*_emulation_rows(), device=card)
    sim, n, s = emulate.emulate(emulate.demo_store(), ridge, workers=64, rps=500,
                                duration_s=1)
    assert s["n"] == n == len(sim.results) > 400 and s["fail_rate"] < 0.05


# the training attention: phase 3's shapes of chip_smoke.py (train_100m's
# microbatch, GQA, a window of 256), then ragged lengths, a bidirectional
# mask and the other head dims
TRAIN_ATTN_SHAPES = [
    (4, 1024, 12, 12, 64, True, 0),
    (4, 1024, 8, 2, 64, True, 0),
    (4, 1024, 12, 12, 64, True, 256),
    (2, 100, 4, 2, 32, True, 0),
    (1, 96, 4, 4, 128, False, 0),
    (1, 80, 4, 2, 256, True, 40),
    (2, 64, 8, 8, 80, True, 0),
    (1, 48, 4, 2, 96, False, 0),
    (1, 33, 2, 1, 16, True, 0),
    (2, 1024, 16, 16, 80, False, 0),     # hubert_xlarge's microbatch, bidirectional
]
GRAD_TOL = {torch.float32: (1e-3, 1e-4),    # tests/test_attention.py:40
            torch.bfloat16: (2e-2, 2e-2)}   # tests/test_kernels.py:18


def _train_inputs(card, B, S, H, KV, hd, dtype):
    gen = torch.Generator(device=card).manual_seed(S * H + hd)
    return [_randn(gen, (B, S, n, hd), dtype, card) for n in (H, KV, KV, H)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", TRAIN_ATTN_SHAPES)
def test_flash_lse_matches_plain(card, B, S, H, KV, hd, causal, window, dtype):
    from repro_torch.kernels import flash_attention as fa
    q, k, v, _ = _train_inputs(card, B, S, H, KV, hd, dtype)
    out, lse = fa.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    plain_out = fa.flash_attention(q, k, v, causal=causal, window=window)
    _, ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window, return_lse=True)
    torch.cuda.synchronize()
    assert lse.shape == (B, S, KV, H // KV) and lse.dtype == torch.float32
    assert torch.equal(out, plain_out)
    torch.testing.assert_close(lse, ref, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", TRAIN_ATTN_SHAPES)
def test_flash_bwd_kernel_matches_plain(card, B, S, H, KV, hd, causal, window, dtype):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    q, k, v, dout = _train_inputs(card, B, S, H, KV, hd, dtype)
    out, lse = fa.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    n = fb.flash_attention_bwd.launches
    got = fb.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fb.flash_attention_bwd.launches == n + 1
    want = fb.flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=causal, window=window,
                                        block=256 if S % 256 == 0 else S)
    rtol, atol = GRAD_TOL[dtype]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol, atol=atol, msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_is_bit_equal_on_two_calls(card, dtype):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    q, k, v, dout = _train_inputs(card, 4, 1024, 8, 2, 64, dtype)
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    a = fb.flash_attention_bwd(q, k, v, out, lse, dout)
    b = fb.flash_attention_bwd(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_attend_blocked_on_the_card_matches_the_cpu(card):
    """The autograd path (B1 with lse, B1b) against the plain blocked versions
    on the CPU, f32, a strided dout."""
    from repro_torch.models.attention import attend_blocked
    q, k, v, dout = _train_inputs(card, 2, 128, 8, 2, 64, torch.float32)
    grads = {}
    for dev in (card, "cpu"):
        leaves = [t.to(dev).requires_grad_() for t in (q, k, v)]
        out = attend_blocked(*leaves, causal=True, window=48, block=32)
        d = torch.cat([dout, dout], -1).to(dev)[..., ::2]
        grads[str(dev)] = [out, *torch.autograd.grad(out, leaves, d)]
    for g, c in zip(grads[str(card)], grads["cpu"]):
        torch.testing.assert_close(g.detach().cpu(), c.detach(), rtol=1e-3, atol=1e-4)


def _frontend_batch(cfg, B=2, S=32, seed=9):
    """Inputs of a frontend model, as tests/test_torch_frontends.py draws them."""
    rng = np.random.default_rng(seed)
    b = {"labels": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.frontend == "frames":
        b["frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        b["loss_mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        b["patch_embeds"] = rng.standard_normal((B, cfg.num_patches, cfg.d_model)
                                                ).astype(np.float32)
    return b


@pytest.mark.parametrize("arch", ["phi3_vision", "hubert_xlarge"])
def test_frontend_lm_on_the_card_matches_the_cpu(card, arch):
    """The LM with each frontend (phi3_vision's patches, hubert_xlarge's
    frames), reduced, f32: hidden states and prefill logits through B1 on the
    card against the same weights on the CPU within 2e-3; the loss and every
    gradient (B1 with lse, B1b) within rtol 1e-3, atol 1e-4; for phi3 4
    greedy decode steps (B2), logits within 2e-3 and tokens equal."""
    import copy
    from dataclasses import replace

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import LM

    cfg = replace(reduced(get_config(arch)), dtype="float32")
    gpu = LM(cfg, device=card, seed=7, attn_block=16)
    cpu = copy.deepcopy(gpu).to("cpu")
    batch = _frontend_batch(cfg)
    out = {}
    for name, lm in (("gpu", gpu), ("cpu", cpu)):
        b = {k: torch.as_tensor(v, device=lm.device) for k, v in batch.items()}
        with torch.no_grad():
            x, _ = lm.forward_seq(b, want_cache=False)
        lg, pc = lm.prefill({k: v for k, v in b.items() if k != "labels"})
        P = {n: p.detach().clone().requires_grad_() for n, p in lm.params().items()}
        loss, _ = lm.loss_fn(P, b)
        grads = torch.autograd.grad(loss, list(P.values()))
        out[name] = (x, lg, pc, loss.detach(), dict(zip(P, grads)))
    (gx, glg, gpc, gl, gg), (cx, clg, cpc, cl, cg) = out["gpu"], out["cpu"]
    for g, c in ((gx, cx), (glg, clg), (gl, cl)):
        torch.testing.assert_close(g.cpu(), c, rtol=2e-3, atol=2e-3)
    for n, c in cg.items():
        torch.testing.assert_close(gg[n].cpu(), c, rtol=1e-3, atol=1e-4, msg=n)
    if cfg.frontend != "patches":
        return
    B, S, W = 2, gx.shape[1], 64
    caches, logits = {}, {"gpu": glg, "cpu": clg}
    for name, lm, pc in (("gpu", gpu, gpc), ("cpu", cpu, cpc)):
        cache = lm.init_cache(B, W)
        for cs, ps in zip(cache["slots"], pc["slots"]):
            for n in cs:
                cs[n][:, :, :ps[n].shape[2]] = ps[n]
        caches[name] = cache
    for t in range(S, S + 4):
        tok = logits["cpu"].argmax(-1).to(torch.int32)
        assert torch.equal(logits["gpu"].argmax(-1).cpu(), logits["cpu"].argmax(-1))
        for name, lm in (("gpu", gpu), ("cpu", cpu)):
            step = {"token": tok.to(lm.device),
                    "pos": torch.full((B,), t, dtype=torch.int32, device=lm.device)}
            logits[name], caches[name] = lm.decode_step(caches[name], step)
        torch.testing.assert_close(logits["gpu"].cpu(), logits["cpu"], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "moonshot_v1_16b", "jamba15_large"])
def test_loss_fn_and_every_gradient_on_the_card_match_the_cpu(card, arch):
    """Reduced f32 Mamba, MoE and hybrid configs: the loss and every gradient
    through B3/B3b and B4/B4b on the card against the plain versions on the
    CPU, within rtol 1e-3, atol 1e-4 (tests/test_attention.py:40)."""
    import copy
    from dataclasses import replace

    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.kernels import mamba_scan_bwd as msb
    from repro_torch.kernels import moe_gmm
    from repro_torch.models import LM
    cfg = replace(reduced(get_config(arch), d_model=64), dtype="float32")
    gpu = LM(cfg, device=card, seed=5, attn_block=16)
    cpu = copy.deepcopy(gpu).to("cpu")
    batch = TokenStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                   global_batch=2)).batch(0)
    out = {}
    n0 = (msb.mamba_scan_bwd.launches, moe_gmm.grouped_matmul_dx.launches,
          moe_gmm.grouped_matmul_dw.launches)
    for name, lm in (("gpu", gpu), ("cpu", cpu)):
        P = {n: p.detach().clone().requires_grad_() for n, p in lm.params().items()}
        loss, _ = lm.loss_fn(P, batch)
        grads = torch.autograd.grad(loss, list(P.values()), allow_unused=True,
                                    materialize_grads=True)
        out[name] = (loss.detach(), dict(zip(P, grads)))
    launched = (msb.mamba_scan_bwd.launches - n0[0], moe_gmm.grouped_matmul_dx.launches - n0[1],
                moe_gmm.grouped_matmul_dw.launches - n0[2])
    assert (launched[0] > 0) == (cfg.mamba is not None)
    assert (launched[1] > 0 and launched[2] > 0) == (cfg.moe is not None)
    torch.testing.assert_close(out["gpu"][0].cpu(), out["cpu"][0], rtol=1e-3, atol=1e-4)
    for n, g in out["cpu"][1].items():
        torch.testing.assert_close(out["gpu"][1][n].cpu(), g, rtol=1e-3, atol=1e-4, msg=n)


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "moonshot_v1_16b"])
def test_train_steps_on_the_card_match_the_cpu_for_mamba_and_moe(card, arch):
    """Where loss_fn raised on the card before B3b and B4b: two f32 AdamW
    steps of the reduced config, card against CPU, losses and parameters
    within 2e-3, and the loss finite."""
    import copy
    from dataclasses import replace

    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.models import LM
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.trainer import make_train_step
    cfg = replace(reduced(get_config(arch)), dtype="float32")
    gpu = LM(cfg, device=card, seed=3, attn_block=16)
    cpu = copy.deepcopy(gpu).to("cpu")
    stream = TokenStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4))
    out = {}
    for name, lm in (("gpu", gpu), ("cpu", cpu)):
        opt = AdamW(lr=1e-3)
        params = {n: p.detach() for n, p in lm.params().items()}
        state, step, losses = opt.init(params), make_train_step(lm, opt, accum=2), []
        for i in range(2):
            params, state, m = step(params, state, stream.batch(i))
            losses.append(float(m["loss"]))
        out[name] = (losses, params)
    assert np.isfinite(out["gpu"][0]).all()
    np.testing.assert_allclose(out["gpu"][0], out["cpu"][0], rtol=2e-3, atol=2e-3)
    for n, p in out["cpu"][1].items():
        torch.testing.assert_close(out["gpu"][1][n].cpu(), p, rtol=2e-3, atol=2e-3, msg=n)


def test_train_steps_on_the_card_match_the_cpu(card):
    """Two f32 AdamW steps of a reduced train_100m with accumulation, card
    against CPU: losses and parameters within 2e-3."""
    import copy
    from dataclasses import replace

    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.models import LM
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.trainer import make_train_step
    cfg = replace(reduced(get_config("train_100m")), dtype="float32")
    gpu = LM(cfg, device=card, seed=3, attn_block=16)
    cpu = copy.deepcopy(gpu).to("cpu")
    stream = TokenStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4))
    out = {}
    for name, lm in (("gpu", gpu), ("cpu", cpu)):
        opt = AdamW(lr=1e-3)
        params = {n: p.detach() for n, p in lm.params().items()}
        state, step, losses = opt.init(params), make_train_step(lm, opt, accum=2), []
        for i in range(2):
            params, state, m = step(params, state, stream.batch(i))
            losses.append(float(m["loss"]))
        out[name] = (losses, params)
    np.testing.assert_allclose(out["gpu"][0], out["cpu"][0], rtol=2e-3, atol=2e-3)
    for n, p in out["cpu"][1].items():
        torch.testing.assert_close(out["gpu"][1][n].cpu(), p, rtol=2e-3, atol=2e-3, msg=n)


def _kernels_run(fn):
    """The CUDA kernels ``fn`` launches, by the names the profiler shows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events() if e.device_type == DeviceType.CUDA}


def _bwd_against_plain(card, B, S, H, KV, hd, causal, window, dtype):
    """B1b against its plain version (one block of S rows, any S); returns the
    kernels the call launched."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    q, k, v, dout = _train_inputs(card, B, S, H, KV, hd, dtype)
    out, lse = fa.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    args = (q, k, v, out, lse, dout)
    got = fb.flash_attention_bwd(*args, causal=causal, window=window)
    want = fb.flash_attention_bwd_plain(*args, causal=causal, window=window, block=S)
    torch.cuda.synchronize()
    rtol, atol = GRAD_TOL[dtype]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol, atol=atol, msg=name)
    return _kernels_run(lambda: fb.flash_attention_bwd(*args, causal=causal, window=window))


def _assert_route(ran, dtype):
    from repro_torch.kernels import flash_attention_bwd as fb
    for other, kernels in fb.KERNELS.items():
        for name in kernels:
            assert any(name in n for n in ran) == (other == dtype), (name, sorted(ran))


@pytest.mark.parametrize("hd", [16, 32, 64, 80, 96, 128, 256])
def test_flash_bwd_bf16_takes_the_tensor_cores_at_every_head_dim(card, hd):
    """Every head dim of the JAX configs, GQA, S not a multiple of a tile:
    right, and through the tensor-core kernels only."""
    from repro_torch.kernels import flash_attention_bwd as fb
    assert hd in fb.HEAD_DIMS
    _assert_route(_bwd_against_plain(card, 2, 130, 4, 2, hd, True, 0, torch.bfloat16),
                  torch.bfloat16)


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", [
    (2, 200, 8, 2, 64, True, 70),       # GQA, window, ragged
    (1, 130, 4, 4, 128, False, 0),      # bidirectional, ragged
    (2, 200, 4, 1, 96, False, 50),      # bidirectional with a window, G = 4
    (1, 130, 6, 2, 80, True, 33),
    (1, 200, 4, 2, 256, False, 0),      # the dk/dv column halves
    (2, 130, 4, 2, 16, True, 0),
    (1, 64, 2, 1, 32, True, 16),        # whole tiles, a window under a tile
    (1, 1, 2, 2, 64, True, 0),          # one row
])
def test_flash_bwd_bf16_tiles_match_plain(card, B, S, H, KV, hd, causal, window):
    _assert_route(_bwd_against_plain(card, B, S, H, KV, hd, causal, window, torch.bfloat16),
                  torch.bfloat16)


@pytest.mark.parametrize("hd", [64, 128])
def test_flash_bwd_bf16_is_bit_equal_on_two_calls(card, hd):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    q, k, v, dout = _train_inputs(card, 2, 512, 8, 2, hd, torch.bfloat16)
    out, lse = fa.flash_attention(q, k, v, window=100, return_lse=True)
    a = fb.flash_attention_bwd(q, k, v, out, lse, dout, window=100)
    b = fb.flash_attention_bwd(q, k, v, out, lse, dout, window=100)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("hd", [64, 256])
def test_flash_bwd_f32_still_takes_the_fma_kernels(card, hd):
    _assert_route(_bwd_against_plain(card, 1, 130, 4, 2, hd, True, 0, torch.float32),
                  torch.float32)


def test_flash_bwd_bf16_refuses_unaligned_tensors(card):
    from repro_torch.kernels import flash_attention_bwd as fb
    q, k, v, dout = _train_inputs(card, 1, 64, 2, 1, 64, torch.bfloat16)
    lse = torch.zeros(1, 64, 1, 2, device=card)
    off = torch.empty(q.numel() + 1, dtype=q.dtype, device=card)[1:].view(q.shape)
    n = fb.flash_attention_bwd.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        fb.flash_attention_bwd(off, k, v, q, lse, dout)
    assert fb.flash_attention_bwd.launches == n


# ---------------------------------------------------------------------------
# B3 with its chunk states, B3b (the scan's backward), B4b (dx and dW)
# ---------------------------------------------------------------------------


def _scan_args(card, Bt, S, DI, N, dtype=torch.float32, h0=True, big_dt=False):
    gen = torch.Generator(device=card).manual_seed(S * 7 + DI + N)
    dt = torch.nn.functional.softplus(torch.randn(Bt, S, DI, generator=gen, device=card)) * 0.1
    if big_dt:          # steps where exp(dt A) underflows to 0
        dt[:, ::5] *= 4000.0
    x = _randn(gen, (Bt, S, DI), dtype, card)
    proj = _randn(gen, (Bt, S, 8 + 2 * N), dtype, card)
    A = -torch.exp(0.2 * torch.randn(DI, N, generator=gen, device=card))
    D = torch.randn(DI, generator=gen, device=card)
    hz = torch.randn(Bt, DI, N, generator=gen, device=card) if h0 else None
    return (dt.to(dtype), x, proj[..., 8:8 + N], proj[..., 8 + N:], A, D, hz), gen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bt,S,DI,N", [(1, 32, 8192, 16), (2, 77, 100, 4), (3, 40, 48, 32),
                                      (2, 65, 64, 8),
                                      (2, 203, 70, 16)])   # a state at every half-chunk
def test_mamba_scan_states_leave_y_and_h_bit_equal(card, Bt, S, DI, N, dtype):
    from repro_torch.kernels import mamba_scan as ms
    args, _ = _scan_args(card, Bt, S, DI, N, dtype)
    y, h = ms.mamba_scan(*args)
    n = ms.mamba_scan.launches
    y2, h2, states = ms.mamba_scan(*args, states=True)
    torch.cuda.synchronize()
    assert ms.mamba_scan.launches == n + 1
    assert torch.equal(y, y2) and torch.equal(h, h2)
    Tc = ms.state_chunk(N)
    assert tuple(states.shape) == (Bt, -(-S // Tc), DI, N)
    _, _, want = ms.mamba_scan_plain(*args, chunk=Tc)
    tol = SCAN_TOL[dtype]
    torch.testing.assert_close(states, want, rtol=tol, atol=tol)
    assert torch.equal(states[:, 0], args[6])


@pytest.mark.parametrize("big_dt", [False, True], ids=["moderate_dt", "dt_A_underflows"])
@pytest.mark.parametrize("Bt,S,DI,N,h0", [
    (1, 64, 8192, 16, False),          # falcon_mamba_7b's widths
    (2, 77, 100, 4, True),             # ragged: S past a chunk, DI not a block multiple
    (3, 40, 48, 32, True),
    (2, 96, 128, 8, True),
    (1, 1024, 8192, 16, False),        # falcon_mamba_7b's widths over 64 spans of 16 steps
    (2, 203, 200, 16, True),           # S past a span and its half, DI past a 64-channel tile
    (2, 50, 70, 8, True),              # DI % 4 != 0: 4-byte copies, DI past a 128-channel tile
])
def test_mamba_scan_bwd_kernel_matches_plain(card, Bt, S, DI, N, h0, big_dt):
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import mamba_scan_bwd as msb
    args, gen = _scan_args(card, Bt, S, DI, N, h0=h0, big_dt=big_dt)
    _, _, states = ms.mamba_scan(*args, states=True)
    ins = [t.contiguous() for t in args[:6]] + [states]
    dy = torch.randn(Bt, S, DI, generator=gen, device=card)
    dh_S = torch.randn(Bt, DI, N, generator=gen, device=card) if h0 else None
    n = msb.mamba_scan_bwd.launches
    got = msb.mamba_scan_bwd(*ins, dy, dh_S)
    again = msb.mamba_scan_bwd(*ins, dy, dh_S)
    torch.cuda.synchronize()
    assert msb.mamba_scan_bwd.launches == n + 2
    want = msb.mamba_scan_bwd_plain(*ins, dy, dh_S, chunk=ms.state_chunk(N))
    tol = SCAN_TOL[torch.float32]
    for name, g, w, a in zip(got._fields, got, want, again):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        torch.testing.assert_close(g, w, rtol=tol, atol=tol, msg=name)
        assert torch.equal(g, a), name


@pytest.mark.parametrize("N", [4, 8, 16, 32])
def test_mamba_scan_bwd_keeps_two_blocks_an_sm(card, N):
    """B3b's registers (at most 128 a thread) and shared memory leave room
    for two of its blocks of 256 threads on one SM at every d_state."""
    from repro_torch.kernels import mamba_scan_bwd as msb
    assert msb.blocks_per_sm(N) >= 2


def test_mamba_scan_bwd_wrapper_rejects_what_the_kernel_does_not_take(card):
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import mamba_scan_bwd as msb
    args, gen = _scan_args(card, 2, 40, 64, 16)
    _, _, states = ms.mamba_scan(*args, states=True)
    ins = [t.contiguous() for t in args[:6]] + [states]
    dy = torch.randn(2, 40, 64, generator=gen, device=card)
    with pytest.raises(TypeError, match="float32"):
        msb.mamba_scan_bwd(*[t.to(torch.bfloat16) if i < 4 else t for i, t in enumerate(ins)],
                           dy)
    with pytest.raises(ValueError, match="contiguous"):
        msb.mamba_scan_bwd(*args[:6], states, dy)          # B and C are strided views
    with pytest.raises(ValueError, match="states"):
        msb.mamba_scan_bwd(*ins[:6], states[:, :1], dy)
    with pytest.raises(ValueError, match="dh_S"):
        msb.mamba_scan_bwd(*ins, dy, torch.zeros(2, 64, 8, device=card))
    with pytest.raises(ValueError, match="CUDA kernel"):
        msb.mamba_scan_bwd(*[t.cpu() for t in ins], dy.cpu())


@pytest.mark.parametrize("N", [16, 32])
def test_scan_kernels_refuse_a_chunk_other_than_their_own(card, monkeypatch, N):
    """B3 and B3b hold the wrappers' state_chunk, which sizes the saved
    states, against their own chunk of steps, so the two cannot drift apart
    unseen."""
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import mamba_scan_bwd as msb
    args, gen = _scan_args(card, 2, 40, 64, N)
    ins = [t.contiguous() for t in args[:6]]
    dy = torch.randn(2, 40, 64, generator=gen, device=card)
    wrong = ms.state_chunk(N) // 2
    states = torch.zeros(2, -(-40 // wrong), 64, N, device=card)
    monkeypatch.setattr(ms, "state_chunk", lambda n: wrong)
    monkeypatch.setattr(msb, "state_chunk", lambda n: wrong)
    n0, n1 = ms.mamba_scan.launches, msb.mamba_scan_bwd.launches
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        ms.mamba_scan(*args, states=True)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        msb.mamba_scan_bwd(*ins, states, dy)
    assert (ms.mamba_scan.launches, msb.mamba_scan_bwd.launches) == (n0, n1)


def _gmm_bwd_case(card, gen, lay, B, S, D, F, dtype):
    x = torch.cat([_randn(gen, (B * S, D), dtype, card),
                   torch.zeros(1, D, dtype=dtype, device=card)])[lay.row_token]
    w = (torch.randn(2, 64, D, F, generator=gen, device=card) / D ** 0.5).to(dtype)[1]
    dy = _randn(gen, (x.shape[0], F), dtype, card)
    return x, w, dy


def _check_used_blocks(moe_gmm, x, w, dy, lay):
    """used_blocks promises that x and dy are zero past the used rows (x is,
    as dispatched; dy is, as the model's backward gives it): on such inputs
    dx and dW with the layout's used_blocks are bit-equal to the calls
    without it, on every route."""
    bmap, bt, used = lay.block_to_expert, lay.block_t, lay.used_blocks
    B, S = lay.token_rows.shape[:2]
    dyz = dy.masked_fill((lay.row_token == B * S)[:, None], 0)
    E = w.shape[0]
    dxu = moe_gmm.grouped_matmul_dx(dyz, w, bmap, bt, used)
    dwu = moe_gmm.grouped_matmul_dw(x, dyz, bmap, bt, E, used)
    torch.cuda.synchronize()
    assert torch.equal(dxu, moe_gmm.grouped_matmul_dx(dyz, w, bmap, bt))
    assert torch.equal(dwu, moe_gmm.grouped_matmul_dw(x, dyz, bmap, bt, E))


@pytest.mark.parametrize("bt", [None, 64, 128], ids=["layout_bt", "bt64", "bt128"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,D,F", [
    (2, 64, 2048, 1408),               # moonshot's experts at 128 tokens: gate/up, then down
    (2, 64, 1408, 2048),
    (1, 16, 128, 64),                  # 8-row blocks
    (4, 32, 64, 192),
])
def test_grouped_matmul_bwd_kernels_match_plain(card, B, S, D, F, dtype, bt):
    """At the layout's own block_t and at 64 and 128, where bf16 takes the
    wgmma route; with used_blocks too (see _check_used_blocks)."""
    from repro_torch.kernels import moe_gmm
    gen = torch.Generator(device=card).manual_seed(S + D + F)
    lay = _routed_layout(card, gen, B, S, block_t=bt)
    x, w, dy = _gmm_bwd_case(card, gen, lay, B, S, D, F, dtype)
    bmap, bt = lay.block_to_expert, lay.block_t
    n = (moe_gmm.grouped_matmul_dx.launches, moe_gmm.grouped_matmul_dw.launches)
    dx = moe_gmm.grouped_matmul_dx(dy, w, bmap, bt)
    dw = moe_gmm.grouped_matmul_dw(x, dy, bmap, bt, w.shape[0])
    dx2 = moe_gmm.grouped_matmul_dx(dy, w, bmap, bt)
    dw2 = moe_gmm.grouped_matmul_dw(x, dy, bmap, bt, w.shape[0])
    torch.cuda.synchronize()
    assert (moe_gmm.grouped_matmul_dx.launches, moe_gmm.grouped_matmul_dw.launches) == (
        n[0] + 2, n[1] + 2)
    want_dx, want_dw = moe_gmm.grouped_matmul_bwd_plain(x, w, dy, bmap, bt)
    tol = TOL[dtype]
    assert dx.dtype == dw.dtype == dtype and dw.shape == w.shape
    torch.testing.assert_close(dx.float(), want_dx.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(dw.float(), want_dw.float(), rtol=tol, atol=tol)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    unused = set(range(64)) - set(bmap.tolist())
    assert all(float(dw[e].abs().max()) == 0 for e in unused)
    _check_used_blocks(moe_gmm, x, w, dy, lay)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,D,F,E,bt", [
    (512, 128, 256, 4, 64), (256, 64, 128, 8, 32), (256, 128, 128, 4, 128), (96, 64, 192, 3, 16),
    (64, 64, 64, 2, 8),
    # the wgmma route off its 128 x 256 tiles (D, F odd multiples of 64), with
    # experts that get no block (E above the blocks)
    (512, 64, 192, 6, 64), (1024, 192, 1408, 9, 128), (768, 1408, 64, 5, 128),
    (384, 192, 64, 16, 64), (640, 320, 448, 12, 128)])
def test_grouped_matmul_bwd_kernels_match_plain_on_sweeps(card, T, D, F, E, bt, dtype):
    """Random block maps, in no order: dW lists each expert's blocks itself."""
    from repro_torch.kernels import moe_gmm
    gen = torch.Generator(device=card).manual_seed(T + bt + 1)
    x = _randn(gen, (T, 2 * D), dtype, card)[:, D:]          # rows through a stride
    w = _randn(gen, (E, D, F), dtype, card)
    dy = _randn(gen, (T, F), dtype, card)
    bmap = torch.randint(0, E, (T // bt,), generator=gen, device=card, dtype=torch.int32)
    dx = moe_gmm.grouped_matmul_dx(dy, w, bmap, bt)
    dw = moe_gmm.grouped_matmul_dw(x, dy, bmap, bt, E)
    want_dx, want_dw = moe_gmm.grouped_matmul_bwd_plain(x, w, dy, bmap, bt)
    tol = TOL[dtype]
    torch.testing.assert_close(dx.float(), want_dx.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(dw.float(), want_dw.float(), rtol=tol, atol=tol)
    assert torch.equal(dx, moe_gmm.grouped_matmul_dx(dy, w, bmap, bt))
    assert torch.equal(dw, moe_gmm.grouped_matmul_dw(x, dy, bmap, bt, E))
    unused = set(range(E)) - set(bmap.tolist())
    assert all(float(dw[e].abs().max()) == 0 for e in unused)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bt", [64, 128])
@pytest.mark.parametrize("D,F", [(2048, 1408), (1408, 2048), (192, 64)])
def test_grouped_matmul_bwd_on_a_layout_that_drops_most_assignments(card, D, F, bt, dtype):
    """8 experts take nearly every assignment and capacity drops ~85% of them
    (moonshot's router at its training start): most row blocks are trailing
    padding, which the wgmma route skips under used_blocks. dy is zero on the
    padding rows, as the model's backward gives it there (the combine's
    gate is 0), so every call agrees bit for bit with and without it."""
    from repro_torch.kernels import moe_gmm
    gen = torch.Generator(device=card).manual_seed(D + F + bt)
    B, S = 4, 256
    lay = _routed_layout(card, gen, B, S, block_t=bt, hot=8)
    kept = int((lay.row_token < B * S).sum())
    assert kept < 0.25 * B * S * 6
    x, w, dy = _gmm_bwd_case(card, gen, lay, B, S, D, F, dtype)
    dy[lay.row_token == B * S] = 0
    bmap, used = lay.block_to_expert, lay.used_blocks
    assert int(used.item()) < bmap.numel() // 2
    dx = moe_gmm.grouped_matmul_dx(dy, w, bmap, bt, used)
    dw = moe_gmm.grouped_matmul_dw(x, dy, bmap, bt, 64, used)
    want_dx, want_dw = moe_gmm.grouped_matmul_bwd_plain(x, w, dy, bmap, bt, used_blocks=used)
    tol = TOL[dtype]
    torch.testing.assert_close(dx.float(), want_dx.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(dw.float(), want_dw.float(), rtol=tol, atol=tol)
    assert torch.equal(dx, moe_gmm.grouped_matmul_dx(dy, w, bmap, bt))
    assert torch.equal(dw, moe_gmm.grouped_matmul_dw(x, dy, bmap, bt, 64))
    assert torch.equal(dx, moe_gmm.grouped_matmul_dx(dy, w, bmap, bt, used))
    assert torch.equal(dw, moe_gmm.grouped_matmul_dw(x, dy, bmap, bt, 64, used))


def test_grouped_matmul_bwd_wrappers_reject_what_the_kernels_do_not_take(card):
    from repro_torch.kernels import moe_gmm
    x = torch.zeros(32, 64, device=card)
    w = torch.zeros(2, 64, 128, device=card)
    dy = torch.zeros(32, 128, device=card)
    bmap = torch.zeros(4, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="shapes"):
        moe_gmm.grouped_matmul_dx(x, w, bmap, 8)            # dy's columns run over F
    with pytest.raises(TypeError, match="int32"):
        moe_gmm.grouped_matmul_dw(x, dy, bmap.long(), 8, 2)
    with pytest.raises(ValueError, match="block_t"):
        moe_gmm.grouped_matmul_dw(x, dy, bmap, 12, 2)
    with pytest.raises(ValueError, match="multiples of 64"):
        moe_gmm.grouped_matmul_dw(x, dy[:, :96], bmap, 8, 2)
    with pytest.raises(ValueError, match="contiguous"):
        moe_gmm.grouped_matmul_dx(dy, w.transpose(1, 2).contiguous().transpose(1, 2), bmap, 8)
    with pytest.raises(TypeError):
        moe_gmm.grouped_matmul_dx(dy.half(), w.half(), bmap, 8)
    with pytest.raises(ValueError, match="rows"):
        moe_gmm.grouped_matmul_dw(x, dy[:16], bmap, 8, 2)
    with pytest.raises(ValueError, match="used_blocks"):
        moe_gmm.grouped_matmul_dw(x, dy, bmap, 8, 2, bmap[:1].long())


def test_a_one_rank_nccl_mesh_step_equals_the_plain_step(card):
    """Reduced qwen3_32b in f32 on a one-rank NCCL group and a (1, 1) mesh:
    the mesh path (DTensor parameters and state, shard_act, B1 and B1b
    through local_map) gives the plain path's losses, gradient norms and
    parameters after 3 steps."""
    from dataclasses import replace

    import torch.distributed as dist

    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.launch.mesh import init_process_group, make_local_mesh
    from repro_torch.launch.train import setup_training
    from repro_torch.models import LM
    from repro_torch.train.optimizer import AdamW

    init_process_group()
    try:
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        mesh = make_local_mesh(model_axis=1)
        cfg = replace(reduced(get_config("qwen3_32b")), dtype="float32")
        lm = LM(cfg, device=card, seed=0, attn_block=16)
        stream = TokenStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8,
                                        seed=0))
        out = {}
        for path in ("plain", "mesh"):
            params, state, step, context, _ = setup_training(
                lm, AdamW(lr=1e-3), mesh if path == "mesh" else None, rows=4, seq=32, accum=2)
            n1, n1b = fa.flash_attention.launches, fb.flash_attention_bwd.launches
            rec = []
            with context:
                for i in range(3):
                    params, state, m = step(params, state, stream.batch(i))
                    rec.append((float(m["loss"]), float(m["grad_norm"])))
            assert fa.flash_attention.launches > n1 and fb.flash_attention_bwd.launches > n1b
            out[path] = rec, {n: t.full_tensor() if hasattr(t, "full_tensor") else t
                              for n, t in params.items()}
        np.testing.assert_allclose(out["mesh"][0], out["plain"][0], rtol=0, atol=2e-3)
        for n, p in out["plain"][1].items():
            torch.testing.assert_close(out["mesh"][1][n], p, rtol=5e-4, atol=5e-5)
    finally:
        dist.destroy_process_group()
