"""The port's plain kernel versions (the CPU path and the card's yardstick)
against the JAX package's Pallas kernels in interpret mode and its jnp
oracles, on the same numpy inputs. Tolerances are the reference's own:
2e-4 in float32, 2e-2 in bfloat16 (tests/test_kernels.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as pallas_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import decode_attention as tdec  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels.decode_attention import decode_route, split_chunk  # noqa: E402
from repro_torch.kernels.flash_attention_bwd import attend_fwd_plain  # noqa: E402

DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a torch tensor (bf16 bit for bit)."""
    a = jnp.asarray(rng.standard_normal(shape, dtype=np.float32), dtype)
    return a, tensor_from_numpy(np.asarray(a))


def _close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", [
    (1, 64, 4, 2, 32, True, 0),
    (1, 32, 2, 2, 16, False, 0),
    (2, 64, 4, 1, 16, True, 20),
    (1, 48, 2, 1, 16, True, 0),
    (1, 32, 4, 4, 80, False, 0),       # hubert_xlarge's head dim, bidirectional
    (1, 32, 4, 4, 96, True, 0),        # phi3_vision's
    (1, 48, 4, 2, 256, True, 16),      # gemma3_12b's, with a window
])
def test_flash_plain_matches_pallas_and_oracle(B, S, H, KV, hd, causal, window, dtype):
    rng = np.random.default_rng(B * S + H + hd)
    jq, tq = _pair(rng, (B, S, H, hd), dtype)
    jk, tk = _pair(rng, (B, S, KV, hd), dtype)
    jv, tv = _pair(rng, (B, S, KV, hd), dtype)
    got = tref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == (B, S, H, hd)
    got = got.float().numpy()
    _close(got, jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window), dtype)
    _close(got, pallas_flash(jq, jk, jv, causal=causal, window=window,
                             block_q=16, block_k=16), dtype)
    # the CPU dispatch takes exactly the blocked forward (one block of S
    # rows at the default block of 512), within the oracle's tolerance of
    # the plain version
    blocked = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_array_equal(blocked.float().numpy(), attend_fwd_plain(
        tq, tk, tv, causal=causal, window=window, block=S)[0].float().numpy())
    _close(blocked.float().numpy(), got, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,W,H,KV,hd,ring", [
    (2, 64, 8, 2, 32, False),
    (3, 32, 4, 4, 16, True),
    (1, 128, 8, 2, 64, False),
    (2, 32, 4, 4, 80, False),
    (2, 48, 4, 4, 96, True),
    (2, 64, 4, 2, 256, True),
])
def test_decode_plain_matches_pallas_and_oracle(B, W, H, KV, hd, ring, dtype):
    rng = np.random.default_rng(B * W + H + hd)
    jq, tq = _pair(rng, (B, H, hd), dtype)
    jk, tk = _pair(rng, (B, W, KV, hd), dtype)
    jv, tv = _pair(rng, (B, W, KV, hd), dtype)
    pos = rng.integers(5, W * 2 if ring else W, B).astype(np.int32)
    got = tref.decode_attention_ref(tq, tk, tv, torch.as_tensor(pos), ring=ring)
    assert got.dtype == tq.dtype and got.shape == (B, H, hd)
    got = got.float().numpy()
    jpos = jnp.asarray(pos)
    _close(got, jref.decode_attention_ref(jq, jk, jv, jpos, ring=ring), dtype)
    _close(got, pallas_decode(jq, jk, jv, jpos, ring=ring, block_w=16), dtype)
    np.testing.assert_array_equal(
        ops.decode_attention(tq, tk, tv, torch.as_tensor(pos), ring=ring).float().numpy(),
        got)


def test_decode_plain_masks_past_valid_len():
    """Cache rows past pos (linear) carry no weight, whatever they hold."""
    rng = np.random.default_rng(0)
    q = torch.as_tensor(rng.standard_normal((2, 4, 16), dtype=np.float32))
    kc = torch.as_tensor(rng.standard_normal((2, 32, 2, 16), dtype=np.float32))
    vc = torch.as_tensor(rng.standard_normal((2, 32, 2, 16), dtype=np.float32))
    pos = torch.tensor([3, 20], dtype=torch.int32)
    a = tref.decode_attention_ref(q, kc, vc, pos)
    kc2, vc2 = kc.clone(), vc.clone()
    kc2[0, 4:] = 1e3
    vc2[1, 21:] = -1e3
    torch.testing.assert_close(tref.decode_attention_ref(q, kc2, vc2, pos), a)


@pytest.mark.parametrize("B,KV,W,chunk", [
    (4, 4, 64, 16),      # tiny_lm, 4 slots, max_len 64
    (2, 8, 256, 16),     # small_lm, 2 slots, max_len 256
    (64, 8, 4096, 64),   # a grid that fills the card at the largest chunk
])
def test_decode_split_fills_the_card(B, KV, W, chunk):
    assert split_chunk(B, KV, W) == chunk


@pytest.mark.parametrize("kernel", [tflash, tdec], ids=["B1", "B2"])
def test_attention_kernels_take_every_head_dim_of_the_jax_configs(kernel):
    """Serving any config of the JAX package's registry reaches B1 and B2 with
    its head_dim: each must be one the kernel takes."""
    from repro.configs import get_config, list_configs

    dims = {get_config(n).head_dim for n in list_configs()}
    assert {80, 96, 256} <= dims
    assert dims <= set(kernel.HEAD_DIMS)


@pytest.mark.parametrize("B,KV,W,hd,itemsize,route", [
    (4, 4, 64, 32, 2, ("one launch", 64)),      # tiny_lm, 4 slots: the engine's decodes
    (4, 4, 256, 32, 2, ("one launch", 256)),
    (2, 8, 256, 64, 2, ("one launch", 256)),    # small_lm, 2 slots
    (2, 16, 64, 128, 2, ("one launch", 64)),    # moonshot_v1_16b, 2 slots
    (2, 16, 256, 128, 2, ("one launch", 256)),
    (2, 16, 256, 128, 4, ("split", 16)),        # ... in float32: rows of 32 lanes
    (1, 2, 512, 128, 2, ("split", 16)),         # the JAX sweep's W512
    (2, 8, 64, 256, 2, ("one launch", 64)),     # gemma3_12b's heads
    (2, 8, 256, 256, 2, ("split", 16)),         # ... its global layers
    (2, 8, 1024, 256, 2, ("split", 32)),        # ... its local ring of 1024
    (64, 8, 4096, 64, 2, ("split", 64)),        # a grid that fills the card
])
def test_decode_route_is_one_launch_at_the_serving_shapes(B, KV, W, hd, itemsize, route):
    assert decode_route(B, KV, W, hd, itemsize) == route


@pytest.mark.parametrize("name", ["flash_attention", "moe_gmm"])
def test_b1_b4_route_by_type_and_refuse_the_cpu_first(name):
    """B1 and B4 take bfloat16 through the tensor cores and float32 through the
    FMA loop, a route for every type they take; a CPU tensor of either type is
    refused before any alignment check, build or launch."""
    import importlib

    mod = importlib.import_module(f"repro_torch.kernels.{name}")
    assert set(mod.ROUTES) == set(mod._DTYPES) == {torch.float32, torch.bfloat16}
    assert "tensor cores" in mod.ROUTES[torch.bfloat16]
    assert "FMA" in mod.ROUTES[torch.float32]
    for dtype in mod.ROUTES:
        if name == "flash_attention":
            q = torch.zeros(1, 17, 4, 66, dtype=dtype)[..., 2:]    # rows off 16 bytes
            args = (q, q[:, :, :2], q[:, :, :2])
            fn = mod.flash_attention
        else:
            x = torch.zeros(16, 66, dtype=dtype)[:, 2:]
            args = (x, torch.zeros(2, 64, 64, dtype=dtype), torch.zeros(2, dtype=torch.int32), 8)
            fn = mod.grouped_matmul
        with pytest.raises(ValueError, match="CUDA kernel"):
            fn(*args)
        assert fn.launches == 0


@pytest.mark.parametrize("H,KV,h0,hl", [(8, 2, 0, 2), (8, 2, 4, 4), (8, 2, 2, 4), (6, 2, 2, 2),
                                        (9, 3, 6, 3), (9, 3, 9, 0), (56, 8, 52, 4)])
def test_the_kv_gradient_cut_is_the_adjoint_of_the_kv_cut(H, KV, h0, hl):
    """``ops._kv_grad_for_heads`` lays the gradient of the kv heads that q
    heads ``[h0, h0 + hl)`` read back into all KV heads as the adjoint of
    ``ops._kv_for_heads`` (<cut(k), g> == <k, cut^T(g)>), zeros for the kv
    heads those q heads do not read; an uneven head split's empty share
    (9 heads over 4 ranks: 3, 3, 3, 0) reads none and gives zeros."""
    gen = torch.Generator().manual_seed(H * 100 + h0)
    group = H // KV
    k = torch.randn(2, 3, KV, 4, generator=gen, dtype=torch.float64)
    cut = ops._kv_for_heads(k, h0, hl, group)
    g = torch.randn(cut.shape, generator=gen, dtype=torch.float64)
    back = ops._kv_grad_for_heads(g, KV, h0, hl, group)
    assert back.shape == k.shape
    assert torch.allclose((cut * g).sum(), (k * back).sum(), rtol=1e-12, atol=1e-12)
    read = set(range(h0 // group, -(-(h0 + hl) // group))) if hl else set()
    for j in set(range(KV)) - read:
        assert not back[:, :, j].any(), j
