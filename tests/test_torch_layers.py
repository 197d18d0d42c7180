"""The port's primitive layers against the JAX package's, on the same numpy
inputs: f32 to float rounding, bf16 within one bf16 step."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _pair(a, dtype):
    j = jnp.asarray(a, dtype)
    return j, tensor_from_numpy(np.asarray(j))


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng.standard_normal((2, 5, 64), dtype=np.float32) * 3, dtype)
    jw, tw = _pair(rng.standard_normal(64, dtype=np.float32) * 0.1, dtype)
    got = tl.rms_norm(tx, tw, 1e-6)
    assert got.dtype == tx.dtype
    _close(got, jl.rms_norm(jx, jw, 1e-6), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_rms_norm(dtype):
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng.standard_normal((2, 5, 4, 16), dtype=np.float32), dtype)
    jw, tw = _pair(rng.standard_normal(16, dtype=np.float32) * 0.1, dtype)
    _close(tl.head_rms_norm(tx, tw, 1e-6), jl.head_rms_norm(jx, jw, 1e-6), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope_sequence(dtype, theta):
    rng = np.random.default_rng(2)
    jx, tx = _pair(rng.standard_normal((2, 24, 4, 32), dtype=np.float32), dtype)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32) + 200, (2, 24))
    got = tl.rope(tx, torch.as_tensor(pos.copy()), theta)
    _close(got, jl.rope(jx, jnp.asarray(pos), theta), dtype)


def test_rope_decode_form():
    """Decode rotates one token per row: rope(q[:, None], pos[:, None])[:, 0]."""
    rng = np.random.default_rng(3)
    jq, tq = _pair(rng.standard_normal((3, 8, 16), dtype=np.float32), "float32")
    pos = np.array([0, 17, 255], np.int32)
    got = tl.rope(tq[:, None], torch.as_tensor(pos)[:, None], 10000.0)[:, 0]
    want = jl.rope(jq[:, None], jnp.asarray(pos)[:, None], 10000.0)[:, 0]
    _close(got, want, "float32")
    # the rotation keeps each half-pair's norm
    torch.testing.assert_close(got.norm(dim=-1), tq.norm(dim=-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gated", [True, False])
def test_mlp(dtype, gated):
    rng = np.random.default_rng(4)
    jx, tx = _pair(rng.standard_normal((2, 3, 32), dtype=np.float32), dtype)
    names = ("wi", "wg", "wo") if gated else ("wi", "wo")
    shapes = {"wi": (32, 64), "wg": (32, 64), "wo": (64, 32)}
    jp, tp = {}, {}
    for n in names:
        jp[n], tp[n] = _pair(rng.standard_normal(shapes[n], dtype=np.float32) * 0.2, dtype)
    tp.setdefault("wg", None)
    got = tl.mlp(tx, tp, gated)
    _close(got, jl.mlp(jx, jp, gated), dtype)


def test_sinusoidal_pos():
    got = tl.sinusoidal_pos(12, 16, torch.float32)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jl.sinusoidal_pos(12, 16, jnp.float32)))


@pytest.mark.parametrize("shape", [(64, 32), (4, 32, 64), (16,)])
def test_init_param_fan_in(shape):
    gen = torch.Generator().manual_seed(0)
    spec = tl.ParamSpec(shape, (None,) * len(shape))
    w = tl.init_param(spec, gen)
    fan_in = shape[-2] if len(shape) >= 2 else shape[0]
    assert w.dtype == torch.float32 and w.shape == shape
    assert abs(w.std().item() * np.sqrt(fan_in) - 1.0) < 0.3
    gen2 = torch.Generator().manual_seed(0)
    torch.testing.assert_close(tl.init_param(spec, gen2), w)
    zeros = tl.ParamSpec(shape, spec.axes, init="zeros")
    assert tl.init_param(zeros, gen).abs().sum() == 0
