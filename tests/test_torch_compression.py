"""The port's gradient compression (``repro_torch.distributed.compression``)
against the JAX package's, on the same seeded numpy inputs.

The cases of tests/test_property.py's compression properties (the int8
bound, the error-feedback identity, top-k keeping the largest), each
checked against the JAX function itself: the int8 payload and scale
bit-equal (absmax over 127 floored at 1e-12, round half to even in both),
the top-k masks equal, sizes included where ``int(n * frac)`` rounds down
to 0 (k is then 1). The pod sync on 8 ranks against the JAX package's
``shard_map`` on 8 devices is in tests/test_torch_mesh.py, which owns the
one 8-rank launch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.distributed import compression as J  # noqa: E402
from repro_torch.distributed import compression as C  # noqa: E402

SIZES = [1, 4, 7, 19, 64, 256, 1000]


def _draw(seed, n, scale=3.0):
    return np.random.default_rng(seed).normal(0, scale, n).astype(np.float32)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("seed", [1, 12345, 2**31 - 1])
def test_int8_payload_and_scale_are_bit_equal_to_jax(seed, n):
    """The payload and the scale are JAX's, bit for bit, and the round trip
    keeps |dequant(quant(x)) - x| <= scale / 2 (tests/test_property.py's
    bound)."""
    x = _draw(seed, n)
    if n == 7:
        x[:] = 0.0                          # the 1e-12 floor
    if n == 19:                             # scale 1: x / scale ties at every half
        x = np.array([127.0] + [k + 0.5 for k in range(-9, 9)], np.float32)
    q, scale = C.quantize_int8(torch.as_tensor(x))
    jq, jscale = J.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert np.float32(scale.item()).tobytes() == np.asarray(jscale, np.float32).tobytes()
    back = C.dequantize_int8(q, scale).numpy()
    np.testing.assert_array_equal(back, np.asarray(J.dequantize_int8(jq, jscale)))
    assert np.all(np.abs(back - x) <= float(scale) / 2 + 1e-6)


@pytest.mark.parametrize("seed", [3, 99, 4242, 2**30 + 7])
def test_error_feedback_matches_jax_and_loses_nothing(seed):
    """g_sent + new_err == g + old_err (nothing lost, only delayed), and each
    scheme's outputs equal the JAX package's bit for bit."""
    rng = np.random.default_rng(seed)
    g = rng.normal(0, 1, 64).astype(np.float32)
    err = rng.normal(0, 0.1, 64).astype(np.float32)
    q, scale, new_err = C.ef_compress_int8(torch.as_tensor(g), torch.as_tensor(err))
    jq, jscale, jnew = J.ef_compress_int8(jnp.asarray(g), jnp.asarray(err))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(new_err.numpy(), np.asarray(jnew))
    sent = C.dequantize_int8(q, scale)
    np.testing.assert_allclose((sent + new_err).numpy(), g + err, rtol=1e-5, atol=1e-5)
    sent_tk, new_err_tk = C.ef_compress_topk(torch.as_tensor(g), torch.as_tensor(err), 0.1)
    jsent, jerr = J.ef_compress_topk(jnp.asarray(g), jnp.asarray(err), 0.1)
    np.testing.assert_array_equal(sent_tk.numpy(), np.asarray(jsent))
    np.testing.assert_array_equal(new_err_tk.numpy(), np.asarray(jerr))
    np.testing.assert_allclose((sent_tk + new_err_tk).numpy(), g + err, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [4, 10, 19, 100])
@pytest.mark.parametrize("frac", [0.05, 0.1, 0.37, 0.9])
def test_topk_mask_equals_jax_and_keeps_the_largest(n, frac):
    """The mask is JAX's (k = max(1, int(n * frac)): 1 at n 4 and 10 with
    frac 0.05, and at n 19); the kept values are at least the dropped."""
    x = _draw(n * 1000 + int(frac * 100), n, 1.0)
    mask = C.topk_mask(torch.as_tensor(x), frac).numpy()
    np.testing.assert_array_equal(mask, np.asarray(J.topk_mask(jnp.asarray(x), frac)))
    assert mask.dtype == np.float32 and mask.sum() == max(1, int(n * frac))
    kept, dropped = np.abs(x)[mask > 0], np.abs(x)[mask == 0]
    if kept.size and dropped.size:
        assert kept.min() >= dropped.max()


def test_topk_keeps_ties_as_jax_does():
    """``>=`` the k-th largest |x|: every value tied with it is kept, in
    both packages."""
    x = np.array([3.0, -3.0, 1.0, 3.0, 0.5, -2.0], np.float32)
    mask = C.topk_mask(torch.as_tensor(x), 0.34).numpy()       # k = 2; three tie at 3
    np.testing.assert_array_equal(mask, np.asarray(J.topk_mask(jnp.asarray(x), 0.34)))
    assert mask.tolist() == [1, 1, 0, 1, 0, 0]


@pytest.mark.parametrize("scheme", ["int8", "topk", "none"])
def test_pod_sync_on_a_mesh_without_pods_is_each_leafs_own_compression(scheme):
    """On a mesh with no ``pod`` dim the sum runs over one pod: the synced
    gradient is the compressed one, cast back to its dtype, for a tree of
    dicts and lists; the plain scheme keeps the error."""
    from repro_torch.distributed.compression import make_pod_grad_sync

    class _Mesh:                                 # no pod dim: no group is asked for
        mesh_dim_names = ("data",)

    rng = np.random.default_rng(5)
    grads = {"a": torch.as_tensor(rng.normal(0, 1, (4, 8)).astype(np.float32)).bfloat16(),
             "b": [torch.as_tensor(rng.normal(0, 1, 16).astype(np.float32))]}
    err = {"a": torch.full((4, 8), 0.01), "b": [torch.zeros(16)]}
    synced, new_err = make_pod_grad_sync(_Mesh(), scheme, 0.25)(grads, err)
    assert synced["a"].dtype == torch.bfloat16 and isinstance(synced["b"], list)
    for g, e, s, ne in ((grads["a"], err["a"], synced["a"], new_err["a"]),
                        (grads["b"][0], err["b"][0], synced["b"][0], new_err["b"][0])):
        if scheme == "int8":
            q, scale, want_err = C.ef_compress_int8(g, e)
            want = C.dequantize_int8(q, scale)
        elif scheme == "topk":
            want, want_err = C.ef_compress_topk(g, e, 0.25)
        else:
            want, want_err = g.float(), e
        assert torch.equal(s, want.to(g.dtype)) and torch.equal(ne, want_err)
