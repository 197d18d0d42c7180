"""The port's attention block against the JAX package's: sequence mode (with
the ring-cache roll of local layers), decode against linear and ring caches,
and the cache write at slot >= W that JAX's scatter drops."""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import reduced  # noqa: E402
from repro.models import attention as ja  # noqa: E402
from repro_torch.bridge import params_from_numpy, tensor_from_numpy  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402

TOL = 2e-4


def _cfg(arch):
    """A reduced f32 config, as the JAX package's and as the port's."""
    jc = replace(reduced(jax_config(arch)), dtype="float32")
    return jc, ModelConfig.from_json(jc.to_json())


def _params(cfg, rng):
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {"wq": (D, H * hd), "wk": (D, KV * hd), "wv": (D, KV * hd), "wo": (H * hd, D)}
    if cfg.qk_norm:
        shapes.update(q_norm=(hd,), k_norm=(hd,))
    p = {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in shapes.items()}
    return {n: jnp.asarray(a) for n, a in p.items()}, params_from_numpy(p)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch,local,S", [
    ("deepseek_coder_33b", False, 24),   # plain GQA
    ("qwen3_32b", False, 16),            # qk_norm
    ("gemma3_12b", True, 40),            # sliding window, S > window: ring roll
    ("gemma3_12b", True, 12),            # sliding window, S <= window
])
def test_attn_forward(arch, local, S):
    jc, tc = _cfg(arch)
    rng = np.random.default_rng(S)
    jp, tp = _params(jc, rng)
    x = rng.standard_normal((2, S, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    jy, jcache = ja.attn_forward(jnp.asarray(x), jp, jc, local, jnp.asarray(pos),
                                 theta=jc.rope_theta)
    ty, tcache = ta.attn_forward(torch.as_tensor(x), tp, tc, local, torch.as_tensor(pos),
                                 theta=tc.rope_theta)
    _close(ty, jy)
    for n in ("k", "v"):
        assert tuple(tcache[n].shape) == jcache[n].shape
        _close(tcache[n], jcache[n])


@pytest.mark.parametrize("arch,local,W,positions", [
    ("deepseek_coder_33b", False, 32, [16, 31]),
    ("qwen3_32b", False, 32, [0, 20]),
    ("gemma3_12b", True, 16, [5, 40]),      # ring: one row wrapped, one not
])
def test_attn_decode(arch, local, W, positions):
    jc, tc = _cfg(arch)
    if local:
        assert W == jc.sliding_window
    rng = np.random.default_rng(W)
    jp, tp = _params(jc, rng)
    B = len(positions)
    x = rng.standard_normal((B, jc.d_model)).astype(np.float32)
    cache = {n: rng.standard_normal((B, W, jc.num_kv_heads, jc.head_dim)).astype(np.float32)
             for n in ("k", "v")}
    pos = np.asarray(positions, np.int32)
    jy, jcache = ja.attn_decode(jnp.asarray(x), jp, jc, local,
                                {n: jnp.asarray(a) for n, a in cache.items()},
                                jnp.asarray(pos), theta=jc.rope_theta)
    tcache = {n: tensor_from_numpy(a) for n, a in cache.items()}
    ty, tcache2 = ta.attn_decode(torch.as_tensor(x), tp, tc, local, tcache,
                                 torch.as_tensor(pos), theta=tc.rope_theta)
    _close(ty, jy)
    for n in ("k", "v"):
        assert tcache2[n] is tcache[n]            # written in place
        _close(tcache[n], jcache[n])


def test_update_cache_drops_write_past_width():
    """JAX's scatter drops a write at slot >= W; the port drops it too (torch
    indexing would raise). The engine reaches this when a prompt buckets to
    max_len."""
    rng = np.random.default_rng(0)
    cache = rng.standard_normal((3, 8, 2, 4)).astype(np.float32)
    new = rng.standard_normal((3, 2, 4)).astype(np.float32)
    slot = np.array([2, 8, 11], np.int32)
    want = np.asarray(ja._update_cache(jnp.asarray(cache), jnp.asarray(new),
                                       jnp.asarray(slot)))
    got = torch.as_tensor(cache.copy())
    ta._update_cache(got, torch.as_tensor(new), torch.as_tensor(slot))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[1:].numpy(), cache[1:])   # rows 1, 2 untouched
    np.testing.assert_array_equal(got[0, 2].numpy(), new[0])


def test_attend_plain_and_decode_agree():
    """The last row of causal sequence attention is one decode step."""
    rng = np.random.default_rng(1)
    q = torch.as_tensor(rng.standard_normal((2, 10, 4, 16)).astype(np.float32))
    k = torch.as_tensor(rng.standard_normal((2, 10, 2, 16)).astype(np.float32))
    v = torch.as_tensor(rng.standard_normal((2, 10, 2, 16)).astype(np.float32))
    seq = ta.attend_plain(q, k, v, causal=True)
    dec = ta.attend_decode(q[:, -1], k, v, torch.full((2,), 9, dtype=torch.int32))
    torch.testing.assert_close(dec, seq[:, -1], rtol=TOL, atol=TOL)
