"""The port's frontends against the JAX package's on the same inputs:
``phi3_vision`` (patches: ``patch_embeds @ patch_proj`` over the first P
positions) and ``hubert_xlarge`` (frames in place of tokens, bidirectional,
sinusoidal positions), reduced, in float32 and bfloat16.

Weights cross through ``bridge.params_from_numpy``; inputs are drawn from a
numpy seed, as ``tests/test_models.py:11-21`` shapes them. Tolerances, none
looser than the reference's: float32 outputs within 2e-3
(tests/test_decode_parity.py), float32 gradients within rtol 1e-3, atol
1e-4 (tests/test_attention.py:40), bfloat16 inputs, losses and gradients
within 2e-2 (tests/test_kernels.py:18). The bfloat16 hidden states, logits
and caches of a whole model are held as the reference holds its own bf16
model (tests/test_decode_parity.py:61, "exactness is the f32 test's job"):
their error's norm within 2e-2 of the reference's norm and no element off
by 0.25 or more. Both packages round each layer's output to bfloat16, in
other orders (the JAX blocked attention and the port's plain one), so a
few elements of a 2-layer model land 2-3 bf16 steps apart.
"""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import reduced  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.models import LM  # noqa: E402

TOL = {"float32": (2e-3, 2e-3), "bfloat16": (2e-2, 2e-2)}
GRAD_TOL = {"float32": (1e-3, 1e-4), "bfloat16": (2e-2, 2e-2)}
BLOCK = 16          # the attention block both packages' blocked attention take
DTYPES = ["float32", "bfloat16"]
ARCHS = ["phi3_vision", "hubert_xlarge"]


def _models(arch, dtype, seed=0):
    jcfg = replace(reduced(jax_config(arch)), dtype=dtype)
    jm = jax_build(jcfg, attn_block=BLOCK)
    params = jm.init_params(jax.random.PRNGKey(seed))
    lm = LM(ModelConfig.from_json(jcfg.to_json()), device="cpu", attn_block=BLOCK)
    lm.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params)))
    return jcfg, jm, params, lm


def _batch(cfg, B=2, S=32, seed=5):
    """numpy inputs, float32 where the model casts them: frames, or tokens
    and patch embeddings; labels and a 0/1 loss mask."""
    rng = np.random.default_rng(seed)
    b = {"labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "frames":
        b["frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        b["loss_mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        b["patch_embeds"] = rng.standard_normal((B, cfg.num_patches, cfg.d_model)
                                                ).astype(np.float32)
    return b


def _port(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _close(got, want, tol, msg=""):
    rtol, atol = tol
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol, err_msg=msg)


def _model_close(got, want, dtype, msg=""):
    """A whole model's outputs: elementwise in float32, bounded drift in bf16."""
    if dtype == "float32":
        return _close(got, want, TOL[dtype], msg)
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, msg
    rel = np.linalg.norm(g - w) / np.linalg.norm(w)
    assert rel <= TOL[dtype][0] and np.abs(g - w).max() < 0.25, (msg, rel, np.abs(g - w).max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_embed_input_matches_jax(arch, dtype):
    jcfg, jm, params, lm = _models(arch, dtype)
    batch = _batch(jcfg)
    want = jm.embed_input(params, batch)
    got = lm.embed_input(_port(batch))
    assert got.dtype == lm.dtype and tuple(got.shape) == want.shape
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_seq_matches_jax(arch, dtype):
    jcfg, jm, params, lm = _models(arch, dtype)
    batch = _batch(jcfg)
    want, _ = jm.forward_seq(params, batch, want_cache=False)
    with torch.no_grad():
        got, _ = lm.forward_seq(_port(batch), want_cache=False)
    assert tuple(got.shape) == want.shape
    _model_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_hubert_prefill_matches_jax(dtype):
    """The encoder's prefill: last-position logits from the output head and
    every layer's k/v."""
    jcfg, jm, params, lm = _models("hubert_xlarge", dtype)
    batch = _batch(jcfg)
    batch.pop("labels")
    jlg, jcache = jm.prefill(params, batch)
    tlg, tcache = lm.prefill(_port(batch))
    _model_close(tlg, jlg, dtype, "logits")
    for cs, js in zip(tcache["slots"], jcache["slots"]):
        for n in cs:
            _model_close(cs[n], js[n], dtype, n)


@pytest.mark.parametrize("dtype", DTYPES)
def test_phi3_prefill_and_decode_match_jax(dtype, B=2, S0=16, W=32, steps=4):
    """A prefill whose first P positions are projected patch embeddings, then
    4 greedy decode steps against the cache: logits at every step, greedy
    tokens, the caches at the end."""
    jcfg, jm, params, lm = _models("phi3_vision", dtype)
    batch = _batch(jcfg, B=B, S=S0)
    batch.pop("labels")
    jlg, jcache = jax.jit(jm.prefill)(params, batch)
    tlg, tcache = lm.prefill(_port(batch))
    jcache = jax.tree.map(lambda d, s: d.at[:, :, :s.shape[2]].set(s.astype(d.dtype)),
                          jm.init_cache(B, W), jcache)
    cache = lm.init_cache(B, W)
    for cs, ps in zip(cache["slots"], tcache["slots"]):
        for n in cs:
            cs[n][:, :, :ps[n].shape[2]] = ps[n]
    dec = jax.jit(jm.decode_step)
    for t in range(S0, S0 + steps + 1):
        _model_close(tlg, jlg, dtype, f"logits at {t - 1}")
        tok = np.array(jnp.argmax(jlg, -1), np.int32)
        if dtype == "float32":
            np.testing.assert_array_equal(tlg.argmax(-1).numpy(), tok)
        if t == S0 + steps:
            break
        pos = np.full((B,), t, np.int32)
        jlg, jcache = dec(params, jcache, {"token": jnp.asarray(tok), "pos": jnp.asarray(pos)})
        tlg, cache = lm.decode_step(cache, {"token": torch.as_tensor(tok),
                                            "pos": torch.as_tensor(pos)})
    for cs, js in zip(cache["slots"], jcache["slots"]):
        for n in cs:
            _model_close(cs[n], js[n], dtype, n)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch, dtype):
    """``loss_fn`` on a frames batch with a loss mask (hubert) and on tokens
    with patch embeddings (phi3), and its gradient in every parameter,
    against ``jax.grad`` of the JAX function; ``remat`` on as the configs
    have it."""
    jcfg, jm, params, lm = _models(arch, dtype)
    assert jcfg.remat
    batch = _batch(jcfg)
    (jloss, jmet), jgrads = jax.value_and_grad(jm.loss_fn, has_aux=True)(params, batch)
    P = {n: p.detach().clone().requires_grad_() for n, p in lm.params().items()}
    loss, metrics = lm.loss_fn(P, _port(batch))
    grads = dict(zip(P, torch.autograd.grad(loss, list(P.values()))))
    _close(loss.detach(), jloss, TOL[dtype], "loss")
    _close(metrics["ce"].detach(), jmet["ce"], TOL[dtype], "ce")
    want = params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), jgrads))
    assert set(grads) == set(want)
    for n, g in grads.items():
        assert g.dtype == lm.dtype, n
        _close(g, want[n], GRAD_TOL[dtype], n)
    assert ("patch_proj" in grads) == (arch == "phi3_vision")
    if arch == "phi3_vision":
        assert float(grads["patch_proj"].float().abs().sum()) > 0


@pytest.mark.parametrize("S", [32, 4, 2], ids=["S_past_P", "S_equal_P", "S_below_P"])
def test_patch_scatter_matches_jax(S):
    """A change of the patch embeddings changes the first P positions and no
    other, as in the JAX package; with S < P the JAX ``concatenate`` gives P
    positions, and so does the port."""
    jcfg, jm, params, lm = _models("phi3_vision", "float32")
    batch = _batch(jcfg, S=S)
    b2 = dict(batch, patch_embeds=batch["patch_embeds"] + 1.0)
    j1, j2 = jm.embed_input(params, batch), jm.embed_input(params, b2)
    t1, t2 = lm.embed_input(_port(batch)), lm.embed_input(_port(b2))
    assert tuple(t1.shape) == j1.shape == (2, max(S, jcfg.num_patches), jcfg.d_model)
    changed_j = np.any(np.asarray(j1) != np.asarray(j2), axis=(0, 2))
    changed_t = torch.any(t1 != t2, dim=2).any(0).numpy()
    np.testing.assert_array_equal(changed_t, changed_j)
    assert changed_t[:jcfg.num_patches].all() and not changed_t[jcfg.num_patches:].any()
    _close(t1, j1, TOL["float32"])


def test_tokens_without_patches_embed_as_tokens():
    """A phi3 batch without ``patch_embeds`` (a decode prompt, a text-only
    prefill) is the tokens' embedding, as in the JAX function."""
    jcfg, jm, params, lm = _models("phi3_vision", "float32")
    batch = {"tokens": _batch(jcfg)["tokens"]}
    _close(lm.embed_input(_port(batch)), jm.embed_input(params, batch), (0, 0))


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_set_follows_the_jax_tree(arch):
    """Names and shapes of the JAX ``init_params`` tree: no ``embed`` for
    frames, ``unembed`` for frames and untied configs, ``patch_proj`` (D, D)
    for patches; the weights are drawn from the seed on the CPU."""
    jcfg, jm, params, lm = _models(arch, "bfloat16")
    flat = params_from_numpy(jax.tree.map(np.asarray, params))
    fresh = LM(lm.cfg, device="cpu", seed=3).state_dict()
    assert list(fresh) == list(lm.state_dict()) and set(fresh) == set(flat)
    for name, t in fresh.items():
        assert tuple(t.shape) == tuple(flat[name].shape) and t.dtype == torch.bfloat16, name
    D = jcfg.d_model
    if arch == "phi3_vision":
        assert tuple(fresh["patch_proj"].shape) == (D, D) and "embed" in fresh
        assert fresh["patch_proj"].float().std() > 0
    else:
        assert "embed" not in fresh and "patch_proj" not in fresh
    assert tuple(fresh["unembed"].shape) == (jcfg.vocab_size, D)
    assert lm.device.type == "cpu" and lm.dtype == torch.bfloat16
