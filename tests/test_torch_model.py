"""The port's LM against the JAX package's on bridged weights, in f32:
prefill and decode logits within 2e-3 (tests/test_decode_parity.py) and
equal greedy tokens."""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import reduced  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.bridge import params_from_numpy, tensor_from_numpy  # noqa: E402
from repro_torch.configs import ModelConfig, get_config  # noqa: E402
from repro_torch.models import LM  # noqa: E402

TOL = 2e-3


def _jax_and_port(jcfg, seed=0):
    jm = jax_build(jcfg)
    params = jm.init_params(jax.random.PRNGKey(seed))
    lm = LM(ModelConfig.from_json(jcfg.to_json()), device="cpu")
    lm.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params)))
    return jm, params, lm


def _run_parity(jcfg, B=2, S0=16, steps=4, W=32):
    jm, params, lm = _jax_and_port(jcfg)
    rng = np.random.default_rng(jcfg.num_layers)
    toks = rng.integers(0, jcfg.vocab_size, (B, S0)).astype(np.int32)
    jlg, jcache = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks)})
    tlg, tcache = lm.prefill({"tokens": torch.as_tensor(toks)})
    # attention k/v fill the first S0 rows of width W; Mamba conv/ssm go in whole
    jcache = jax.tree.map(lambda d, s: d.at[:, :, :s.shape[2]].set(s.astype(d.dtype)),
                          jm.init_cache(B, W), jcache)
    cache = lm.init_cache(B, W)
    for cs, ps in zip(cache["slots"], tcache["slots"]):
        for n in cs:
            assert ps[n].dtype == cs[n].dtype, n
            cs[n][:, :, :ps[n].shape[2]] = ps[n]
    dec = jax.jit(jm.decode_step)
    for t in range(S0, S0 + steps + 1):
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), rtol=TOL, atol=TOL,
                                   err_msg=f"{jcfg.name} logits at {t - 1}")
        tok = np.array(jnp.argmax(jlg, -1), np.int32)
        np.testing.assert_array_equal(tlg.argmax(-1).numpy(), tok)
        if t == S0 + steps:
            break
        pos = np.full((B,), t, np.int32)
        jlg, jcache = dec(params, jcache, {"token": jnp.asarray(tok), "pos": jnp.asarray(pos)})
        tlg, cache = lm.decode_step(cache, {"token": torch.as_tensor(tok),
                                            "pos": torch.as_tensor(pos)})
    for cs, js in zip(cache["slots"], jcache["slots"]):
        for n in cs:
            np.testing.assert_allclose(cs[n].numpy(), np.asarray(js[n]), rtol=TOL, atol=TOL)


def test_tiny_lm_full_width_f32_parity():
    _run_parity(replace(jax_config("tiny_lm"), dtype="float32"))


def test_small_lm_reduced_f32_parity():
    _run_parity(replace(jax_config("small_lm"), dtype="float32", num_layers=2,
                        vocab_size=1024))


def test_gemma3_reduced_ring_f32_parity():
    """Local layers keep ring caches of the window's width (W = 16 < 24)."""
    _run_parity(replace(reduced(jax_config("gemma3_12b")), dtype="float32"), S0=20, W=24)


def test_falcon_mamba_reduced_f32_parity():
    """Mamba slots: logits, greedy tokens and the final conv/ssm caches."""
    _run_parity(replace(reduced(jax_config("falcon_mamba_7b")), dtype="float32"))


@pytest.mark.parametrize("arch", ["moonshot_v1_16b", "jamba15_large", "grok1_314b"])
def test_moe_families_reduced_f32_parity(arch):
    """MoE slots at the default capacity factor, so the prefill drops
    assignments: moonshot (every layer MoE), jamba (MoE on every 2nd layer, a
    dense MLP on the others, inside its 8-layer Mamba/attention period) and
    grok (8 experts, top-2, GQA)."""
    _run_parity(replace(reduced(jax_config(arch)), dtype="float32"))


def test_falcon_mamba_state_dict_and_caches_follow_the_jax_tree():
    jcfg = reduced(jax_config("falcon_mamba_7b"))
    jm = jax_build(jcfg)
    lm = LM(ModelConfig.from_json(jcfg.to_json()), device="cpu")
    flat = params_from_numpy(jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(1))))
    assert set(flat) == set(lm.state_dict())
    for name, t in lm.state_dict().items():
        assert tuple(t.shape) == tuple(flat[name].shape), name
        assert t.dtype == torch.bfloat16 == flat[name].dtype
    jspecs, _ = jm.cache_specs(3, 32)
    for cs, js in zip(lm.init_cache(3, 32)["slots"], jspecs["slots"]):
        assert set(cs) == set(js) == {"conv", "ssm"}
        for n, t in cs.items():
            assert tuple(t.shape) == js[n].shape, n
        assert cs["conv"].dtype == torch.bfloat16 and cs["ssm"].dtype == torch.float32
    p = lm.state_dict()
    n = jcfg.mamba.d_state
    want_a = torch.log(torch.arange(1, n + 1, dtype=torch.float32)).to(torch.bfloat16)
    assert torch.equal(p["slots.0.A_log"][1, 5], want_a)
    dt = torch.nn.functional.softplus(p["slots.0.dt_bias"].float())
    assert 0.9e-3 < dt.min() and dt.max() < 0.11      # inverse softplus of [1e-3, 1e-1]
    assert torch.equal(p["slots.0.D"], torch.ones_like(p["slots.0.D"]))


def test_state_dict_names_follow_the_jax_tree():
    jm = jax_build(jax_config("tiny_lm"))
    lm = LM(get_config("tiny_lm"), device="cpu")
    flat = params_from_numpy(jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(1))))
    assert set(flat) == set(lm.state_dict())
    for name, t in lm.state_dict().items():
        assert tuple(t.shape) == tuple(flat[name].shape), name
        assert t.dtype == torch.bfloat16 == flat[name].dtype
    assert lm.param_specs()["slots"][0]["wq"].shape == (4, 256, 256)


def test_bridge_keeps_bf16_bits():
    a = np.asarray(jnp.asarray(np.linspace(-3, 3, 97, dtype=np.float32), jnp.bfloat16))
    t = tensor_from_numpy(a)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16))


def test_weights_follow_the_seed():
    a = LM(get_config("tiny_lm"), device="cpu", seed=5).state_dict()
    b = LM(get_config("tiny_lm"), device="cpu", seed=5).state_dict()
    c = LM(get_config("tiny_lm"), device="cpu", seed=6).state_dict()
    for n in a:
        torch.testing.assert_close(a[n], b[n], rtol=0, atol=0)
    assert not torch.equal(a["slots.0.wq"], c["slots.0.wq"])
    assert a["final_norm"].abs().sum() == 0         # norms start at zero: scale 1 + w


@pytest.mark.parametrize("arch", ["phi3_vision", "hubert_xlarge"])
def test_frontend_families_build_with_the_jax_parameter_set(arch):
    """The frontends are ported: phi3_vision (patches: ``patch_proj``, an
    untied ``unembed``) and hubert_xlarge (frames: no ``embed``) build on the
    CPU with the JAX parameter tree's names and shapes."""
    jcfg = reduced(jax_config(arch))
    lm = LM(ModelConfig.from_json(jcfg.to_json()), device="cpu")
    flat = params_from_numpy(jax.tree.map(np.asarray,
                                          jax_build(jcfg).init_params(jax.random.PRNGKey(1))))
    assert set(flat) == set(lm.state_dict())
    for name, t in lm.state_dict().items():
        assert tuple(t.shape) == tuple(flat[name].shape), name
    assert ("patch_proj" in flat) == (arch == "phi3_vision")
    assert ("embed" in flat) == (arch != "hubert_xlarge") and "unembed" in flat
