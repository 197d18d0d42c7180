"""The port's selective scan and Mamba block against the JAX package on the
same numpy inputs: the plain scan against the Pallas kernel in interpret mode
and the jnp oracle (2e-3 in float32, 5e-2 in bfloat16: tests/test_kernels.py),
the h0/h_S extension against ``_ssm_chunk_scan``, and ``_causal_conv``,
``mamba_forward``, ``mamba_decode`` and ``LM.decode_step`` on bridged f32
parameters of a reduced falcon_mamba_7b (2e-3)."""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import reduced  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.mamba_scan import mamba_scan as pallas_mamba  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro_torch.bridge import params_from_numpy, tensor_from_numpy  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.mamba_scan import mamba_scan_plain  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402

TOL = {"float32": 2e-3, "bfloat16": 5e-2}
SWEEP = [(2, 128, 64, 8, 32, 32), (1, 64, 128, 16, 64, 64), (2, 96, 32, 4, 32, 16)]


def _pair(a, dtype="float32"):
    """The same values as a JAX array and a torch tensor (bf16 bit for bit)."""
    j = jnp.asarray(a, dtype)
    return j, tensor_from_numpy(np.asarray(j))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _scan_inputs(rng, B, S, DI, N, dtype):
    """The JAX sweep's distributions (tests/test_kernels.py), drawn with numpy."""
    dt = np.log1p(np.exp(rng.standard_normal((B, S, DI)))) * 0.1
    return (_pair(dt.astype(np.float32), dtype),
            _pair(rng.standard_normal((B, S, DI), np.float32), dtype),
            _pair(rng.standard_normal((B, S, N), np.float32), dtype),
            _pair(rng.standard_normal((B, S, N), np.float32), dtype),
            _pair(-np.exp(rng.standard_normal((DI, N), np.float32) * 0.2)),
            _pair(rng.standard_normal((DI,), np.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,DI,N,chunk,bd", SWEEP)
def test_mamba_scan_plain_matches_pallas_and_oracle(B, S, DI, N, chunk, bd, dtype):
    rng = np.random.default_rng(B * S + DI + N)
    ins = _scan_inputs(rng, B, S, DI, N, dtype)
    jins = [j for j, _ in ins]
    tins = [t for _, t in ins]
    y, h = mamba_scan_plain(*tins)
    assert y.dtype == tins[1].dtype and y.shape == (B, S, DI)
    assert h.dtype == torch.float32 and h.shape == (B, DI, N)
    _close(y.float(), jref.mamba_scan_ref(*jins), TOL[dtype])
    _close(y.float(), pallas_mamba(*jins, chunk=chunk, block_d=bd, interpret=True),
           TOL[dtype])
    assert tref.mamba_scan_ref is mamba_scan_plain


@pytest.mark.parametrize("B,S,DI,N,chunk", [(2, 48, 32, 8, 16), (1, 20, 64, 16, 20)])
def test_mamba_scan_h0_and_final_state_match_chunk_scan(B, S, DI, N, chunk):
    """With a non-zero h0: y and h_S against the JAX model's chunked scan
    (which leaves D x to its caller)."""
    rng = np.random.default_rng(S + DI)
    dt, x, Bc, Cc, A, D = _scan_inputs(rng, B, S, DI, N, "float32")
    jh0, th0 = _pair(rng.standard_normal((B, DI, N), np.float32))
    jy, jh = jmamba._ssm_chunk_scan(dt[0], x[0], Bc[0], Cc[0], A[0], jh0, chunk)
    jy = jy + x[0] * D[0]
    y, h = mamba_scan_plain(dt[1], x[1], Bc[1], Cc[1], A[1], D[1], th0)
    _close(y, jy, TOL["float32"])
    _close(h, jh, TOL["float32"])
    assert not torch.equal(th0, h)          # h0 is read, not overwritten


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [4, 8, 16, 32])
def test_mamba_scan_resumes_from_its_final_state(N, dtype):
    """A scan cut in two, the first part's h_S the second's h0 (prefill
    handing its state on), is the scan of the whole, held against the JAX
    oracle, at every d_state the kernel takes."""
    from repro_torch.kernels.mamba_scan import STATE_DIMS

    assert N in STATE_DIMS
    B, S, DI, cut = 2, 24, 32, 13
    rng = np.random.default_rng(N)
    ins = _scan_inputs(rng, B, S, DI, N, dtype)
    tins = [t for _, t in ins]
    seq = lambda t, sl: t[:, sl] if t.dim() == 3 else t      # dt, x, B, C: [B,S,.]
    y1, h1 = mamba_scan_plain(*[seq(t, slice(0, cut)) for t in tins])
    y2, h2 = mamba_scan_plain(*[seq(t, slice(cut, S)) for t in tins], h1)
    y, h = mamba_scan_plain(*tins)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(h2, h, rtol=1e-6, atol=1e-6)
    _close(torch.cat([y1, y2], 1).float(), jref.mamba_scan_ref(*[j for j, _ in ins]), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_mamba_scan_on_cpu_is_the_plain_version(dtype):
    rng = np.random.default_rng(7)
    tins = [t for _, t in _scan_inputs(rng, 2, 40, 32, 16, dtype)]
    h0 = torch.as_tensor(rng.standard_normal((2, 32, 16), np.float32))
    for init in (None, h0):
        y, h = ops.mamba_scan(*tins, init)
        py, ph = mamba_scan_plain(*tins, init)
        torch.testing.assert_close(y, py, rtol=0, atol=0)
        torch.testing.assert_close(h, ph, rtol=0, atol=0)


def _cfg():
    return replace(reduced(jax_config("falcon_mamba_7b")), dtype="float32")


@pytest.fixture(scope="module")
def bridged():
    """JAX params of a reduced f32 falcon_mamba_7b, their port copies, and both
    models."""
    jcfg = _cfg()
    jm = jax_build(jcfg)
    params = jm.init_params(jax.random.PRNGKey(0))
    lm = LM(ModelConfig.from_json(jcfg.to_json()), device="cpu")
    lm.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params)))
    jp = jax.tree.map(lambda a: a[0], params["slots"][0])
    tp = lm.slots[0].period(0)
    return jcfg, jm, params, lm, jp, tp


@pytest.mark.parametrize("with_carry", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_jax(with_carry, dtype):
    rng = np.random.default_rng(11)
    jx, tx = _pair(rng.standard_normal((2, 9, 24), np.float32), dtype)
    jw, tw = _pair(rng.standard_normal((4, 24), np.float32), dtype)
    jc = tc = None
    if with_carry:
        jc, tc = _pair(rng.standard_normal((2, 3, 24), np.float32), dtype)
    jout, jcarry = jmamba._causal_conv(jx, jw, jc)
    tout, tcarry = tmamba._causal_conv(tx, tw, tc)
    assert tout.dtype == tx.dtype and tcarry.shape == (2, 3, 24)
    # the same products and adds in the same order, each rounded to x's type:
    # equal bit for bit, bf16 included
    _close(tout.float(), jout, 0)
    _close(tcarry.float(), jcarry, 0)


def test_softplus_is_jax_softplus():
    v = np.array([-80.0, -20.0, -1.5, 0.0, 0.3, 19.0, 21.0, 90.0], np.float32)
    got = tmamba.softplus(torch.as_tensor(v)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.softplus(jnp.asarray(v))),
                               rtol=1e-6, atol=1e-7)


def test_mamba_forward_matches_jax(bridged):
    jcfg, _, _, _, jp, tp = bridged
    rng = np.random.default_rng(2)
    jx, tx = _pair(rng.standard_normal((2, 12, jcfg.d_model), np.float32))
    jy, jcache = jmamba.mamba_forward(jx, jp, jcfg, chunk=4)
    ty, tcache = tmamba.mamba_forward(tx, tp, jcfg)
    _close(ty, jy, TOL["float32"])
    assert set(tcache) == {"conv", "ssm"} and tcache["ssm"].dtype == torch.float32
    for n in ("conv", "ssm"):
        assert tuple(tcache[n].shape) == jcache[n].shape
        _close(tcache[n], jcache[n], TOL["float32"])


def test_mamba_decode_matches_jax_and_writes_the_cache_in_place(bridged):
    jcfg, _, _, _, jp, tp = bridged
    m = jcfg.mamba
    rng = np.random.default_rng(3)
    jx, tx = _pair(rng.standard_normal((3, jcfg.d_model), np.float32))
    jconv, tconv = _pair(rng.standard_normal((3, m.d_conv - 1, m.d_inner), np.float32))
    jssm, tssm = _pair(rng.standard_normal((3, m.d_inner, m.d_state), np.float32))
    stacked = {"conv": torch.zeros((2, *tconv.shape)), "ssm": torch.zeros((2, *tssm.shape))}
    stacked["conv"][1], stacked["ssm"][1] = tconv, tssm
    layer = {n: c[1] for n, c in stacked.items()}        # views, as decode_step passes
    jy, jcache = jmamba.mamba_decode(jx, jp, jcfg, {"conv": jconv, "ssm": jssm})
    ty, tcache = tmamba.mamba_decode(tx, tp, jcfg, layer)
    _close(ty, jy, TOL["float32"])
    for n in ("conv", "ssm"):
        assert tcache[n] is layer[n]
        _close(stacked[n][1], jcache[n], TOL["float32"])
        assert stacked[n][0].abs().sum() == 0


def test_decode_step_advances_the_ssm_state(bridged):
    """Two decode steps on the in-place cache give the JAX package's
    second-step logits; a state that never advanced would not."""
    _, jm, params, lm, _, _ = bridged
    B, S0 = 2, 8
    toks = np.random.default_rng(4).integers(0, 128, (B, S0)).astype(np.int32)
    _, jcache = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks)})
    _, tcache = lm.prefill({"tokens": torch.as_tensor(toks)})
    before = [s["ssm"].clone() for s in tcache["slots"]]
    dec = jax.jit(jm.decode_step)
    for t, tok in enumerate(([5, 9], [17, 3])):
        tok = np.array(tok, np.int32)
        pos = np.full((B,), S0 + t, np.int32)
        jlg, jcache = dec(params, jcache, {"token": jnp.asarray(tok), "pos": jnp.asarray(pos)})
        tlg, tcache = lm.decode_step(tcache, {"token": torch.as_tensor(tok),
                                              "pos": torch.as_tensor(pos)})
    _close(tlg, jlg, TOL["float32"])
    for ts, js, b in zip(tcache["slots"], jcache["slots"], before):
        assert not torch.equal(ts["ssm"], b)
        for n in ("conv", "ssm"):
            _close(ts[n], js[n], TOL["float32"])


def test_slot_cache_admits_the_mamba_state_whole():
    from repro_torch.serving.kv_cache import SlotCache

    lm = LM(ModelConfig.from_json(reduced(jax_config("falcon_mamba_7b")).to_json()),
            device="cpu", seed=1)
    kv = SlotCache(lm, slots=3, max_len=32)
    toks = torch.as_tensor(np.random.default_rng(5).integers(0, 128, (1, 16)), dtype=torch.int32)
    _, pc = lm.prefill({"tokens": toks})
    kv.admit(1, pc, 16, rid=7, gen_tokens=2)
    (c,), (p,) = kv.cache["slots"], pc["slots"]
    assert c["conv"].dtype == p["conv"].dtype == torch.bfloat16
    assert c["ssm"].dtype == p["ssm"].dtype == torch.float32
    for n in ("conv", "ssm"):
        assert torch.equal(c[n][:, 1], p[n][:, 0])
        assert c[n][:, 0].abs().sum() == 0 and c[n][:, 2].abs().sum() == 0
    assert kv.pos[1] == 16 and kv.active.tolist() == [False, True, False]
