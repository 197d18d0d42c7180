"""The port's training attention against the JAX package's ``attend_blocked``:
the blocked forward with its logsumexp, the flash backward (B1b's plain
version) and the autograd path of ``attend_blocked``, on the same numpy
inputs. Tolerances: the reference's own, f32 outputs and logsumexps within
2e-4 (tests/test_kernels.py:17) and f32 gradients within rtol 1e-3, atol
1e-4 (tests/test_attention.py:40); bf16 within 2e-2 (tests/test_kernels.py:18)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as JA  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as fb  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402

OUT_TOL = 2e-4
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4
BF16_TOL = 2e-2

# tests/test_attention.py's cases: causal, GQA, bidirectional, window, MQA
CASES = [
    dict(B=2, S=32, H=4, KV=2, hd=8, causal=True, window=0, blk=8),
    dict(B=1, S=48, H=6, KV=3, hd=16, causal=True, window=0, blk=16),
    dict(B=2, S=32, H=4, KV=4, hd=8, causal=False, window=0, blk=8),
    dict(B=2, S=64, H=4, KV=2, hd=8, causal=True, window=12, blk=16),
    dict(B=1, S=64, H=8, KV=1, hd=8, causal=True, window=0, blk=32),
    dict(B=1, S=32, H=4, KV=2, hd=16, causal=False, window=10, blk=8),
]
IDS = [f"S{c['S']}-H{c['H']}-KV{c['KV']}-{'causal' if c['causal'] else 'bidir'}"
       f"-w{c['window']}-blk{c['blk']}" for c in CASES]


def _inputs(c, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    shapes = {"q": (c["B"], c["S"], c["H"], c["hd"]), "k": (c["B"], c["S"], c["KV"], c["hd"]),
              "v": (c["B"], c["S"], c["KV"], c["hd"]), "dout": (c["B"], c["S"], c["H"], c["hd"])}
    arrs = {n: rng.standard_normal(s, dtype=np.float32) for n, s in shapes.items()}
    jx = {n: jnp.asarray(a).astype(dtype) for n, a in arrs.items()}
    tt = {n: tensor_from_numpy(np.asarray(a)) for n, a in jx.items()}
    return jx, tt


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("c", CASES, ids=IDS)
def test_blocked_forward_and_lse_match_jax(c):
    jx, tt = _inputs(c, 1)
    out, lse = JA._attend_fwd_impl(jx["q"], jx["k"], jx["v"], c["causal"], c["window"],
                                   c["blk"], False)
    tout, tlse = fb.attend_fwd_plain(tt["q"], tt["k"], tt["v"], causal=c["causal"],
                                     window=c["window"], block=c["blk"])
    assert tlse.shape == lse.shape and tlse.dtype == torch.float32
    _close(tout, out, OUT_TOL, OUT_TOL, "out")
    _close(tlse, lse, OUT_TOL, OUT_TOL, "lse")
    # B1's plain version gives the same logsumexp from materialized scores
    pout, plse = fa.flash_attention_plain(tt["q"], tt["k"], tt["v"], causal=c["causal"],
                                          window=c["window"], return_lse=True)
    _close(pout, out, OUT_TOL, OUT_TOL, "flash_attention_plain out")
    _close(plse, lse, OUT_TOL, OUT_TOL, "flash_attention_plain lse")
    oout, olse = ops.flash_attention_lse(tt["q"], tt["k"], tt["v"], causal=c["causal"],
                                         window=c["window"], block=c["blk"])
    assert torch.equal(oout, tout) and torch.equal(olse, tlse)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", CASES, ids=IDS)
def test_backward_plain_matches_jax_attend_bwd_impl(c, dtype):
    """B1b's plain version on the JAX forward's residuals, against the JAX
    package's ``_attend_bwd_impl`` on the same ones."""
    jx, _ = _inputs(c, 2, dtype)
    out, lse = JA._attend_fwd_impl(jx["q"], jx["k"], jx["v"], c["causal"], c["window"],
                                   c["blk"], False)
    want = JA._attend_bwd_impl((jx["q"], jx["k"], jx["v"], out, lse), jx["dout"],
                               c["causal"], c["window"], c["blk"], False)
    args = [tensor_from_numpy(np.asarray(a)) for a in (jx["q"], jx["k"], jx["v"], out, lse,
                                                       jx["dout"])]
    got = fb.flash_attention_bwd_plain(*args, causal=c["causal"], window=c["window"],
                                       block=c["blk"])
    via_ops = ops.flash_attention_bwd(*args, causal=c["causal"], window=c["window"],
                                      block=c["blk"])
    for name, g, w, o in zip(("dq", "dk", "dv"), got, want, via_ops):
        assert g.dtype == args[0].dtype and g.shape == tuple(w.shape)
        assert torch.equal(g, o)
        if dtype == "float32":
            _close(g, w, GRAD_RTOL, GRAD_ATOL, name)
        else:
            _close(g, w, BF16_TOL, BF16_TOL, name)


@pytest.mark.parametrize("c", CASES, ids=IDS)
def test_attend_blocked_output_and_grads_match_jax(c):
    """The autograd Function end to end against ``jax.vjp`` of the JAX
    ``attend_blocked``, cotangent from numpy."""
    jx, tt = _inputs(c, 3)
    kw = dict(causal=c["causal"], window=c["window"], block=c["blk"])
    out, vjp = jax.vjp(lambda q, k, v: JA.attend_blocked(q, k, v, **kw),
                       jx["q"], jx["k"], jx["v"])
    want = vjp(jx["dout"])
    leaves = [tt[n].clone().requires_grad_() for n in ("q", "k", "v")]
    tout = TA.attend_blocked(*leaves, **kw)
    _close(tout, out, OUT_TOL, OUT_TOL, "out")
    got = torch.autograd.grad(tout, leaves, tt["dout"])
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, GRAD_RTOL, GRAD_ATOL, name)


def test_attn_forward_takes_attend_blocked_only_under_autograd(monkeypatch):
    """With grad recorded the block goes through ``attend_blocked`` (B1 with
    its logsumexp, then B1b, on the card); without, through the serving call."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import LM

    cfg = replace(get_config("tiny_lm"), num_layers=1, dtype="float32", vocab_size=64)
    lm = LM(cfg, device="cpu", attn_block=8)
    calls = []
    real = ops.flash_attention_lse
    monkeypatch.setattr(ops, "flash_attention_lse",
                        lambda *a, **kw: calls.append(kw["block"]) or real(*a, **kw))
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, 64, (2, 16)))
    lm.prefill({"tokens": toks})
    assert calls == []
    P = {n: p.detach().requires_grad_() for n, p in lm.params().items()}
    loss, _ = lm.loss_fn(P, {"tokens": toks, "labels": toks})
    assert calls == [8]
    loss.backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in P.values())


def test_attend_blocked_refuses_a_block_that_does_not_divide_s():
    q = torch.zeros(1, 24, 2, 8)
    with pytest.raises(ValueError, match="multiple of block"):
        TA.attend_blocked(q, q, q, causal=True, block=16)


def test_flash_attention_bwd_wrapper_refuses_non_cuda_tensors():
    q = torch.zeros(1, 16, 2, 16)
    lse = torch.zeros(1, 16, 1, 2)
    with pytest.raises(ValueError, match="CUDA kernel"):
        fb.flash_attention_bwd(q, q[:, :, :1], q[:, :, :1], q, lse, q)
    m = q.to("meta")
    with pytest.raises(ValueError, match="CUDA kernel"):
        ops.flash_attention_bwd(m, m[:, :, :1], m[:, :, :1], m, lse.to("meta"), m)
    assert fb.flash_attention_bwd.launches == 0


def test_block_pairs_and_masks_are_the_jax_package_s():
    for nb, causal, wb in ((8, True, 0), (8, False, 0), (8, True, 2), (5, False, 1)):
        np.testing.assert_array_equal(
            fb._block_pairs(nb, nb, causal=causal, window_blocks=wb),
            JA._block_pairs(nb, nb, causal=causal, window_blocks=wb))
    for i, j, causal, window in ((2, 1, True, 0), (3, 3, True, 12), (1, 2, False, 5)):
        np.testing.assert_array_equal(
            fb._pair_mask(i, j, 8, causal, window, "cpu").numpy(),
            np.asarray(JA._pair_mask(i, j, 8, causal, window)))


def test_b1b_routes_by_type_and_names_its_kernels():
    """B1b takes bfloat16 through the tensor cores and float32 through the FMA
    loop; each route names the two CUDA kernels it launches (the names the
    profiler shows, none inside another), each defined in the source; a CPU
    tensor of either type is refused before any check, build or launch."""
    from repro_torch.kernels import build
    assert set(fb.ROUTES) == set(fb.KERNELS) == set(fb._DTYPES) == {torch.float32,
                                                                   torch.bfloat16}
    assert "tensor cores" in fb.ROUTES[torch.bfloat16] and "FMA" in fb.ROUTES[torch.float32]
    names = [n for dtype in fb.KERNELS for n in fb.KERNELS[dtype]]
    assert len(set(names)) == 4 and all(len(fb.KERNELS[d]) == 2 for d in fb.KERNELS)
    assert not any(a != b and a in b for a in names for b in names)
    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    assert all(f"{n}(" in src for n in names)
    for dtype in fb.ROUTES:
        q = torch.zeros(1, 17, 2, 18, dtype=dtype)[..., 2:]     # rows off 16 bytes
        lse = torch.zeros(1, 17, 1, 2)
        with pytest.raises(ValueError, match="CUDA kernel"):
            fb.flash_attention_bwd(q, q[:, :, :1], q[:, :, :1], q, lse, q)
    assert fb.flash_attention_bwd.launches == 0
