"""The plain backward versions of the selective scan (B3b) and the grouped
matmul (B4b) against the JAX package's autodiff, and the port's autograd
Functions against autograd through the plain forwards, on the CPU.

* ``mamba_scan_bwd_plain`` against ``jax.vjp`` of
  ``repro.kernels.ref.mamba_scan_ref`` (y from zeros, the D term) and of
  ``repro.models.mamba._ssm_chunk_scan`` (h0, dh_S and dh0);
* ``grouped_matmul_bwd_plain`` against ``jax.vjp`` of
  ``repro.kernels.ref.grouped_matmul_ref`` on layouts from ``build_layout``:
  with drops, with an expert that gets no rows, with trailing padding
  blocks, at every ``block_t``;
* ``ops.mamba_scan``, ``ops.grouped_matmul`` and ``moe_forward``'s dispatch
  and combine under autograd against autograd through the plain forwards;
* the chunk states of the plain forward at several ``T_c``, 16 (``state_chunk``) among them.

Inputs are float32 from seeded numpy. Tolerance: rtol 1e-3, atol 1e-4, the
reference's gradient tolerance (tests/test_attention.py:40).
"""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import reduced  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.mamba import _ssm_chunk_scan  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.mamba_scan import (associative_scan, mamba_scan_chunked,  # noqa: E402
                                            mamba_scan_plain, state_chunk)
from repro_torch.kernels.mamba_scan_bwd import (ScanGrads, block_channels,  # noqa: E402
                                                mamba_scan_bwd_chunked, mamba_scan_bwd_plain)
from repro_torch.kernels.moe_gmm import grouped_matmul_bwd_plain, grouped_matmul_plain  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

RTOL, ATOL = 1e-3, 1e-4


def _close(got, want, name=""):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL, err_msg=name)


def _scan_inputs(Bt, S, DI, N, seed, big_dt=False):
    """dt, x, B, C, A, D (and h0, dy, dh_S) as numpy float32. ``big_dt``
    draws steps where exp(dt A) underflows to 0 in float32."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((Bt, S, DI)))) * 0.5
    if big_dt:
        dt[:, ::5] *= 400.0
    A = -np.exp(0.5 * rng.standard_normal((DI, N)))
    ins = [dt, rng.standard_normal((Bt, S, DI)), rng.standard_normal((Bt, S, N)),
           rng.standard_normal((Bt, S, N)), A, rng.standard_normal(DI),
           rng.standard_normal((Bt, DI, N)), rng.standard_normal((Bt, S, DI)),
           rng.standard_normal((Bt, DI, N))]
    return [a.astype(np.float32) for a in ins]


def _plain_bwd(dt, x, B, C, A, D, h0, dy, dh_S, chunk):
    t = [torch.as_tensor(a) for a in (dt, x, B, C, A, D)]
    h0 = None if h0 is None else torch.as_tensor(h0)
    _, _, states = mamba_scan_plain(*t, h0, chunk=chunk)
    return mamba_scan_bwd_plain(*t, states, torch.as_tensor(dy),
                                None if dh_S is None else torch.as_tensor(dh_S), chunk=chunk)


@pytest.mark.parametrize("Bt,S,DI,N,chunk", [
    (2, 32, 16, 8, 8), (1, 40, 12, 4, 16), (2, 24, 8, 16, 32), (1, 17, 8, 32, 16),
    (2, 40, 12, 16, 16), (1, 33, 8, 8, 16)])         # state_chunk(N) = 16 at every N
def test_scan_bwd_plain_matches_vjp_of_the_reference(Bt, S, DI, N, chunk):
    dt, x, B, C, A, D, _, dy, _ = _scan_inputs(Bt, S, DI, N, S + N)
    y, vjp = jax.vjp(jref.mamba_scan_ref, *map(jnp.asarray, (dt, x, B, C, A, D)))
    want = vjp(jnp.asarray(dy))
    g = _plain_bwd(dt, x, B, C, A, D, None, dy, None, chunk)
    for name, got, w in zip(("ddt", "dx", "dB", "dC", "dA", "dD"), g[:6], want):
        _close(got, w, name)
    assert float(g.dh0.abs().max()) > 0


@pytest.mark.parametrize("big_dt", [False, True], ids=["moderate_dt", "dt_A_underflows"])
@pytest.mark.parametrize("Bt,S,DI,N,chunk,jchunk", [
    (2, 32, 16, 8, 8, 8), (1, 48, 12, 16, 32, 16), (2, 20, 8, 4, 32, 20),
    (1, 48, 12, 16, 16, 16), (2, 37, 8, 8, 16, 8)])  # state_chunk(N) = 16 at every N
def test_scan_bwd_plain_matches_vjp_of_the_chunk_scan(Bt, S, DI, N, chunk, jchunk, big_dt):
    """h0 in, dh_S in, dh0 out, against the JAX model's own scan (without
    the D term, which it adds outside: D = 0 here and dD checked apart).
    With ``big_dt`` a fifth of the steps have exp(dt A) = 0 in float32: the
    reverse pass recomputes the states and never divides by it."""
    dt, x, B, C, A, _, h0, dy, dh_S = _scan_inputs(Bt, S, DI, N, 7 * S + N, big_dt)
    if big_dt:
        assert (np.exp(dt[..., None] * A) == 0).any()
    fn = lambda dt, x, B, C, A, h0: _ssm_chunk_scan(dt, x, B, C, A, h0, jchunk)  # noqa: E731
    (y, h_S), vjp = jax.vjp(fn, *map(jnp.asarray, (dt, x, B, C, A, h0)))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh_S)))
    D0 = np.zeros(DI, np.float32)
    g = _plain_bwd(dt, x, B, C, A, D0, h0, dy, dh_S, chunk)
    for name, got, w in zip(("ddt", "dx", "dB", "dC", "dA", "dh0"),
                            (g.ddt, g.dx, g.dB, g.dC, g.dA, g.dh0), want):
        assert np.isfinite(got.numpy()).all(), name
        _close(got, w, name)
    _close(g.dD, (dy * x).sum((0, 1)), "dD")


@pytest.mark.parametrize("N,chunk", [(8, 4), (8, 7), (16, 32), (32, 16), (4, 64), (16, 16),
                                     (4, 16)])
def test_plain_forward_states_are_the_states_at_each_chunk_start(N, chunk):
    Bt, S, DI = 2, 45, 8
    dt, x, B, C, A, D, h0, _, _ = map(torch.as_tensor, _scan_inputs(Bt, S, DI, N, chunk))
    y, h_S, states = mamba_scan_plain(dt, x, B, C, A, D, h0, chunk=chunk)
    assert tuple(states.shape) == (Bt, -(-S // chunk), DI, N)
    y2, h2 = mamba_scan_plain(dt, x, B, C, A, D, h0)
    assert torch.equal(y, y2) and torch.equal(h_S, h2)
    assert torch.equal(states[:, 0], h0)
    for k in range(1, states.shape[1]):
        t = k * chunk
        _, h_t = mamba_scan_plain(dt[:, :t], x[:, :t], B[:, :t], C[:, :t], A, D, h0)
        assert torch.equal(states[:, k], h_t), k


def _leaves(*arrays):
    return [torch.as_tensor(a).requires_grad_() for a in arrays]


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("N", [8, 16])
def test_ops_mamba_scan_function_matches_autograd_through_the_plain_forward(N, with_h0):
    dt, x, B, C, A, D, h0, dy, dh_S = _scan_inputs(2, 37, 12, N, N + with_h0)
    outs = {}
    for name in ("function", "plain"):
        ins = _leaves(dt, x, B, C, A, D) + (_leaves(h0) if with_h0 else [None])
        fn = ops.mamba_scan if name == "function" else mamba_scan_plain
        y, h = fn(*ins)
        loss = (y * torch.as_tensor(dy)).sum() + (h * torch.as_tensor(dh_S)).sum()
        leaves = [t for t in ins if t is not None]
        outs[name] = (y.detach(), h.detach(), torch.autograd.grad(loss, leaves))
    yf, hf, gf = outs["function"]
    yp, hp, gp = outs["plain"]
    # the Function's CPU forward is the chunked scan: bit-equal to it, and
    # within the gradient tolerance of the sequential one autograd runs through
    cy, ch = mamba_scan_chunked(*(t.detach() if t is not None else None for t in ins[:7]))
    assert torch.equal(yf, cy) and torch.equal(hf, ch)
    _close(yf, yp, "y")
    _close(hf, hp, "h")
    assert len(gf) == 6 + with_h0
    for i, (a, b) in enumerate(zip(gf, gp)):
        _close(a, b, str(i))
    with torch.no_grad():      # the engine's call saves nothing and keeps its route
        y0, h0_ = ops.mamba_scan(*map(torch.as_tensor, (dt, x, B, C, A, D)))
    assert y0.grad_fn is None and torch.equal(y0, mamba_scan_chunked(
        *map(torch.as_tensor, (dt, x, B, C, A, D)))[0])


@pytest.mark.parametrize("used", [None, 24, 40], ids=["all_blocks", "used_24", "used_all"])
def test_gmm_bwd_plain_with_one_expert_matches_vjp_of_the_reference(used):
    """A rank's one expert under expert parallelism: 16 blocks a product,
    dx and dW against ``jax.vjp`` of ``grouped_matmul_ref``; with
    ``used_blocks`` (x and dy zero past it, as promised) the same dx and dW
    and zeros in dx past it."""
    T, D, F, bt = 40 * 16, 16, 24, 16
    rng = np.random.default_rng(used or 1)
    x = rng.standard_normal((T, D)).astype(np.float32)
    dy = rng.standard_normal((T, F)).astype(np.float32)
    if used is not None:
        x[used * bt:] = 0.0
        dy[used * bt:] = 0.0
    w = rng.standard_normal((1, D, F)).astype(np.float32)
    bmap = np.zeros(T // bt, np.int32)
    _, vjp = jax.vjp(lambda x_, w_: jref.grouped_matmul_ref(x_, w_, jnp.asarray(bmap), bt),
                     jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(dy))
    ub = None if used is None else torch.tensor([used], dtype=torch.int32)
    dx, dw = grouped_matmul_bwd_plain(torch.as_tensor(x), torch.as_tensor(w),
                                      torch.as_tensor(dy), torch.as_tensor(bmap), bt,
                                      used_blocks=ub)
    _close(dx, want_dx, "dx")
    _close(dw, want_dw, "dw")
    if used is not None:
        assert float(dx[used * bt:].abs().max() if used * bt < T else 0.0) == 0.0


def _layout(B, S, E, k, cf, seed, block_t=None, skip_expert=None):
    """A layout routed from random probabilities, as moe_forward builds it:
    (block_to_expert, T_pad, block_t, kept rows)."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, S, E)).astype(np.float32)
    if skip_expert is not None:
        logits[..., skip_expert] = -1e9          # an expert that gets no rows
    probs = torch.softmax(torch.as_tensor(logits), -1)
    gate, eidx = torch.topk(probs, k, -1)
    C = tmoe.capacity(S, k, E, cf)
    bt = block_t or tmoe.block_rows(B, C)
    lay = tmoe.build_layout(eidx, gate / gate.sum(-1, keepdim=True), C, bt, E)
    return lay, C


@pytest.mark.parametrize("block_t", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("case", ["drops", "empty_expert", "no_drops"])
def test_gmm_bwd_plain_matches_vjp_of_the_reference(case, block_t):
    B, S, E, k, D, F = 2, 24, 8, 2, 16, 24
    cf = 100.0 if case == "no_drops" else 1.0
    lay, C = _layout(B, S, E, k, cf, block_t, block_t,
                     skip_expert=3 if case == "empty_expert" else None)
    bmap = lay.block_to_expert
    T = lay.row_token.numel()
    kept = int((lay.row_token < B * S).sum())
    if case == "drops":
        assert kept < B * S * k
    if case == "empty_expert":
        assert 3 not in bmap.tolist()
    # trailing padding blocks: the extra ones past the last used block
    assert T // block_t > -(-kept // block_t)
    rng = np.random.default_rng(block_t)
    x = rng.standard_normal((T, D)).astype(np.float32)
    x[lay.row_token.numpy() == B * S] = 0.0          # padding rows are zeros, as dispatched
    w = rng.standard_normal((E, D, F)).astype(np.float32)
    dy = rng.standard_normal((T, F)).astype(np.float32)
    _, vjp = jax.vjp(lambda x_, w_: jref.grouped_matmul_ref(x_, w_, jnp.asarray(bmap.numpy()),
                                                            block_t),
                     jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(dy))
    dx, dw = grouped_matmul_bwd_plain(torch.as_tensor(x), torch.as_tensor(w),
                                      torch.as_tensor(dy), bmap, block_t)
    _close(dx, want_dx, "dx")
    _close(dw, want_dw, "dw")
    if case == "empty_expert":
        assert float(dw[3].abs().max()) == 0.0
    only_dx = grouped_matmul_bwd_plain(torch.as_tensor(x), torch.as_tensor(w),
                                       torch.as_tensor(dy), bmap, block_t, need_dw=False)
    assert only_dx[1] is None and torch.equal(only_dx[0], dx)


@pytest.mark.parametrize("block_t", [8, 32, 64, 128])
@pytest.mark.parametrize("case", ["drops", "empty_expert", "no_drops"])
def test_gmm_bwd_plain_with_used_blocks_is_bit_equal_and_matches_vjp(case, block_t):
    """With the layout's ``used_blocks`` the plain backward leaves out the
    trailing padding blocks: on the model's inputs (x and dy zero on padding
    rows, as dispatch and the combine's gate 0 give them) it is bit-equal to
    the call without it, and matches ``jax.vjp`` of the reference; on dy that
    is not zero there, dx is zero past the used rows."""
    B, S, E, k, D, F = 2, 24, 8, 2, 16, 24
    cf = 100.0 if case == "no_drops" else 1.0
    lay, C = _layout(B, S, E, k, cf, block_t + 1, block_t,
                     skip_expert=3 if case == "empty_expert" else None)
    bmap, used = lay.block_to_expert, lay.used_blocks
    T = lay.row_token.numel()
    pad = lay.row_token.numpy() == B * S
    assert int(used.item()) < T // block_t
    rng = np.random.default_rng(block_t + 1)
    x, dy = rng.standard_normal((T, D)).astype(np.float32), rng.standard_normal((T, F))
    w = rng.standard_normal((E, D, F)).astype(np.float32)
    x[pad] = 0.0
    dy = dy.astype(np.float32)
    raw_dy = torch.as_tensor(dy.copy())
    dy[pad] = 0.0
    args = (torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(dy), bmap, block_t)
    dx_u, dw_u = grouped_matmul_bwd_plain(*args, used_blocks=used)
    dx, dw = grouped_matmul_bwd_plain(*args)
    assert torch.equal(dx_u, dx) and torch.equal(dw_u, dw)
    _, vjp = jax.vjp(lambda x_, w_: jref.grouped_matmul_ref(x_, w_, jnp.asarray(bmap.numpy()),
                                                            block_t),
                     jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(dy))
    _close(dx_u, want_dx, "dx")
    _close(dw_u, want_dw, "dw")
    n = int(used.item()) * block_t
    dx_raw, _ = grouped_matmul_bwd_plain(args[0], args[1], raw_dy, bmap, block_t,
                                         used_blocks=used, need_dw=False)
    assert not dx_raw[n:].any() and dx_raw[n:].shape[0] > 0


@pytest.mark.parametrize("block_t", [8, 16, 32, 64, 128])
def test_gmm_bwd_route_is_named_for_every_type_and_block_t(block_t):
    """B4b's route for each (type, block_t) it takes: bf16 at block_t 64 and
    128 on wgmma fed by TMA (csrc/moe_gmm_bwd.cu), bf16 below that on B4's
    mma.sync kernels, float32 on the FMA loop (csrc/moe_gmm.cu)."""
    from repro_torch.kernels import moe_gmm
    assert moe_gmm.bwd_route(torch.float32, block_t) == moe_gmm.ROUTES[torch.float32]
    bf16 = moe_gmm.bwd_route(torch.bfloat16, block_t)
    assert "tensor cores" in bf16
    if block_t >= 64:
        assert bf16 == moe_gmm.WGMMA_ROUTE and "wgmma" in bf16 and "TMA" in bf16
    else:
        assert bf16 == moe_gmm.ROUTES[torch.bfloat16] and "mma.sync" in bf16
    assert set(moe_gmm.WGMMA_BLOCK_TS) <= set(moe_gmm.BLOCK_TS)


def test_used_blocks_reaches_the_backward_through_ops(monkeypatch):
    """``moe_expert_ffn`` hands the layout's ``used_blocks`` to each product's
    backward (B4b), and B4's forward runs without it."""
    from repro_torch.kernels import moe_gmm
    lay, _ = _layout(2, 16, 8, 2, 1.0, 5)
    T = lay.row_token.numel()
    seen = {"fwd": 0, "bwd": []}
    fwd, bwd = moe_gmm.grouped_matmul_plain, moe_gmm.grouped_matmul_bwd_plain

    def fwd_spy(*a, **kw):
        seen["fwd"] += 1
        assert not kw and len(a) == 4
        return fwd(*a)

    def bwd_spy(*a, used_blocks=None, **kw):
        seen["bwd"].append(used_blocks)
        return bwd(*a, used_blocks=used_blocks, **kw)

    monkeypatch.setattr(moe_gmm, "grouped_matmul_plain", fwd_spy)
    monkeypatch.setattr(moe_gmm, "grouped_matmul_bwd_plain", bwd_spy)
    rng = np.random.default_rng(3)
    xin, wg, wi, wo = _leaves(rng.standard_normal((T, 16)).astype(np.float32),
                              *(rng.standard_normal(s).astype(np.float32)
                                for s in ((8, 16, 32), (8, 16, 32), (8, 32, 16))))
    y = ops.moe_expert_ffn(xin, wg, wi, wo, lay.block_to_expert, lay.block_t, lay.used_blocks)
    y.sum().backward()
    assert seen["fwd"] == 3 and len(seen["bwd"]) == 3
    assert all(u is lay.used_blocks for u in seen["bwd"])


def test_ops_grouped_matmul_function_matches_autograd_through_the_plain_forward():
    lay, _ = _layout(2, 16, 8, 2, 1.25, 4)
    bmap, bt = lay.block_to_expert, lay.block_t
    T = lay.row_token.numel()
    rng = np.random.default_rng(9)
    x, w, dy = (rng.standard_normal(s).astype(np.float32) for s in ((T, 64), (8, 64, 128),
                                                                       (T, 128)))
    grads = {}
    for name, fn in (("function", ops.grouped_matmul), ("plain", grouped_matmul_plain)):
        xt, wt = _leaves(x, w)
        y = fn(xt, wt, bmap, bt)
        grads[name] = torch.autograd.grad((y * torch.as_tensor(dy)).sum(), [xt, wt])
    for a, b, n in zip(grads["function"], grads["plain"], ("dx", "dw")):
        _close(a, b, n)


def _plain_combine(contrib, rows, row_token):
    cp = torch.cat([contrib, contrib.new_zeros(1, contrib.shape[1])])
    return sum(cp[rows[:, j]] for j in range(rows.shape[1]))


@pytest.mark.parametrize("capacity_factor", [1.0, 100.0], ids=["drops", "no_drops"])
def test_moe_dispatch_and_combine_backwards_match_autograd_through_the_gathers(
        capacity_factor):
    """moe_forward's dispatch and combine (Functions with their own
    backwards: gathers in ascending expert order, and one gather over
    row_token) against autograd through the plain gathers, on the reduced
    moonshot, with and without capacity drops: every gradient."""
    jcfg = reduced(jax_config("moonshot_v1_16b"))
    cfg = ModelConfig.from_json(replace(jcfg, dtype="float32").to_json())
    cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=capacity_factor))
    D, E, Fe = cfg.d_model, cfg.moe.num_experts, cfg.moe.expert_ff
    rng = np.random.default_rng(2)
    arrays = {"x": rng.standard_normal((2, 16, D)), "router": rng.standard_normal((D, E)),
              "wg": rng.standard_normal((E, D, Fe)) / 8, "wi": rng.standard_normal((E, D, Fe)) / 8,
              "wo": rng.standard_normal((E, Fe, D)) / 8}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    dy = torch.as_tensor(rng.standard_normal((2, 16, D)).astype(np.float32))
    grads, outs = {}, {}
    for name in ("functions", "gathers"):
        leaves = {k: torch.as_tensor(v).requires_grad_() for k, v in arrays.items()}
        p = {k: leaves[k] for k in ("router", "wg", "wi", "wo")}
        if name == "functions":
            y = tmoe.moe_forward(leaves["x"], p, cfg)
        else:
            orig = tmoe._Dispatch.apply, tmoe._Combine.apply
            tmoe._Dispatch.apply = staticmethod(
                lambda x2, rt, rows: torch.cat([x2, x2.new_zeros(1, x2.shape[1])])[rt])
            tmoe._Combine.apply = staticmethod(_plain_combine)
            try:
                y = tmoe.moe_forward(leaves["x"], p, cfg)
            finally:
                tmoe._Dispatch.apply, tmoe._Combine.apply = orig
        outs[name] = y.detach()
        grads[name] = torch.autograd.grad((y * dy).sum(), list(leaves.values()))
    assert torch.equal(outs["functions"], outs["gathers"])
    for n, a, b in zip(arrays, grads["functions"], grads["gathers"]):
        _close(a, b, n)
    assert float(grads["functions"][0].abs().max()) > 0


def test_state_chunk_keeps_a_chunk_of_64_channels_in_128_kb():
    """B3b keeps a span's recomputed states in registers: a thread's 2
    channels x 2 states x state_chunk(N) steps in 64 of its 128 registers, a
    block's 1024 / N channels (64 at N 16) in 64 KB, two blocks an SM in 128
    KB of its 256 KB register file. B3 writes each state at the start of one
    of its groups of steps, so the span divides B3's chunk."""
    for N in (4, 8, 16, 32):
        per_thread = state_chunk(N) * 2 * 2
        assert per_thread <= 64
        assert state_chunk(N) * N * block_channels(N) * 4 <= 64 * 1024
        assert 2 * 256 * per_thread * 4 <= 128 * 1024
        assert (16 if N == 32 else 32) % state_chunk(N) == 0


# ---------------------------------------------------------------------------
# The chunked scan: the CPU path (the JAX model's _ssm_chunk_scan)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 37, 100, 256])
def test_associative_scan_is_the_sequential_fold(n):
    """Every prefix of ``(a, b)`` under ``(al ar, bl ar + br)`` in float64,
    at lengths that are powers of two and lengths padded to one, against a
    step-by-step fold; the inputs are left as they were."""
    rng = np.random.default_rng(n)
    a = torch.as_tensor(rng.uniform(0.5, 1.0, (2, n, 3, 4)))
    b = torch.as_tensor(rng.standard_normal((2, n, 3, 4)))
    a0, b0 = a.clone(), b.clone()
    got_a, got_b = associative_scan(a, b)
    ca, cb = torch.ones_like(a[:, 0]), torch.zeros_like(b[:, 0])
    for t in range(n):
        ca, cb = ca * a[:, t], cb * a[:, t] + b[:, t]
        torch.testing.assert_close(got_a[:, t], ca, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(got_b[:, t], cb, rtol=1e-12, atol=1e-12)
    assert torch.equal(a, a0) and torch.equal(b, b0)


CHUNKED_TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _chunked_close(got, want, dtype, name=""):
    tol = CHUNKED_TOL[dtype]
    np.testing.assert_allclose(np.asarray(got.float(), np.float32),
                               np.asarray(want.float() if isinstance(want, torch.Tensor)
                                          else want, np.float32),
                               rtol=tol, atol=tol, err_msg=name)


# (Bt, S, DI, N, block): S past one block of 256 and not a multiple of it
# (one chunk of S, as in JAX), two blocks of 256, and small blocks for many
# chunks; the saved states every 16 steps in each
CHUNKED = [(1, 300, 8, 16, 256), (1, 512, 4, 8, 256), (2, 96, 8, 4, 32), (2, 48, 6, 32, 16)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Bt,S,DI,N,block", CHUNKED)
def test_chunked_scan_matches_the_sequential_one_and_the_jax_chunk_scan(Bt, S, DI, N, block,
                                                                        dtype):
    dt, x, B, C, A, D, h0, _, _ = _scan_inputs(Bt, S, DI, N, S + block)
    dt = dt * 0.2
    t = [torch.as_tensor(a).to(getattr(torch, dtype)) for a in (dt, x, B, C)]
    A_, D_, h0_ = map(torch.as_tensor, (A, D, h0))
    Tc = state_chunk(N)
    y, h, st = mamba_scan_chunked(*t, A_, D_, h0_, chunk=Tc, block=block)
    assert y.dtype == t[1].dtype and h.dtype == st.dtype == torch.float32
    assert tuple(st.shape) == (Bt, -(-S // Tc), DI, N)
    py, ph, pst = mamba_scan_plain(*t, A_, D_, h0_, chunk=Tc)
    _chunked_close(y, py, dtype, "y")
    _chunked_close(h, ph, dtype, "h_S")
    _chunked_close(st, pst, dtype, "states")
    # the JAX model's scan on the same (rounded) inputs, D x added outside
    j = [jnp.asarray(a.float().numpy()) for a in t]
    bx = (t[0] * t[1]).float().numpy()            # the port rounds dt x to the inputs' type
    jy, jh = _ssm_chunk_scan(j[0], jnp.asarray(bx) / j[0], j[2], j[3], jnp.asarray(A),
                             jnp.asarray(h0), block)
    if dtype == "float32":
        jy, jh = _ssm_chunk_scan(j[0], j[1], j[2], j[3], jnp.asarray(A), jnp.asarray(h0), block)
    _chunked_close(y, jy + j[1] * jnp.asarray(D), dtype, "y vs jax")
    _chunked_close(h, jh, dtype, "h_S vs jax")
    y2, h2 = mamba_scan_chunked(*t, A_, D_, h0_, block=block)
    assert torch.equal(y, y2) and torch.equal(h, h2)       # the states change nothing


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Bt,S,DI,N,block", CHUNKED)
def test_chunked_scan_bwd_matches_the_sequential_one_and_jax_grad(Bt, S, DI, N, block, dtype):
    """Every gradient, h0 and dh_S included, against the sequential backward
    on the same saved states and (float32) against ``jax.vjp`` of
    ``_ssm_chunk_scan`` at the same block."""
    dt, x, B, C, A, D, h0, dy, dh_S = _scan_inputs(Bt, S, DI, N, 3 * S + block)
    dt = dt * 0.2
    cast = lambda a: torch.as_tensor(a).to(getattr(torch, dtype)).float()  # noqa: E731
    t = [cast(a) for a in (dt, x, B, C)] + [torch.as_tensor(A), torch.as_tensor(D)]
    Tc = state_chunk(N)
    _, _, states = mamba_scan_chunked(*t, torch.as_tensor(h0), chunk=Tc, block=block)
    args = (*t, states, torch.as_tensor(dy), torch.as_tensor(dh_S))
    g = mamba_scan_bwd_chunked(*args, chunk=Tc, block=block)
    want = mamba_scan_bwd_plain(*args, chunk=Tc)
    for name, got, w in zip(ScanGrads._fields, g, want):
        assert got.shape == w.shape and np.isfinite(got.numpy()).all(), name
        _chunked_close(got, w, dtype, name)
    if dtype == "float32":
        fn = lambda dt, x, B, C, A, h0: _ssm_chunk_scan(dt, x, B, C, A, h0, block)  # noqa: E731
        _, vjp = jax.vjp(fn, *map(jnp.asarray, (dt, x, B, C, A, h0)))
        jg = vjp((jnp.asarray(dy), jnp.asarray(dh_S)))
        D_term = {"dx": D * dy, "ddt": 0.0}
        for name, w in zip(("ddt", "dx", "dB", "dC", "dA", "dh0"), jg):
            _chunked_close(getattr(g, name), np.asarray(w) + D_term.get(name, 0.0), dtype, name)


class _OpCount(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_cpu_scan_and_its_backward_dispatch_ops_by_the_chunk_not_the_step():
    """One ``ops.mamba_scan`` under autograd and its backward at S 4096 (16
    blocks of 256): at most 800 dispatched ops a block (~400 measured), the count of 16
    blocks twice that of 8; the step-by-step pair (``mamba_scan_plain`` and
    ``mamba_scan_bwd_plain``) dispatches over 10 times as many."""
    def count(S):
        dt, x, B, C, A, D, _, dy, _ = _scan_inputs(1, S, 4, 4, 5)
        leaves = _leaves(dt * 0.2, x, B, C, A, D)
        with _OpCount() as c:
            y, h = ops.mamba_scan(*leaves)
            torch.autograd.grad((y * torch.as_tensor(dy)).sum(), leaves)
        return c.n
    n8, n16 = count(2048), count(4096)
    assert n16 <= 800 * 16, n16
    assert abs(n16 - 2 * n8) <= 0.05 * n16, (n8, n16)
    dt, x, B, C, A, D, _, dy, _ = map(torch.as_tensor, _scan_inputs(1, 256, 4, 4, 5))
    with _OpCount() as c:             # the step-by-step pair over one block
        _, _, states = mamba_scan_plain(dt, x, B, C, A, D, chunk=16)
        mamba_scan_bwd_plain(dt, x, B, C, A, D, states, dy, chunk=16)
    assert c.n * 16 > 10 * n16, (c.n, n16)
