"""The port's MoE slice against the JAX package on the same numpy inputs:
B4's plain version against the Pallas kernel in interpret mode and the jnp
oracle (2e-4 in float32, 2e-2 in bfloat16: tests/test_kernels.py), the
routing, the expert-sorted layout against ``moe_forward``'s kept slots, and
``moe_forward`` itself on bridged weights, with and without capacity drops."""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import reduced  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.moe_gmm import grouped_matmul as pallas_gmm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.moe_gmm import grouped_matmul_plain  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _pair(a, dtype="float32"):
    """The same values as a JAX array and a torch tensor (bf16 bit for bit)."""
    j = jnp.asarray(a, dtype)
    return j, tensor_from_numpy(np.asarray(j))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _cfg(name, no_drop=False):
    """A reduced config (8 experts, top-2), or "moonshot_e64": the reduced
    moonshot_v1_16b with its own 64 experts and top-6 routing."""
    if name == "moonshot_e64":
        cfg = reduced(jax_config("moonshot_v1_16b"))
        cfg = replace(cfg, moe=replace(cfg.moe, num_experts=64, top_k=6, expert_ff=64))
    else:
        cfg = reduced(jax_config(name))
    if no_drop:      # tests/test_decode_parity.py:24-25
        cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    return cfg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,D,F,E,bt", [
    (512, 128, 256, 4, 64),      # the JAX sweep (tests/test_kernels.py:86-89)
    (256, 64, 128, 8, 32),
    (128, 64, 128, 8, 16),       # the serving block_t range
])
def test_grouped_matmul_plain_matches_pallas_and_oracle(T, D, F, E, bt, dtype):
    rng = np.random.default_rng(T + D + bt)
    jx, tx = _pair(rng.standard_normal((T, D), np.float32), dtype)
    jw, tw = _pair(rng.standard_normal((E, D, F), np.float32), dtype)
    bmap = np.sort(rng.integers(0, E, T // bt)).astype(np.int32)
    got = grouped_matmul_plain(tx, tw, torch.as_tensor(bmap), bt)
    assert got.dtype == tx.dtype and tuple(got.shape) == (T, F)
    tol = TOL[dtype]
    _close(got.float(), pallas_gmm(jx, jw, jnp.asarray(bmap), block_t=bt), tol)
    _close(got.float(), jref.grouped_matmul_ref(jx, jw, jnp.asarray(bmap), bt), tol)
    torch.testing.assert_close(ops.grouped_matmul(tx, tw, torch.as_tensor(bmap), bt), got,
                               rtol=0, atol=0)
    assert tref.grouped_matmul_ref is grouped_matmul_plain


def _jax_route(x, router, k):
    """moe.py:42-46 of the JAX package."""
    logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32), router.astype(jnp.float32))
    gate, eidx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    return eidx, gate / jnp.maximum(gate.sum(-1, keepdims=True), 1e-9)


def _jax_slots(eidx, E, C):
    """moe.py:49-73 of the JAX package: (valid [B, S*k] in the original
    assignment order, slot_tok [B, E*C])."""
    B, S, k = eidx.shape
    flat_e = eidx.reshape(B, S * k)
    flat_t = jnp.repeat(jnp.arange(S), k)[None, :]
    order = jnp.argsort(flat_e, axis=-1, stable=True)
    se = jnp.take_along_axis(flat_e, order, -1)
    st = jnp.take_along_axis(jnp.broadcast_to(flat_t, (B, S * k)), order, -1)
    starts = jax.vmap(lambda row: jnp.searchsorted(row, jnp.arange(E)))(se)
    pos_in_e = jnp.arange(S * k)[None, :] - jnp.take_along_axis(starts, se, -1)
    valid = pos_in_e < C
    slot = jnp.where(valid, se * C + pos_in_e, E * C)
    slot_tok = jax.vmap(lambda s_, t_: jnp.full((E * C + 1,), S, jnp.int32)
                        .at[s_].set(t_.astype(jnp.int32), mode="drop"))(slot, st)[:, :-1]
    kept = np.zeros((B, S * k), bool)
    np.put_along_axis(kept, np.asarray(order), np.asarray(valid), -1)
    return kept, np.asarray(slot_tok)


def _route_inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, cfg.d_model), np.float32)
    router = rng.standard_normal((cfg.d_model, cfg.moe.num_experts), np.float32)
    return x, router / np.sqrt(cfg.d_model)


@pytest.mark.parametrize("arch,B,S", [("moonshot_v1_16b", 2, 16), ("moonshot_e64", 1, 32),
                                      ("grok1_314b", 3, 1)])
def test_route_matches_jax(arch, B, S):
    cfg = _cfg(arch)
    x, router = _route_inputs(cfg, B, S, S)
    jeidx, jgate = _jax_route(jnp.asarray(x), jnp.asarray(router), cfg.moe.top_k)
    eidx, gate = tmoe.route(torch.as_tensor(x), torch.as_tensor(router), cfg)
    np.testing.assert_array_equal(eidx.numpy(), np.asarray(jeidx))
    np.testing.assert_allclose(gate.numpy(), np.asarray(jgate), rtol=1e-6, atol=1e-6)
    assert gate.dtype == torch.float32


@pytest.mark.parametrize("arch,B,S,drops", [
    ("moonshot_v1_16b", 2, 16, True),     # C = 5 for 32 assignments on 8 experts
    ("moonshot_e64", 1, 32, True),        # moonshot's own routing at the S32 bucket: C = 3
    ("moonshot_e64", 2, 16, True),
    ("moonshot_e64", 3, 1, False),        # decode: C = 1, a token's experts are distinct
])
def test_build_layout_keeps_the_jax_slots(arch, B, S, drops):
    cfg = _cfg(arch)
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    C = tmoe.capacity(S, k, E, cfg.moe.capacity_factor)
    x, router = _route_inputs(cfg, B, S, 7 * S + B)
    eidx, gate = tmoe.route(torch.as_tensor(x), torch.as_tensor(router), cfg)
    bt = tmoe.block_rows(B, C)
    lay = tmoe.build_layout(eidx, gate, C, bt, E)
    jkept, jslot_tok = _jax_slots(jnp.asarray(eidx.numpy()), E, C)

    T_pad = lay.row_token.shape[0]
    nt = -(-B * S * k // bt) + min(E, B * S * k)
    assert T_pad == nt * bt and tuple(lay.block_to_expert.shape) == (nt,)
    rows = lay.token_rows.reshape(B, S * k).numpy()
    kept = rows < T_pad
    np.testing.assert_array_equal(kept, jkept)            # the same kept set as JAX
    assert (~kept).any() == drops
    # every kept assignment sits in a block of its own expert, with its token and gate
    bmap = lay.block_to_expert.numpy()
    assert bmap.dtype == np.int32 and bmap.min() >= 0 and bmap.max() < E
    assert (np.diff(bmap) >= 0).all()
    flat_e = eidx.reshape(B, S * k).numpy()
    tok = np.arange(B * S)[:, None].repeat(k, 1).reshape(B, S * k)
    r = rows[kept]
    np.testing.assert_array_equal(bmap[r // bt], flat_e[kept])
    np.testing.assert_array_equal(lay.row_token.numpy()[r], tok[kept])
    np.testing.assert_array_equal(lay.row_gate.numpy()[r], gate.reshape(B, S * k).numpy()[kept])
    assert len(np.unique(r)) == len(r)
    # padding rows point at the zero row, with gate 0
    pad = np.setdiff1d(np.arange(T_pad), r)
    assert (lay.row_token.numpy()[pad] == B * S).all() and (lay.row_gate.numpy()[pad] == 0).all()
    # within an expert and a batch row, the tokens come in JAX's slot order
    row_expert = np.repeat(bmap, bt)
    for b in range(B):
        for e in range(E):
            toks = lay.row_token.numpy()[row_expert == e]
            mine = [t - b * S for t in toks if b * S <= t < (b + 1) * S]
            theirs = [t for t in jslot_tok[b, e * C:(e + 1) * C] if t < S]
            assert mine == theirs, (b, e)


def _weights(cfg, rng):
    E, D, F = cfg.moe.num_experts, cfg.d_model, cfg.moe.expert_ff
    return {"router": rng.standard_normal((D, E), np.float32) / np.sqrt(D),
            "wg": rng.standard_normal((E, D, F), np.float32) / np.sqrt(D),
            "wi": rng.standard_normal((E, D, F), np.float32) / np.sqrt(D),
            "wo": rng.standard_normal((E, F, D), np.float32) / np.sqrt(F)}


@pytest.mark.parametrize("no_drop", [False, True], ids=["capacity", "no_drop"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,shape", [("moonshot_v1_16b", (2, 16)), ("moonshot_e64", (1, 32)),
                                        ("moonshot_e64", (2,))], ids=["S16", "e64-S32", "decode"])
def test_moe_forward_matches_jax(arch, shape, dtype, no_drop):
    cfg = replace(_cfg(arch, no_drop), dtype=dtype)
    rng = np.random.default_rng(len(shape) + int(no_drop))
    jx, tx = _pair(rng.standard_normal((*shape, cfg.d_model), np.float32), dtype)
    params = {n: _pair(a, dtype) for n, a in _weights(cfg, rng).items()}
    want = jmoe.moe_forward(jx, {n: j for n, (j, _) in params.items()}, cfg)
    got = tmoe.moe_forward(tx, {n: t for n, (_, t) in params.items()},
                           ModelConfig.from_json(cfg.to_json()))
    assert got.dtype == tx.dtype and tuple(got.shape) == tuple(want.shape)
    _close(got.float(), want, TOL[dtype])


def test_capacity_and_block_rows_follow_the_serving_buckets():
    """moonshot_v1_16b at the engine's buckets: C = 2 (S16), 3 (S32), 1
    (decode); one 8-row block holds all of an expert's rows there."""
    cap = lambda S: tmoe.capacity(S, 6, 64, 1.25)  # noqa: E731
    assert (cap(16), cap(32), cap(1), cap(64)) == (2, 3, 1, 7)
    assert tmoe.block_rows(1, cap(32)) == tmoe.block_rows(2, 1) == 8
    assert tmoe.block_rows(1, cap(256)) == 32 and tmoe.block_rows(64, 30) == 128
    assert tmoe.capacity(4, 2, 8, 8.0) == 8      # no-drop: capped at S*k
