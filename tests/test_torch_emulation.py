"""The port's worker emulation (paper Fig. 2, steps 2-4) against the JAX
package's, on the CPU: AdamW, the ridge and MLP fits, the emulated
simulator, and the launcher ``repro_torch.launch.emulate``.

Tolerances, and why:
- AdamW: 1e-6 with float32 state, 1e-2 relative with bfloat16 state (one
  bfloat16 rounding of a moment may land on the other side).
- Ridge: the reference puts ``inflight`` and ``batch_size`` side by side, and
  ``inflight = batch_size - 1`` on every row, so two standardised columns are
  equal and only ``lam`` holds the solve. Two float32 solvers split the weight
  between them differently, so ``w`` is not compared; the predictions
  ``Xs @ w`` are, within 1e-4, and ``resid_std`` within 1e-3 relative.
- MLP: with JAX's initial draws carried across, the parameters agree within
  1e-5 after 20 steps. Adam's normalisation amplifies float32 summation-order
  differences over longer runs, so after 300 steps only ``resid_std`` (1e-2
  relative) and the RMSE of ``test_mlp_beats_or_matches_ridge_rmse`` (5%)
  are compared.
"""
import itertools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core.config_store as jax_store  # noqa: E402
import repro.core.emulation as jax_emu  # noqa: E402
import repro.core.router as jax_router  # noqa: E402
import repro.core.simulator as jax_sim  # noqa: E402
import repro.core.types as jax_types  # noqa: E402
from repro.train.optimizer import AdamW as JaxAdamW  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import emulation as emu  # noqa: E402
from repro_torch.core import simulator as port_sim  # noqa: E402
from repro_torch.core import types as port_types  # noqa: E402
from repro_torch.core.config_store import ConfigStore  # noqa: E402
from repro_torch.core.router import build_tree  # noqa: E402
from repro_torch.core.types import FunctionConfig  # noqa: E402
from repro_torch.launch import emulate  # noqa: E402
from repro_torch.train.optimizer import AdamW  # noqa: E402
from test_emulation import _synth_records  # noqa: E402  (the reference's records)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def synth():
    return emu.telemetry_matrix(_synth_records())


@pytest.fixture(scope="module")
def engine_rows():
    """Telemetry of the example's 24-request mix on the port's engine (CPU)."""
    recs = emulate.profile_worker(emulate.demo_store(), "cpu")
    assert len(recs) == 24
    return emu.telemetry_matrix(recs)


# ------------------------------------------------------------------ AdamW
def _tree(rng):
    return {"w": rng.normal(size=(5, 3)).astype(np.float32),
            "inner": {"b": rng.normal(size=(3,)).astype(np.float32),
                      "s": rng.normal(size=(2, 2, 2)).astype(np.float32)}}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _np32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("steps", [1, 10])
def test_adamw_matches_jax(steps, weight_decay, state_dtype):
    rng = np.random.default_rng(steps)
    p0 = _tree(rng)
    grads = [_tree(rng) for _ in range(steps)]
    to_t = lambda t: {k: to_t(v) if isinstance(v, dict) else torch.tensor(v)
                      for k, v in t.items()}
    jopt = JaxAdamW(lr=3e-3, weight_decay=weight_decay, state_dtype=state_dtype)
    popt = AdamW(lr=3e-3, weight_decay=weight_decay, state_dtype=state_dtype)
    jp = jax.tree.map(jnp.asarray, p0)
    js = jopt.init(jp)
    pp = to_t(p0)
    ps = popt.init(pp)
    for g in grads:
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        pp, ps = popt.update(to_t(g), ps, pp)
    assert int(ps["step"]) == int(js["step"]) == steps
    assert ps["m"]["w"].dtype == getattr(torch, state_dtype)
    tol = dict(atol=1e-6, rtol=0) if state_dtype == "float32" else dict(atol=1e-6, rtol=1e-2)
    for want, got in ((jp, pp), (js["m"], ps["m"]), (js["v"], ps["v"])):
        got = dict(_leaves(got))
        for name, w in _leaves(want):
            np.testing.assert_allclose(_np32(got[name]), _np32(w), **tol, err_msg=name)


# ------------------------------------------------------------------ ridge
def _ridge_predictions(model, X):
    xs = (X - model.mu) / model.sd
    return np.concatenate([xs, np.ones((len(X), 1), np.float32)], 1) @ model.w


@pytest.mark.parametrize("rows", ["synth", "engine_rows"])
def test_ridge_fit_matches_jax_on_predictions(rows, request):
    X, y, ok = request.getfixturevalue(rows)
    want = jax_emu.RidgeWorkerModel.fit(X, y, ok)
    got = emu.RidgeWorkerModel.fit(X, y, ok, device="cpu")
    np.testing.assert_array_equal(got.mu, want.mu)
    np.testing.assert_array_equal(got.sd, want.sd)
    np.testing.assert_allclose(_ridge_predictions(got, X), _ridge_predictions(want, X),
                               atol=1e-4, rtol=0)
    assert got.resid_std == pytest.approx(want.resid_std, rel=1e-3)
    assert got.fail_rate == want.fail_rate


def test_ridge_carried_across_drives_the_example_run_to_the_jax_digest(engine_rows,
                                                                       monkeypatch):
    """The example's step 3 (1024 workers, fanout 16, 5000 rps for 4 s) from
    one JAX-fitted ridge model: the JAX package's simulator as
    examples/emulate_workers.py drives it, and the port's through the
    launcher's ``emulate``."""
    jridge = jax_emu.RidgeWorkerModel.fit(*engine_rows)
    monkeypatch.setattr(jax_types, "_req_ids", itertools.count())
    store = jax_store.ConfigStore()
    for fn, arch, c in (("tiny-gen", "tiny_lm", 4), ("small-gen", "small_lm", 2)):
        store.put(jax_types.FunctionConfig(name=fn, arch=arch, concurrency=c,
                                           gen_tokens=4, idle_timeout_s=60.0))
    want = jax_sim.Simulator(jax_router.build_tree(1024, fanout=16), store,
                             jax_emu.EmulatedServiceModel(jridge, seed=2), seed=4)
    n_want = jax_sim.poisson_load(want, fn="tiny-gen", rps=5000, duration_s=4, seed=6)
    want.run()

    monkeypatch.setattr(port_types, "_req_ids", itertools.count())
    pridge = emu.RidgeWorkerModel(w=jridge.w, mu=jridge.mu, sd=jridge.sd,
                                  resid_std=jridge.resid_std, fail_rate=jridge.fail_rate)
    got, n, _ = emulate.emulate(emulate.demo_store(), pridge)
    assert n == n_want == len(got.results) > 19000
    assert port_sim.stream_digest(got) == jax_sim.stream_digest(want)


# -------------------------------------------------------------------- MLP
@pytest.fixture(scope="module")
def jax_init(synth):
    """JAX's initial draws: a fit of 0 steps returns them."""
    return jax_emu.MLPWorkerModel.fit(*synth, steps=0).params


def test_mlp_20_steps_match_jax_from_its_initial_draws(synth, jax_init):
    want = jax_emu.MLPWorkerModel.fit(*synth, steps=20)
    got = emu.MLPWorkerModel.fit(*synth, steps=20, device="cpu", init=jax_init)
    assert set(got.params) == set(want.params)
    for name, w in want.params.items():
        assert got.params[name].shape == w.shape, name
        np.testing.assert_allclose(got.params[name], w, atol=1e-5, rtol=0, err_msg=name)


def _rmse(model, X, y):
    """The measure of tests/test_emulation.py::test_mlp_beats_or_matches_ridge_rmse."""
    rng = np.random.default_rng(2)
    errs = []
    for i in range(0, len(X), 7):
        pred, _ = model.predict(X[i], rng)
        errs.append((np.log(pred + 1e-6) - np.log(y[i] + 1e-6)) ** 2)
    return float(np.sqrt(np.mean(errs)))


def test_mlp_300_steps_match_jax_statistically(synth, jax_init):
    X, y, ok = synth
    want = jax_emu.MLPWorkerModel.fit(X, y, ok, steps=300)
    got = emu.MLPWorkerModel.fit(X, y, ok, steps=300, device="cpu", init=jax_init)
    assert got.resid_std == pytest.approx(want.resid_std, rel=1e-2)
    assert got.fail_rate == want.fail_rate
    assert _rmse(got, X, y) == pytest.approx(_rmse(want, X, y), rel=0.05)


def test_mlp_bridged_from_jax_predicts_as_jax(synth):
    X, y, ok = synth
    want = jax_emu.MLPWorkerModel.fit(X, y, ok, steps=20)
    got = bridge.mlp_worker_model(want)
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    for i in range(0, 200, 9):
        (lw, okw), (lg, okg) = want.predict(X[i], r1), got.predict(X[i], r2)
        assert lg == pytest.approx(lw, rel=1e-5) and okg == okw


def test_mlp_default_init_is_seeded_and_shaped_as_jax(synth, jax_init):
    X, y, ok = synth
    a = emu.MLPWorkerModel.fit(X[:200], y[:200], ok[:200], steps=3, seed=1, device="cpu")
    b = emu.MLPWorkerModel.fit(X[:200], y[:200], ok[:200], steps=3, seed=1, device="cpu")
    c = emu.MLPWorkerModel.fit(X[:200], y[:200], ok[:200], steps=3, seed=2, device="cpu")
    for name, w in jax_init.items():
        assert a.params[name].shape == w.shape and a.params[name].dtype == np.float32
        np.testing.assert_array_equal(a.params[name], b.params[name])
    assert not np.array_equal(a.params["w1"], c.params["w1"])


# ------------------------- mirrors of tests/test_emulation.py, port alone
def test_ridge_recovers_structure(synth):
    X, y, ok = synth
    model = emu.RidgeWorkerModel.fit(X, y, ok, device="cpu")
    rng = np.random.default_rng(1)
    f_warm = np.array([0, 0, 1, 0, 16, 8, 1.0], np.float32)
    f_cold = np.array([0, 0, 1, 1, 16, 8, 1.0], np.float32)
    p_warm = np.median([model.predict(f_warm, rng)[0] for _ in range(50)])
    p_cold = np.median([model.predict(f_cold, rng)[0] for _ in range(50)])
    assert p_cold > 2.0 * p_warm
    assert model.fail_rate == pytest.approx(0.01, abs=0.01)


def test_mlp_beats_or_matches_ridge_rmse(synth):
    X, y, ok = synth
    ridge = emu.RidgeWorkerModel.fit(X, y, ok, device="cpu")
    mlp = emu.MLPWorkerModel.fit(X, y, ok, steps=300, device="cpu")
    assert _rmse(mlp, X, y) < _rmse(ridge, X, y) * 1.3


def _fn_store():
    store = ConfigStore()
    store.put(FunctionConfig(name="fn", arch="tiny_lm", concurrency=4, cold_start_s=0.2))
    return store


def test_emulated_sim_fidelity():
    store = _fn_store()
    real = port_sim.Simulator(build_tree(8, fanout=4), store,
                              port_sim.SyntheticServiceModel(seed=2), seed=5)
    port_sim.poisson_load(real, fn="fn", rps=150, duration_s=15, seed=4)
    real_res = real.run()
    X, y, ok = emu.telemetry_matrix([r for r in real.telemetry if r.latency > 0])
    model = emu.RidgeWorkerModel.fit(X, y, ok, device="cpu")
    sim = port_sim.Simulator(build_tree(8, fanout=4), store,
                             emu.EmulatedServiceModel(model, seed=0), seed=5)
    port_sim.poisson_load(sim, fn="fn", rps=150, duration_s=15, seed=4)
    emu_res = sim.run()
    rep = emu.fidelity_report(np.array([r.latency for r in real_res if r.ok]),
                              np.array([r.latency for r in emu_res if r.ok]))
    assert rep["p50_rel_err"] < 0.25
    assert rep["p95_rel_err"] < 0.35
    assert rep["mean_rel_err"] < 0.25


def test_emulation_scales_to_1000_workers():
    X, y, ok = emu.telemetry_matrix(_synth_records(1000))
    model = emu.RidgeWorkerModel.fit(X, y, ok, device="cpu")
    sim = port_sim.Simulator(build_tree(1024, fanout=16), _fn_store(),
                             emu.EmulatedServiceModel(model), seed=1)
    n = port_sim.poisson_load(sim, fn="fn", rps=2000, duration_s=5, seed=4)
    s = port_sim.summarize(sim.run())
    assert s["n"] == n and s["fail_rate"] < 0.05


def test_fidelity_report_identity():
    x = np.random.default_rng(0).lognormal(0, 0.3, 5000)
    rep = emu.fidelity_report(x, x)
    assert rep["ks"] < 1e-9 and rep["p99_rel_err"] < 1e-9
    assert rep == jax_emu.fidelity_report(x, x)


# --------------------------------------------------------------- launcher
def test_emulate_launcher_runs_small_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.emulate", "--device",
                          "cpu", "--workers", "64", "--rps", "500", "--duration", "1"],
                         env=env, capture_output=True, text=True, timeout=600, check=True)
    lines = out.stdout.splitlines()
    assert lines[0].startswith("step 1: 24 telemetry rows")
    assert "ridge resid_std=" in lines[1] and "mlp resid_std=" in lines[1]
    assert sum("per-row median rel err" in ln for ln in lines) == 2
    assert "over 64 emulated workers" in lines[-1] and "fail=" in lines[-1]
