"""The port's training path against the JAX package's on the same inputs:
``loss_fn`` and every gradient, the MoE auxiliary loss, train steps with the
three optimizers (with and without accumulation), the eval step, the data
pipeline, the schedules, checkpoints (both ways across the packages) and the
launcher on the CPU.

Weights cross through ``bridge.params_from_numpy``; batches come from the
JAX package's seeded ``TokenStream``. Tolerances, none looser than the
reference's: losses and other model outputs within 2e-3
(tests/test_decode_parity.py), f32 gradients within rtol 1e-3, atol 1e-4
(tests/test_attention.py:40), parameters after three steps within rtol
5e-4, atol 5e-5 (tests/test_trainer.py:49-51), data and checkpoints
byte-equal, schedules within rtol 1e-6 (one float32 rounding).
"""
import json
import os
import shutil
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import reduced  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.distributed.checkpoint import CheckpointManager as JaxManager  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import schedule as jsched  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.bridge import params_from_numpy, tensor_from_numpy  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.distributed.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.transformer import AUX_LOSS_COEF  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import schedule as tsched  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

LOSS_TOL = 2e-3
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4
PARAM_RTOL, PARAM_ATOL = 5e-4, 5e-5
SCHED_RTOL = 1e-6
BLOCK = 16          # the attention block both packages' blocked attention take


def _models(jcfg, seed=0):
    jm = jax_build(jcfg, attn_block=BLOCK)
    params = jm.init_params(jax.random.PRNGKey(seed))
    lm = LM(ModelConfig.from_json(jcfg.to_json()), device="cpu", attn_block=BLOCK)
    lm.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params)))
    return jm, params, lm


def _flat(tree):
    """The JAX params (or grads) tree as ``{state_dict name: float32 array}``."""
    return {n: t.float().numpy() for n, t in
            params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), tree)).items()}


def _batch(cfg, S=32, B=4, seed=3, step=0):
    return jdata.TokenStream(jdata.DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                              global_batch=B, seed=seed)).batch(step)


def _cfg(name, chunk=0):
    return replace(reduced(jax_config(name)), dtype="float32", logits_chunk=chunk)


def _grads(lm, batch):
    P = {n: p.detach().clone().requires_grad_() for n, p in lm.params().items()}
    loss, metrics = lm.loss_fn(P, batch)
    names = list(P)
    # norm2 of a slot without an MLP takes no part: zeros, as under jax.grad
    grads = torch.autograd.grad(loss, [P[n] for n in names], allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), metrics, dict(zip(names, grads))


@pytest.mark.parametrize("chunk", [0, 16], ids=["full_logits", "logits_chunk16"])
@pytest.mark.parametrize("arch", ["qwen3_32b", "gemma3_12b", "moonshot_v1_16b",
                                  "falcon_mamba_7b", "jamba15_large"])
def test_loss_and_every_gradient_match_jax(arch, chunk):
    """Dense families: qk_norm and GQA (qwen3), sliding-window local layers
    and a period of 6 (gemma3); MoE (moonshot: router, experts through B4b's
    plain version, the dispatch's own backward), Mamba (falcon: ``A_log``,
    ``D``, ``dt_bias``, ``x_proj`` through B3b's plain version) and both in
    one model (jamba); ``remat`` on as the configs have it."""
    jcfg = _cfg(arch, chunk)
    assert jcfg.remat
    jm, params, lm = _models(jcfg)
    batch = _batch(jcfg)
    (jloss, jmet), jgrads = jax.value_and_grad(jm.loss_fn, has_aux=True)(params, batch)
    loss, metrics, grads = _grads(lm, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_TOL, atol=LOSS_TOL)
    assert set(metrics) == set(jmet)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmet[k]), rtol=LOSS_TOL,
                                   atol=LOSS_TOL, err_msg=k)
    want = _flat(jgrads)
    assert set(grads) == set(want)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[n], rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=n)


def test_moonshot_loss_and_aux_match_jax():
    jcfg = _cfg("moonshot_v1_16b")
    jm, params, lm = _models(jcfg)
    batch = _batch(jcfg)
    jloss, jmet = jax.jit(jm.loss_fn)(params, batch)
    loss, metrics, grads = _grads(lm, batch)
    for got, want in ((loss, jloss), (metrics["ce"], jmet["ce"]), (metrics["aux"], jmet["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(float(loss), float(metrics["ce"] + AUX_LOSS_COEF * metrics["aux"]),
                               rtol=1e-6)
    # the plain B4 path is differentiable on the CPU: every expert stack gets a gradient
    assert all(torch.isfinite(g).all() for g in grads.values())
    assert float(grads["slots.0.moe_wi"].abs().sum()) > 0


def test_falcon_mamba_loss_matches_jax():
    jcfg = _cfg("falcon_mamba_7b")
    jm, params, lm = _models(jcfg)
    batch = _batch(jcfg)
    jloss, _ = jax.jit(jm.loss_fn)(params, batch)
    loss, _, grads = _grads(lm, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_TOL, atol=LOSS_TOL)
    # the plain B3 path is differentiable on the CPU
    assert all(torch.isfinite(g).all() for g in grads.values())
    assert float(grads["slots.0.A_log"].abs().sum()) > 0


@pytest.mark.parametrize("opt_name", ["sgdm", "adafactor"])
def test_jamba_train_steps_match_jax(opt_name):
    """Three steps of reduced jamba15_large (Mamba and MoE in one model)
    through the port's trainer against the JAX package's: each step's loss
    and gradient norm, then every parameter. (AdamW is held on qwen3 above:
    here its first update of a gradient of 2e-9, against its eps of 1e-8,
    turns the two packages' 1e-9 differences in summation order into a
    parameter 1.6e-4 apart.)"""
    jcfg = _cfg("jamba15_large")
    jm, jparams, lm = _models(jcfg)
    jo = jopt.make_optimizer(opt_name, jsched.warmup_cosine(1e-3, 2, 3), jcfg)
    to = topt.make_optimizer(opt_name, tsched.warmup_cosine(1e-3, 2, 3), lm.cfg)
    jstep = jax.jit(jtrainer.make_train_step(jm, jo))
    tstep = ttrainer.make_train_step(lm, to)
    jp, js = jparams, jo.init(jparams)
    tp = {n: p.detach() for n, p in lm.params().items()}
    ts = to.init(tp)
    for i in range(3):
        batch = _batch(jcfg, step=i)
        jp, js, jm_ = jstep(jp, js, batch)
        tp, ts, tm = tstep(tp, ts, batch)
        for k in tm:
            np.testing.assert_allclose(float(tm[k]), float(jm_[k]), rtol=LOSS_TOL,
                                       atol=LOSS_TOL, err_msg=f"step {i} {k}")
    want = _flat(jp)
    assert set(tp) == set(want)
    for n, p in tp.items():
        np.testing.assert_allclose(p.float().numpy(), want[n], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=n)


def test_moe_aux_loss_matches_jax():
    jcfg = _cfg("moonshot_v1_16b")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, jcfg.d_model), dtype=np.float32)
    router = rng.standard_normal((jcfg.d_model, jcfg.moe.num_experts), dtype=np.float32)
    want = jmoe.moe_aux_loss(jnp.asarray(x), {"router": jnp.asarray(router)}, jcfg)
    got = tmoe.moe_aux_loss(torch.as_tensor(x), {"router": torch.as_tensor(router)},
                            ModelConfig.from_json(jcfg.to_json()))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.fixture(scope="module")
def qwen():
    jcfg = _cfg("qwen3_32b")
    return (jcfg, *_models(jcfg))


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("opt_name", ["adamw", "adafactor", "sgdm"])
def test_train_steps_match_jax(qwen, opt_name, accum):
    """Three steps of ``make_train_step`` from ``make_optimizer`` under a warmup
    schedule: the losses and gradient norms at each step, then every parameter."""
    jcfg, jm, jparams, lm = qwen
    jo = jopt.make_optimizer(opt_name, jsched.warmup_cosine(1e-3, 2, 3), jcfg)
    to = topt.make_optimizer(opt_name, tsched.warmup_cosine(1e-3, 2, 3), lm.cfg)
    jstep = jax.jit(jtrainer.make_train_step(jm, jo, accum=accum))
    tstep = ttrainer.make_train_step(lm, to, accum=accum)
    jp, js = jparams, jo.init(jparams)
    tp = {n: p.detach() for n, p in lm.params().items()}
    ts = to.init(tp)
    for i in range(3):
        batch = _batch(jcfg, step=i)
        jp, js, jm_ = jstep(jp, js, batch)
        tp, ts, tm = tstep(tp, ts, batch)
        assert set(tm) == {"loss", "grad_norm"}
        for k in tm:
            np.testing.assert_allclose(float(tm[k]), float(jm_[k]), rtol=LOSS_TOL,
                                       atol=LOSS_TOL, err_msg=f"step {i} {k}")
    assert int(ts["step"]) == int(js["step"]) == 3
    want = _flat(jp)
    for n, p in tp.items():
        np.testing.assert_allclose(p.numpy(), want[n], rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=n)


def test_eval_step_matches_jax(qwen):
    jcfg, jm, jparams, lm = qwen
    batch = _batch(jcfg, step=7)
    want = jtrainer.make_eval_step(jm)(jparams, batch)
    got = ttrainer.make_eval_step(lm)(lm.params(), batch)
    assert set(got) == set(want) == {"loss", "ce"}
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_TOL)


def test_grad_transform_hook_and_metrics(qwen):
    """tests/test_trainer.py's hook and metrics tests, on the port."""
    _, _, _, lm = qwen
    calls = []

    def gt(grads):
        calls.append(1)
        return {n: torch.zeros_like(g) for n, g in grads.items()}

    params = {n: p.detach() for n, p in lm.params().items()}
    opt = topt.AdamW(lr=0.0)
    step = ttrainer.make_train_step(lm, opt, accum=2, grad_transform=gt)
    new, _, m = step(params, opt.init(params), _batch(lm.cfg))
    assert calls and float(m["grad_norm"]) == 0.0 and set(m) == {"loss", "grad_norm"}
    assert all(torch.equal(new[n], params[n]) for n in params)


@pytest.mark.parametrize("kind", ["synthetic", "memmap"])
def test_token_stream_and_prefetcher_batches_are_byte_equal(tmp_path, kind):
    path = None
    if kind == "memmap":
        path = str(tmp_path / "tokens.bin")
        np.random.default_rng(0).integers(0, 500, 4096).astype(np.int32).tofile(path)
    for dp_rank, dp_size in ((0, 1), (1, 2)):
        kw = dict(vocab_size=512, seq_len=24, global_batch=8, seed=11, kind=kind, path=path,
                  dp_rank=dp_rank, dp_size=dp_size)
        js = jdata.TokenStream(jdata.DataConfig(**kw))
        ts = tdata.TokenStream(tdata.DataConfig(**kw))
        for step in (0, 1, 17):
            a, b = js.batch(step), ts.batch(step)
            assert set(a) == set(b) == {"tokens", "labels"}
            for n in a:
                assert a[n].dtype == b[n].dtype and a[n].tobytes() == b[n].tobytes()
        jp, tp = jdata.Prefetcher(js, start_step=3), tdata.Prefetcher(ts, start_step=3)
        try:
            for _ in range(4):
                a, b = jp.next(), tp.next()
                assert all(a[n].tobytes() == b[n].tobytes() for n in a)
        finally:
            jp.stop()
            tp.stop()


@pytest.mark.parametrize("name", ["constant", "warmup_cosine", "inverse_sqrt"])
def test_schedules_match_jax(name):
    args = {"constant": (3e-3,), "warmup_cosine": (3e-3, 20, 60),
            "inverse_sqrt": (1e-2, 10)}[name]
    jf, tf = getattr(jsched, name)(*args), getattr(tsched, name)(*args)
    steps = np.arange(0, 80, dtype=np.int32)
    want = np.array([float(jf(jnp.asarray(s))) for s in steps])
    got = np.array([float(tf(torch.tensor(int(s), dtype=torch.int32))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=SCHED_RTOL)


# ---------------------------------------------------------------------------
# Checkpoints (tests/test_checkpoint.py:22-85, on the port)
# ---------------------------------------------------------------------------


@pytest.fixture
def tree_():
    return {"params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                       "b": torch.ones((4,), dtype=torch.bfloat16)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32),
                    "m": {"w": torch.full((3, 4), 0.5)}}}


def _leaves(tree):
    from repro_torch.distributed.checkpoint import _flatten
    return [leaf for _, leaf in _flatten(tree)]


def test_checkpoint_roundtrip(tmp_path, tree_):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(42, tree_)
    assert mgr.latest_step() == 42
    restored = mgr.restore(42, tree_)
    for a, b in zip(_leaves(tree_), _leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_async_save_and_wait(tmp_path, tree_):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, tree_)
    mgr.wait()
    assert mgr.latest_step() == 1


def test_checkpoint_keep_k_retention(tmp_path, tree_):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree_)
    assert mgr.all_steps() == [3, 4]


def test_checkpoint_uncommitted_step_ignored(tmp_path, tree_):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(5, tree_)
    os.makedirs(tmp_path / "step_000000009")       # a torn write: no MANIFEST
    assert mgr.latest_step() == 5


def test_checkpoint_corrupted_manifest_skipped(tmp_path, tree_):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(5, tree_)
    mgr.save(6, tree_)
    shutil.rmtree(tmp_path / "step_000000006")
    assert mgr.latest_step() == 5
    step, restored = mgr.restore_latest(tree_)
    assert step == 5 and restored is not None


def test_checkpoint_restore_latest_empty(tmp_path, tree_):
    step, restored = CheckpointManager(str(tmp_path)).restore_latest(tree_)
    assert step is None and restored is None


def test_checkpoint_extra_metadata(tmp_path, tree_):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(8, tree_, extra={"mesh": [1], "arch": "train_100m"})
    with open(tmp_path / "step_000000008" / "MANIFEST.json") as f:
        assert json.load(f)["extra"]["arch"] == "train_100m"


def _nested(rng):
    """A nested dict with a list and a scalar, in float32, bfloat16 and int32."""
    return {"p": {"embed": rng.standard_normal((6, 4), dtype=np.float32),
                  "slots": [{"wq": rng.standard_normal((2, 4, 4), dtype=np.float32)},
                            {"wq": rng.standard_normal((2, 4, 4), dtype=np.float32)}]},
            "o": {"step": np.asarray(3, np.int32),
                  "m": rng.standard_normal((5,), dtype=np.float32)}}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_between_the_packages(tmp_path, writer):
    """A nested tree written by one package's manager restores in the other's
    to the same arrays and dtypes, the bfloat16 leaf bit for bit."""
    arrs = _nested(np.random.default_rng(0))
    jtree = jax.tree.map(jnp.asarray, arrs)
    jtree["p"]["embed"] = jtree["p"]["embed"].astype(jnp.bfloat16)
    ttree = jax.tree.map(lambda a: tensor_from_numpy(np.asarray(a)), jtree)
    if writer == "jax":
        JaxManager(str(tmp_path), async_save=False).save(4, jtree)
        got = CheckpointManager(str(tmp_path)).restore(4, ttree)
        pairs = zip(_leaves(got), jax.tree.leaves(jtree))
    else:
        CheckpointManager(str(tmp_path), async_save=False).save(4, ttree)
        got = JaxManager(str(tmp_path)).restore(4, jtree)
        pairs = zip(_leaves(ttree), jax.tree.leaves(got))
    n = 0
    for t, j in pairs:
        j = np.asarray(j)
        assert str(t.dtype).removeprefix("torch.") == j.dtype.name
        if j.dtype.name == "bfloat16":
            assert t.view(torch.int16).numpy().tobytes() == j.view(np.int16).tobytes()
        else:
            assert t.numpy().tobytes() == j.tobytes()
        n += 1
    assert n == 5


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def test_train_launcher_runs_reduced_train_100m_on_the_cpu(capsys):
    from repro_torch.launch import train
    rec = train.main(["--device", "cpu", "--arch", "train_100m", "--reduced", "--steps", "5"])
    out = capsys.readouterr().out
    assert "[train] step     0 loss=" in out and "[train] step     4 loss=" in out
    assert "tok/s=" in out and out.rstrip().endswith("[train] done")
    assert len(rec["losses"]) == 5 and np.isfinite(rec["losses"]).all()
    assert rec["tokens"] == 5 * 8 * 64 and rec["start"] == 0


def test_train_launcher_resumes_exactly(tmp_path, capsys):
    """20 steps with a checkpoint every 10, then a run resumed from step 10
    gives steps 11-20's losses bit for bit."""
    from repro_torch.launch import train
    ck = str(tmp_path / "ck")
    args = ["--device", "cpu", "--arch", "train_100m", "--reduced", "--seq", "32",
            "--ckpt", ck, "--ckpt-every", "10"]
    full = train.main(args + ["--steps", "20"])
    assert CheckpointManager(ck).all_steps() == [10, 20]
    shutil.rmtree(os.path.join(ck, "step_000000020"))
    resumed = train.main(args + ["--steps", "10"])
    assert "[train] resumed at step 10" in capsys.readouterr().out
    assert resumed["start"] == 10 and resumed["losses"] == full["losses"][10:]
    assert CheckpointManager(ck).all_steps() == [10, 20]


def test_train_launcher_refuses_a_model_axis_and_needs_a_card(monkeypatch):
    from repro_torch.launch import train
    # one rank does not split into a model axis of 2 (tests/test_torch_mesh.py
    # trains on one across 8 ranks)
    with pytest.raises(ValueError, match="does not divide 1 ranks"):
        train.main(["--device", "cpu", "--reduced", "--steps", "1", "--model-axis", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--reduced", "--steps", "1"])
