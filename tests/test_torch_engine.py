"""The port's serving engine on the CPU (plain versions): the five checks of
tests/test_engine.py, and token parity with the JAX engine on shared f32
weights."""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import base as jax_configs  # noqa: E402
from repro.configs import reduced  # noqa: E402
from repro.core.config_store import ConfigStore as JaxConfigStore  # noqa: E402
from repro.core.config_store import ImageRegistry as JaxImageRegistry  # noqa: E402
from repro.core.types import FunctionConfig as JaxFunctionConfig  # noqa: E402
from repro.core.types import Request as JaxRequest  # noqa: E402
from repro.serving.engine import Worker as JaxWorker  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import ModelConfig, base as port_configs  # noqa: E402
from repro_torch.core.config_store import ConfigStore, ImageRegistry  # noqa: E402
from repro_torch.core.router import build_tree  # noqa: E402
from repro_torch.core.types import FunctionConfig, Request  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.serving import engine as port_engine  # noqa: E402
from repro_torch.serving.engine import Engine, Worker, _bucket, weight_seed  # noqa: E402


@pytest.fixture(scope="module")
def platform():
    store = ConfigStore()
    store.put(FunctionConfig(name="gen", arch="tiny_lm", concurrency=4,
                             gen_tokens=4, idle_timeout_s=60.0))
    return store, ImageRegistry()


@pytest.fixture(scope="module")
def engine(platform):
    store, registry = platform
    return Engine(build_tree(2, fanout=2), store, registry, max_len=64, device="cpu")


def test_batched_requests_complete(engine):
    reqs = [Request(fn="gen", arrival_t=0.0, size=8) for _ in range(6)]
    for r in reqs:
        engine.submit(r)
    results = engine.run()
    assert len(results) == 6
    assert all(r.ok for r in results)
    assert {r.rid for r in results} == {r.rid for r in reqs}


def test_cold_then_warm(engine):
    r1 = Request(fn="gen", arrival_t=0.0, size=8)
    engine.submit(r1)
    engine.run()
    r2 = Request(fn="gen", arrival_t=0.0, size=8)
    engine.submit(r2)
    res2 = engine.run()
    tel = engine.telemetry()
    cold_flags = {t.cold for t in tel}
    assert True in cold_flags         # first touch materialized and warmed up
    assert res2[-1].ok


def test_greedy_decode_matches_offline(platform):
    """Engine-generated tokens == offline greedy decode on the same weights."""
    store, registry = platform
    w = Worker("w0", store, registry, max_len=64, device="cpu")
    req = Request(fn="gen", arrival_t=0.0, size=8)
    w.submit(req)
    results = w.drain()
    assert results and results[0].ok
    inst = w.instances["gen"][0]
    got = inst.generated[req.rid]

    # offline: same weights, same prompt handling (bucket to 16 with zero pad)
    toks = np.zeros((1, 16), np.int32)
    toks[0, :8] = (np.arange(8) % 97 + 2)
    logits, pcache = inst.model.prefill({"tokens": torch.as_tensor(toks)})
    cache = inst.model.init_cache(1, 64)
    for cs, ps in zip(cache["slots"], pcache["slots"]):
        for n in cs:
            cs[n][:, :, :16] = ps[n]
    exp = [int(torch.argmax(logits[0]))]
    tok = exp[0]
    for i in range(3):
        lg, cache = inst.model.decode_step(
            cache, {"token": torch.tensor([tok]), "pos": torch.tensor([16 + i])})
        tok = int(torch.argmax(lg[0]))
        exp.append(tok)
    assert got[:2] == exp[:2], (got, exp)


def test_within_instance_concurrency_real(platform):
    """c=1 spawns more instances than c=4 on the real engine too (RQ-A)."""
    store, registry = platform
    counts = {}
    for c in (1, 4):
        store.put(FunctionConfig(name="gen", arch="tiny_lm", concurrency=c,
                                 gen_tokens=2, idle_timeout_s=60.0))
        w = Worker(f"w-{c}", store, registry, max_len=64, device="cpu")
        for _ in range(4):
            w.submit(Request(fn="gen", arrival_t=0.0, size=8))
        w.drain()
        counts[c] = len(w.instances["gen"])
    store.put(FunctionConfig(name="gen", arch="tiny_lm", concurrency=4,
                             gen_tokens=4, idle_timeout_s=60.0))
    assert counts[1] == 4 and counts[4] == 1


def test_telemetry_recorded(engine):
    engine.submit(Request(fn="gen", arrival_t=0.0, size=8))
    engine.run()
    tel = engine.telemetry()
    assert tel
    t = tel[-1]
    assert t.latency > 0 and t.fn == "gen" and len(t.features()) == 7


def test_prompt_at_max_len_decodes_without_raising():
    """A prompt that buckets to max_len admits at pos = W: the first decode
    write falls past the cache and is dropped, as in the JAX engine."""
    store = ConfigStore()
    store.put(FunctionConfig(name="gen", arch="tiny_lm", concurrency=2, gen_tokens=2))
    w = Worker("w-edge", store, ImageRegistry(), max_len=32, device="cpu")
    req = Request(fn="gen", arrival_t=0.0, size=20)
    assert _bucket(req.size) == 32
    w.submit(req)
    res = w.drain()
    assert res[0].ok and len(w.instances["gen"][0].generated[req.rid]) == 3


def test_weight_seed_is_stable():
    # crc32, not the process-salted hash() the JAX engine seeds with
    assert weight_seed("tiny_lm") == 120455981
    assert weight_seed("tiny_lm") != weight_seed("small_lm")


def _register_both(monkeypatch, jcfg):
    """``jcfg`` under its own name, in both registries for this test."""
    monkeypatch.setitem(jax_configs._REGISTRY, jcfg.name, jcfg)
    monkeypatch.setitem(port_configs._REGISTRY, jcfg.name,
                        ModelConfig.from_json(jcfg.to_json()))
    return jcfg.name


@pytest.fixture
def f32_tiny(monkeypatch):
    """tiny_lm in f32 under its own name, in both registries for this test."""
    return _register_both(monkeypatch, replace(jax_configs.get_config("tiny_lm"),
                                               name="tiny_lm_f32", dtype="float32"))


@pytest.fixture
def f32_falcon(monkeypatch):
    """A reduced falcon_mamba_7b in f32 under its own name, in both registries."""
    return _register_both(monkeypatch, replace(
        reduced(jax_configs.get_config("falcon_mamba_7b")), name="falcon_mamba_f32",
        dtype="float32"))


def test_worker_tokens_match_the_jax_worker(f32_tiny, monkeypatch):
    """The port's Worker, with its image seeded from the JAX instance's bridged
    f32 weights, generates the JAX Worker's tokens for the same requests."""
    _worker_parity(f32_tiny, monkeypatch)


def test_falcon_mamba_worker_tokens_match_the_jax_worker(f32_falcon, monkeypatch):
    """The same for Mamba slots: admission inserts the conv/ssm caches whole
    (ssm in float32), and the prompt's pad tokens run through the scan into
    the state handed to decode, as in the JAX engine."""
    _worker_parity(f32_falcon, monkeypatch)


def _worker_parity(arch, monkeypatch):
    sizes = [8, 20, 5, 13]
    jstore = JaxConfigStore()
    jstore.put(JaxFunctionConfig(name="gen", arch=arch, concurrency=2, gen_tokens=4))
    jw = JaxWorker("jw", jstore, JaxImageRegistry(), max_len=64)
    jreqs = [JaxRequest(fn="gen", arrival_t=0.0, size=s) for s in sizes]
    for r in jreqs:
        jw.submit(r)
    assert len(jw.drain()) == len(sizes)
    jinst = jw.instances["gen"][0]     # both replicas share the image's weights

    cfg = port_configs.get_config(arch)
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, jinst.params)))
    monkeypatch.setitem(port_engine._IMAGE_CACHE, (arch, 2, 64, "cpu"), lm)
    store = ConfigStore()
    store.put(FunctionConfig(name="gen", arch=arch, concurrency=2, gen_tokens=4))
    w = Worker("w", store, ImageRegistry(), max_len=64, device="cpu")
    reqs = [Request(fn="gen", arrival_t=0.0, size=s) for s in sizes]
    for r in reqs:
        w.submit(r)
    assert len(w.drain()) == len(sizes)
    assert len(w.instances["gen"]) == len(jw.instances["gen"]) == 2
    assert all(i.model is lm for i in w.instances["gen"])
    got = {rid: t for i in w.instances["gen"] for rid, t in i.generated.items()}
    want = {rid: t for i in jw.instances["gen"] for rid, t in i.generated.items()}
    assert [got[r.rid] for r in reqs] == [want[r.rid] for r in jreqs]
