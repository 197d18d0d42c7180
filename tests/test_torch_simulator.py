"""The port's simulator core against the JAX package's: the same run, built in
each package from the same seeds with each package's own types, store and
tree, gives the same ``stream_digest`` byte for byte (and the same decision
logs where they are recorded). Also the event engine's order and the configs
that ``Simulator.fn_cost`` reads."""
import itertools
import random
import types

import numpy as np
import pytest

import repro.configs as jax_configs
import repro.core.config_store as jax_store
import repro.core.events as jax_events
import repro.core.placement as jax_placement
import repro.core.router as jax_router
import repro.core.simulator as jax_sim
import repro.core.types as jax_types
import repro.workloads as jax_workloads
import repro_torch.configs as port_configs
import repro_torch.core.config_store as port_store
import repro_torch.core.events as port_events
import repro_torch.core.router as port_router
import repro_torch.core.simulator as port_sim
import repro_torch.core.types as port_types
import repro_torch.workloads as port_workloads

JAX = types.SimpleNamespace(sim=jax_sim, store=jax_store, router=jax_router,
                            types=jax_types, wl=jax_workloads, events=jax_events)
PORT = types.SimpleNamespace(sim=port_sim, store=port_store, router=port_router,
                             types=port_types, wl=port_workloads, events=port_events)


@pytest.fixture
def fresh_ids(monkeypatch):
    """Restart both packages' process-global request-id counters (what
    ``poisson_load``'s ``rid_base=None`` draws from) before a side runs."""
    def reset():
        for pkg in (JAX, PORT):
            monkeypatch.setattr(pkg.types, "_req_ids", itertools.count())
    return reset


def _both(build, fresh_ids):
    """``build(pkg)`` in each package, the counters restarted before each."""
    out = []
    for pkg in (JAX, PORT):
        fresh_ids()
        out.append(build(pkg))
    return out


def _store(pkg, *cfgs):
    store = pkg.store.ConfigStore()
    for kw in cfgs:
        store.put(pkg.types.FunctionConfig(**kw))
    return store


def _fidelity_real_run(pkg, backend):
    """The "real" run of tests/test_emulation.py::test_emulated_sim_fidelity."""
    store = _store(pkg, dict(name="fn", arch="tiny_lm", concurrency=4, cold_start_s=0.2))
    sim = pkg.sim.Simulator(pkg.router.build_tree(8, fanout=4), store,
                            pkg.sim.SyntheticServiceModel(seed=2), seed=5,
                            event_backend=backend)
    pkg.sim.poisson_load(sim, fn="fn", rps=150, duration_s=15, seed=4)
    sim.run()
    return sim


@pytest.mark.parametrize("backend", ["single_heap", "sharded"])
def test_fidelity_real_run_digest_equal(backend, fresh_ids):
    j, p = _both(lambda pkg: _fidelity_real_run(pkg, backend), fresh_ids)
    assert len(p.results) > 1500
    assert port_sim.stream_digest(p) == jax_sim.stream_digest(j)
    assert p.events_processed == j.events_processed


def test_backends_agree_in_the_port(fresh_ids):
    fresh_ids()
    a = _fidelity_real_run(PORT, "single_heap")
    fresh_ids()
    b = _fidelity_real_run(PORT, "sharded")
    assert port_sim.stream_digest(a) == port_sim.stream_digest(b)


def _mixed(pkg, *, duration_s=6.0, workers=4, leaf_policy="least_loaded", slo=None,
           sim_kw=None, mem=None):
    """Three functions (concurrency 0, 1 and 4; timeout 0.4 s; at most two
    instances a worker) under bursty arrivals."""
    cfgs = [dict(name=f"f{c}", arch=arch, concurrency=c, timeout_s=0.4,
                 max_instances_per_worker=2, cold_start_s=0.15,
                 **({} if mem is None else {"memory_mb": m}))
            for c, arch, m in ((0, "tiny_lm", 384), (1, "small_lm", 768), (4, "tiny_lm", 512))]
    store = _store(pkg, *cfgs)
    profiles = [pkg.wl.FunctionProfile(c["name"], weight=w,
                                       size=pkg.wl.SizeDist.uniform(8, 48),
                                       slo_p95_s=slo)
                for c, w in zip(cfgs, (0.5, 0.2, 0.3))]
    wl = pkg.wl.MixedWorkload(pkg.wl.BurstyArrivals(rate_on=900.0, rate_off=120.0,
                                                    mean_on_s=0.5, mean_off_s=1.5),
                              profiles, duration_s=duration_s, seed=11)
    tree = pkg.router.build_tree(workers, fanout=2, leaf_policy=leaf_policy)
    sim = pkg.sim.Simulator(tree, store, pkg.sim.SyntheticServiceModel(seed=3), seed=7,
                            **(sim_kw or {}))
    return sim, wl


def _run_mixed(pkg, **kw):
    sim, wl = _mixed(pkg, **kw)
    sim.load(wl)
    sim.run()
    return sim


def _assert_same(j, p):
    assert len(p.results) == len(j.results) > 0
    assert port_sim.stream_digest(p) == jax_sim.stream_digest(j)


@pytest.mark.parametrize("backend", ["single_heap", "sharded"])
def test_mixed_bursty_workload_digest_equal(backend, fresh_ids):
    j, p = _both(lambda pkg: _run_mixed(pkg, sim_kw=dict(event_backend=backend)),
                 fresh_ids)
    _assert_same(j, p)
    errors = {r.error for r in p.results if not r.ok}
    assert "queue timeout" in errors        # the 0.4 s timeout bites


def test_hedged_requests_digest_equal(fresh_ids):
    j, p = _both(lambda pkg: _run_mixed(pkg, sim_kw=dict(hedge_after_s=0.05)), fresh_ids)
    _assert_same(j, p)
    assert p.hedges_seen == j.hedges_seen > 0


def test_retry_budget_digest_equal(fresh_ids):
    def build(pkg):
        sim, wl = _mixed(pkg, sim_kw=dict(retry_budget=2))
        sim.load(wl)
        for i, w in enumerate(("w0", "w1", "w2")):
            sim.inject_failure(w, at=0.7 + 1.3 * i, recover_after=0.8)
        sim.run()
        return sim
    j, p = _both(build, fresh_ids)
    _assert_same(j, p)
    assert p.retries_scheduled == j.retries_scheduled > 0


@pytest.mark.parametrize("placer", sorted(jax_placement.PLACERS))
def test_worker_memory_under_every_placer_digest_equal(placer, fresh_ids):
    kw = dict(worker_memory_mb=1536, placer=placer, zones=2, record_decisions=True)
    j, p = _both(lambda pkg: _run_mixed(pkg, mem=True, sim_kw=kw), fresh_ids)
    _assert_same(j, p)
    assert p.placement_log() == j.placement_log() != ""


@pytest.mark.parametrize("staleness", [0.0, 0.05])
@pytest.mark.parametrize("policy", sorted(jax_router.POLICIES))
def test_every_leaf_policy_digest_equal(policy, staleness, fresh_ids):
    j, p = _both(lambda pkg: _run_mixed(pkg, workers=8, leaf_policy=policy, slo=0.3,
                                        sim_kw=dict(state_staleness_s=staleness)),
                 fresh_ids)
    _assert_same(j, p)


def test_iid_scope_worker_digest_equal(fresh_ids):
    j, p = _both(lambda pkg: _run_mixed(pkg, sim_kw=dict(iid_scope="worker")), fresh_ids)
    _assert_same(j, p)
    assert {r.instance for r in p.results} == {r.instance for r in j.results}


def test_recorded_decision_logs_equal(fresh_ids):
    j, p = _both(lambda pkg: _run_mixed(pkg, sim_kw=dict(record_decisions=True)),
                 fresh_ids)
    _assert_same(j, p)
    assert p.placement_log() == j.placement_log() != ""
    assert p.routing_log() == j.routing_log() != ""


@pytest.mark.parametrize("backend", ["single_heap", "sharded"])
def test_load_bulk_digest_equal_and_equal_to_load(backend, fresh_ids):
    def build(pkg, bulk):
        sim, wl = _mixed(pkg, sim_kw=dict(event_backend=backend))
        batch = wl.generate_bulk()
        if bulk:
            assert sim.load_bulk(batch, chunk=500) == len(batch)
        else:
            for req in batch.to_requests():
                sim.submit(req)
        sim.run()
        return sim
    j, p = _both(lambda pkg: build(pkg, True), fresh_ids)
    _assert_same(j, p)
    fresh_ids()
    assert port_sim.stream_digest(build(PORT, False)) == port_sim.stream_digest(p)


def test_segmented_run_equals_straight_run(fresh_ids):
    def build(pkg, cuts):
        sim, wl = _mixed(pkg)
        sim.load(wl)
        for t in cuts:
            sim.run(until=t)
        sim.run()
        return sim
    straight = _both(lambda pkg: build(pkg, ()), fresh_ids)
    cut = _both(lambda pkg: build(pkg, (1.5, 3.25, 4.0)), fresh_ids)
    _assert_same(*straight)
    _assert_same(*cut)
    assert port_sim.stream_digest(cut[1]) == port_sim.stream_digest(straight[1])
    assert cut[1].events_processed == straight[1].events_processed \
        == straight[0].events_processed == cut[0].events_processed


def test_part_summaries_merge_to_summarize(fresh_ids):
    j, p = _both(_run_mixed, fresh_ids)
    half = len(p.results) // 2
    merged = port_sim.merge_part_summaries([port_sim.part_summary(p.results[:half]),
                                            port_sim.part_summary(p.results[half:])])
    want = port_sim.summarize(p.results)
    assert merged == want == jax_sim.summarize(j.results)
    assert jax_sim.merge_part_summaries([jax_sim.part_summary(j.results[:half]),
                                         jax_sim.part_summary(j.results[half:])]) == merged


def test_emulation_example_scale_with_synthetic_model(fresh_ids):
    """The example's shape at scale (1024 workers, fanout 16, 5000 rps for
    4 s), served by the synthetic model."""
    def build(pkg):
        store = _store(pkg, dict(name="tiny-gen", arch="tiny_lm", concurrency=4,
                                 gen_tokens=4, idle_timeout_s=60.0))
        sim = pkg.sim.Simulator(pkg.router.build_tree(1024, fanout=16), store,
                                pkg.sim.SyntheticServiceModel(seed=2), seed=4)
        n = pkg.sim.poisson_load(sim, fn="tiny-gen", rps=5000, duration_s=4, seed=6)
        sim.run()
        return sim, n
    (j, nj), (p, np_) = _both(build, fresh_ids)
    assert np_ == nj == len(p.results)
    _assert_same(j, p)


# ----------------------------------------------------------------- events
def _event_ops(seed, engines):
    """The same random pushes, bulk runs and pops into every engine; each
    pop must agree. Returns the drained stream of the first engine."""
    rng = random.Random(seed)
    nprng = np.random.default_rng(seed)
    now, stream = 0.0, []
    for op in range(600):
        r = rng.random()
        if r < 0.4:
            t = now + rng.random() * rng.choice([0.01, 0.5, 10.0, 1000.0])
            kind = "tick" if rng.random() < 0.1 else "ev"
            for e in engines:
                e.push(t, kind, op)
        elif r < 0.55:
            ts = np.sort(now + nprng.uniform(0.0, rng.choice([0.05, 2.0, 40.0]),
                                             rng.randrange(0, 300)))
            for e in engines:
                e.push_bulk(ts, "arrival", None)
        else:
            until = None if rng.random() < 0.6 else now + rng.random() * 3.0
            popped = [e.pop(until=until) for e in engines]
            assert all(x == popped[0] for x in popped), (seed, op, popped)
            if popped[0] is not None:
                now = max(now, popped[0][0])
                stream.append(popped[0])
        assert len({len(e) for e in engines}) == 1
        assert len({e.pending_real for e in engines}) == 1
    while True:
        popped = [e.pop() for e in engines]
        assert all(x == popped[0] for x in popped), (seed, popped)
        if popped[0] is None:
            return stream
        stream.append(popped[0])


@pytest.mark.parametrize("seed", range(6))
def test_event_engine_order_equal_across_backends_and_packages(seed):
    engines = [pkg.events.EventEngine(b, background=("tick",))
               for pkg in (JAX, PORT) for b in ("single_heap", "sharded")]
    assert len(_event_ops(seed, engines)) > 300


def test_event_backend_registries_equal():
    assert port_events.list_event_backends() == jax_events.list_event_backends()


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("name", list(jax_configs.list_configs()))
def test_config_param_count_and_fn_cost_equal(name):
    assert port_configs.get_config(name).to_json() == jax_configs.get_config(name).to_json()
    assert port_configs.get_config(name).param_count() == \
        jax_configs.get_config(name).param_count()
    costs = []
    for pkg in (JAX, PORT):
        store = _store(pkg, dict(name="fn", arch=name))
        sim = pkg.sim.Simulator(pkg.router.build_tree(2, fanout=2), store,
                                pkg.sim.SyntheticServiceModel())
        costs.append(sim.fn_cost("fn"))
    assert costs[0] == costs[1] != 1.0
