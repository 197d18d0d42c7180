"""The port's platform layers against the JAX package's: the chaos layer
(``core/faults.py``), the front-door gateway (``core/gateway.py``), workflows,
the scenario registry, the Azure trace reader, the autoscaler (metrics,
policies, controller, replay) and the elasticity launcher. The same run,
built in each package from the same seeds with each package's own types,
gives the same ``stream_digest``, fault, gateway and decision logs byte for
byte."""
import dataclasses
import hashlib
import itertools
import json
import os
import random
import subprocess
import sys
import types
from pathlib import Path

import pytest

import repro.autoscale as jax_autoscale
import repro.core.config_store as jax_store
import repro.core.faults as jax_faults
import repro.core.gateway as jax_gateway
import repro.core.router as jax_router
import repro.core.simulator as jax_sim
import repro.core.types as jax_types
import repro.launch.elastic as jax_elastic
import repro.workloads as jax_workloads
import repro.workloads.azure as jax_azure
import repro_torch.autoscale as port_autoscale
import repro_torch.core.config_store as port_store
import repro_torch.core.faults as port_faults
import repro_torch.core.gateway as port_gateway
import repro_torch.core.router as port_router
import repro_torch.core.simulator as port_sim
import repro_torch.core.types as port_types
import repro_torch.launch.elastic as port_elastic
import repro_torch.workloads as port_workloads
import repro_torch.workloads.azure as port_azure
from repro_torch.autoscale.replay import ReplayGateway

JAX = types.SimpleNamespace(sim=jax_sim, store=jax_store, router=jax_router, types=jax_types,
                            wl=jax_workloads, faults=jax_faults, gateway=jax_gateway,
                            autoscale=jax_autoscale, azure=jax_azure, elastic=jax_elastic)
PORT = types.SimpleNamespace(sim=port_sim, store=port_store, router=port_router,
                             types=port_types, wl=port_workloads, faults=port_faults,
                             gateway=port_gateway, autoscale=port_autoscale, azure=port_azure,
                             elastic=port_elastic)
ROOT = Path(__file__).resolve().parent.parent
AZURE = str(ROOT / "tests" / "data" / "azure_sample.csv")


@pytest.fixture
def fresh_ids(monkeypatch):
    """Restart both packages' process-global request-id counters (what a
    ``rid_base=None`` request draws from) before a side runs."""
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


def _digest(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def _scenario_sim(pkg, name, *, over, tree=None, **sim_kw):
    """Scenario ``name`` (built with ``over``) and the demo configs its
    functions need, on the synthetic model; returns the simulator (loaded,
    not run) and the count ``load`` returned."""
    wl = pkg.wl.build_scenario(name, **over)
    store = pkg.store.ConfigStore()
    pkg.wl.install_demo_configs(store, wl)
    sim = pkg.sim.Simulator(tree(pkg) if tree else pkg.router.build_tree(8, fanout=4), store,
                            pkg.sim.SyntheticServiceModel(seed=2), seed=7, **sim_kw)
    return sim, sim.load(wl)


def _assert_same(j, p):
    assert len(p.results) == len(j.results) > 0
    assert port_sim.stream_digest(p) == jax_sim.stream_digest(j)
    assert p.events_processed == j.events_processed


# ------------------------------------------------------------------ faults
# golden digests the JAX package pins (tests/test_faults.py:233-239): the chaos
# layer wired in but off (default FaultConfig, zones assigned) moves no byte
GOLDEN_OFF = {"steady": ("90ac57f36c579d36", dict(rps=300.0, duration_s=8.0, seed=3)),
              "multi_tenant": ("ec5034f85267151c", dict(rps=400.0, duration_s=8.0, seed=3))}


@pytest.mark.parametrize("case", sorted(GOLDEN_OFF))
def test_port_simulator_takes_faults_and_gives_the_jax_golden(case):
    want, kw = GOLDEN_OFF[case]
    sim, _ = _scenario_sim(PORT, case, over=kw, zones=2, faults=port_faults.FaultConfig())
    assert sim.faults is not None and not sim.faults.cfg.enabled
    sim.run()
    assert port_sim.stream_digest(sim) == want
    assert sim.fault_log() == ""


FAULT_PLANS = {
    "crash_chains": dict(worker_mttf_s=2.5, worker_mttr_s=0.8),
    "scripted_zone_outage": dict(scheduled=((1.5, "z0", 1.5),)),
    "random_zone_outages": dict(zone_outage_rate=0.4, zone_mttr_s=0.8),
    "stragglers": dict(straggler_rate=1.5, straggler_factor=6.0, straggler_duration_s=0.8),
    "lost_completions": dict(lost_finish_p=0.03),
    "all_kinds": dict(worker_mttf_s=4.0, worker_mttr_s=0.5, scheduled=((2.0, "z1", 1.0),),
                      straggler_rate=1.0, lost_finish_p=0.01, start_s=0.5, horizon_s=4.0),
}


@pytest.mark.parametrize("plan", sorted(FAULT_PLANS))
def test_fault_plan_digest_and_fault_log_equal(plan, fresh_ids):
    def build(pkg):
        sim, _ = _scenario_sim(pkg, "multi_tenant",
                               over=dict(rps=300.0, duration_s=5.0, seed=3), zones=2,
                               retry_budget=2, record_decisions=True,
                               faults=pkg.faults.FaultConfig(seed=4, **FAULT_PLANS[plan]))
        sim.run()
        return sim
    j, p = _both(build, fresh_ids)
    _assert_same(j, p)
    assert p.fault_log() == j.fault_log() != ""
    assert p.faults.summary() == j.faults.summary()
    assert p.placement_log() == j.placement_log()
    assert p.routing_log() == j.routing_log()
    assert p.retries_scheduled == j.retries_scheduled


def test_fault_config_fields_equal():
    assert [f.name for f in dataclasses.fields(port_faults.FaultConfig)] == \
        [f.name for f in dataclasses.fields(jax_faults.FaultConfig)]
    assert port_faults.FaultConfig().enabled is False
    assert port_sim.RETRYABLE_ERRORS == jax_sim.RETRYABLE_ERRORS


# ----------------------------------------------------------------- gateway
def _noisy(pkg, gateway=True, **sim_kw):
    """``noisy_neighbor`` with its quota and a ``max_inflight`` ceiling that
    sheds batch first, worker failures whose retries consult the gateway."""
    over = dict(seed=3, duration_s=4.0, gateway=gateway is True, flood_rate=60.0,
                flood_burst=8.0, max_inflight=40, batch_share=0.25)
    sim, _ = _scenario_sim(pkg, "noisy_neighbor", over=over, retry_budget=2,
                           tree=lambda pkg: pkg.router.build_tree(4, fanout=2),
                           **({} if gateway is True else {"gateway": gateway}), **sim_kw)
    for i, at in enumerate((1.0, 1.5, 2.2, 3.0)):
        sim.inject_failure(f"w{i}", at=at, recover_after=0.5)
    sim.run()
    return sim


def test_gateway_run_gateway_log_equal(fresh_ids):
    j, p = _both(lambda pkg: _noisy(pkg, record_decisions=True), fresh_ids)
    _assert_same(j, p)
    log = p.gateway_log()
    assert log == j.gateway_log()
    assert "verdict=rate limited" in log and "verdict=admission rejected" in log
    assert " retry " in log                                   # retries consult it too
    assert p.gateway.summary() == j.gateway.summary()
    assert p.retries_scheduled == j.retries_scheduled > 0
    assert (port_gateway.RATE_LIMITED, port_gateway.ADMISSION_REJECTED) == \
        (jax_gateway.RATE_LIMITED, jax_gateway.ADMISSION_REJECTED)


def test_control_plane_writes_the_same_gateway_lines(fresh_ids):
    """``ControlPlane.log_gateway`` on the same verdicts, in each package."""
    lines = []
    for pkg in (JAX, PORT):
        fresh_ids()
        sim = pkg.sim.Simulator(pkg.router.build_tree(2, fanout=2), pkg.store.ConfigStore(),
                                pkg.sim.SyntheticServiceModel(seed=2), record_decisions=True)
        for i, verdict in enumerate((None, pkg.gateway.RATE_LIMITED,
                                     pkg.gateway.ADMISSION_REJECTED)):
            sim.now = 0.125 * i
            req = pkg.types.Request(fn="f", arrival_t=sim.now, rid=i)
            sim.control.log_gateway("retry" if i == 2 else "arrival", req, verdict)
        lines.append(list(sim.gateway_records))
    assert lines[0] == lines[1] and len(lines[1]) == 3


def test_gateway_off_disabled_and_unlimited_leave_the_digest(fresh_ids):
    """The relation ``tests/test_gateway.py:193-206`` pins, in the port and
    against the JAX package."""
    def build(pkg):
        out = {}
        for label, cfg in (("none", None), ("disabled", pkg.gateway.GatewayConfig(enabled=False)),
                           ("unlimited", pkg.gateway.GatewayConfig())):
            sim, _ = _scenario_sim(pkg, "steady", over=dict(rps=200.0, duration_s=4.0, seed=3),
                                   tree=lambda pkg: pkg.autoscale.build_pool(1, 2), gateway=cfg)
            sim.run()
            out[label] = (pkg.sim.stream_digest(sim), sim.gateway)
        return out
    j, p = _both(build, fresh_ids)
    assert p["disabled"][1] is None and p["unlimited"][1] is not None
    assert {d for d, _ in p.values()} == {d for d, _ in j.values()} == {j["none"][0]}


def test_recorded_verdicts_replay_byte_identically_in_the_port(fresh_ids):
    jax_live, live = _both(lambda pkg: _noisy(pkg, record_decisions=True), fresh_ids)
    records = live.gateway.decision_records()
    assert any(r["verdict"] != "admit" for r in records)
    assert jax_live.gateway.decision_records() == records
    fresh_ids()
    again = _noisy(PORT, gateway=ReplayGateway(records))
    assert port_sim.stream_digest(again) == port_sim.stream_digest(live)
    assert again.gateway.summary() == live.gateway.summary()
    with pytest.raises(ValueError, match="diverged"):
        ReplayGateway([{"rid": 7, "verdict": "admit"}]).admit(
            port_types.Request(fn="f", arrival_t=0.0, rid=8), 0.0)


def test_token_bucket_and_admission_equal():
    rng = random.Random(5)
    ops = [(rng.choice(["f", "g", "h"]), rng.choice(["interactive", "batch", None]),
            rng.random() < 0.3) for _ in range(400)]
    verdicts = []
    for pkg in (JAX, PORT):
        gw = pkg.gateway.Gateway(pkg.gateway.GatewayConfig(
            quotas={"f": pkg.gateway.TenantQuota(rate=20.0, burst=3.0, priority="batch"),
                    "g": pkg.gateway.TenantQuota(rate=50.0, burst=1.0)},
            max_inflight=6, batch_share=0.5), record=True)
        out, held = [], []
        for i, (fn, pri, release) in enumerate(ops):
            now = i * 0.01
            if release and held:
                gw.release(held.pop(0), now)
            req = pkg.types.Request(fn=fn, arrival_t=now, rid=i, priority=pri)
            v = gw.admit(req, now, retry=i % 7 == 0)
            if v is None:
                held.append(req)
            out.append(v)
        verdicts.append((out, gw.decision_records(), gw.summary()))
    assert verdicts[0] == verdicts[1]
    assert {None, "rate limited", "admission rejected"} <= set(verdicts[1][0])


# --------------------------------------------------------------- scenarios
SHORT = dict(duration_s=3.0, seed=3)
SCENARIO_KW = {
    "zone_outage": dict(outage_at=1.0, outage_duration_s=1.0, lost_finish_p=0.01),
    "retry_storm": dict(outage_at=1.0, outage_duration_s=0.8),
    "trace_replay": dict(path=AZURE, fmt="azure", aggregate=True, time_scale=0.01,
                         duration_s=None),
}


def test_scenario_registries_equal():
    assert port_workloads.list_scenarios() == jax_workloads.list_scenarios()
    assert len(port_workloads.list_scenarios()) == 11
    assert set(port_workloads.__all__) == set(jax_workloads.__all__)


@pytest.mark.parametrize("name", sorted(jax_workloads.SCENARIOS))
def test_every_scenario_digest_equal(name, fresh_ids):
    def build(pkg):
        sim, n = _scenario_sim(pkg, name, over={**SHORT, **SCENARIO_KW.get(name, {})},
                               zones=3, retry_budget=1, record_decisions=True)
        sim.run()
        return sim, n
    (j, nj), (p, np_) = _both(build, fresh_ids)
    assert np_ == nj
    _assert_same(j, p)
    assert p.fault_log() == j.fault_log()
    assert p.gateway_log() == j.gateway_log()
    assert p.routing_log() == j.routing_log()


# -------------------------------------------------------------- autoscaler
POLICIES = ("static", "reactive", "target_concurrency", "predictive", "slo_aware")
FLASH = dict(duration_s=12.0, seed=3, base_rps=12.0, burst_rps=1000.0, mean_burst_s=2.0,
             mean_calm_s=4.0)
SCALER = dict(interval_s=0.25, window_s=2.0, min_replicas=1, max_replicas=8,
              workers_per_replica=2, cooldown_s=2.0)


def _autoscaled(pkg, policy, *, scaler=None, branches=1, leaf_policy="least_loaded",
                flash=FLASH):
    """A cell of the autoscale study (``examples/autoscale_study.py``)."""
    wl = pkg.wl.build_scenario("flash_crowd", **flash)
    store = pkg.store.ConfigStore()
    pkg.wl.install_demo_configs(store, wl)
    sim = pkg.sim.Simulator(pkg.autoscale.build_pool(branches, 2, leaf_policy=leaf_policy),
                            store, pkg.sim.SyntheticServiceModel(seed=2), seed=7,
                            worker_capacity_slots=1, placer="first_fit")
    if scaler is None:
        pol = (pkg.autoscale.get_autoscaler("slo_aware", slo_p95_s=wl.slo_targets())
               if policy == "slo_aware" else policy)
        scaler = pkg.autoscale.Autoscaler(pol, leaf_policy=leaf_policy, **SCALER)
    sim.attach_autoscaler(scaler)
    sim.load(wl)
    sim.run()
    return sim, scaler


def test_autoscale_registry_and_exports_equal():
    assert port_autoscale.list_autoscalers() == jax_autoscale.list_autoscalers()
    assert set(POLICIES) <= set(port_autoscale.list_autoscalers())
    assert set(port_autoscale.__all__) == set(jax_autoscale.__all__) | {"ControlPlane"}


@pytest.mark.parametrize("policy", POLICIES)
def test_every_policy_decision_log_equal(policy, fresh_ids):
    (js, jsc), (ps, psc) = _both(
        lambda pkg: _autoscaled(pkg, policy, branches=3 if policy == "static" else 1),
        fresh_ids)
    _assert_same(js, ps)
    assert psc.decision_log() == jsc.decision_log() != ""
    assert psc.decision_records() == jsc.decision_records()
    assert psc.summary() == jsc.summary()


def test_flash_crowd_autoscaled_golden_in_the_port():
    """The digests ``tests/test_placement.py:243-245`` pins, from the port."""
    sim, scaler = _autoscaled(PORT, "slo_aware", leaf_policy="warm_least_loaded",
                              flash=dict(FLASH, duration_s=30.0, mean_calm_s=10.0))
    assert port_sim.stream_digest(sim) == "9019f07d1f8667aa"
    assert _digest(scaler.decision_log()) == "c7a8b3d40c5fc522"


def test_replay_reproduces_the_decision_log_in_the_port(tmp_path, fresh_ids):
    (_, jsc), (ps, psc) = _both(lambda pkg: _autoscaled(pkg, "slo_aware"), fresh_ids)
    path = tmp_path / "decisions.json"
    port_autoscale.save_decision_log(psc.decision_records(), str(path))
    records = port_autoscale.load_decision_log(str(path))
    assert records == psc.decision_records() == jsc.decision_records()
    fresh_ids()
    sim, sc = _autoscaled(PORT, None, scaler=port_autoscale.replay(records, **SCALER))
    assert sc.decision_log() == psc.decision_log()
    assert port_sim.stream_digest(sim) == port_sim.stream_digest(ps)


def test_metrics_primitives_equal():
    rng = random.Random(2)

    def samples(pkg):
        out = []
        for k in range(4):
            fns = tuple(pkg.autoscale.FnSample(
                fn=f, queue=rng.randrange(9), inflight=rng.randrange(9),
                arrivals=rng.randrange(50), completions=rng.randrange(50),
                warm=rng.randrange(4), p95_est=rng.random(), shed=rng.randrange(3),
                goodput=rng.randrange(40)) for f in rng.sample("abcde", 3))
            out.append(pkg.autoscale.MetricsSample(
                t=rng.random() * 10, replicas=rng.randrange(1, 5), workers=rng.randrange(1, 9),
                queue=rng.randrange(20), inflight=rng.randrange(20),
                arrivals=rng.randrange(100), completions=rng.randrange(100),
                cold_starts=rng.randrange(5), fns=tuple(sorted(fns, key=lambda f: f.fn)),
                unhealthy=rng.randrange(2)))
        return out

    got = []
    for pkg in (JAX, PORT):
        rng.seed(2)
        ss = samples(pkg)
        merged = pkg.autoscale.metrics.merge_fleet_samples([ss[0], None, *ss[1:]])
        win = pkg.autoscale.MetricsWindow(3)
        for s in ss:
            win.push(s)
        est = pkg.autoscale.LatencyEstimator(maxlen=32)
        for i in range(100):
            est.observe("abc"[i % 3], rng.random())
        got.append((dataclasses.astuple(merged), win.avg("queue"), win.avg("arrivals", tail=2),
                    win.arrival_rate(0.25), win.fn_avg("a", "p95_est"), win.fn_names(),
                    [est.p95(f) for f in "abcz"]))
    assert got[0] == got[1]


# --------------------------------------------------------------- workflows
@pytest.mark.parametrize("scen", ["ml_pipeline", "etl_fanout"])
def test_workflow_summaries_equal(scen, fresh_ids):
    def build(pkg):
        sim, n = _scenario_sim(pkg, scen, over=dict(duration_s=6.0, seed=3),
                               tree=lambda pkg: pkg.router.build_tree(
                                   8, fanout=4, leaf_policy="workflow_aware",
                                   inner_policy="workflow_aware"))
        sim.run()
        return sim, n
    (j, nj), (p, np_) = _both(build, fresh_ids)
    _assert_same(j, p)
    assert len(p.workflow_results) == np_ == nj > 0
    s = port_workloads.summarize_workflows(p.workflow_results)
    assert s == jax_workloads.summarize_workflows(j.workflow_results)
    assert s["ok"] > 0


def test_workflow_spec_decomposition_equal():
    def spec(pkg):
        S = pkg.wl.StageSpec
        size = pkg.wl.SizeDist.const(8)
        return pkg.wl.WorkflowSpec("diamond", slo_s=3.0, stages=(
            S("a", fn="f", size=size), S("b", fn="g", deps=("a",), weight=3.0, size=size),
            S("c", fn="f", deps=("a",), fanout=3, size=size, prob=0.5),
            S("d", fn="h", deps=("b", "c"), weight=2.0, size=size)))
    j, p = spec(JAX), spec(PORT)
    for attr in ("critical", "tasks_per_instance", "rid_offset"):
        assert getattr(p, attr) == getattr(j, attr)
    with pytest.raises(ValueError):
        port_workloads.WorkflowSpec("bad", stages=(port_workloads.StageSpec(
            "x", fn="f", deps=("y",)),))


# ------------------------------------------------------------------- azure
def test_azure_sample_readers_equal():
    rows = [dataclasses.astuple(r) for r in port_azure.load_azure_trace(AZURE)]
    assert rows == [dataclasses.astuple(r) for r in jax_azure.load_azure_trace(AZURE)]
    assert len(rows) == 3
    assert port_workloads.trace_functions(AZURE) == jax_workloads.trace_functions(AZURE)
    for kw in ({}, dict(function="f3e2", time_scale=0.01), dict(aggregate=True)):
        got = port_workloads.azure_trace_iats(AZURE, **kw)
        assert list(got) == list(jax_workloads.azure_trace_iats(AZURE, **kw)) and len(got)
    counts = (3, 0, 2, 0, 0, 5, 1, 0)
    assert list(port_azure.minute_counts_to_iats(counts, time_scale=0.5)) == \
        list(jax_azure.minute_counts_to_iats(counts, time_scale=0.5))
    streams = [port_workloads.azure_trace_streams(AZURE, time_scale=0.01),
               jax_workloads.azure_trace_streams(AZURE, time_scale=0.01)]
    reqs = [[(r.rid, r.fn, r.arrival_t, r.size, r.priority) for s in ss for r in s.generate()]
            for ss in streams]
    assert reqs[0] == reqs[1] and len(reqs[0]) == 27


# ----------------------------------------------------------------- elastic
@pytest.mark.parametrize("scenario", jax_elastic.SCENARIOS)
def test_elastic_scenarios_print_the_same_summary(scenario, capsys, fresh_ids):
    lines = []
    for pkg in (JAX, PORT):
        fresh_ids()
        s = pkg.elastic.run(scenario)
        lines.append((capsys.readouterr().out, s))
    assert lines[0] == lines[1]
    assert lines[1][0].startswith(f"[elastic:{scenario}] n=")


def test_elastic_cli_runs_one_scenario_in_the_port(capsys):
    assert port_elastic.SCENARIOS == jax_elastic.SCENARIOS
    port_elastic.main(["--scenario", "node_failure"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 and out[0].startswith("[elastic:node_failure] n=")


# ----------------------------------------------------- standing alone
def test_platform_paths_import_nothing_of_the_jax_package():
    """Run every lazily imported path (faults and a gateway carried by
    scenarios, workflows, the Azure reader, replay, the partitioned runner)
    in a fresh process: ``jax`` and ``repro`` stay out of ``sys.modules``."""
    code = f"""
import json, sys
from repro_torch.autoscale import Autoscaler, build_pool, replay
from repro_torch.core.config_store import ConfigStore
from repro_torch.core.router import build_tree
from repro_torch.core.simulator import Simulator, SyntheticServiceModel
from repro_torch.parallel import run_partitioned
from repro_torch.workloads import build_scenario, install_demo_configs

def sim_of(name, **kw):
    wl = build_scenario(name, duration_s=1.0, seed=3, **kw)
    store = ConfigStore()
    install_demo_configs(store, wl)
    sim = Simulator(build_tree(4, fanout=2), store, SyntheticServiceModel(seed=2), seed=7,
                    zones=2, record_decisions=True)
    sim.load(wl)
    return sim

for name in ("zone_outage", "retry_storm", "noisy_neighbor", "ml_pipeline"):
    sim_of(name).run()
sim_of("trace_replay", path={AZURE!r}, fmt="azure", time_scale=0.001).run()
sim = Simulator(build_pool(1, 2), ConfigStore(), SyntheticServiceModel(seed=2))
sim.attach_autoscaler(replay([]))
run_partitioned(lambda k, n: sim_of("steady"), 2, mode="inline")
print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
