"""The port's partitioned runner (``repro_torch.parallel``) against the JAX
package's: the same K-partition scenario, built in each package, merges to
the same digests and logs, inline and in forked processes; on the fast path
it equals the port's serial run. Also the partition primitives, and the
runner's refusal of a partition that fails in its forked child (what a
service model on the card gives there)."""
import itertools
import multiprocessing
import os
import types

import pytest

import repro.core.config_store as jax_store
import repro.core.gateway as jax_gateway
import repro.core.router as jax_router
import repro.core.simulator as jax_sim
import repro.core.types as jax_types
import repro.parallel as jax_parallel
import repro.workloads as jax_workloads
import repro_torch.core.config_store as port_store
import repro_torch.core.gateway as port_gateway
import repro_torch.core.router as port_router
import repro_torch.core.simulator as port_sim
import repro_torch.core.types as port_types
import repro_torch.parallel as port_parallel
import repro_torch.workloads as port_workloads
from repro.autoscale import Autoscaler as JaxAutoscaler
from repro.parallel.partition import ResultSink as JaxResultSink
from repro_torch.autoscale import Autoscaler as PortAutoscaler
from repro_torch.parallel.partition import ResultSink as PortResultSink

JAX = types.SimpleNamespace(sim=jax_sim, store=jax_store, router=jax_router, types=jax_types,
                            wl=jax_workloads, parallel=jax_parallel, gateway=jax_gateway,
                            Autoscaler=JaxAutoscaler, ResultSink=JaxResultSink)
PORT = types.SimpleNamespace(sim=port_sim, store=port_store, router=port_router,
                             types=port_types, wl=port_workloads, parallel=port_parallel,
                             gateway=port_gateway, Autoscaler=PortAutoscaler,
                             ResultSink=PortResultSink)
FORK = "fork" in multiprocessing.get_all_start_methods()


@pytest.fixture(autouse=True)
def fresh_ids(monkeypatch):
    for pkg in (JAX, PORT):
        monkeypatch.setattr(pkg.types, "_req_ids", itertools.count())


class DetService:
    """RNG-free service time, a pure function of the request (as
    ``tests/_prop_drivers.py::_DetServiceModel``), so a partition's requests
    cost the same with or without the others beside them."""

    def sample(self, cfg, *, batch_size, queue_len, prompt, cold, fn_cost):
        base = 0.004 + 0.0008 * (prompt + cfg.gen_tokens) * fn_cost
        return base * (1.0 + 0.30 * max(batch_size - 1, 0)), True


def _streams(pkg, tenants=6):
    return [pkg.wl.MixedWorkload(pkg.wl.PoissonArrivals(rate=15.0 + 5 * j),
                                 [pkg.wl.FunctionProfile(f"t{j}",
                                                         size=pkg.wl.SizeDist.const(16))],
                                 duration_s=1.5, seed=500 + j, rid_base=j * 1_000_000)
            for j in range(tenants)]


def _store(pkg, fns):
    store = pkg.store.ConfigStore()
    for fn in fns:
        store.put(pkg.types.FunctionConfig(name=fn, arch="tiny_lm", concurrency=2,
                                           cold_start_s=0.05))
    return store


def _branch(pkg, k):
    return pkg.router.build_leaf(f"p{k}", [f"p{k}w0", f"p{k}w1"], "round_robin")


def _builder(pkg, service=DetService, **sim_kw):
    """Partition ``k`` of ``n``: its tenants (``partition_streams``, the
    ``tenant_hash`` assignment) behind a ``tenant_hash`` root over its own
    branch."""
    def build(k, n):
        mine = pkg.parallel.partition_streams(_streams(pkg), n)[k]
        sim = pkg.sim.Simulator(
            pkg.router.LBNode("root", "tenant_hash", children=[_branch(pkg, k)]),
            _store(pkg, [s.profiles[0].fn for s in mine]), service(), seed=7,
            record_decisions=True, iid_scope="worker", **sim_kw)
        for s in mine:
            sim.load(s)
        return sim
    return build


def _serial(pkg, K):
    streams = _streams(pkg)
    sim = pkg.sim.Simulator(
        pkg.router.LBNode("root", "tenant_hash", children=[_branch(pkg, k) for k in range(K)]),
        _store(pkg, [s.profiles[0].fn for s in streams]), DetService(), seed=7,
        record_decisions=True, iid_scope="worker")
    for s in streams:
        sim.load(s)
    sim.run()
    return sim


@pytest.mark.parametrize("K", [1, 2, 3])
def test_inline_merge_equal_across_packages_and_to_the_serial_run(K):
    j = jax_parallel.run_partitioned(_builder(JAX), K, mode="inline")
    p = port_parallel.run_partitioned(_builder(PORT), K, mode="inline")
    serial = _serial(PORT, K)
    assert len(p.results) == len(serial.results) > 0
    assert port_sim.stream_digest(p) == jax_sim.stream_digest(j) == port_sim.stream_digest(serial)
    assert p.digest() == j.digest() and p.digests == j.digests
    assert p.routing_log() == j.routing_log() == serial.routing_log()
    assert p.placement_log() == j.placement_log() == serial.placement_log()
    assert p.counters == j.counters
    assert p.counters["events_processed"] == serial.events_processed
    assert p.summary() == j.summary()


@pytest.mark.skipif(not FORK, reason="fork start method unavailable")
def test_process_mode_equals_inline_in_both_packages():
    """Forked partitions (each child runs host code only) merge to what the
    inline partitions give, in each package; full and summary collects."""
    got = []
    for pkg in (JAX, PORT):
        build = _builder(pkg, collect_telemetry=False)    # summary digests cover results only
        inline = pkg.parallel.run_partitioned(build, 2, mode="inline")
        proc = pkg.parallel.run_partitioned(build, 2, mode="process")
        summ = pkg.parallel.run_partitioned(build, 2, mode="process", collect="summary")
        assert proc.mode == "process"
        assert pkg.sim.stream_digest(proc) == pkg.sim.stream_digest(inline)
        assert proc.routing_log() == inline.routing_log()
        assert proc.counters == inline.counters and proc.summary() == inline.summary()
        assert summ.results == [] and summ.digests == inline.digests
        assert summ.summary() == inline.summary()
        got.append((pkg.sim.stream_digest(proc), proc.digest(), summ.digest(), proc.counters))
    assert got[0] == got[1]


def test_barrier_coupled_run_equal_across_packages():
    """A platform-wide ``max_inflight`` split across partition gateways at
    every window barrier: the same barriers, ceilings and gateway log."""
    runs = []
    for pkg in (JAX, PORT):
        build = _builder(pkg, gateway=pkg.gateway.GatewayConfig(max_inflight=3))
        runs.append(pkg.parallel.run_partitioned(build, 2, mode="inline", max_inflight=3))
    j, p = runs
    assert p.barriers == j.barriers and len(p.barriers) > 1
    assert p.gateway_log() == j.gateway_log() != ""
    assert port_sim.stream_digest(p) == jax_sim.stream_digest(j)
    assert p.counters["gw_shed"] == j.counters["gw_shed"] > 0


def test_partition_primitives_equal():
    for total, demands in ((10, [3.0, 1.0, 0.0]), (7, [1.0] * 4), (2, [5.0, 5.0, 5.0]),
                           (100, [0.3, 2.7, 9.1, 0.0, 4.4])):
        assert port_parallel.split_ceiling(total, demands) == \
            jax_parallel.split_ceiling(total, demands)
    assert port_parallel.combined_digest(["ab", "cd"]) == \
        jax_parallel.combined_digest(["ab", "cd"])
    windows = []
    for pkg in (JAX, PORT):
        sim = pkg.sim.Simulator(pkg.router.build_tree(2, fanout=2),
                                _store(pkg, ["a"]), DetService(), seed=1)
        w = [pkg.parallel.conservative_window(sim)]
        sim.attach_autoscaler(pkg.Autoscaler("reactive", interval_s=0.01))
        w.append(pkg.parallel.conservative_window(sim))
        windows.append(w)
    assert windows[0] == windows[1] == [0.05, 0.01]
    parts = [port_parallel.partition_streams(_streams(PORT), 3),
             jax_parallel.partition_streams(_streams(JAX), 3)]
    assert [[s.seed for s in b] for b in parts[0]] == [[s.seed for s in b] for b in parts[1]]


def _plain(part: dict) -> dict:
    return {k: v.tolist() if hasattr(v, "tolist") else v for k, v in part.items()}


def test_result_sink_equal_across_packages():
    sinks = []
    for pkg in (JAX, PORT):
        sim = _builder(pkg)(0, 1)
        sim.run()
        sink = pkg.ResultSink()
        for r in sim.results:
            sink.append(r)
        assert len(sink) == len(sim.results) > 0
        part = _plain(sink.part())
        assert part == _plain(pkg.sim.part_summary(sim.results))
        sinks.append((part, sink.digest()))
    assert sinks[0] == sinks[1]


class RefusedInAFork:
    """A service model that fails in a forked child as a model whose weights
    live on the card does there (CUDA cannot be re-initialised after a
    fork)."""

    parent = os.getpid()

    def sample(self, cfg, **kw):
        if os.getpid() != self.parent:
            raise RuntimeError("Cannot re-initialize CUDA in forked subprocess")
        return 0.01, True


@pytest.mark.skipif(not FORK, reason="fork start method unavailable")
def test_a_partition_that_fails_in_its_fork_raises():
    build = _builder(PORT, service=RefusedInAFork)
    with pytest.raises(RuntimeError, match=r"(?s)^partition \d failed.*re-initialize CUDA"):
        port_parallel.run_partitioned(build, 2, mode="process")
    inline = port_parallel.run_partitioned(build, 2, mode="inline")
    assert len(inline.results) > 0
