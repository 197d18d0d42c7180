"""The port's partitioned runner merges its decision and fault logs on the
exact time each line was written, so the merged logs equal the serial run
on the union tree even where two partitions write within one microsecond.

The scenario is ``tests/_prop_drivers.py::run_partition_merge_ops``'s, built
from each package: random tenant streams behind a ``tenant_hash`` root over
per-partition ``round_robin`` branches, served by an RNG-free model. At
seeds 915022765 and 1046368593 two arrivals of different partitions fall
within one microsecond (at 915022765, rid 4000004 at 0.9429606736 s and rid
1000008 at 0.9429608738 s, both printed ``t=0.942961``). The JAX package's
runner merges on the printed time and swaps them; the port's keeps the
serial order. The lines themselves are the same in both packages."""
import itertools
import multiprocessing
import random
import types

import pytest

import repro.core.config_store as jax_store
import repro.core.router as jax_router
import repro.core.simulator as jax_sim
import repro.core.types as jax_types
import repro.parallel as jax_parallel
import repro.workloads as jax_workloads
import repro_torch.core.config_store as port_store
import repro_torch.core.faults as port_faults
import repro_torch.core.router as port_router
import repro_torch.core.simulator as port_sim
import repro_torch.core.types as port_types
import repro_torch.parallel as port_parallel
import repro_torch.workloads as port_workloads

JAX = types.SimpleNamespace(sim=jax_sim, store=jax_store, router=jax_router, types=jax_types,
                            wl=jax_workloads, parallel=jax_parallel)
PORT = types.SimpleNamespace(sim=port_sim, store=port_store, router=port_router,
                             types=port_types, wl=port_workloads, parallel=port_parallel)
FORK = "fork" in multiprocessing.get_all_start_methods()
# where the printed-time merge is wrong, and two where it is right
TIED_SEEDS = (915022765, 1046368593)
SEEDS = TIED_SEEDS + (3, 11)
LOGS = ("routing_log", "placement_log", "gateway_log", "fault_log")


@pytest.fixture(autouse=True)
def fresh_ids(monkeypatch):
    for pkg in (JAX, PORT):
        monkeypatch.setattr(pkg.types, "_req_ids", itertools.count())


class DetService:
    """RNG-free service time, a pure function of the request (as
    ``tests/_prop_drivers.py::_DetServiceModel``)."""

    def sample(self, cfg, *, batch_size, queue_len, prompt, cold, fn_cost):
        base = 0.004 + 0.0008 * (prompt + cfg.gen_tokens) * fn_cost
        base *= 1.0 + 0.30 * max(batch_size - 1, 0)
        return base, True


def _scenario(pkg, seed):
    """(K, serial run, partition builder) of ``run_partition_merge_ops``'s
    scenario at ``seed``, drawn in the same order."""
    rng = random.Random(seed)
    K = rng.choice([2, 3, 4])
    n_streams = rng.randrange(K, 3 * K + 1)
    rates = [rng.choice([5.0, 10.0, 20.0]) for _ in range(n_streams)]
    sizes = [rng.choice([8, 16, 24]) for _ in range(n_streams)]
    wpl = rng.choice([2, 3])

    def streams():
        return [pkg.wl.MixedWorkload(pkg.wl.PoissonArrivals(rate=rates[j]),
                                     [pkg.wl.FunctionProfile(
                                         fn=f"t{j}", size=pkg.wl.SizeDist.const(sizes[j]))],
                                     duration_s=2.0, seed=500 + j, rid_base=j * 1_000_000)
                for j in range(n_streams)]

    def store(fns):
        s = pkg.store.ConfigStore()
        for fn in fns:
            s.put(pkg.types.FunctionConfig(name=fn, arch="tiny_lm", concurrency=2,
                                           cold_start_s=0.05, idle_timeout_s=5.0))
        return s

    def branch(k):
        return pkg.router.build_leaf(f"p{k}", [f"p{k}w{i}" for i in range(wpl)], "round_robin")

    def simulator(root, mine):
        sim = pkg.sim.Simulator(root, store([s.profiles[0].fn for s in mine]), DetService(),
                                seed=7, record_decisions=True, iid_scope="worker")
        for s in mine:
            sim.load(s)
        return sim

    serial = simulator(pkg.router.LBNode("root", "tenant_hash",
                                         children=[branch(k) for k in range(K)]), streams())
    serial.run()

    def build(k, n):
        mine = pkg.parallel.partition_streams(streams(), n)[k]
        return simulator(pkg.router.LBNode("root", "tenant_hash", children=[branch(k)]), mine)

    return K, serial, build


def _logs(run):
    return {name: getattr(run, name)() for name in LOGS}


@pytest.mark.parametrize("mode", ["inline", "process"])
@pytest.mark.parametrize("seed", SEEDS)
def test_merged_logs_equal_the_serial_run(seed, mode):
    if mode == "process" and not FORK:
        pytest.skip("fork start method unavailable")
    K, serial, build = _scenario(PORT, seed)
    merged = port_parallel.run_partitioned(build, K, mode=mode)
    assert merged.mode == mode
    assert _logs(merged) == _logs(serial)
    assert merged.routing_log() != ""
    assert port_sim.stream_digest(merged) == port_sim.stream_digest(serial)
    assert merged.counters["events_processed"] == serial.events_processed


@pytest.mark.parametrize("seed", SEEDS)
def test_lines_equal_the_reference_and_only_the_tied_merge_differs(seed):
    """The serial runs' logs are the same bytes in both packages; the port's
    merge equals the JAX merge wherever that one is right, and differs from
    it exactly at the seeds with a tie within one microsecond."""
    K, port_serial, port_build = _scenario(PORT, seed)
    _, jax_serial, jax_build = _scenario(JAX, seed)
    assert _logs(port_serial) == _logs(jax_serial)
    port_merged = port_parallel.run_partitioned(port_build, K, mode="inline")
    jax_merged = jax_parallel.run_partitioned(jax_build, K, mode="inline")
    assert sorted(port_merged.routing_records) == sorted(jax_merged.routing_records)
    assert (port_merged.routing_log() == jax_merged.routing_log()) == (seed not in TIED_SEEDS)
    assert port_sim.stream_digest(port_merged) == jax_sim.stream_digest(jax_merged)


def test_exact_times_ride_beside_each_line():
    """Every decision and fault line has the exact time it was written at,
    which the line prints rounded to the microsecond."""
    K, serial, _ = _scenario(PORT, TIED_SEEDS[0])
    c = serial.control
    for lines, times in ((c.routing_records, c.routing_times),
                         (c.placement_records, c.placement_times),
                         (c.gateway_records, c.gateway_times)):
        assert len(lines) == len(times)
        assert all(line.startswith(f"t={t:.6f} ") for line, t in zip(lines, times))
        assert times == sorted(times)
    assert len(c.routing_times) > 0 and len(c.placement_times) > 0


def test_fault_lines_merge_on_their_exact_times():
    """Two partitions that each inject faults: the merged fault log is the
    union of their lines in the order of the exact times they were written
    (ties to the lower partition), the same inline and forked."""
    def build(k, n):
        w = port_workloads.build_scenario("multi_tenant", rps=200.0, duration_s=3.0, seed=3 + k)
        store = port_store.ConfigStore()
        port_workloads.install_demo_configs(store, w)
        sim = port_sim.Simulator(
            port_router.build_tree(4, fanout=2), store, DetService(), seed=7 + k, zones=2,
            retry_budget=2, record_decisions=True,
            faults=port_faults.FaultConfig(seed=4 + k, worker_mttf_s=1.5, worker_mttr_s=0.5,
                                           lost_finish_p=0.02))
        sim.load(w)
        return sim

    parts = []
    for k in range(2):
        sim = build(k, 2)
        sim.run()
        f = sim.faults
        assert len(f.records) == len(f.times) > 0
        assert all(line.startswith(f"t={t:.6f} ") for line, t in zip(f.records, f.times))
        parts.append(sorted((t, k, i, line) for i, (t, line) in enumerate(zip(f.times,
                                                                                f.records))))
    want = "\n".join(e[3] for e in sorted(parts[0] + parts[1]))
    modes = ("inline", "process") if FORK else ("inline",)
    for mode in modes:
        assert port_parallel.run_partitioned(build, 2, mode=mode).fault_log() == want
