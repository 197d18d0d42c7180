"""Pluggable replica-placement layer: bin-pack replica starts by memory.

The port's own copy of the JAX package's ``core/placement.py``, which holds no
JAX: the port imports nothing of that package.

SeBS (Copik et al.) and the FaaS Benchmarking Framework both identify the
per-function memory allocation as a dominant platform knob; this module
makes it a first-class architectural axis of the testbed. Every worker
carries an optional ``memory_mb`` capacity, every started replica charges
its function's ``FunctionConfig.memory_mb`` against it, and a *placer*
decides which worker hosts the next replica (and which worker gives one
back on scale-down).

A placer never mutates state. It ranks candidate workers; the simulator
supplies the candidates in a deterministic preference order (coldest in
the function for placement, warmest for reaping) and then attempts the
actual start/stop in the placer's order, so two same-seed runs make
byte-identical placement decisions.

The worker objects a placer sees are duck-typed (the simulator's
``_Worker``); a placer may read:

- ``name``              stable worker id (the deterministic tiebreak)
- ``mem_free_mb()``     free memory, ``inf`` when the worker is uncapped
- ``fits(mem_mb)``      admission check against the memory capacity
- ``fn_replicas(fn)``   live replicas of one function on this worker
- ``total_instances``   live replicas across all functions
- ``zone``              failure domain (``Simulator(zones=...)``), or None

Registering a custom placer mirrors the LB-policy and autoscaler
registries::

    @register_placer
    class MyPlacer(Placer):
        name = "my_placer"
        def place_order(self, fn, memory_mb, workers):
            return [w for w in workers if w.fits(memory_mb)]

    sim = Simulator(tree, store, model, placer="my_placer",
                    worker_memory_mb=4096)
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

PLACERS: Dict[str, Callable[..., "Placer"]] = {}


def register_placer(cls):
    """Class decorator: add a Placer subclass to the registry."""
    PLACERS[cls.name] = cls
    return cls


def get_placer(name: str, **params) -> "Placer":
    """Construct a registered placer by name: the config/CLI hook."""
    if name not in PLACERS:
        raise KeyError(f"placer {name!r} not registered "
                       f"(have: {sorted(PLACERS)})")
    return PLACERS[name](**params)


def list_placers() -> List[str]:
    return sorted(PLACERS)


class Placer:
    """Base interface: rank candidate workers for one replica move.

    ``workers`` arrives in the simulator's preference order (see module
    docstring); a placer filters by fit and may re-rank. Python sorts are
    stable, so a placer that sorts on a memory key degenerates to the
    incoming order when every worker is uncapped — which is what keeps
    unlimited-memory runs byte-identical to the pre-placement simulator.
    """

    name = "base"

    def place_order(self, fn: str, memory_mb: float,
                    workers: Sequence) -> List:
        """Workers that can host one more ``memory_mb`` replica of ``fn``,
        best host first."""
        raise NotImplementedError

    def reap_order(self, fn: str, workers: Sequence) -> List:
        """Workers to take an idle replica of ``fn`` from, first choice
        first. Default: the simulator's warmest-first preference order."""
        return list(workers)

    def blocked_cold_eta_s(self, need_mb: float, free_mb: float,
                           svc_s: float, depth: int,
                           inflight: int) -> float:
        """Graded ETA for a memory-blocked cold start on one leaf.

        ``deadline_aware`` routing historically priced a blocked cold
        start with a flat ~infinite penalty, which ranks a leaf that is
        1 MB short identically to one that needs the whole worker to
        drain. This hook prices the *unblock* instead: memory frees as
        outstanding work (queued + in flight) completes, so the expected
        wait is the per-request service time times the share of that
        work that must finish before the deficit closes. The estimate is
        capped at the flat penalty so a graded leaf can never outrank
        the flat model's view of an unblocked one.

        Opt-in: the simulator only wires this into
        ``StateView.mem_eta`` under ``mem_eta="placer"`` — the default
        flat penalty keeps every existing golden digest byte-identical.
        """
        from repro_torch.core.router import MEM_BLOCKED_PENALTY_S
        deficit = max(need_mb - free_mb, 0.0) / max(need_mb, 1.0)
        outstanding = max(inflight + depth, 1)
        eta = max(svc_s, 1e-6) * outstanding * min(deficit, 1.0)
        return min(eta, MEM_BLOCKED_PENALTY_S)


@register_placer
class FirstFitPlacer(Placer):
    """Classic first-fit bin packing: take the first candidate with room.

    With unlimited memory every candidate fits, so this is exactly the
    pre-placement behaviour (pinned by the golden digests in
    ``tests/test_placement.py``) — the safe default.
    """

    name = "first_fit"

    def place_order(self, fn, memory_mb, workers):
        return [w for w in workers if w.fits(memory_mb)]


@register_placer
class BestFitMemoryPlacer(Placer):
    """Best-fit bin packing on memory: tightest surviving gap first.

    Packing big-footprint replicas into the fullest worker that still
    fits preserves large contiguous headroom elsewhere — the placement
    that keeps a heterogeneous-memory mix schedulable where first-fit
    fragments the fleet. Reaping is the mirror image: free memory on the
    most pressured worker first.
    """

    name = "best_fit_memory"

    def place_order(self, fn, memory_mb, workers):
        return sorted((w for w in workers if w.fits(memory_mb)),
                      key=lambda w: w.mem_free_mb())

    def reap_order(self, fn, workers):
        return sorted(workers, key=lambda w: w.mem_free_mb())


@register_placer
class SpreadPlacer(Placer):
    """Availability-first: spread replicas of a function across workers.

    Prefers the worker holding the fewest replicas of ``fn`` (then the
    emptiest overall, then the most free memory) so one worker failure
    takes out the smallest share of a function's warm capacity.
    """

    name = "spread"

    def place_order(self, fn, memory_mb, workers):
        return sorted((w for w in workers if w.fits(memory_mb)),
                      key=lambda w: (w.fn_replicas(fn), w.total_instances,
                                     -w.mem_free_mb()))


@register_placer
class SpreadZonesPlacer(Placer):
    """Failure-domain-aware spread: balance a function's replicas across
    *zones* first, then apply the per-worker spread key inside the zone.

    ``spread`` is blind to the tree's failure domains — with few
    functions and same-size workers it happily fills one branch, and a
    zone outage then takes out a function's entire warm capacity at
    once. This placer counts the function's replicas per zone over the
    candidate set and always grows the least-loaded zone, so any single
    zone holds at most ⌈replicas/zones⌉ of the function. Reaping is the
    mirror: shrink the most replica-heavy zone first. With no zones
    configured every worker shares the ``None`` domain and both orders
    degenerate to plain ``spread``.
    """

    name = "spread_zones"

    @staticmethod
    def _zone_load(fn, workers):
        load: dict = {}
        for w in workers:
            z = getattr(w, "zone", None)
            load[z] = load.get(z, 0) + w.fn_replicas(fn)
        return load

    def place_order(self, fn, memory_mb, workers):
        fits = [w for w in workers if w.fits(memory_mb)]
        # zone load counts *every* candidate's replicas, not just the
        # ones with room — a memory-full worker still anchors its zone's
        # share of the function, and dropping it from the count would
        # keep piling replicas into an already-loaded zone
        load = self._zone_load(fn, workers)
        return sorted(fits, key=lambda w: (
            load[getattr(w, "zone", None)], w.fn_replicas(fn),
            w.total_instances, -w.mem_free_mb()))

    def reap_order(self, fn, workers):
        load = self._zone_load(fn, workers)
        # stable sort keeps the simulator's warmest-first preference
        # order inside each zone
        return sorted(workers,
                      key=lambda w: -load[getattr(w, "zone", None)])
