"""Parallel discrete-event simulation in the port: partitioned sim
processes with conservative lookahead and a deterministic merge. Own
copies of the JAX package's ``parallel/`` modules, which hold no JAX: the
port imports nothing of that package.

Public surface::

    from repro_torch.parallel import run_partitioned, MergedRun

    merged = run_partitioned(build, n_partitions=8, collect="summary")
    merged.summary()            # == summarize() over the union
    merged.digest()             # byte-identity projection

``process`` mode forks its partitions. A forked child may run host code
but must not touch the card: a partition whose service model predicts on
CUDA (``core.emulation.MLPWorkerModel`` on the card) fails in the child
and the runner raises ``RuntimeError("partition k failed ...")``. Drive
process mode with a host-side model (the ridge, whose weights are numpy,
or ``SyntheticServiceModel``).

See ``repro_torch.parallel.runner`` for the synchronization model and
``repro_torch.parallel.partition`` for the lookahead derivation, ceiling
apportionment, and the memory-bounded ``ResultSink``.
"""
from repro_torch.parallel.partition import (ResultSink, combined_digest,
                                            conservative_window, partition_streams,
                                            split_ceiling)
from repro_torch.parallel.runner import MergedRun, run_partitioned

__all__ = [
    "MergedRun",
    "ResultSink",
    "combined_digest",
    "conservative_window",
    "partition_streams",
    "run_partitioned",
    "split_ceiling",
]
