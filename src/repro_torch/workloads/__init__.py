"""Workload generators of the port: arrival processes and multi-function
mixes, own copies of the JAX package's ``workloads/arrivals.py`` and
``workloads/workload.py``. The scenario registry, the Azure trace reader
and workflows come with the rest of the platform layers."""
from repro_torch.workloads.arrivals import (ARRIVALS, ArrivalProcess,
                                            BurstyArrivals, DiurnalArrivals,
                                            PoissonArrivals, TraceArrivals,
                                            get_arrival, iats_from_times,
                                            read_trace, register_arrival,
                                            write_trace)
from repro_torch.workloads.workload import (FunctionProfile, MixedWorkload,
                                            RequestBatch, SizeDist)

__all__ = [
    "ARRIVALS", "ArrivalProcess", "PoissonArrivals", "BurstyArrivals",
    "DiurnalArrivals", "TraceArrivals", "get_arrival", "register_arrival",
    "read_trace", "write_trace", "iats_from_times",
    "FunctionProfile", "MixedWorkload", "RequestBatch", "SizeDist",
]
