"""Workload scenario subsystem of the port: arrival processes,
multi-function mixes, workflows, the Azure trace reader and a
named-scenario registry. Own copies of the JAX package's ``workloads/``
modules, which hold no JAX: the port imports nothing of that package."""
from repro_torch.workloads.arrivals import (ARRIVALS, ArrivalProcess,
                                            BurstyArrivals, DiurnalArrivals,
                                            PoissonArrivals, TraceArrivals,
                                            get_arrival, iats_from_times,
                                            read_trace, register_arrival,
                                            write_trace)
from repro_torch.workloads.azure import (azure_trace_arrivals, azure_trace_iats,
                                         azure_trace_streams, load_azure_trace,
                                         trace_functions)
from repro_torch.workloads.scenarios import (SCENARIOS, build_scenario,
                                             install_demo_configs, list_scenarios,
                                             register_scenario)
from repro_torch.workloads.workflows import (StageSpec, WorkflowEngine,
                                             WorkflowResult, WorkflowSpec,
                                             WorkflowWorkload,
                                             summarize_workflows)
from repro_torch.workloads.workload import (FunctionProfile, MixedWorkload,
                                            RequestBatch, SizeDist)

__all__ = [
    "ARRIVALS", "ArrivalProcess", "PoissonArrivals", "BurstyArrivals",
    "DiurnalArrivals", "TraceArrivals", "get_arrival", "register_arrival",
    "read_trace", "write_trace", "iats_from_times",
    "load_azure_trace", "azure_trace_arrivals", "azure_trace_iats",
    "azure_trace_streams", "trace_functions",
    "SCENARIOS", "build_scenario", "list_scenarios", "register_scenario",
    "install_demo_configs",
    "FunctionProfile", "MixedWorkload", "RequestBatch", "SizeDist",
    "StageSpec", "WorkflowSpec", "WorkflowWorkload", "WorkflowEngine",
    "WorkflowResult", "summarize_workflows",
]
