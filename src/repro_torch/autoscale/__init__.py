"""Autoscaler control-loop subsystem of the port: policy registry +
controller, with the control plane that every ``Simulator`` builds.

Own copies of the JAX package's ``autoscale/`` modules, which hold no JAX:
the port imports nothing of that package. Turns the paper's static
``replicate()`` recipe into a live control loop driven by the workload
scenarios, with per-function metrics, SLO-aware scaling, per-function
prewarm/reap, and decision-log replay."""
from repro_torch.autoscale.control import ControlPlane
from repro_torch.autoscale.controller import (Autoscaler, ScalingDecision,
                                              build_pool)
from repro_torch.autoscale.metrics import (FnSample, LatencyEstimator,
                                           MetricsSample, MetricsWindow,
                                           ServiceEstimator)
from repro_torch.autoscale.policy import (AUTOSCALERS, AutoscalePolicy,
                                          PredictivePolicy, ReactivePolicy,
                                          SloAwarePolicy, StaticPolicy,
                                          TargetConcurrencyPolicy,
                                          get_autoscaler, list_autoscalers,
                                          register_autoscaler)
from repro_torch.autoscale.replay import (ReplayPolicy, load_decision_log,
                                          replay, save_decision_log)

__all__ = [
    "ControlPlane",
    "Autoscaler", "ScalingDecision", "build_pool",
    "FnSample", "LatencyEstimator", "MetricsSample", "MetricsWindow",
    "ServiceEstimator",
    "AUTOSCALERS", "AutoscalePolicy", "StaticPolicy", "ReactivePolicy",
    "TargetConcurrencyPolicy", "PredictivePolicy", "SloAwarePolicy",
    "get_autoscaler", "list_autoscalers", "register_autoscaler",
    "ReplayPolicy", "replay", "save_decision_log", "load_decision_log",
]
