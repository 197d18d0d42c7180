"""The autoscale layer of the port: the control plane the simulator builds.

Only ``control`` (the :class:`ControlPlane` that every ``Simulator`` builds)
and ``metrics`` (the service estimator that deadline-aware routing reads,
imported lazily by the simulator) are ported so far; the policies, the
controller and decision-log replay come with the rest of the platform
layers.
"""
from repro_torch.autoscale.control import ControlPlane

__all__ = ["ControlPlane"]
