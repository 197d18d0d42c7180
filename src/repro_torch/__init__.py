"""PyTorch/CUDA port of the HyperFaaS testbed, for NVIDIA Hopper (sm_90a).

A second package beside the JAX one (``repro``), mirroring its layout:
``configs/``, ``core/``, ``autoscale/``, ``workloads/`` and ``parallel/`` are
the port's own copies of the JAX-free layers,
``models/`` and ``serving/`` are ported to PyTorch, and ``kernels/`` holds
hand-written CUDA kernels (sources in ``csrc/``) beside their plain PyTorch
versions. Entry points run on the card unless the caller asks for the CPU.
"""
