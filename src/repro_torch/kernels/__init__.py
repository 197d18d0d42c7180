"""Hand-written Hopper kernels of the port (CUDA C++ in ``csrc/``), each beside
its plain PyTorch version; ``ops.py`` dispatches between them by device."""
