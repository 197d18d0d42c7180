"""Hand-written Hopper kernels of the port (CUDA C++ in ``csrc/``), each beside
its plain PyTorch version; ``ops.py`` dispatches between them by device."""


def block_of(S: int, block: int) -> int:
    """The block of a blocked pass over S steps (the plain blocked
    attention's rows, the chunked scan's chunk): ``min(block, S)``, or S
    where that does not divide S (the JAX package's rule in
    ``attend_blocked`` and ``_ssm_chunk_scan``)."""
    block = min(block, S)
    return block if S % block == 0 else S
