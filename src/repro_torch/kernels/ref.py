"""Plain PyTorch versions of the ported kernels (the allclose targets), named
as in the JAX package's ``kernels/ref.py``. Each lives beside its kernel.
``mamba_scan_ref`` also takes ``h0`` and returns ``(y, h_S)`` where the JAX
oracle returns y alone."""
from __future__ import annotations

from repro_torch.kernels.decode_attention import decode_attention_plain as decode_attention_ref
from repro_torch.kernels.flash_attention import flash_attention_plain as flash_attention_ref
from repro_torch.kernels.mamba_scan import mamba_scan_plain as mamba_scan_ref
from repro_torch.kernels.moe_gmm import grouped_matmul_plain as grouped_matmul_ref

__all__ = ["flash_attention_ref", "decode_attention_ref", "mamba_scan_ref",
           "grouped_matmul_ref"]
