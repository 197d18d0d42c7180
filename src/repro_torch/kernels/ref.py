"""Plain PyTorch versions of the ported kernels (the allclose targets), named
as in the JAX package's ``kernels/ref.py``. Each lives beside its kernel."""
from __future__ import annotations

from repro_torch.kernels.decode_attention import decode_attention_plain as decode_attention_ref
from repro_torch.kernels.flash_attention import flash_attention_plain as flash_attention_ref

__all__ = ["flash_attention_ref", "decode_attention_ref"]
