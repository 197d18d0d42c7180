"""Grouped matmul over expert-sorted rows on Hopper: kernel B4 of the port.

Replaces the TPU kernel ``repro/kernels/moe_gmm.py::_gmm_kernel`` (its
``pl.pallas_call`` at line 71)::

    y[i*bt:(i+1)*bt] = x[i*bt:(i+1)*bt] @ w[block_to_expert[i]]

with x ``[T_pad, D]`` rows sorted by expert, each expert's group padded to a
multiple of ``block_t`` (``models/moe.py::build_layout`` builds this layout),
w ``[E, D, F]`` and ``block_to_expert`` ``[T_pad / block_t]`` int32 in
``[0, E)``. The sum runs in float32; y ``[T_pad, F]`` is in x's type.

The kernel is ``csrc/moe_gmm.cu``: one block per (row block, 64-column F
tile), which loads its own expert id (the TPU's scalar prefetch) and loops
over D. At the serving shapes of ``moonshot_v1_16b`` (D 2048, F 1408, 64
experts, a few rows per expert) it is bound by the bytes of the experts'
weights: each distinct expert's ``D*F`` values are read once per row block,
so the layout keeps an expert's rows in as few blocks as it can, and a
decode step (12 assignments with 2 slots) reads ~64 MB (0.019 ms at 3.35
TB/s) where the operations, ``2 * rows * D * F``, are far below the bf16
ridge: the kernel is as fast as the weights stream from HBM. The route
follows the type (:data:`ROUTES`):

- bfloat16, the serving path: the tensor cores (``mma.sync``, float32
  sums) with the weights as the M side, ``y^T = w[e]^T x^T``, so that an
  8-row block is one n8 tile with no padding; weight and x tiles stream
  through a 4-stage ring of ``cp.async`` copies.
- float32: float32 FMA over tiles staged in shared memory, exact to
  2e-4.

It takes ``block_t`` in {8, 16, 32, 64, 128}, D and F multiples of 64, x
rows and w experts/rows through strides with the last dimension contiguous
and 16-byte aligned.

:func:`grouped_matmul_plain` is the JAX package's oracle
(``kernels/ref.py::grouped_matmul_ref``) in plain PyTorch, a loop over the
row blocks: the CPU path and the kernel's yardstick of correctness.
:func:`grouped_matmul` launches the kernel and counts its launches in
``grouped_matmul.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import check_capability
from repro_torch.kernels import build

BLOCK_TS = (8, 16, 32, 64, 128)
TILE = 64               # D and F must be multiples of this
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's route for each type it takes (csrc/moe_gmm.cu dispatches on it)
ROUTES = {torch.float32: "float32 FMA", torch.bfloat16: "bf16 tensor cores (mma.sync)"}


def grouped_matmul_plain(x: torch.Tensor, w: torch.Tensor, block_to_expert: torch.Tensor,
                         block_t: int) -> torch.Tensor:
    """Row block i of x times ``w[block_to_expert[i]]``, float32 sums, in x's
    type. A loop over blocks: gathering ``w[block_to_expert]`` whole would
    make an ``nt x D x F`` copy (0.9 GB at moonshot's widths)."""
    y = torch.empty((x.shape[0], w.shape[2]), dtype=x.dtype, device=x.device)
    for i, e in enumerate(block_to_expert.tolist()):
        rows = slice(i * block_t, (i + 1) * block_t)
        y[rows] = (x[rows].float() @ w[e].float()).to(x.dtype)
    return y


_FN = None


def _kernel():
    global _FN
    if _FN is None:
        fn = build.load("moe_gmm").grouped_matmul_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_int64] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(x, w, block_to_expert, block_t):
    if x.device.type != "cuda":
        raise ValueError(f"grouped_matmul launches a CUDA kernel; got a tensor on {x.device} "
                         f"(the CPU takes grouped_matmul_plain)")
    if w.device != x.device or block_to_expert.device != x.device:
        raise ValueError("x, w and block_to_expert must lie on one device")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"grouped_matmul takes float32 or bfloat16 x and w of one type, got "
                        f"{x.dtype} and {w.dtype}")
    if block_to_expert.dtype != torch.int32:
        raise TypeError(f"block_to_expert must be int32, got {block_to_expert.dtype}")
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"shapes x [T_pad, D], w [E, D, F]; got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if block_t not in BLOCK_TS:
        raise ValueError(f"block_t {block_t} not in {BLOCK_TS}")
    T, D = x.shape
    F = w.shape[2]
    if T == 0 or T % block_t:
        raise ValueError(f"T_pad {T} is not a positive multiple of block_t {block_t}")
    if block_to_expert.shape != (T // block_t,) or not block_to_expert.is_contiguous():
        raise ValueError(f"block_to_expert must be a contiguous [{T // block_t}], got "
                         f"{tuple(block_to_expert.shape)}")
    if D % TILE or F % TILE:
        raise ValueError(f"D {D} and F {F} must be multiples of {TILE}")
    vec = 16 // x.element_size()        # the kernel's 16-byte loads
    if x.stride(1) != 1 or w.stride(2) != 1:
        raise ValueError("x and w must be contiguous in their last dimension")
    if (x.stride(0) % vec or w.stride(0) % vec or w.stride(1) % vec
            or x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("x and w must be 16-byte aligned, rows included")


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, block_to_expert: torch.Tensor,
                   block_t: int) -> torch.Tensor:
    """Launch kernel B4 on CUDA tensors. Returns y [T_pad, F] in x's type.
    ``block_to_expert`` must hold expert ids in ``[0, E)``: the kernel traps
    (a CUDA error at the next synchronisation) on one outside it."""
    _check(x, w, block_to_expert, block_t)
    check_capability(x.device)
    T, D = x.shape
    E, _, F = w.shape
    y = torch.empty((T, F), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel()(
            x.data_ptr(), w.data_ptr(), block_to_expert.data_ptr(), y.data_ptr(),
            _DTYPES[x.dtype], block_t, T // block_t, E, D, F,
            x.stride(0), w.stride(0), w.stride(1),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"grouped_matmul kernel launch failed with CUDA error {err}")
    grouped_matmul.launches += 1
    return y


grouped_matmul.launches = 0
