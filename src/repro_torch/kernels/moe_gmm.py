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

The backward, kernel B4b, replaces no TPU kernel: the JAX model
differentiates its expert einsums (``repro/models/moe.py:88-91``) by
autodiff. It has two entry points, each counting its launches, and three
routes, which :func:`bwd_route` names for each (type, ``block_t``):

- bfloat16 at ``block_t`` 64 and 128, every training microbatch
  (``csrc/moe_gmm_bwd.cu``): warpgroup MMA (``wgmma.mma_async``, float32
  sums in registers) on 64 x 64 tiles that the Tensor Memory Accelerator
  loads into a 3-stage ``mbarrier`` ring; persistent blocks of one
  producer warp and two consumer warpgroups (one at ``block_t`` 64), whose
  next tile's loads overlap this tile's epilogue, and whose results the
  TMA stores from shared memory while they compute the next tile.
- bfloat16 at ``block_t`` 8-32: B4's ``mma.sync`` kernels (``csrc/moe_gmm.cu``).
- float32: float32 FMA over tiles staged in shared memory, exact to 2e-4.

:func:`grouped_matmul_dx`: ``dx[blk i] = dy[blk i] @ w[e_i]^T``. w is read
in its own ``[E, D, F]`` layout (no transposed copy: at moonshot's training
shapes that would be 369 MB a weight): its tile is K-major for ``wgmma``
as it lies (``mma.sync``: read row-major into the A fragments; float32:
transposed in shared memory). The ``wgmma`` route takes a tile of one row
block by 256 columns, so dy's rows are read from L2 ``D / 256`` times.

:func:`grouped_matmul_dw`: ``dw[e] = sum over e's row blocks of x^T dy``,
``[E, D, F]`` in w's type with float32 sums. Each output tile has one
writer (no atomics, so two calls are bit-equal), which finds its expert's
row blocks in ``block_to_expert`` on the card (no host round trip, any
order of the map) and sums their rows in ascending order; an expert with
no rows gets zeros. The ``wgmma`` route's tiles are 128 of D by 256 of F,
x and dy both MN-major (``wgmma``'s transpose bit).

Both are bound by their bytes at moonshot's microbatch (T_pad 32 768,
block_t 128, D 2048, F 1408, 64 experts, 24 576 of the rows kept), at
3.35 TB/s: dx reads dy's used rows and each used expert's weights and
writes all of dx, dW reads x's and dy's used rows and writes every
expert's dw (369 MB). With 219 of the 256 row blocks used that is 0.174
ms for dx and 0.168 ms for dW (0.178 for each over every block), against
``2 * kept * D * F`` operations, 0.144 ms at 989 TFLOP/s
(``chip_smoke.py`` reckons both).

``used_blocks`` (``models/moe.py::Layout.used_blocks``, a ``[1]`` int32 on
the card) is a promise: x and dy are zero on the rows at and past
``used_blocks * block_t``, as they are on the layout's trailing padding
blocks (dispatch gathers zero rows there, and the combine's gate is 0).
On such inputs every route gives the same values with it and without it
(``None``: every block). The ``wgmma`` route uses it to skip those blocks:
dW leaves them out of its sums, dx writes zeros there, and neither reads
them; the other routes compute every block. What a route writes past the
used rows on inputs that break the promise is not part of the contract.

:func:`grouped_matmul_bwd_plain` is both in plain PyTorch (a loop over row
blocks for dx, over experts for dW, float32 sums): the CPU path and B4b's
yardstick.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.device import check_capability
from repro_torch.kernels import build

BLOCK_TS = (8, 16, 32, 64, 128)
TILE = 64               # D and F must be multiples of this
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# B4's route for each type it takes (csrc/moe_gmm.cu dispatches on it); B4b's
# routes are bwd_route's
ROUTES = {torch.float32: "float32 FMA", torch.bfloat16: "bf16 tensor cores (mma.sync)"}
# B4b's bf16 route at these block_t (csrc/moe_gmm_bwd.cu)
WGMMA_ROUTE, WGMMA_BLOCK_TS = "bf16 tensor cores (wgmma, TMA)", (64, 128)


def bwd_route(dtype: torch.dtype, block_t: int) -> str:
    """The route B4b's dx and dW take for this type and ``block_t``."""
    if dtype == torch.bfloat16 and block_t in WGMMA_BLOCK_TS:
        return WGMMA_ROUTE
    return ROUTES[dtype]


def grouped_matmul_plain(x: torch.Tensor, w: torch.Tensor, block_to_expert: torch.Tensor,
                         block_t: int) -> torch.Tensor:
    """Row block i of x times ``w[block_to_expert[i]]``, float32 sums, in x's
    type. A loop over blocks: gathering ``w[block_to_expert]`` whole would
    make an ``nt x D x F`` copy (0.9 GB at moonshot's widths). Each block
    takes its expert's weights by ``index_select``, so no value is read on
    the host (the dry run's fake tensors have none). With one expert (a
    rank's share under expert parallelism, jamba's 16 experts on 16 ranks)
    every block takes it: 16 blocks a product, a sixteenth of the ops the
    dry run dispatches on fake tensors."""
    y = torch.empty((x.shape[0], w.shape[2]), dtype=x.dtype, device=x.device)
    if w.shape[0] == 1:
        w0 = w[0].float()
        for r0 in range(0, x.shape[0], 16 * block_t):
            rows = slice(r0, r0 + 16 * block_t)
            y[rows] = (x[rows].float() @ w0).to(x.dtype)
        return y
    for i in range(block_to_expert.shape[0]):
        rows = slice(i * block_t, (i + 1) * block_t)
        we = w.index_select(0, block_to_expert[i:i + 1])[0]
        y[rows] = (x[rows].float() @ we.float()).to(x.dtype)
    return y


def grouped_matmul_bwd_plain(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                             block_to_expert: torch.Tensor, block_t: int, *,
                             used_blocks: Optional[torch.Tensor] = None,
                             need_dx: bool = True,
                             need_dw: bool = True) -> Tuple[Optional[torch.Tensor],
                                                            Optional[torch.Tensor]]:
    """(dx [T_pad, D] in x's type, dw [E, D, F] in w's type) of
    :func:`grouped_matmul_plain` for ``dy`` [T_pad, F], float32 sums; None
    for what is not needed. Under ``used_blocks``' promise (x and dy zero
    on the blocks at and past it) it leaves those blocks out: zeros in dx,
    nothing in dw. dW sums each expert's blocks in block order (with one
    expert, 16 blocks a product as the forward: their rows summed inside
    each product, the products in block order). No value is read on the
    host: the blocks past ``used_blocks`` are masked, not cut."""
    nt = block_to_expert.shape[0]
    if w.shape[0] == 1:
        return _one_expert_bwd(x, w, dy, block_t, used_blocks, need_dx, need_dw)
    live = None
    if used_blocks is not None:
        live = torch.arange(nt, device=x.device) < used_blocks.to(x.device)
    dx = dw = None
    if need_dx:
        dx = torch.zeros_like(x)
        for i in range(nt):
            rows = slice(i * block_t, (i + 1) * block_t)
            we = w.index_select(0, block_to_expert[i:i + 1])[0]
            d = (dy[rows].float() @ we.float().T).to(x.dtype)
            dx[rows] = d if live is None else torch.where(live[i], d, dx[rows])
    if need_dw:
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        for i in range(nt):
            rows = slice(i * block_t, (i + 1) * block_t)
            g = x[rows].float().T @ dy[rows].float()
            if live is not None:
                g = g * live[i]
            dw.index_add_(0, block_to_expert[i:i + 1], g[None])
        dw = dw.to(w.dtype)
    return dx, dw


def _one_expert_bwd(x, w, dy, block_t, used_blocks, need_dx, need_dw):
    """:func:`grouped_matmul_bwd_plain` where every block takes the one
    expert, 16 blocks a product."""
    R = 16 * block_t
    live = None
    if used_blocks is not None:
        live = (torch.arange(x.shape[0], device=x.device)
                < used_blocks.to(x.device) * block_t)[:, None]
    w0 = w[0].float()
    dx = dw = None
    if need_dx:
        dx = torch.empty_like(x)
        for r0 in range(0, x.shape[0], R):
            d = (dy[r0:r0 + R].float() @ w0.T).to(x.dtype)
            dx[r0:r0 + R] = d if live is None else torch.where(live[r0:r0 + R], d, 0)
    if need_dw:
        acc = torch.zeros(w.shape[1:], dtype=torch.float32, device=w.device)
        for r0 in range(0, x.shape[0], R):
            xr = x[r0:r0 + R].float()
            acc += (xr if live is None else xr * live[r0:r0 + R]).T @ dy[r0:r0 + R].float()
        dw = acc[None].to(w.dtype)
    return dx, dw


_FN = {}


def _kernel(name="grouped_matmul_fwd"):
    """Entry point ``name`` of ``csrc/moe_gmm.cu``: 4 pointers, 6 ints, the
    strides (dW's two, the others' three), the stream; or, for a name ending
    in ``_wgmma``, of ``csrc/moe_gmm_bwd.cu``: 5 pointers (``used_blocks``
    the fourth), 5 ints (no type), the strides, the stream."""
    if name not in _FN:
        wgmma = name.endswith("_wgmma")
        fn = getattr(build.load("moe_gmm_bwd" if wgmma else "moe_gmm"), name)
        fn.argtypes = ([ctypes.c_void_p] * (5 if wgmma else 4)
                       + [ctypes.c_int] * (5 if wgmma else 6)
                       + [ctypes.c_int64] * (2 if name.startswith("grouped_matmul_dw") else 3)
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN[name] = fn
    return _FN[name]


def _check_used(used_blocks, device):
    if used_blocks is None:
        return
    if (used_blocks.device != device or used_blocks.dtype != torch.int32
            or tuple(used_blocks.shape) != (1,)):
        raise ValueError(f"used_blocks must be a [1] int32 on {device}, got "
                         f"{tuple(used_blocks.shape)} {used_blocks.dtype} on {used_blocks.device}")


def _check(x, w, block_to_expert, block_t, what="grouped_matmul", k_dim=1):
    """What the kernels take; x's columns run over w's dimension ``k_dim``
    (1: B4 and B4b's dW, 2: B4b's dx)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} launches a CUDA kernel; got a tensor on {x.device} "
                         f"(the CPU takes {'grouped_matmul_bwd' if k_dim == 2 else what}_plain)")
    if w.device != x.device or block_to_expert.device != x.device:
        raise ValueError("x, w and block_to_expert must lie on one device")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"{what} takes float32 or bfloat16 x and w of one type, got "
                        f"{x.dtype} and {w.dtype}")
    if block_to_expert.dtype != torch.int32:
        raise TypeError(f"block_to_expert must be int32, got {block_to_expert.dtype}")
    if x.dim() != 2 or w.dim() != 3 or w.shape[k_dim] != x.shape[1]:
        raise ValueError(f"shapes x [T_pad, K], w [E, K, N] (dx: [E, N, K]); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if block_t not in BLOCK_TS:
        raise ValueError(f"block_t {block_t} not in {BLOCK_TS}")
    T, K = x.shape
    N = w.shape[3 - k_dim]
    if T == 0 or T % block_t:
        raise ValueError(f"T_pad {T} is not a positive multiple of block_t {block_t}")
    if block_to_expert.shape != (T // block_t,) or not block_to_expert.is_contiguous():
        raise ValueError(f"block_to_expert must be a contiguous [{T // block_t}], got "
                         f"{tuple(block_to_expert.shape)}")
    if K % TILE or N % TILE:
        raise ValueError(f"D {w.shape[1]} and F {w.shape[2]} must be multiples of {TILE}")
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


def grouped_matmul_dx(dy: torch.Tensor, w: torch.Tensor, block_to_expert: torch.Tensor,
                      block_t: int, used_blocks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch B4b's dx on CUDA tensors: ``dy[blk i] @ w[e_i]^T``, [T_pad, D]
    in dy's type, w read in place (:func:`bwd_route` names the kernel)."""
    _check(dy, w, block_to_expert, block_t, "grouped_matmul_dx", k_dim=2)
    _check_used(used_blocks, dy.device)
    check_capability(dy.device)
    T, F = dy.shape
    E, D, _ = w.shape
    dx = torch.empty((T, D), dtype=dy.dtype, device=dy.device)
    with torch.cuda.device(dy.device):
        stream = torch.cuda.current_stream(dy.device).cuda_stream
        if bwd_route(dy.dtype, block_t) == WGMMA_ROUTE:
            err = _kernel("grouped_matmul_dx_wgmma")(
                dy.data_ptr(), w.data_ptr(), block_to_expert.data_ptr(),
                None if used_blocks is None else used_blocks.data_ptr(), dx.data_ptr(),
                block_t, T // block_t, E, D, F, dy.stride(0), w.stride(0), w.stride(1), stream)
        else:
            err = _kernel("grouped_matmul_dx")(
                dy.data_ptr(), w.data_ptr(), block_to_expert.data_ptr(), dx.data_ptr(),
                _DTYPES[dy.dtype], block_t, T // block_t, E, D, F, dy.stride(0), w.stride(0),
                w.stride(1), stream)
    if err:
        raise RuntimeError(f"grouped_matmul_dx kernel launch failed with CUDA error {err}")
    grouped_matmul_dx.launches += 1
    return dx


grouped_matmul_dx.launches = 0


def grouped_matmul_dw(x: torch.Tensor, dy: torch.Tensor, block_to_expert: torch.Tensor,
                      block_t: int, num_experts: int,
                      used_blocks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch B4b's dW on CUDA tensors: ``dw[e] = sum over e's row blocks of
    x^T dy``, [E, D, F] contiguous in x's type, float32 sums
    (:func:`bwd_route` names the kernel)."""
    T, D = x.shape
    F = dy.shape[1]
    dw = torch.empty((num_experts, D, F), dtype=x.dtype, device=x.device)
    if dy.dim() != 2 or dy.shape[0] != T:
        raise ValueError(f"dy {tuple(dy.shape)} and x {tuple(x.shape)} differ in rows")
    _check(x, dw, block_to_expert, block_t, "grouped_matmul_dw")
    _check(dy, dw, block_to_expert, block_t, "grouped_matmul_dw", k_dim=2)
    _check_used(used_blocks, x.device)
    check_capability(x.device)
    nt = T // block_t
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if bwd_route(x.dtype, block_t) == WGMMA_ROUTE:
            err = _kernel("grouped_matmul_dw_wgmma")(
                x.data_ptr(), dy.data_ptr(), block_to_expert.data_ptr(),
                None if used_blocks is None else used_blocks.data_ptr(), dw.data_ptr(),
                block_t, nt, num_experts, D, F, x.stride(0), dy.stride(0), stream)
        else:
            err = _kernel("grouped_matmul_dw")(
                x.data_ptr(), dy.data_ptr(), block_to_expert.data_ptr(), dw.data_ptr(),
                _DTYPES[x.dtype], block_t, nt, num_experts, D, F, x.stride(0), dy.stride(0),
                stream)
    if err:
        raise RuntimeError(f"grouped_matmul_dw kernel launch failed with CUDA error {err}")
    grouped_matmul_dw.launches += 1
    return dw


grouped_matmul_dw.launches = 0
