"""The selective scan's vector-Jacobian product on Hopper: kernel B3b of the port.

The JAX package has no Pallas kernel for it: its model differentiates the
chunked scan ``repro/models/mamba.py::_ssm_chunk_scan`` (line 24) by
autodiff. The port's forward is kernel B3, so its backward is a kernel too.
For the forward ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t``,
``y_t = C_t . h_t + D x_t`` (h_{-1} = h0, h_S = h_{S-1}), given ``dy`` and
optionally ``dh_S``, with ``a_t = exp(dt_t A)``::

    g_t   = C_t dy_t + a_{t+1} g_{t+1}            (g_{S-1} starts from dh_S)
    dx_t  = dt_t sum_n g_t B_t + D dy_t
    ddt_t = x_t sum_n g_t B_t + sum_n g_t A a_t h_{t-1}
    dB_t  = sum_e g_t dt_t x_t,   dC_t = sum_e dy_t h_t
    dA    = sum_{b,t} g_t dt_t a_t h_{t-1},   dD = sum_{b,t} dy_t x_t
    dh0   = a_0 g_0

The states ``h_t`` come from the float32 states B3 saves at the start of
every ``T_c`` = :func:`~repro_torch.kernels.mamba_scan.state_chunk` = 16
steps (``mamba_scan(..., states=True)``): each span's are recomputed forward
from its saved state, then the span runs in reverse. The recurrence is never
run backwards as ``(h_t - bx_t) / a_t``: ``a_t`` underflows to 0 at large
``dt |A|``.

The kernel is ``csrc/mamba_scan_bwd.cu``: one block of 256 threads per
(batch row, 1024 / N channels), one thread per 2 channels x 2 states with
their ``A log2 e`` in registers, the N / 2 threads of a channel pair in one
warp. A span's inputs arrive in shared memory by double-buffered
``cp.async``; the thread's 16 recomputed states of the span stay in 64
registers (the loops fully unrolled), so a block takes ~52 KB of shared
memory at N 16 and at most 128 registers a thread, and two blocks share an
SM. The reverse runs steps in groups (two at N >= 16) whose loads,
exponentials (``ex2.approx``) and shuffle rounds interleave; the sums over a
channel pair's lanes (dx, ddt) and over a warp's pairs (dB, dC) are halving
reduce-scatters. What holds it above its bound of bytes (~0.24 ms at
falcon_mamba_7b's microbatch) is the instructions its warps issue, ~108 a
step of a warp in the unrolled span. The sums over channels (dB, dC) and
over the batch (dA, dD) leave each block as partials, which a second kernel
of the same source sums in a fixed order: no atomics, so two calls give the
same bits. It takes float32 only (the model casts dt, x, B and C to float32
before the scan) and N in {4, 8, 16, 32}.

:func:`mamba_scan_bwd_plain` is the same reverse recurrence in plain
PyTorch, a loop over t in float32: the CPU path and the kernel's yardstick
of correctness. :func:`mamba_scan_bwd` launches the kernel and counts its
launches in ``mamba_scan_bwd.launches``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.device import check_capability
from repro_torch.kernels import build
from repro_torch.kernels.mamba_scan import STATE_DIMS, state_chunk


class ScanGrads(NamedTuple):
    ddt: torch.Tensor       # [Bt, S, DI]
    dx: torch.Tensor        # [Bt, S, DI]
    dB: torch.Tensor        # [Bt, S, N]
    dC: torch.Tensor        # [Bt, S, N]
    dA: torch.Tensor        # [DI, N]
    dD: torch.Tensor        # [DI]
    dh0: torch.Tensor       # [Bt, DI, N]


def mamba_scan_bwd_plain(dt: torch.Tensor, x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                         A: torch.Tensor, D: torch.Tensor, states: torch.Tensor,
                         dy: torch.Tensor, dh_S: Optional[torch.Tensor] = None, *,
                         chunk: int) -> ScanGrads:
    """The reverse recurrence in float32, chunk by chunk from the states at
    the start of every ``chunk`` steps (``states[:, k]`` enters chunk k)."""
    dt, x, B, C, A, D, dy = (t.float() for t in (dt, x, B, C, A, D, dy))
    Bt, S, DI = x.shape
    bx = dt * x
    g = torch.zeros_like(states[:, 0]) if dh_S is None else dh_S.float()
    ddt, dx = torch.empty_like(x), torch.empty_like(x)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    dA = torch.zeros_like(A)
    for k in reversed(range(states.shape[1])):
        t0, t1 = k * chunk, min(S, (k + 1) * chunk)
        hs = [states[:, k]]                       # hs[i] = h_{t0 + i - 1}
        for t in range(t0, t1):
            hs.append(torch.exp(dt[:, t, :, None] * A) * hs[-1]
                      + bx[:, t, :, None] * B[:, t, None, :])
        for t in reversed(range(t0, t1)):
            a = torch.exp(dt[:, t, :, None] * A)
            g = C[:, t, None, :] * dy[:, t, :, None] + g       # g carried a_{t+1} g_{t+1}
            h_prev, h_t = hs[t - t0], hs[t - t0 + 1]
            dbx = (g * B[:, t, None, :]).sum(-1)
            gah = g * a * h_prev
            ddt[:, t] = dbx * x[:, t] + (gah * A).sum(-1)
            dx[:, t] = dbx * dt[:, t] + D * dy[:, t]
            dB[:, t] = (g * bx[:, t, :, None]).sum(1)
            dC[:, t] = (dy[:, t, :, None] * h_t).sum(1)
            dA += (gah * dt[:, t, :, None]).sum(0)
            g = a * g
    return ScanGrads(ddt, dx, dB, dC, dA, (dy * x).sum((0, 1)), g)


_FN = None


def block_channels(N: int) -> int:
    """Channels of one block of the kernel: 256 threads of 2 channels x 2
    states each (``kThreads / P * kCT`` in the source)."""
    return 1024 // N


def blocks_per_sm(N: int) -> int:
    """Blocks of the kernel resident on one SM at d_state N, as the CUDA
    runtime reckons them from its registers and shared memory (on the card:
    it builds the kernel)."""
    fn = build.load("mamba_scan_bwd").mamba_scan_bwd_blocks_per_sm
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    n = fn(N)
    if n < 0:
        raise RuntimeError(f"mamba_scan_bwd occupancy query failed with CUDA error {-n}")
    return n


def _kernel():
    global _FN
    if _FN is None:
        fn = build.load("mamba_scan_bwd").mamba_scan_bwd
        fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(dt, x, B, C, A, D, states, dy, dh_S):
    if x.device.type != "cuda":
        raise ValueError(f"mamba_scan_bwd launches a CUDA kernel; got a tensor on {x.device} "
                         f"(the CPU takes mamba_scan_bwd_plain)")
    ts = [dt, x, B, C, A, D, states, dy] + ([] if dh_S is None else [dh_S])
    if any(t.device != x.device for t in ts):
        raise ValueError("dt, x, B, C, A, D, states, dy and dh_S must lie on one device")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"mamba_scan_bwd takes float32 only, got "
                        f"{sorted({str(t.dtype) for t in ts})}")
    if x.dim() != 3 or dt.shape != x.shape or dy.shape != x.shape or B.dim() != 3 \
            or B.shape != C.shape:
        raise ValueError(f"shapes dt=x=dy [Bt,S,DI], B=C [Bt,S,N]; got {tuple(dt.shape)}, "
                         f"{tuple(x.shape)}, {tuple(dy.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    Bt, S, DI = x.shape
    N = B.shape[2]
    if min(Bt, S, DI) == 0:
        raise ValueError("mamba_scan_bwd needs Bt, S and DI above 0")
    if N not in STATE_DIMS:
        raise ValueError(f"d_state {N} not in {STATE_DIMS}")
    if B.shape[:2] != (Bt, S) or A.shape != (DI, N) or D.shape != (DI,):
        raise ValueError(f"B {tuple(B.shape)}, A {tuple(A.shape)}, D {tuple(D.shape)} do not "
                         f"match x {tuple(x.shape)}")
    nc = -(-S // state_chunk(N))
    if states.shape != (Bt, nc, DI, N):
        raise ValueError(f"states must be [Bt, ceil(S/{state_chunk(N)}), DI, N] = "
                         f"{(Bt, nc, DI, N)}, got {tuple(states.shape)}")
    if dh_S is not None and dh_S.shape != (Bt, DI, N):
        raise ValueError(f"dh_S must be [Bt, DI, N] = {(Bt, DI, N)}, got {tuple(dh_S.shape)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("mamba_scan_bwd takes contiguous tensors")


def mamba_scan_bwd(dt: torch.Tensor, x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                   A: torch.Tensor, D: torch.Tensor, states: torch.Tensor, dy: torch.Tensor,
                   dh_S: Optional[torch.Tensor] = None) -> ScanGrads:
    """Launch kernel B3b on CUDA tensors (float32, contiguous); ``states``
    from ``mamba_scan(..., states=True)``."""
    _check(dt, x, B, C, A, D, states, dy, dh_S)
    check_capability(x.device)
    Bt, S, DI = x.shape
    N = B.shape[2]
    tiles = -(-DI // block_channels(N))
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    ddt, dx = torch.empty_like(x), torch.empty_like(x)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    dA, dD = torch.empty((DI, N), **f32), torch.empty((DI,), **f32)
    dh0 = torch.empty((Bt, DI, N), **f32)
    # per-block partials, summed by the kernel's second pass in a fixed order
    dbc = torch.empty((tiles, Bt, S, 2 * N), **f32)
    dA_b = torch.empty((Bt, DI, N), **f32)
    dD_b = torch.empty((Bt, DI), **f32)
    with torch.cuda.device(dev):
        err = _kernel()(
            dt.data_ptr(), x.data_ptr(), B.data_ptr(), C.data_ptr(), A.data_ptr(),
            D.data_ptr(), states.data_ptr(), dy.data_ptr(),
            None if dh_S is None else dh_S.data_ptr(), ddt.data_ptr(), dx.data_ptr(),
            dB.data_ptr(), dC.data_ptr(), dA.data_ptr(), dD.data_ptr(), dh0.data_ptr(),
            dbc.data_ptr(), dA_b.data_ptr(), dD_b.data_ptr(),
            Bt, S, DI, N, state_chunk(N), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"mamba_scan_bwd kernel launch failed with CUDA error {err}")
    mamba_scan_bwd.launches += 1
    return ScanGrads(ddt, dx, dB, dC, dA, dD, dh0)


mamba_scan_bwd.launches = 0
