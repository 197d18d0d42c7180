"""Selective scan (Mamba-1) on Hopper: kernel B3 of the port.

Replaces the TPU kernel ``repro/kernels/mamba_scan.py::_mamba_kernel`` (its
``pl.pallas_call`` at line 68)::

    h_t = exp(dt_t A) * h_{t-1} + (dt_t x_t) B_t
    y_t = C_t . h_t + D x_t

with dt, x ``[Bt, S, DI]``, B, C ``[Bt, S, N]``, A ``[DI, N]``, D ``[DI]``.
Beyond the TPU kernel, which starts from zeros and drops the final state,
it takes ``h0`` ``[Bt, DI, N]`` (zeros when ``None``) and returns ``h_S``:
prefill hands that state to decode. On request (``states=True``, the
training forward) it also writes the float32 state at the start of every
:func:`state_chunk` steps, ``[Bt, ceil(S / T_c), DI, N]`` (the first is
h0): the backward, B3b (``mamba_scan_bwd.py``), recomputes the states of
each span from them. y and h_S are the same bits with or without.

The kernel is ``csrc/mamba_scan.cu``: one block per 64 channels loops over
t, one thread per (channel, N/4 states) with the states in registers, each
exponential one ``ex2`` of ``dt * (A log2 e)``, and y a sum over the 4
threads of a channel. dt, x, B and C arrive by double-buffered 16-byte
``cp.async`` copies where their layout allows, so the next chunk of time
steps loads while one is scanned, and y leaves a chunk at a time in
16-byte stores. Its floor is the SFUs' exponentials at long prompts and
the latency of its sequential loop at short ones. It takes float32 and
bfloat16 dt/x/B/C of one type through their strides (B and C may be column
slices of one projection), N in {4, 8, 16, 32}, and float32 A, D and state.

:func:`mamba_scan_plain` is the JAX package's sequential oracle
(``kernels/ref.py::mamba_scan_ref``) in plain PyTorch, with ``h0``/``h_S``
added: the CPU path and the kernel's yardstick of correctness.
:func:`mamba_scan` launches the kernel and counts its launches in
``mamba_scan.launches``. Both return ``(y, h_S)``: y in x's type, h_S in
float32.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.device import check_capability
from repro_torch.kernels import build

STATE_DIMS = (4, 8, 16, 32)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def state_chunk(N: int) -> int:
    """Time steps between the saved states, 16 at every N: B3b keeps the
    states of such a span in registers, 16 steps x 4 (channel, state) pairs
    a thread in 64 of them. It divides B3's chunk of staged steps (32, 16 at
    N 32), so B3 writes a state at every half-chunk or chunk. The wrappers
    pass it to B3 and B3b, which refuse it unless it is their own
    (``state_chunk`` in ``csrc/common.cuh``)."""
    return 16


def mamba_scan_plain(dt: torch.Tensor, x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                     A: torch.Tensor, D: torch.Tensor, h0: Optional[torch.Tensor] = None,
                     chunk: Optional[int] = None):
    """The sequential recurrence, float32 state. Returns (y [Bt,S,DI] in x's
    type, h_S [Bt,DI,N] float32), and with ``chunk`` the states at the start
    of every ``chunk`` steps, ``[Bt, ceil(S / chunk), DI, N]``, third."""
    Bt, S, DI = x.shape
    A32 = A.float()
    dt32 = dt.float()
    bx = (dt * x).float()      # rounded to the inputs' type, as in the JAX oracle
    B32, C32 = B.float(), C.float()
    if h0 is None:
        h = torch.zeros((Bt, DI, A.shape[1]), dtype=torch.float32, device=x.device)
    else:
        h = h0.float()
    ys, states = [], []
    for t in range(S):
        if chunk and t % chunk == 0:
            states.append(h)
        h = torch.exp(dt32[:, t, :, None] * A32) * h + bx[:, t, :, None] * B32[:, t, None, :]
        ys.append((h * C32[:, t, None, :]).sum(-1))
    y = torch.stack(ys, 1) + x.float() * D.float()
    if chunk:
        return y.to(x.dtype), h, torch.stack(states, 1)
    return y.to(x.dtype), h


_FN = None


def _kernel():
    global _FN
    if _FN is None:
        fn = build.load("mamba_scan").mamba_scan_fwd
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                       + [ctypes.c_int64] * 12 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(dt, x, B, C, A, D, h0):
    if x.device.type != "cuda":
        raise ValueError(f"mamba_scan launches a CUDA kernel; got a tensor on {x.device} "
                         f"(the CPU takes mamba_scan_plain)")
    ts = [dt, x, B, C, A, D] + ([] if h0 is None else [h0])
    if any(t.device != x.device for t in ts):
        raise ValueError("dt, x, B, C, A, D and h0 must lie on one device")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (dt, B, C)):
        raise TypeError(f"mamba_scan takes float32 or bfloat16 dt/x/B/C of one type, got "
                        f"{dt.dtype}, {x.dtype}, {B.dtype}, {C.dtype}")
    if any(t.dtype != torch.float32 for t in ts[4:]):
        raise TypeError("mamba_scan takes float32 A, D and h0")
    if x.dim() != 3 or dt.shape != x.shape or B.dim() != 3 or B.shape != C.shape:
        raise ValueError(f"shapes dt=x [Bt,S,DI], B=C [Bt,S,N]; got {tuple(dt.shape)}, "
                         f"{tuple(x.shape)}, {tuple(B.shape)}, {tuple(C.shape)}")
    Bt, S, DI = x.shape
    N = B.shape[2]
    if min(Bt, S, DI) == 0:
        raise ValueError("mamba_scan needs Bt, S and DI above 0")
    if B.shape[:2] != (Bt, S) or A.shape != (DI, N) or D.shape != (DI,):
        raise ValueError(f"B {tuple(B.shape)}, A {tuple(A.shape)}, D {tuple(D.shape)} do not "
                         f"match x {tuple(x.shape)}")
    if h0 is not None and h0.shape != (Bt, DI, N):
        raise ValueError(f"h0 must be [Bt, DI, N] = {(Bt, DI, N)}, got {tuple(h0.shape)}")
    if N not in STATE_DIMS:
        raise ValueError(f"d_state {N} not in {STATE_DIMS}")
    if not all(t.is_contiguous() for t in ts[4:]):
        raise ValueError("A, D and h0 must be contiguous")


def mamba_scan(dt: torch.Tensor, x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
               A: torch.Tensor, D: torch.Tensor, h0: Optional[torch.Tensor] = None,
               states: bool = False):
    """Launch kernel B3 on CUDA tensors. Returns (y [Bt,S,DI] in x's type,
    h_S [Bt,DI,N] float32), and with ``states`` the float32 states at the
    start of every :func:`state_chunk` steps, ``[Bt, ceil(S / T_c), DI, N]``,
    third."""
    _check(dt, x, B, C, A, D, h0)
    check_capability(x.device)
    Bt, S, DI = x.shape
    N = B.shape[2]
    y = torch.empty((Bt, S, DI), dtype=x.dtype, device=x.device)
    h_last = torch.empty((Bt, DI, N), dtype=torch.float32, device=x.device)
    hs = None
    if states:
        hs = torch.empty((Bt, -(-S // state_chunk(N)), DI, N), dtype=torch.float32,
                         device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel()(
            dt.data_ptr(), x.data_ptr(), B.data_ptr(), C.data_ptr(), A.data_ptr(),
            D.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_last.data_ptr(), None if hs is None else hs.data_ptr(), _DTYPES[x.dtype],
            Bt, S, DI, N, state_chunk(N),
            *dt.stride(), *x.stride(), *B.stride(), *C.stride(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"mamba_scan kernel launch failed with CUDA error {err}")
    mamba_scan.launches += 1
    return (y, h_last, hs) if states else (y, h_last)


mamba_scan.launches = 0
