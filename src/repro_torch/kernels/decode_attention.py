"""Decode attention on Hopper: kernel B2 of the port.

Replaces the TPU kernel ``repro/kernels/decode_attention.py::_decode_kernel``
(its ``pl.pallas_call`` at line 84): one query token per sequence against a
linear or ring KV cache, the G query heads of a kv head together, with a
per-sequence ``valid_len`` = ``min(pos + 1, W)`` (a ring cache: ``W`` once
``pos >= W``) past which cache blocks are skipped.

The kernel is ``csrc/decode_attention.cu``: one block of 8 warps per
(b, kv head, up to 8 of its query heads) reads the cache straight from
global memory in 16-byte vectors, its warps on interleaved keys, the q rows
sharing each K/V load, and merges its warps' online softmaxes in shared
memory. :func:`decode_route` picks the route on the host: one launch over
all of ``[0, valid_len)`` at the serving shapes, where the call is bound by
latency; for long caches, where one block per (b, kv head) would walk too
many keys, flash-decoding in two launches (partial softmaxes over chunks of
W, :func:`split_chunk` keys each, then a combine per (b, h)). It takes
float32 and bfloat16, the public ``[B, H, hd]`` / ``[B, W, KV, hd]`` layout
with strides (a layer's slice of the stacked cache needs no copy), 16-byte
aligned rows and every head dim of the JAX package's configs
(:data:`HEAD_DIMS`).

:func:`decode_attention_plain` is the JAX package's ``attend_decode`` with
``impl="ref"`` in plain PyTorch: the CPU path and the kernel's yardstick of
correctness. :func:`decode_attention` launches the kernel and counts its
launches in ``decode_attention.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.device import check_capability
from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMS = 132                  # H100 SXM streaming multiprocessors
WARPS = 8                  # warps of a block (csrc/decode_attention.cu kWarps; a card test
                           # holds WARPS * keys_per_step to the kernel's own)
MAX_STEPS = 16             # key steps a warp may walk on the one-launch route


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           positions: torch.Tensor, *, ring: bool = False) -> torch.Tensor:
    """q [B,H,hd]; caches [B,W,KV,hd]; positions [B] (index of the token being
    generated). A ring cache (``ring=True``) is fully valid once wrapped."""
    B, W, KV, hd = k_cache.shape
    H = q.shape[1]
    G = H // KV
    qr = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgd,btkd->bkgt", qr.float(), k_cache.float()) * hd ** -0.5
    slot = torch.arange(W, device=q.device)
    valid = slot[None, :] <= positions[:, None]
    if ring:
        valid = valid | (positions[:, None] >= W)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # the JAX reference rounds p to the cache's type before the second product
    out = torch.einsum("bkgt,btkd->bkgd", p.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(B, H, hd).to(q.dtype)


def split_chunk(B: int, KV: int, W: int) -> int:
    """Keys per chunk of pass 1: halve from 64 (down to 16) until the grid
    of chunks x kv heads x sequences gives every SM two blocks."""
    chunk = 64
    while chunk > 16 and B * KV * -(-W // chunk) < 2 * SMS:
        chunk //= 2
    return chunk


def keys_per_step(hd: int, itemsize: int) -> int:
    """Keys a warp reads at once: a row's 16-byte vectors take a power of two
    of its 32 lanes (all 32 past 32 vectors)."""
    lanes = 1
    while lanes < min(32, hd * itemsize // 16):
        lanes *= 2
    return 32 // lanes


def decode_route(B: int, KV: int, W: int, hd: int, itemsize: int) -> Tuple[str, int]:
    """The kernel's route and the keys a block takes: ``("one launch", W)``
    while one block per (b, kv head) walks at most :data:`MAX_STEPS` steps of
    each warp over the cache; past that ``("split", split_chunk(B, KV, W))``,
    a second launch combining the chunks."""
    if -(-W // (WARPS * keys_per_step(hd, itemsize))) <= MAX_STEPS:
        return "one launch", W
    return "split", split_chunk(B, KV, W)


_FN = None


def _kernel():
    global _FN
    if _FN is None:
        fn = build.load("decode_attention").decode_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                       + [ctypes.c_int64] * 8
                       + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(q, k_cache, v_cache, positions):
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention launches a CUDA kernel; got a tensor on "
                         f"{q.device} (the CPU takes decode_attention_plain)")
    if any(t.device != q.device for t in (k_cache, v_cache, positions)):
        raise ValueError("q, caches and positions must lie on one device")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"decode_attention takes float32 or bfloat16 q/caches of one type, "
                        f"got {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"shapes q [B,H,hd], caches [B,W,KV,hd]; got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, W, KV, hd = k_cache.shape
    if min(B, W, KV, q.shape[1]) == 0:
        raise ValueError("decode_attention needs B, H, KV and W above 0")
    if q.shape[0] != B or q.shape[2] != hd or q.shape[1] % KV:
        raise ValueError(f"q {tuple(q.shape)} does not match caches {tuple(k_cache.shape)}")
    if positions.shape != (B,) or positions.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"positions must be [B] integers, got {tuple(positions.shape)} "
                         f"{positions.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if q.stride(2) != 1 or k_cache.stride(3) != 1 or v_cache.stride(3) != 1:
        raise ValueError("the head dimension of q and the caches must be contiguous")
    vec = 16 // q.element_size()       # the kernel's 16-byte loads
    if any(t.data_ptr() % 16 or any(st % vec for st in t.stride()[:-1])
           for t in (q, k_cache, v_cache)):
        raise ValueError("q and the caches must be 16-byte aligned, rows included")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     positions: torch.Tensor, *, ring: bool = False) -> torch.Tensor:
    """Launch kernel B2 on CUDA tensors: q [B,H,hd]; caches [B,W,KV,hd];
    positions [B] -> [B,H,hd]."""
    _check(q, k_cache, v_cache, positions)
    check_capability(q.device)
    B, W, KV, hd = k_cache.shape
    H = q.shape[1]
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    route, chunk = decode_route(B, KV, W, hd, q.element_size())
    part_acc = part_ml = None
    if route == "split":
        nsplit = -(-W // chunk)
        part_acc = torch.empty(B * H * nsplit * hd, dtype=torch.float32, device=q.device)
        part_ml = torch.empty(B * H * nsplit * 2, dtype=torch.float32, device=q.device)
    pos = positions if positions.dtype == torch.int32 else positions.to(torch.int32)
    pos = pos.contiguous()
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
            out.data_ptr(), None if part_acc is None else part_acc.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(),
            _DTYPES[q.dtype], B, W, H, KV, hd, chunk,
            q.stride(0), q.stride(1),
            k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
            v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
            int(ring), hd ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed with CUDA error {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
