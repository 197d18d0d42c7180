"""Flash attention forward (prefill) on Hopper: kernel B1 of the port.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::_flash_kernel``
(its ``pl.pallas_call`` at line 103): causal, sliding-window or bidirectional
GQA attention with an online softmax in float32, scale ``hd**-0.5``, masked
scores at the finite ``-1e30`` and ``l`` clamped at ``1e-30``.

The kernel is ``csrc/flash_attention.cu``, looping in each block only over
the kv tiles the mask lets through. It takes the public ``[B, S, H, hd]`` /
``[B, S, KV, hd]`` layout with strides, every head dim of the JAX package's
configs (:data:`HEAD_DIMS`), and masks its own ragged edges. At the
serving shapes (S <= 256) it is bound by latency, not by HBM bytes: how
many SMs its blocks occupy and how long each block's chain of loads and
arithmetic is (see the note in the source). The route follows the type
(:data:`ROUTES`):

- bfloat16, the serving path: 16 query rows per warp, QK^T and PV on the
  tensor cores (``mma.sync``, float32 sums, P rounded to bf16), K/V tiles
  streamed through rings of ``cp.async`` copies; where the grid leaves the
  card room, a long row's kv tiles are split over 2-4 groups of warps, and
  two q tiles may share a block and its K/V tiles. Rows must be 16-byte
  aligned.
- float32: a float32 FMA loop (one block per 64 query rows), exact to
  2e-4, which TF32 would not be.

With ``return_lse=True`` (the training path, whose backward B1b in
``flash_attention_bwd.py`` recomputes the probabilities from it) both routes
also write each row's logsumexp ``m + log(max(l, 1e-30))`` in float32, shaped
``[B, S, KV, G]`` as the JAX package's ``_attend_fwd_impl`` returns it; the
serving calls pass no buffer and the kernel writes none.

:func:`flash_attention_plain` is the same function in plain PyTorch (the JAX
package's ``attend_plain``): the CPU path and the kernel's yardstick of
correctness. :func:`flash_attention` launches the kernel and counts its
launches in ``flash_attention.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import check_capability
from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's route for each type it takes (csrc/flash_attention.cu dispatches on it)
ROUTES = {torch.float32: "float32 FMA", torch.bfloat16: "bf16 tensor cores (mma.sync)"}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int = 0, return_lse: bool = False):
    """Materialized-scores attention in float32. q [B,S,H,hd]; k,v [B,S,KV,hd].

    With ``return_lse``, returns ``(out, lse)``: lse [B,S,KV,G] float32, the
    logsumexp of each row's masked scores."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qr = q.reshape(B, S, KV, G, hd).float()
    s = torch.einsum("bqkgd,btkd->bkgqt", qr, k.float()) * hd ** -0.5
    pos = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window and window > 0:
        mask &= (pos[:, None] - pos[None, :]) < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqt,btkd->bqkgd", p, v.float()).reshape(B, S, H, hd).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1).permute(0, 3, 1, 2)
    return out


_FN = None


def _kernel():
    global _FN
    if _FN is None:
        fn = build.load("flash_attention").flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_int64] * 9
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(q, k, v):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention launches a CUDA kernel; got a tensor on "
                         f"{q.device} (the CPU takes flash_attention_plain)")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q/k/v of one type, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes q [B,S,H,hd], k=v [B,S,KV,hd]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"{H} query heads are not a multiple of {k.shape[2]} kv heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the head dimension of q, k and v must be contiguous")
    if q.dtype == torch.bfloat16:       # the tensor-core route's 16-byte copies
        if any(t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]) for t in (q, k, v)):
            raise ValueError("bfloat16 q, k and v must be 16-byte aligned, rows included")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, return_lse: bool = False):
    """Launch kernel B1 on CUDA tensors: q [B,S,H,hd]; k,v [B,S,KV,hd] -> [B,S,H,hd],
    or ``(out, lse)`` with ``return_lse`` (lse [B,S,KV,G] float32)."""
    _check(q, k, v)
    check_capability(q.device)
    B, S, H, hd = q.shape
    KV = k.shape[2]
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, S, KV, H // KV), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None,
            _DTYPES[q.dtype], B, S, H, KV, hd,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(causal), int(window or 0), hd ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA error {err}")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
