"""Flash attention backward on Hopper: kernel B1b of the port.

The JAX package's ``attend_blocked`` (``repro/models/attention.py:59-93``)
is a flash forward with a plain-JAX custom VJP: the forward saves the
logsumexp of each row (``_attend_fwd_impl``, ``:96-147``), and the backward
(``_attend_bwd_impl``, ``:150-209``) recomputes each (q block, kv block)
pair's probabilities from it and adds into dq, dk and dv. It has no Pallas
kernel; the port's counterpart of the backward is B1b,
``csrc/flash_attention_bwd.cu``, because its forward is B1.

B1b computes ``dq, dk, dv`` from ``(q, k, v, out, lse, dout)`` for causal,
sliding-window and bidirectional masks with GQA, in float32 or bfloat16 with
float32 sums, with the reference's rounding (p and ds rounded to the input
type before their products). It is deterministic: a dq pass per q tile that
also writes ``D = rowsum(dO * O)``, then a dk/dv pass per kv tile over the q
tiles that can see it; each output is written by one block, without
atomics, so two calls give the same bits. It takes contiguous tensors only.
The route follows the type (:data:`ROUTES`; :data:`KERNELS` names the CUDA
kernels each launches):

- bfloat16, the training path: the products on the tensor cores
  (``mma.sync``, bf16 operands, float32 sums), each warp owning 16 rows of
  its pass's output so that p and ds go from one product's accumulators
  into the next one's operands in registers; Q/dO or K/V tiles streamed
  through ``cp.async`` rings; masks only on the tiles that need one. Its
  tensors must be 16-byte aligned.
- float32: a float32 FMA loop out of shared memory, exact to the JAX
  package's float32 tolerance.

Beside it, the plain versions, ported from the JAX package over the same
block pairs: :func:`attend_fwd_plain` (``_attend_fwd_impl``: the blocked
forward returning ``(out, lse)``) and :func:`flash_attention_bwd_plain`
(``_attend_bwd_impl``), with :func:`_block_pairs` and :func:`_pair_mask`.
:func:`flash_attention_bwd` launches the kernel and counts its launches in
``flash_attention_bwd.launches`` (one a call; the call runs both passes).
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.device import check_capability
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import _DTYPES, HEAD_DIMS, NEG_INF

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
# the kernel's route for each type it takes (csrc/flash_attention_bwd.cu
# dispatches on it), and the CUDA kernels of each, dq pass first
ROUTES = {torch.float32: "float32 FMA", torch.bfloat16: "bf16 tensor cores (mma.sync)"}
KERNELS = {torch.float32: ("bwd_dq_kernel", "bwd_dkdv_kernel"),
           torch.bfloat16: ("bwd_dq_tc_kernel", "bwd_dkdv_tc_kernel")}


def _block_pairs(nq: int, nkv: int, *, causal: bool, window_blocks: int) -> np.ndarray:
    """Static (i, j) block pairs that can contribute under the mask."""
    pairs = []
    for i in range(nq):
        lo = max(0, i - window_blocks) if window_blocks > 0 else 0
        hi = i + 1 if causal else nkv
        pairs.extend((i, j) for j in range(lo, hi))
    return np.asarray(pairs, np.int32)


def _pair_mask(i: int, j: int, block: int, causal: bool, window: int,
               device) -> torch.Tensor:
    ar = torch.arange(block, device=device)
    qpos, kpos = i * block + ar, j * block + ar
    mask = torch.ones((block, block), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window and window > 0:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    return mask


def _setup(q, k, block, window, causal):
    B, S, H, hd = q.shape
    KV = k.shape[2]
    nb = S // block
    wb = math.ceil(window / block) if window else 0
    return (B, S, H, hd, KV, H // KV, nb,
            _block_pairs(nb, nb, causal=causal, window_blocks=wb).tolist(), hd ** -0.5)


def attend_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                     window: int = 0, block: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """The blocked flash forward over the contributing block pairs (the JAX
    package's ``_attend_fwd_impl``). q [B,S,H,hd]; k,v [B,S,KV,hd]; S a
    multiple of ``block``. Returns (out [B,S,H,hd] in q's type, lse
    [B,S,KV,G] float32)."""
    B, S, H, hd, KV, G, nb, pairs, scale = _setup(q, k, block, window, causal)
    qb = q.reshape(B, nb, block, KV, G, hd)
    kb = k.reshape(B, nb, block, KV, hd)
    vb = v.reshape(B, nb, block, KV, hd)
    acc = [torch.zeros((B, block, KV, G, hd), device=q.device) for _ in range(nb)]
    m = [torch.full((B, block, KV, G), NEG_INF, device=q.device) for _ in range(nb)]
    l = [torch.zeros((B, block, KV, G), device=q.device) for _ in range(nb)]
    for i, j in pairs:
        s = torch.einsum("bqkgd,btkd->bkgqt", qb[:, i].float(), kb[:, j].float()) * scale
        s = torch.where(_pair_mask(i, j, block, causal, window, q.device), s, NEG_INF)
        m_new = torch.maximum(m[i], torch.movedim(s.amax(-1), -1, 1))   # [B,bq,KV,G]
        p = torch.exp(s - torch.movedim(m_new, 1, -1)[..., None])      # [B,KV,G,bq,bk]
        corr = torch.exp(m[i] - m_new)
        l[i] = l[i] * corr + torch.movedim(p.sum(-1), -1, 1)
        pv = torch.einsum("bkgqt,btkd->bqkgd", p.to(v.dtype).float(), vb[:, j].float())
        acc[i] = acc[i] * corr[..., None] + pv
        m[i] = m_new
    lc = torch.clamp_min(torch.stack(l, 1), 1e-30)
    out = (torch.stack(acc, 1) / lc[..., None]).reshape(B, S, H, hd).to(q.dtype)
    return out, (torch.stack(m, 1) + torch.log(lc)).reshape(B, S, KV, G)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                              causal: bool, window: int = 0, block: int = 512) -> Grads:
    """dq, dk, dv over the contributing block pairs (the JAX package's
    ``_attend_bwd_impl``): p recomputed from ``lse``, p and ds rounded to the
    inputs' type before their products, float32 sums, each gradient in its
    input's type. S must be a multiple of ``block``."""
    B, S, H, hd, KV, G, nb, pairs, scale = _setup(q, k, block, window, causal)
    qb = q.reshape(B, nb, block, KV, G, hd)
    kb = k.reshape(B, nb, block, KV, hd)
    vb = v.reshape(B, nb, block, KV, hd)
    dob = dout.reshape(B, nb, block, KV, G, hd)
    lseb = lse.reshape(B, nb, block, KV, G).float()
    # D_i = rowsum(dO ∘ O) — the softmax-jacobian diagonal term
    Db = (dout.float() * out.float()).sum(-1).reshape(B, nb, block, KV, G)
    dq = [torch.zeros((B, block, KV, G, hd), device=q.device) for _ in range(nb)]
    dk = [torch.zeros((B, block, KV, hd), device=q.device) for _ in range(nb)]
    dv = [torch.zeros((B, block, KV, hd), device=q.device) for _ in range(nb)]
    for i, j in pairs:
        qi, kj, vj, doi = qb[:, i].float(), kb[:, j].float(), vb[:, j].float(), dob[:, i].float()
        s = torch.einsum("bqkgd,btkd->bkgqt", qi, kj) * scale
        s = torch.where(_pair_mask(i, j, block, causal, window, q.device), s, NEG_INF)
        p = torch.exp(s - torch.movedim(lseb[:, i], 1, -1)[..., None])  # [B,KV,G,bq,bk]
        pc = p.to(v.dtype).float()
        dv[j] = dv[j] + torch.einsum("bkgqt,bqkgd->btkd", pc, doi)
        dp = torch.einsum("bqkgd,btkd->bkgqt", doi, vj)
        ds = p * (dp - torch.movedim(Db[:, i], 1, -1)[..., None]) * scale
        dsc = ds.to(q.dtype).float()
        dq[i] = dq[i] + torch.einsum("bkgqt,btkd->bqkgd", dsc, kj)
        dk[j] = dk[j] + torch.einsum("bkgqt,bqkgd->btkd", dsc, qi)
    return (torch.stack(dq, 1).reshape(B, S, H, hd).to(q.dtype),
            torch.stack(dk, 1).reshape(B, S, KV, hd).to(k.dtype),
            torch.stack(dv, 1).reshape(B, S, KV, hd).to(v.dtype))


_FN = None


def _kernel():
    global _FN
    if _FN is None:
        fn = build.load("flash_attention_bwd").flash_attention_bwd
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(q, k, v, out, lse, dout):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd launches a CUDA kernel; got a tensor on "
                         f"{q.device} (the CPU takes flash_attention_bwd_plain)")
    ts = (q, k, v, out, dout, lse)
    if any(t.device != q.device for t in ts):
        raise ValueError("q, k, v, out, lse and dout must lie on one device")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (k, v, out, dout)):
        raise TypeError(f"flash_attention_bwd takes float32 or bfloat16 q/k/v/out/dout of "
                        f"one type, got {[t.dtype for t in (q, k, v, out, dout)]}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes q [B,S,H,hd], k=v [B,S,KV,hd]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd or H % KV:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout {tuple(dout.shape)} must be shaped "
                         f"as q {tuple(q.shape)}")
    if lse.dtype != torch.float32 or lse.shape != (B, S, KV, H // KV):
        raise ValueError(f"lse must be float32 [B,S,KV,G] = {(B, S, KV, H // KV)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("flash_attention_bwd takes contiguous q, k, v, out, lse and dout")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v, out, dout)):
        raise ValueError("bfloat16 q, k, v, out and dout must be 16-byte aligned (the "
                         "tensor-core route's 16-byte copies)")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0) -> Grads:
    """Launch kernel B1b on contiguous CUDA tensors: q, out, dout [B,S,H,hd]; k, v
    [B,S,KV,hd]; lse [B,S,KV,G] float32 from B1. Returns (dq, dk, dv) in the
    inputs' type."""
    _check(q, k, v, out, lse, dout)
    check_capability(q.device)
    B, S, H, hd = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    dsum = torch.empty((B, S, H), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dsum.data_ptr(),
            _DTYPES[q.dtype], B, S, H, k.shape[2], hd, int(causal), int(window or 0),
            hd ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed with CUDA error {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
