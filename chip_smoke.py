#!/usr/bin/env python3
"""Quickest proof that the PyTorch port starts and serves on the GPU.

    python3 chip_smoke.py

Needs one CUDA card of compute capability 9.0 (an H100) and ``nvcc``; it
imports nothing of JAX. Phases, each of which fails the run:

1. environment: the card's name and power limit, torch, the capability;
2. build: the four kernels of the serving paths from ``src/repro_torch/csrc``,
   one ``nvcc`` each, all at once;
3. kernels against their plain PyTorch versions on the card, at the serving
   shapes and at the JAX package's sweep shapes: attention (B1, B2) and the
   grouped matmul (B4, on layouts routed as moonshot_v1_16b routes) in
   float32 (TF32 off) within 2e-4 and bfloat16 within 2e-2, the selective
   scan (B3) within 2e-3 and 5e-2, its output and its final state; times of
   kernel, plain version, bound and one library call where there is one
   (``scaled_dot_product_attention`` for attention, ``torch._grouped_mm``
   for B4, timed here only; no PyTorch call computes a selective scan);
4. engine: the port's ``Engine`` serves 24 requests of ``tiny_lm`` (c=4) and
   ``small_lm`` (c=2) at full width in bfloat16, and must have launched B1
   and B2;
5. engine: the port's ``Engine`` serves 8 requests of ``falcon_mamba_7b``
   (c=2) at full width and depth (64 layers, bfloat16), and must have
   launched B3; cold start split into materialization and warm-up, peak
   device memory;
6. engine: the port's ``Engine`` serves 8 requests of ``moonshot_v1_16b``
   (c=2) at full width and depth (48 layers, 64 experts, top-6, bfloat16),
   and must have launched B4 three times per layer per model call, B1 and
   B2, and not B3; the same cold start, memory and timing report;
7. model parity: an f32 ``tiny_lm``, and f32 ``falcon_mamba_7b`` and
   ``moonshot_v1_16b`` cut to 2 layers at full width, on the card (kernels)
   against the same weights on the CPU (plain versions): logits and caches
   within 2e-3, greedy tokens equal, over a prefill and 4 decode steps.

Between the engine phases the image cache is emptied, so that the card
holds one large image at a time.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a card it exits non-zero and
prints no result.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_S = 3.35e12                         # H100 SXM HBM3
PEAK_FLOP_S = {"bfloat16": 989e12,            # dense tensor-core bf16
               "float32": 67e12}              # float32 outside the tensor cores
TOL = {"float32": 2e-4, "bfloat16": 2e-2}     # tests/test_kernels.py:17-19
SCAN_TOL = {"float32": 2e-3, "bfloat16": 5e-2}   # tests/test_kernels.py:78-79
LOGIT_TOL = 2e-3                              # tests/test_decode_parity.py

# (label, B, S, H, KV, hd, causal, window): the engine's prefills (tiny_lm and
# small_lm, prompts bucketed to 16/32/64, 256 at the Engine's default max_len)
# and the JAX sweep (tests/test_kernels.py:24-29)
FLASH_CASES = [
    ("tiny_lm S16", 1, 16, 8, 4, 32, True, 0),
    ("tiny_lm S32", 1, 32, 8, 4, 32, True, 0),
    ("tiny_lm S64", 1, 64, 8, 4, 32, True, 0),
    ("tiny_lm S256", 1, 256, 8, 4, 32, True, 0),
    ("small_lm S16", 1, 16, 8, 8, 64, True, 0),
    ("small_lm S32", 1, 32, 8, 8, 64, True, 0),
    ("small_lm S64", 1, 64, 8, 8, 64, True, 0),
    ("small_lm S256", 1, 256, 8, 8, 64, True, 0),
    ("moonshot S16", 1, 16, 16, 16, 128, True, 0),
    ("moonshot S32", 1, 32, 16, 16, 128, True, 0),
    ("sweep", 2, 256, 4, 2, 64, True, 0),
    ("sweep bidir", 1, 256, 4, 4, 128, False, 0),
    ("sweep window", 2, 512, 8, 2, 64, True, 100),
    ("sweep", 1, 128, 2, 1, 32, True, 0),
]
# (label, B, W, H, KV, hd, ring): the engine's decodes (B = slots, W = max_len)
# and the JAX sweep (tests/test_kernels.py:44-48)
DECODE_CASES = [
    ("tiny_lm c4 W64", 4, 64, 8, 4, 32, False),
    ("tiny_lm c4 W256", 4, 256, 8, 4, 32, False),
    ("small_lm c2 W64", 2, 64, 8, 8, 64, False),
    ("small_lm c2 W256", 2, 256, 8, 8, 64, False),
    ("moonshot c2 W64", 2, 64, 16, 16, 128, False),
    ("sweep", 2, 256, 8, 2, 64, False),
    ("sweep ring", 3, 128, 4, 4, 32, True),
    ("sweep", 1, 512, 16, 2, 128, False),
]
# (label, Bt, S, DI, N): falcon_mamba_7b's prefills (prompts bucketed to 16/32,
# 64 and 256 for longer ones), float32 with a non-zero h0 as mamba_forward
# calls it, and the JAX sweep (tests/test_kernels.py:63-67) in both types
MAMBA_CASES = [
    ("falcon_mamba_7b S16", 1, 16, 8192, 16),
    ("falcon_mamba_7b S32", 1, 32, 8192, 16),
    ("falcon_mamba_7b S64", 1, 64, 8192, 16),
    ("falcon_mamba_7b S256", 1, 256, 8192, 16),
    ("sweep", 2, 128, 64, 8),
    ("sweep", 1, 64, 128, 16),
    ("sweep", 2, 96, 32, 4),
]
# (label, B, S, D, F): moonshot_v1_16b's expert GEMMs (64 experts, top-6) on
# layouts routed from random router probabilities: a decode step with 2 slots
# (B=2, S=1) and the 16/32-token prefill buckets, gate/up (D 2048 -> F 1408)
# and down (1408 -> 2048)
GMM_CASES = [
    ("moonshot decode c2 wg/wi", 2, 1, 2048, 1408),
    ("moonshot decode c2 wo", 2, 1, 1408, 2048),
    ("moonshot S16 wg/wi", 1, 16, 2048, 1408),
    ("moonshot S16 wo", 1, 16, 1408, 2048),
    ("moonshot S32 wg/wi", 1, 32, 2048, 1408),
    ("moonshot S32 wo", 1, 32, 1408, 2048),
]
# (T_pad, D, F, E, block_t): the JAX sweep (tests/test_kernels.py:86-89)
GMM_SWEEP = [(512, 128, 256, 4, 64), (256, 64, 128, 8, 32)]
# the shapes the kernels line reports: the engine's commonest calls
FLASH_LINE = "tiny_lm S32"
DECODE_LINE = "tiny_lm c4 W64"
MAMBA_LINE = "falcon_mamba_7b S32"
GMM_LINE = "moonshot decode c2 wg/wi"    # 2 of B4's 3 calls per layer of a decode step


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=100, warmup=10) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=50):
    """Mean device time per call of the kernels ``fn`` launches, from the
    profiler's CUDA activity (None where the profiler sees no device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return sum(spans) / iters / 1e3 if spans else None


def _ms(x):
    return "not measured" if x is None else f"{x:.4f}"


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOP_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_environment():
    import torch
    smi = nvidia_smi()
    print(f"[env] nvidia-smi: {smi}")
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    cap = torch.cuda.get_device_capability(0)
    print(f"[env] {torch.cuda.get_device_name(0)} capability {cap} "
          f"count {torch.cuda.device_count()}")
    check(cap >= (9, 0), f"capability {cap} is below (9, 0)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    took = build.build()
    for name in build.SOURCES:
        build.load(name)
        regs = [ln.strip() for ln in build.build_log(name).splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"[build] {name}: {build.library_path(name).name} "
              f"({took.get(name, 0.0):.1f} s)")
        for ln in regs:
            print(f"[build]   {ln}")
    print(f"[build] total {time.perf_counter() - t0:.1f} s")


def _inputs(gen, shape, dtype, device="cuda"):
    import torch
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def phase_kernels():
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        tol = TOL[dname]
        for label, B, S, H, KV, hd, causal, window in FLASH_CASES:
            q = _inputs(gen, (B, S, H, hd), dtype)
            k = _inputs(gen, (B, S, KV, hd), dtype)
            v = _inputs(gen, (B, S, KV, hd), dtype)
            out = fa.flash_attention(q, k, v, causal=causal, window=window)
            ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ok = torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)
            print(f"[kernels] flash_attention {label} B{B} S{S} H{H} KV{KV} hd{hd} "
                  f"causal={causal} window={window} {dname}: max_abs_err {err:.3e} "
                  f"(tol {tol:g}) {'ok' if ok else 'FAIL'}")
            check(ok, f"flash_attention {label} {dname} disagrees with its plain version")
            if not label.startswith("sweep"):
                rows[("flash_attention", label, dname)] = _time_flash(
                    F, fa, q, k, v, causal, window, dname, err)
        for label, B, W, H, KV, hd, ring in DECODE_CASES:
            q = _inputs(gen, (B, H, hd), dtype)
            kc = _inputs(gen, (B, W, KV, hd), dtype)
            vc = _inputs(gen, (B, W, KV, hd), dtype)
            rng = np.random.default_rng(B * W + H)
            if label.startswith("sweep"):
                pos = rng.integers(5, W * 2 if ring else W, B)
            else:   # the engine's decode positions: prompt bucket + a few tokens
                pos = rng.integers(16, 40, B)
            pos = torch.as_tensor(pos, dtype=torch.int32, device="cuda")
            out = dec.decode_attention(q, kc, vc, pos, ring=ring)
            ref = dec.decode_attention_plain(q, kc, vc, pos, ring=ring)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ok = torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)
            print(f"[kernels] decode_attention {label} B{B} W{W} H{H} KV{KV} hd{hd} "
                  f"ring={ring} {dname}: max_abs_err {err:.3e} (tol {tol:g}) "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"decode_attention {label} {dname} disagrees with its plain version")
            if not label.startswith("sweep"):
                rows[("decode_attention", label, dname)] = _time_decode(
                    F, dec, q, kc, vc, pos, ring, dname, err)
    rows.update(_check_mamba(gen))
    rows.update(_check_gmm(gen))
    print("[kernels] ms: CUDA events over back-to-back calls (host overhead "
          "included); device_ms: the profiler's kernel time per call")
    for (name, label, dname), r in rows.items():
        lib = "library_ms none (no PyTorch call computes it)"
        if r["library_ms"] is not None:
            lib = (f"library_ms {r['library_ms']:.4f} (device {_ms(r['library_device_ms'])}, "
                   f"max_abs_err {r['library_err']:.1e}, {r['library']})")
        print(f"[kernels] time {name} {label} {dname}: kernel_ms {r['ms']:.4f} "
              f"(device {_ms(r['device_ms'])}) plain_ms {r['plain_ms']:.4f} "
              f"(device {_ms(r['plain_device_ms'])}) {lib} "
              f"bound_ms {r['bound_ms']:.6f} ({r['bound_by']})")
    return rows


def _check_mamba(gen):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import mamba_scan as ms

    rows = {}
    for label, Bt, S, DI, N in MAMBA_CASES:
        serving = not label.startswith("sweep")
        for dname in ("float32",) if serving else ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            dt = (F.softplus(torch.randn(Bt, S, DI, generator=gen, device="cuda")) * 0.1
                  ).to(dtype)
            x = _inputs(gen, (Bt, S, DI), dtype)
            Bc = _inputs(gen, (Bt, S, N), dtype)
            Cc = _inputs(gen, (Bt, S, N), dtype)
            A = -torch.exp(0.2 * torch.randn(DI, N, generator=gen, device="cuda"))
            D = torch.randn(DI, generator=gen, device="cuda")
            h0 = torch.randn(Bt, DI, N, generator=gen, device="cuda") if serving else None
            args = (dt, x, Bc, Cc, A, D, h0)
            y, h = ms.mamba_scan(*args)
            ry, rh = ms.mamba_scan_plain(*args)
            torch.cuda.synchronize()
            tol = SCAN_TOL[dname]
            err = (y.float() - ry.float()).abs().max().item()
            h_err = (h - rh).abs().max().item()
            ok = (torch.allclose(y.float(), ry.float(), rtol=tol, atol=tol)
                  and torch.allclose(h, rh, rtol=tol, atol=tol))
            print(f"[kernels] mamba_scan {label} Bt{Bt} S{S} DI{DI} N{N} h0={h0 is not None} "
                  f"{dname}: max_abs_err y {err:.3e} h_S {h_err:.3e} (tol {tol:g}) "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"mamba_scan {label} {dname} disagrees with its plain version")
            if serving:
                rows[("mamba_scan", label, dname)] = _time_mamba(ms, args, dname,
                                                                 max(err, h_err))
    return rows


def _time_mamba(ms, args, dname, err):
    dt, x, Bc, Cc, A, D, h0 = args
    Bt, S, DI = x.shape
    N = Bc.shape[2]
    # each input read once, y and h_S written once; per (t, channel, state) an
    # exp and 6 float32 operations, per (t, channel) 3 (dt*x and D*x + y)
    nbytes = ((dt.numel() + 2 * x.numel() + Bc.numel() + Cc.numel()) * x.element_size()
              + (A.numel() + D.numel() + (1 + (h0 is not None)) * Bt * DI * N) * 4)
    b_ms, b_by = bound_ms(nbytes, Bt * S * DI * (7.0 * N + 3), dname)
    kern = lambda: ms.mamba_scan(*args)
    plain = lambda: ms.mamba_scan_plain(*args)
    plain_iters = max(5, 1600 // S)      # the plain loop makes ~5 torch calls per step
    return {"shape": f"Bt{Bt} S{S} DI{DI} N{N}", "max_abs_err": err,
            "ms": time_ms(kern), "device_ms": device_ms(kern),
            "plain_ms": time_ms(plain, iters=plain_iters, warmup=2),
            "plain_device_ms": device_ms(plain, iters=plain_iters),
            "library_ms": None, "library_device_ms": None, "library_err": None,
            "library": None,
            "bound_ms": b_ms, "bound_by": b_by}


def _check_gmm(gen):
    import torch

    from repro_torch.kernels import moe_gmm
    from repro_torch.models import moe as tmoe

    rows = {}
    E, k = 64, 6
    for label, B, S, D, F in GMM_CASES:          # moonshot's routing at this shape
        C = tmoe.capacity(S, k, E, 1.25)
        gate, eidx = torch.softmax(torch.randn(B, S, E, generator=gen, device="cuda"),
                                   -1).topk(k)
        lay = tmoe.build_layout(eidx, gate / gate.sum(-1, keepdim=True), C,
                                tmoe.block_rows(B, C), E)
        kept = int((lay.row_token < B * S).sum())
        what = (f"B{B} S{S} C{C} T_pad{lay.row_token.numel()} bt{lay.block_t} D{D} F{F} "
                f"E{E}: {kept} of {B * S * k} assignments kept, "
                f"{int(torch.unique(lay.block_to_expert).numel())} experts")
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            x = torch.cat([_inputs(gen, (B * S, D), dtype),
                           torch.zeros(1, D, dtype=dtype, device="cuda")])[lay.row_token]
            args = (x, _gmm_weights(gen, E, D, F, dtype), lay.block_to_expert, lay.block_t)
            err = _gmm_compare(moe_gmm, label, what, args, dname)
            if dname == "bfloat16":
                rows[("grouped_matmul", label, dname)] = _time_gmm(moe_gmm, args, kept, err)
    for T, D, F, E2, bt in GMM_SWEEP:            # random block_to_expert
        bmap = torch.randint(0, E2, (T // bt,), generator=gen, device="cuda",
                             dtype=torch.int32)
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            args = (_inputs(gen, (T, D), dtype), _gmm_weights(gen, E2, D, F, dtype), bmap, bt)
            _gmm_compare(moe_gmm, "sweep", f"T{T} D{D} F{F} E{E2} bt{bt}", args, dname)
    return rows


def _gmm_weights(gen, E, D, F, dtype):
    import torch
    return (torch.randn(E, D, F, generator=gen, device="cuda") / D ** 0.5).to(dtype)


def _gmm_compare(moe_gmm, label, what, args, dname):
    import torch
    out = moe_gmm.grouped_matmul(*args)
    ref = moe_gmm.grouped_matmul_plain(*args)
    torch.cuda.synchronize()
    tol = TOL[dname]
    err = (out.float() - ref.float()).abs().max().item()
    ok = torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)
    print(f"[kernels] grouped_matmul {label} {what} {dname}: max_abs_err {err:.3e} "
          f"(tol {tol:g}) {'ok' if ok else 'FAIL'}")
    check(ok, f"grouped_matmul {label} {dname} disagrees with its plain version")
    return err


def _time_gmm(moe_gmm, args, kept, err):
    import torch
    x, w, bmap, bt = args
    T, D = x.shape
    E, _, F = w.shape
    # each distinct expert's weights, x and bmap read once, y written once;
    # 2*D*F operations for each row that holds an assignment
    experts = int(torch.unique(bmap).numel())
    nbytes = (experts * D * F + T * D + T * F) * x.element_size() + bmap.numel() * 4
    b_ms, b_by = bound_ms(nbytes, 2.0 * kept * D * F, "bfloat16")
    plain = lambda: moe_gmm.grouped_matmul_plain(*args)
    if hasattr(torch, "_grouped_mm"):
        # one group per expert: the run of blocks bmap gives it (bmap is sorted)
        offs = (torch.cumsum(torch.bincount(bmap.long(), minlength=E), 0) * bt).to(torch.int32)
        lib, lib_name = (lambda: torch._grouped_mm(x, w, offs=offs)), "torch._grouped_mm"
    else:
        lib = lambda: torch.bmm(x.view(-1, bt, D), w[bmap.long()]).view(T, F)
        lib_name = "torch.bmm over w[block_to_expert], the gather included"
    lib_err = (lib().float() - plain().float()).abs().max().item()
    return _timings(lambda: moe_gmm.grouped_matmul(*args), plain, lib,
                    f"T_pad{T} bt{bt} D{D} F{F} E{E}, {experts} experts", err, lib_err,
                    b_ms, b_by, library=lib_name,
                    plain_iters=20)        # the plain loop makes ~4 torch calls per block


def _time_flash(F, fa, q, k, v, causal, window, dname, err):
    import torch
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mask = None
    if window:
        i = torch.arange(S, device=q.device)
        mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
    lib = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None, enable_gqa=True)
    lib_err = (lib().transpose(1, 2).float()
               - fa.flash_attention_plain(q, k, v, causal=causal, window=window).float()
               ).abs().max().item()
    pairs = 0
    for t in range(S):   # (query, key) pairs the mask lets through
        lo = max(0, t - window + 1) if window else 0
        pairs += (t + 1 if causal else S) - lo
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    b_ms, b_by = bound_ms(nbytes, 4.0 * hd * pairs * B * H, dname)
    kern = lambda: fa.flash_attention(q, k, v, causal=causal, window=window)
    plain = lambda: fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    return _timings(kern, plain, lib, f"B{B} S{S} H{H} KV{KV} hd{hd}", err, lib_err,
                    b_ms, b_by)


def _timings(kern, plain, lib, shape, err, lib_err, b_ms, b_by,
             library="scaled_dot_product_attention", plain_iters=100):
    return {"shape": shape, "max_abs_err": err, "library": library,
            "ms": time_ms(kern), "device_ms": device_ms(kern),
            "plain_ms": time_ms(plain, iters=plain_iters),
            "plain_device_ms": device_ms(plain, iters=plain_iters // 2),
            "library_ms": time_ms(lib), "library_device_ms": device_ms(lib),
            "library_err": lib_err, "bound_ms": b_ms, "bound_by": b_by}


def _time_decode(F, dec, q, kc, vc, pos, ring, dname, err):
    import torch
    B, W, KV, hd = kc.shape
    H = q.shape[1]
    slot = torch.arange(W, device=q.device)
    valid = slot[None, :] <= pos[:, None].long()
    if ring:
        valid = valid | (pos[:, None].long() >= W)
    mask = valid[:, None, None, :]
    qt, kt, vt = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)
    lib_err = (lib()[:, :, 0].float()
               - dec.decode_attention_plain(q, kc, vc, pos, ring=ring).float()
               ).abs().max().item()
    keys = int(valid.sum().item())          # cache rows this run's positions need
    nbytes = (2 * q.numel() + 2 * keys * KV * hd) * q.element_size() + pos.numel() * 4
    b_ms, b_by = bound_ms(nbytes, 4.0 * hd * keys * H, dname)
    kern = lambda: dec.decode_attention(q, kc, vc, pos, ring=ring)
    plain = lambda: dec.decode_attention_plain(q, kc, vc, pos, ring=ring)
    return _timings(kern, plain, lib, f"B{B} W{W} H{H} KV{KV} hd{hd}", err, lib_err,
                    b_ms, b_by)


def phase_engine():
    import numpy as np
    import torch

    from repro_torch.core.config_store import ConfigStore, ImageRegistry
    from repro_torch.core.router import build_tree
    from repro_torch.core.simulator import summarize
    from repro_torch.core.types import FunctionConfig, Request
    from repro_torch.serving.engine import Engine

    store = ConfigStore()
    for fn, arch, c in (("tiny-gen", "tiny_lm", 4), ("small-gen", "small_lm", 2)):
        store.put(FunctionConfig(name=fn, arch=arch, concurrency=c,
                                 gen_tokens=4, idle_timeout_s=60.0))
    engine = Engine(build_tree(2, fanout=2), store, ImageRegistry(), max_len=64,
                    device="cuda")
    rng = np.random.default_rng(0)
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    reqs, results = [], []
    for _ in range(24):   # the mix of examples/emulate_workers.py
        fn = "tiny-gen" if rng.random() < 0.8 else "small-gen"
        req = Request(fn=fn, arrival_t=0.0, size=int(rng.integers(4, 24)))
        reqs.append(req)
        engine.submit(req)
        if rng.random() < 0.4:
            results.extend(engine.run())
    results.extend(engine.run())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: wrappers[name].launches for name in ("flash_attention",
                                                          "decode_attention")}

    check(len(results) == 24 and all(r.ok for r in results),
          f"{sum(r.ok for r in results)}/{len(results)} of 24 requests ok")
    check({r.rid for r in results} == {r.rid for r in reqs}, "request ids lost")
    tel = engine.telemetry()
    check(len(tel) == 24 and all(len(t.features()) == 7 and t.latency > 0 for t in tel),
          "telemetry rows missing, short or without latency")
    for name, n in launches.items():
        check(n > 0, f"the engine never launched {name}")
    insts = [i for w in engine.workers.values() for il in w.instances.values() for i in il]
    tokens = sum(len(toks) for i in insts for toks in i.generated.values())
    check(all(len(toks) == 5 for i in insts for toks in i.generated.values()),
          "a request did not generate its first token plus gen_tokens=4")
    s = summarize(results)
    colds = [round(i.cold_start_s, 3) for i in insts]
    n_fn = {fn: sum(r.fn == fn for r in reqs) for fn in ("tiny-gen", "small-gen")}
    print(f"[engine] {s['ok']}/{s['n']} ok ({n_fn}) in {wall:.3f} s: "
          f"p50 {s['p50'] * 1e3:.1f} ms p99 {s['p99'] * 1e3:.1f} ms "
          f"cold_rate {s['cold_rate']:.2f}")
    print(f"[engine] instance cold starts (s): {colds}")
    print(f"[engine] generated {tokens} tokens, {tokens / wall:.1f} tokens/s end to end")
    print(f"[engine] kernel launches: {launches} "
          f"(per request: {launches['flash_attention'] / 24:.2f} flash, "
          f"{launches['decode_attention'] / 24:.2f} decode)")
    _profile_engine(engine, Request, "tiny-gen", "tiny_lm", (4, 9, 14, 19, 23, 6, 11, 17),
                    ("flash_fwd_kernel", "decode_partial_kernel", "decode_combine_kernel"))
    return launches


def _wrappers():
    """Every kernel wrapper of the port, by name: each counts its launches."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import moe_gmm
    return {"flash_attention": fa.flash_attention, "decode_attention": dec.decode_attention,
            "mamba_scan": ms.mamba_scan, "grouped_matmul": moe_gmm.grouped_matmul}


def _serve_image(arch, fn, tag, n_req=8):
    """``n_req`` requests of one large image (c=2, ``max_len`` 64, 4 generated
    tokens) through the Engine, prompt sizes and run points drawn as in
    phase 4's mix. Every launch count is set to 0 just before and read just
    after, and the model's prefill and decode_step calls are counted.
    Returns (engine, instances, launches, calls)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.config_store import ConfigStore, ImageRegistry
    from repro_torch.core.router import build_tree
    from repro_torch.core.simulator import summarize
    from repro_torch.core.types import FunctionConfig, Request
    from repro_torch.models import LM
    from repro_torch.serving.engine import Engine

    store = ConfigStore()
    store.put(FunctionConfig(name=fn, arch=arch, concurrency=2, gen_tokens=4,
                             idle_timeout_s=60.0))
    engine = Engine(build_tree(2, fanout=2), store, ImageRegistry(), max_len=64,
                    device="cuda")
    rng = np.random.default_rng(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    calls = {"prefill": 0, "decode_step": 0}
    originals = {name: getattr(LM, name) for name in calls}

    def counted(name):
        def call(self, *a, **kw):
            calls[name] += 1
            return originals[name](self, *a, **kw)
        return call

    wrappers = _wrappers()
    for name in calls:
        setattr(LM, name, counted(name))
    try:
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        reqs, results = [], []
        for _ in range(n_req):
            req = Request(fn=fn, arrival_t=0.0, size=int(rng.integers(4, 24)))
            reqs.append(req)
            engine.submit(req)
            if rng.random() < 0.4:
                results.extend(engine.run())
        results.extend(engine.run())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: w.launches for name, w in wrappers.items()}
    finally:
        for name, f in originals.items():
            setattr(LM, name, f)
    peak = torch.cuda.max_memory_allocated()

    check(len(results) == n_req and all(r.ok for r in results),
          f"{sum(r.ok for r in results)}/{len(results)} of {n_req} {arch} requests ok")
    check({r.rid for r in results} == {r.rid for r in reqs}, f"{arch} request ids lost")
    tel = engine.telemetry()
    check(len(tel) == n_req and all(len(t.features()) == 7 and t.latency > 0 for t in tel),
          f"{arch} telemetry rows missing, short or without latency")
    insts = [i for w in engine.workers.values() for il in w.instances.values() for i in il]
    check(all(len(toks) == 5 for i in insts for toks in i.generated.values()),
          f"a {arch} request did not generate its first token plus gen_tokens=4")
    tokens = sum(len(toks) for i in insts for toks in i.generated.values())
    s = summarize(results)
    cfg = get_config(arch)
    print(f"[{tag}] {arch} {cfg.dtype}, {cfg.num_layers} layers, "
          f"{cfg.param_count() / 1e9:.2f} B parameters: {s['ok']}/{s['n']} ok in {wall:.3f} s: "
          f"p50 {s['p50'] * 1e3:.1f} ms p99 {s['p99'] * 1e3:.1f} ms cold_rate "
          f"{s['cold_rate']:.2f} (prompt sizes {[r.size for r in reqs]})")
    for i in insts:
        print(f"[{tag}] instance {i.iid} cold start {i.cold_start_s:.3f} s = "
              f"materialization {i.materialize_s:.3f} s + warm-up {i.warmup_s:.3f} s "
              f"+ rest {i.cold_start_s - i.materialize_s - i.warmup_s:.3f} s")
    print(f"[{tag}] generated {tokens} tokens, {tokens / wall:.1f} tokens/s end to end")
    print(f"[{tag}] device memory: max_memory_allocated {peak / 2**30:.2f} GiB "
          f"(allocated before the phase {mem0 / 2**30:.2f} GiB)")
    print(f"[{tag}] model calls {calls}; kernel launches {launches}")
    return engine, insts, launches, calls


def _time_model_calls(inst, tag):
    """One model call of each kind on the image's weights, after the counts
    were read: host wall per call (CUDA events) against device time."""
    import torch
    tok = torch.zeros(inst.slots, dtype=torch.int32, device="cuda")
    step = lambda: inst.model.decode_step(inst.kv.cache, {"token": tok,
                                                          "pos": inst.kv.positions()})
    prompt = torch.zeros((1, 32), dtype=torch.int32, device="cuda")
    prefill = lambda: inst.model.prefill({"tokens": prompt})
    for name, fn in ((f"decode step ({inst.slots} slots)", step), ("prefill S32", prefill)):
        wall_ms, dev_ms = time_ms(fn, iters=10, warmup=2), device_ms(fn, iters=5)
        print(f"[{tag}] {name}: {wall_ms:.2f} ms per call, device {_ms(dev_ms)} ms "
              f"(busy {dev_ms / wall_ms:.1%})" if dev_ms else
              f"[{tag}] {name}: {wall_ms:.2f} ms per call, device not measured")


def phase_engine_mamba():
    """falcon_mamba_7b at full width and depth in bfloat16 through the Engine."""
    from repro_torch.core.types import Request

    engine, insts, launches, _ = _serve_image("falcon_mamba_7b", "ssm-gen", "engine-ssm")
    check(launches["mamba_scan"] > 0, "the engine never launched mamba_scan")
    check(launches["flash_attention"] == launches["decode_attention"]
          == launches["grouped_matmul"] == 0,
          "an attention or MoE kernel ran in falcon_mamba_7b (attention-free, no MoE)")
    print(f"[engine-ssm] mamba_scan launches per request {launches['mamba_scan'] / 8:.2f}; "
          f"one per layer per prefill, warm-up prefill included")
    _time_model_calls(insts[0], "engine-ssm")
    _profile_engine(engine, Request, "ssm-gen", "falcon_mamba_7b", (4, 9, 14, 19),
                    ("mamba_scan_kernel",))
    return {"mamba_scan": launches["mamba_scan"]}


def phase_engine_moe():
    """moonshot_v1_16b at full width and depth in bfloat16 through the Engine."""
    from repro_torch.configs import get_config
    from repro_torch.core.types import Request

    engine, insts, launches, calls = _serve_image("moonshot_v1_16b", "moe-gen", "engine-moe")
    layers = get_config("moonshot_v1_16b").num_layers
    want = 3 * layers * (calls["prefill"] + calls["decode_step"])
    print(f"[engine-moe] grouped_matmul launches {launches['grouped_matmul']} = 3 x {layers} "
          f"layers x ({calls['prefill']} prefill + {calls['decode_step']} decode_step calls, "
          f"warm-up included) = {want}")
    check(launches["grouped_matmul"] == want,
          f"grouped_matmul launched {launches['grouped_matmul']} times, not {want}")
    check(launches["flash_attention"] > 0 and launches["decode_attention"] > 0,
          "the engine never launched an attention kernel on moonshot_v1_16b")
    check(launches["mamba_scan"] == 0, "mamba_scan ran in a model without Mamba layers")
    _time_model_calls(insts[0], "engine-moe")
    _profile_engine(engine, Request, "moe-gen", "moonshot_v1_16b", (4, 9, 14, 19),
                    ("gmm_kernel", "flash_fwd_kernel", "decode_partial_kernel",
                     "decode_combine_kernel"))
    return {"grouped_matmul": launches["grouped_matmul"]}


def release_images():
    """Empty the image cache, so that the card holds one large image at a time."""
    import torch

    from repro_torch.serving import engine
    engine._IMAGE_CACHE.clear()
    gc.collect()
    torch.cuda.empty_cache()


def _profile_engine(engine, Request, fn, arch, sizes, port_kernels):
    """Device busy share of a warm pass and where the device time goes, from
    the profiler's CUDA activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for size in sizes:
            engine.submit(Request(fn=fn, arrival_t=0.0, size=size))
        res = engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(len(res) == len(sizes) and all(r.ok for r in res), "profiled pass lost requests")
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
    busy = sum(by_name.values())
    print(f"[engine] warm pass, {len(sizes)} {arch} requests: wall {wall:.3f} s, device busy "
          f"{busy * 1e3:.2f} ms ({busy / wall:.1%}), idle {1 - busy / wall:.1%}")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"[engine]   {t * 1e3:8.3f} ms {t / busy:6.1%}  {name[:90]}")
    for kernel in port_kernels:
        t = sum(v for k, v in by_name.items() if kernel in k)
        print(f"[engine]   {t * 1e3:8.3f} ms {t / busy:6.1%}  {kernel} (port)")


def phase_parity():
    from repro_torch.configs import get_config

    _parity(replace(get_config("tiny_lm"), dtype="float32"), "tiny_lm")
    _parity(replace(get_config("falcon_mamba_7b"), dtype="float32", num_layers=2),
            "falcon_mamba_7b (2 layers, full width)")
    _parity(replace(get_config("moonshot_v1_16b"), dtype="float32", num_layers=2),
            "moonshot_v1_16b (2 layers, full width)")


def _parity(cfg, label, B=2, S0=16, W=32, steps=4):
    """The f32 model on the card (kernels) against the same weights on the CPU
    (plain versions): logits and greedy tokens at every step, then every
    cache tensor (k/v, or the conv window and the SSM state)."""
    import copy

    import numpy as np
    import torch

    from repro_torch.models import LM

    gpu = LM(cfg, device="cuda", seed=11)
    cpu = copy.deepcopy(gpu).to("cpu")  # the card's weights: the CPU would draw others
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S0)).astype(np.int32)
    caches, logits = {}, {}
    for name, lm in (("gpu", gpu), ("cpu", cpu)):
        lg, pc = lm.prefill({"tokens": torch.as_tensor(toks, device=lm.device)})
        cache = lm.init_cache(B, W)
        for cs, ps in zip(cache["slots"], pc["slots"]):
            for n in cs:
                cs[n][:, :, :ps[n].shape[2]] = ps[n]    # k/v: S0 of W rows; conv/ssm whole
        caches[name], logits[name] = cache, lg
    worst = 0.0
    for t in range(S0, S0 + steps + 1):
        g, c = logits["gpu"].float().cpu(), logits["cpu"]
        err = (g - c).abs().max().item()
        worst = max(worst, err)
        check(torch.allclose(g, c, rtol=LOGIT_TOL, atol=LOGIT_TOL),
              f"{label} f32 logits at position {t - 1}: max_abs_err {err:.3e}")
        tok_g, tok_c = g.argmax(-1), c.argmax(-1)
        check(torch.equal(tok_g, tok_c), f"greedy tokens differ: {tok_g} vs {tok_c}")
        if t == S0 + steps:
            break
        for name, lm in (("gpu", gpu), ("cpu", cpu)):
            batch = {"token": tok_c.to(torch.int32).to(lm.device),
                     "pos": torch.full((B,), t, dtype=torch.int32, device=lm.device)}
            logits[name], caches[name] = lm.decode_step(caches[name], batch)
    cache_err = {}
    for gs, cs in zip(caches["gpu"]["slots"], caches["cpu"]["slots"]):
        for n in cs:
            g = gs[n].float().cpu()
            e = (g - cs[n].float()).abs().max().item()
            cache_err[n] = max(cache_err.get(n, 0.0), e)
            check(torch.allclose(g, cs[n].float(), rtol=LOGIT_TOL, atol=LOGIT_TOL),
                  f"{label} f32 cache {n!r} after {steps} decode steps: max_abs_err {e:.3e}")
    errs = " ".join(f"{n} {e:.3e}" for n, e in cache_err.items())
    print(f"[parity] {label} f32 prefill + {steps} decode steps, card vs CPU: logits "
          f"max_abs_err {worst:.3e}, caches {errs} (tol {LOGIT_TOL:g}), greedy tokens equal")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; it runs on the card",
              file=sys.stderr)
        return 2
    import repro_torch.kernels.build  # noqa: F401  (fails outside a checkout)

    t0 = time.perf_counter()
    took = {}

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        took[name] = round(time.perf_counter() - t, 1)
        return out

    smi = timed("environment", phase_environment)
    timed("build", phase_build)
    rows = timed("kernels", phase_kernels)
    launches = timed("engine tiny/small", phase_engine)
    launches.update(timed("engine falcon_mamba_7b", phase_engine_mamba))
    release_images()
    launches.update(timed("engine moonshot_v1_16b", phase_engine_moe))
    release_images()
    timed("parity", phase_parity)

    kernels = []
    for name, label, dname, replaces, source in (
            ("flash_attention", FLASH_LINE, "bfloat16",
             "src/repro/kernels/flash_attention.py:103",
             "src/repro_torch/csrc/flash_attention.cu"),
            ("decode_attention", DECODE_LINE, "bfloat16",
             "src/repro/kernels/decode_attention.py:84",
             "src/repro_torch/csrc/decode_attention.cu"),
            ("mamba_scan", MAMBA_LINE, "float32", "src/repro/kernels/mamba_scan.py:68",
             "src/repro_torch/csrc/mamba_scan.cu"),
            ("grouped_matmul", GMM_LINE, "bfloat16", "src/repro/kernels/moe_gmm.py:71",
             "src/repro_torch/csrc/moe_gmm.cu")):
        r = rows[(name, label, dname)]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "device_ms": r["device_ms"], "plain_device_ms": r["plain_device_ms"],
                        "library_device_ms": r["library_device_ms"],
                        "library": r["library"],
                        "shape": f"{label}: {r['shape']}", "dtype": dname})
    print(f"[done] {time.perf_counter() - t0:.1f} s; by phase (s): {took}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
