#!/usr/bin/env python3
"""Quickest proof that the PyTorch port starts and serves on the GPU.

    python3 chip_smoke.py

Needs one CUDA card of compute capability 9.0 (an H100) and ``nvcc``; it
imports nothing of JAX. Phases, each of which fails the run:

1. environment: the card's name, power limit and max SM clock, torch, the
   capability;
2. build: the four kernels of the serving paths from ``src/repro_torch/csrc``,
   one ``nvcc`` each, all at once; registers and spills of every kernel;
3. kernels against their plain PyTorch versions on the card, at the serving
   shapes, at the JAX package's sweep shapes and at the head dims of its
   other configs (80, 96, 256): attention (B1, B2, each B2 line naming its
   route: one launch or split) and the
   grouped matmul (B4, on layouts routed as moonshot_v1_16b routes) in
   float32 (TF32 off, the FMA route) within 2e-4 and bfloat16 (the
   tensor-core route) within 2e-2, each line naming its route, the selective
   scan (B3) within 2e-3 and 5e-2, its output and its final state; times of
   kernel, plain version, bound and one library call where there is one
   (``scaled_dot_product_attention`` for attention, ``torch._grouped_mm``
   for B4, timed here only; no PyTorch call computes a selective scan;
   B3's bound is the largest of bytes, float32 operations and its
   exponentials on the SFUs);
4. engine: the port's ``Engine`` serves 24 requests of ``tiny_lm`` (c=4) and
   ``small_lm`` (c=2) at full width in bfloat16, and must have launched B1
   and B2;
4b. emulation (paper Fig. 2, through ``repro_torch.launch.emulate``): the
   same mix on one port ``Worker``, which must launch B1 and B2; the ridge
   and MLP worker models fitted to its telemetry on the card and on the CPU
   (ridge predicted log-latencies within 1e-4, MLP parameters after 20 steps
   within 1e-5, both ``resid_std`` printed, fits timed); 1024 emulated
   workers at 5000 requests/s for 4 s from the card-fitted ridge (every
   request answered, fail rate below 0.05; p50, p99, events and events/s
   printed); 64 emulated workers at 500 requests/s for 1 s from the MLP,
   one forward a request on the card and on the CPU (microseconds a call);
4c. platform (host code, driven by 4b's card-fitted models): the JAX
   package's pinned digests with the synthetic model (the flash-crowd
   autoscaled run, the faults-off runs; a disabled or unlimited gateway
   leaves the digest); from the card-fitted ridge, the autoscale study's
   matrix (3 shapes x 5 policies), a zone outage at 1024 workers behind a
   gateway under ``slo_aware``, ``ml_pipeline`` and the Azure sample's
   replay: every request ends once, answered, failed or shed, and two runs
   give equal stream and decision-log digests; ``run_partitioned`` over 4
   partitions inline and in forked processes gives one digest, and process
   mode refuses the MLP that lives on the card (``partition k failed``);
5. engine: the port's ``Engine`` serves 8 requests of ``falcon_mamba_7b``
   (c=2) at full width and depth (64 layers, bfloat16), and must have
   launched B3; cold start split into materialization and warm-up, peak
   device memory;
6. engine: the port's ``Engine`` serves 8 requests of ``moonshot_v1_16b``
   (c=2) at full width and depth (48 layers, 64 experts, top-6, bfloat16),
   and must have launched B4 three times per layer per model call, B1 and
   B2, and not B3; the same cold start, memory and timing report;
7. model parity: an f32 ``tiny_lm``, a reduced f32 ``tiny_lm`` at head dims
   96 and 256, and f32 ``falcon_mamba_7b`` and ``moonshot_v1_16b`` cut to 2
   layers at full width, on the card (kernels)
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
SMS = 132                                     # H100 SXM streaming multiprocessors
SFU_PER_CLOCK = 16                            # ex2 a clock per SM (compute capability 9.0)
TOL = {"float32": 2e-4, "bfloat16": 2e-2}     # tests/test_kernels.py:17-19
SCAN_TOL = {"float32": 2e-3, "bfloat16": 5e-2}   # tests/test_kernels.py:78-79
LOGIT_TOL = 2e-3                              # tests/test_decode_parity.py
EMU_RIDGE_TOL = 1e-4     # ridge predicted log-latency, card vs CPU (tests/test_torch_emulation.py)
EMU_MLP_TOL = 1e-5       # MLP parameters after 20 steps, card vs CPU (the same)

# phase 4c: digests the JAX package's tests pin, copied here (this script imports
# nothing of that package), and the autoscale study's traffic shapes
FLASH_GOLDEN = ("9019f07d1f8667aa", "c7a8b3d40c5fc522")   # tests/test_placement.py:243-245
FAULTS_OFF_GOLDEN = {                                      # tests/test_faults.py:234-239
    "steady": ("90ac57f36c579d36", dict(rps=300.0, duration_s=8.0, seed=3)),
    "multi_tenant": ("ec5034f85267151c", dict(rps=400.0, duration_s=8.0, seed=3)),
}
FLASH = dict(duration_s=30.0, seed=3, base_rps=12.0, burst_rps=1000.0,
             mean_burst_s=2.0, mean_calm_s=10.0)           # tests/test_placement.py:206-207
STUDY_SHAPES = {"flash_crowd": FLASH,                      # examples/autoscale_study.py:22-28
                "daily_cycle": dict(duration_s=60.0, seed=3, mean_rps=150.0, period_s=60.0),
                "steady": dict(duration_s=30.0, seed=3, rps=120.0)}
AZURE_SAMPLE = ROOT / "tests" / "data" / "azure_sample.csv"

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
    # moonshot's S64 and S256 buckets (hd 128): the bf16 route timed where a
    # head's q rows fill four 16-row tiles and more
    ("moonshot S64", 1, 64, 16, 16, 128, True, 0),
    ("moonshot S256", 1, 256, 16, 16, 128, True, 0),
    ("sweep", 2, 256, 4, 2, 64, True, 0),
    ("sweep bidir", 1, 256, 4, 4, 128, False, 0),
    ("sweep window", 2, 512, 8, 2, 64, True, 100),
    ("sweep", 1, 128, 2, 1, 32, True, 0),
]
# the head dims of the JAX package's other configs (hd 256, 96, 80), at the
# engine's S32 and S256 buckets: gemma3_12b (16 heads, 8 kv, its local
# layers' window of 1024 at S past it), phi3_vision, hubert_xlarge (an
# encoder: bidirectional). Like every case added after the lists above, each
# draws its inputs from a generator of its own (_own_gen)
FLASH_HD_CASES = [
    ("gemma3 S32", 1, 32, 16, 8, 256, True, 0),
    ("gemma3 S256", 1, 256, 16, 8, 256, True, 0),
    ("gemma3 local S1280", 1, 1280, 16, 8, 256, True, 1024),
    ("phi3 S32", 1, 32, 32, 32, 96, True, 0),
    ("phi3 S256", 1, 256, 32, 32, 96, True, 0),
    ("hubert S256", 1, 256, 16, 16, 80, False, 0),
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
# gemma3_12b (hd 256; its local layers' ring of 1024 takes the split route),
# phi3_vision (hd 96), and hubert_xlarge's heads (hd 80)
DECODE_HD_CASES = [
    ("gemma3 c2 W64", 2, 64, 16, 8, 256, False),
    ("gemma3 local c2 W1024 ring", 2, 1024, 16, 8, 256, True),
    ("phi3 c2 W64", 2, 64, 32, 32, 96, False),
    ("hubert-shaped c2 W64", 2, 64, 16, 16, 80, False),
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
    # the S64 prefill bucket: 384 assignments, the most that still take 8-row blocks
    ("moonshot S64 wg/wi", 1, 64, 2048, 1408),
    ("moonshot S64 wo", 1, 64, 1408, 2048),
]
# (T_pad, D, F, E, block_t): the JAX sweep (tests/test_kernels.py:86-89), then
# the block_t the routed cases do not reach, so that every instantiation of
# both routes is held against the plain version
GMM_SWEEP = [(512, 128, 256, 4, 64), (256, 64, 128, 8, 32),
             (256, 128, 128, 4, 128), (96, 64, 192, 3, 16)]
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


def nvidia_smi(query="name,power.limit") -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


MAX_SM_HZ = None     # the card's max SM clock, read in phase 1 (B3's SFU bound)


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


def device_ms(fn, iters=50, wrapper=None):
    """Mean device time per call of the kernels ``fn`` launches, from the
    profiler's CUDA activity; None where the profiler saw no device time.
    The profiler drops kernel events now and then, more of them after
    windows of many events, so each kernel counts with its events' mean time
    times its launches a call, not with its events' sum over ``iters``. For
    a port kernel's ``wrapper`` those are its launch count's rise over the
    window per call (each CUDA kernel a wrapper launches runs once a wrapper
    launch), exact, and a kernel the profiler saw fewer times is reported;
    for the plain versions and library calls they are a kernel's events over
    ``iters``, rounded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    n0 = wrapper.launches if wrapper is not None else 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.setdefault(e.name, []).append(e.time_range.elapsed_us())
    if not spans:
        return None
    total = 0.0
    for name, d in spans.items():
        if wrapper is None:
            per_call = max(1, round(len(d) / iters))
        else:
            per_call = (wrapper.launches - n0) / iters
            if len(d) < per_call * iters:
                print(f"[kernels] the profiler saw {len(d)} of the {per_call * iters:g} "
                      f"launches of {name}; its time is their mean")
        total += sum(d) / len(d) * per_call
    return total / 1e3


def _ms(x):
    return "not measured" if x is None else f"{x:.4f}"


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOP_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_environment():
    import torch
    global MAX_SM_HZ
    smi = nvidia_smi()
    print(f"[env] nvidia-smi: {smi}")
    clock = nvidia_smi("clocks.max.sm")
    MAX_SM_HZ = float(clock.split()[0]) * 1e6
    print(f"[env] max SM clock {clock}")
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
        print(f"[build] {name}: {build.library_path(name).name} "
              f"({took.get(name, 0.0):.1f} s)")
        for fn, regs, spill in _ptxas_report(build.build_log(name)):
            print(f"[build]   {fn}: {regs}; {spill}")
    print(f"[build] total {time.perf_counter() - t0:.1f} s")


def _ptxas_report(log):
    """(kernel, registers, spills) from nvcc's -Xptxas -v output, kernel names
    demangled where c++filt is there."""
    import re
    import shutil
    rows, fn, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn, spill = m.group(1), ""
        elif "spill" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln and fn:
            rows.append([fn, ln.split(":", 1)[-1].strip(), spill])
            fn = None
    if rows and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True, timeout=60)
        names = out.stdout.splitlines()
        if len(names) == len(rows):
            for r, n in zip(rows, names):
                r[0] = re.sub(r"\(anonymous namespace\)::", "", n).split("(")[0]
    return rows


def _inputs(gen, shape, dtype, device="cuda"):
    import torch
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def _own_gen(*case):
    """A generator seeded from the case itself, for the cases that came after
    phase 3's first lists: those draw from one generator in turn, and a case
    added among them would change the inputs of every case after it."""
    import zlib

    import torch
    seed = zlib.crc32(" ".join(map(str, case)).encode())
    return torch.Generator(device="cuda").manual_seed(seed)


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
        for case in FLASH_CASES + FLASH_HD_CASES:
            label, B, S, H, KV, hd, causal, window = case
            g = gen if case in FLASH_CASES else _own_gen("flash_attention", label, dname)
            q = _inputs(g, (B, S, H, hd), dtype)
            k = _inputs(g, (B, S, KV, hd), dtype)
            v = _inputs(g, (B, S, KV, hd), dtype)
            out = fa.flash_attention(q, k, v, causal=causal, window=window)
            ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ok = torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)
            print(f"[kernels] flash_attention {label} B{B} S{S} H{H} KV{KV} hd{hd} "
                  f"causal={causal} window={window} {dname} [{fa.ROUTES[dtype]}]: "
                  f"max_abs_err {err:.3e} (tol {tol:g}) {'ok' if ok else 'FAIL'}")
            check(ok, f"flash_attention {label} {dname} disagrees with its plain version")
            if not label.startswith("sweep"):
                rows[("flash_attention", label, dname)] = _time_flash(
                    F, fa, q, k, v, causal, window, dname, err)
        for case in DECODE_CASES + DECODE_HD_CASES:
            label, B, W, H, KV, hd, ring = case
            g = gen if case in DECODE_CASES else _own_gen("decode_attention", label, dname)
            q = _inputs(g, (B, H, hd), dtype)
            kc = _inputs(g, (B, W, KV, hd), dtype)
            vc = _inputs(g, (B, W, KV, hd), dtype)
            rng = np.random.default_rng(B * W + H)
            if label.startswith("sweep"):
                pos = rng.integers(5, W * 2 if ring else W, B)
            elif ring:   # a local layer's ring, wrapped
                pos = rng.integers(W, 2 * W, B)
            else:   # the engine's decode positions: prompt bucket + a few tokens
                pos = rng.integers(16, 40, B)
            pos = torch.as_tensor(pos, dtype=torch.int32, device="cuda")
            out = dec.decode_attention(q, kc, vc, pos, ring=ring)
            ref = dec.decode_attention_plain(q, kc, vc, pos, ring=ring)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ok = torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)
            route = dec.decode_route(B, KV, W, hd, q.element_size())
            print(f"[kernels] decode_attention {label} B{B} W{W} H{H} KV{KV} hd{hd} "
                  f"ring={ring} {dname} [{route[0]}, {route[1]} keys a block]: "
                  f"max_abs_err {err:.3e} (tol {tol:g}) {'ok' if ok else 'FAIL'}")
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
        print(f"[kernels] time {name} {label} {dname} ({r['shape']}): kernel_ms {r['ms']:.4f} "
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
    # exp and 6 float32 operations, per (t, channel) 3 (dt*x and D*x + y); the
    # exps on the SFUs, 16 a clock per SM at the card's max SM clock
    nbytes = ((dt.numel() + 2 * x.numel() + Bc.numel() + Cc.numel()) * x.element_size()
              + (A.numel() + D.numel() + (1 + (h0 is not None)) * Bt * DI * N) * 4)
    b_ms, b_by = bound_ms(nbytes, Bt * S * DI * (7.0 * N + 3), dname)
    sfu_ms = Bt * S * DI * N / (SFU_PER_CLOCK * SMS * MAX_SM_HZ) * 1e3
    if sfu_ms > b_ms:
        b_ms, b_by = sfu_ms, "operations"
    kern = lambda: ms.mamba_scan(*args)
    plain = lambda: ms.mamba_scan_plain(*args)
    plain_iters = max(5, 1600 // S)      # the plain loop makes ~5 torch calls per step
    binds = "SFU exps" if b_ms == sfu_ms else b_by
    return {"shape": f"Bt{Bt} S{S} DI{DI} N{N}, bound by {binds}", "max_abs_err": err,
            "ms": time_ms(kern), "device_ms": device_ms(kern, wrapper=ms.mamba_scan),
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
    print(f"[kernels] grouped_matmul {label} {what} {dname} [{moe_gmm.ROUTES[args[0].dtype]}]: "
          f"max_abs_err {err:.3e} (tol {tol:g}) {'ok' if ok else 'FAIL'}")
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
    return _timings(lambda: moe_gmm.grouped_matmul(*args), moe_gmm.grouped_matmul, plain, lib,
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
    return _timings(kern, fa.flash_attention, plain, lib, f"B{B} S{S} H{H} KV{KV} hd{hd}", err,
                    lib_err, b_ms, b_by)


def _timings(kern, wrapper, plain, lib, shape, err, lib_err, b_ms, b_by,
             library="scaled_dot_product_attention", plain_iters=100):
    return {"shape": shape, "max_abs_err": err, "library": library,
            "ms": time_ms(kern), "device_ms": device_ms(kern, wrapper=wrapper),
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
    route = dec.decode_route(B, KV, W, hd, q.element_size())[0]
    return _timings(kern, dec.decode_attention, plain, lib,
                    f"B{B} W{W} H{H} KV{KV} hd{hd}, {route}", err, lib_err, b_ms, b_by)


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
                    ("flash_fwd_tc_kernel", "decode_kernel", "decode_combine_kernel"))
    return launches


def _wrappers():
    """Every kernel wrapper of the port, by name: each counts its launches."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import moe_gmm
    return {"flash_attention": fa.flash_attention, "decode_attention": dec.decode_attention,
            "mamba_scan": ms.mamba_scan, "grouped_matmul": moe_gmm.grouped_matmul}


def phase_emulation():
    """Paper Fig. 2 on the card, through ``repro_torch.launch.emulate``: the
    example's 24 requests on one port ``Worker`` (B1 and B2 counted), the
    ridge and MLP fits on the card against the CPU on that telemetry, 1024
    emulated workers from the card-fitted ridge, and 64 from the card-fitted
    MLP (one forward on the card per request)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.emulation import (EmulatedServiceModel, MLPWorkerModel,
                                            RidgeWorkerModel, telemetry_matrix)
    from repro_torch.core.router import build_tree
    from repro_torch.core.simulator import Simulator, poisson_load, summarize
    from repro_torch.launch import emulate

    store = emulate.demo_store()
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    recs = emulate.profile_worker(store, "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    check(len(recs) == 24, f"{len(recs)} of 24 telemetry rows with a latency")
    for name in ("flash_attention", "decode_attention"):
        check(launches[name] > 0, f"the emulation's real worker never launched {name}")
    print(f"[emulation] step 1: 24 requests on one Worker in {wall:.3f} s, "
          f"kernel launches {launches}")
    X, y, ok = telemetry_matrix(recs)

    def fit_ms(fit):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fit()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    ridge, ridge_cold_ms = fit_ms(lambda: RidgeWorkerModel.fit(X, y, ok, device="cuda"))
    ridge, ridge_ms = fit_ms(lambda: RidgeWorkerModel.fit(X, y, ok, device="cuda"))
    ridge_cpu = RidgeWorkerModel.fit(X, y, ok, device="cpu")
    xs = np.concatenate([(X - ridge.mu) / ridge.sd, np.ones((len(X), 1), np.float32)], 1)
    err = float(np.abs(xs @ ridge.w - xs @ ridge_cpu.w).max())
    check(err <= EMU_RIDGE_TOL, f"ridge log-latency card vs CPU: max_abs_err {err:.3e}")
    print(f"[emulation] step 2 ridge ({X.shape[0]} rows x {X.shape[1]} features): "
          f"resid_std card {ridge.resid_std:.6f} CPU {ridge_cpu.resid_std:.6f}; "
          f"predicted log-latency max_abs_err {err:.3e} (tol {EMU_RIDGE_TOL:g}); "
          f"fit {ridge_ms:.2f} ms on the card ({ridge_cold_ms:.2f} ms the first time)")

    init = {n: p.numpy() for n, p in
            MLPWorkerModel.init_params(X.shape[1], 32, 0, "cpu").items()}
    short = {d: MLPWorkerModel.fit(X, y, ok, steps=20, device=d, init=init)
             for d in ("cuda", "cpu")}
    err = max(float(np.abs(short["cuda"].params[n] - short["cpu"].params[n]).max())
              for n in init)
    check(err <= EMU_MLP_TOL, f"MLP parameters after 20 steps, card vs CPU: {err:.3e}")
    mlp, mlp_ms = fit_ms(lambda: MLPWorkerModel.fit(X, y, ok, steps=300, device="cuda",
                                                    init=init))
    mlp_cpu, mlp_cpu_ms = fit_ms(lambda: MLPWorkerModel.fit(X, y, ok, steps=300,
                                                            device="cpu", init=init))
    print(f"[emulation] step 2 MLP: parameters after 20 steps card vs CPU max_abs_err "
          f"{err:.3e} (tol {EMU_MLP_TOL:g}); 300 steps: resid_std card "
          f"{mlp.resid_std:.6f} CPU {mlp_cpu.resid_std:.6f}; fit {mlp_ms:.1f} ms on the "
          f"card ({mlp_ms / 300:.3f} ms a step), {mlp_cpu_ms:.1f} ms on the CPU")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, prof_ms = fit_ms(lambda: MLPWorkerModel.fit(X, y, ok, steps=300, device="cuda",
                                                       init=init))
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    print(f"[emulation] step 2 MLP under the profiler: {prof_ms:.1f} ms of wall, device busy "
          f"{busy:.2f} ms ({busy / prof_ms:.1%}), {len(dev) / 300:.1f} device events a step")
    for name, model in (("ridge", ridge), ("mlp", mlp)):
        errs = emulate.row_errors(model, X, y)
        print(f"[emulation] step 4 [{name}]: per-row median rel err {np.median(errs):.2%} "
              f"(p90 {np.percentile(errs, 90):.2%})")

    t = time.perf_counter()
    sim, n, s = emulate.emulate(store, ridge)
    wall = time.perf_counter() - t
    check(s["n"] == n and s["fail_rate"] < 0.05,
          f"1024 emulated workers: {s['n']} results of {n} requests, "
          f"fail_rate {s['fail_rate']:.3f}")
    print(f"[emulation] step 3: {n} requests over 1024 emulated workers (ridge fitted on "
          f"the card) in {wall:.3f} s of host time: p50 {s['p50'] * 1e3:.2f} ms p99 "
          f"{s['p99'] * 1e3:.2f} ms fail {s['fail_rate']:.4f}, {sim.events_processed} events, "
          f"{sim.events_processed / wall:.0f} events/s")

    for label, model in (("card", mlp), ("CPU", mlp_cpu)):
        timed = _TimedPredict(model)
        small = Simulator(build_tree(64, fanout=16), store, EmulatedServiceModel(timed, seed=2),
                          seed=4)
        n = poisson_load(small, fn="tiny-gen", rps=500, duration_s=1, seed=6)
        s = summarize(small.run())
        check(s["n"] == n, f"64 MLP-emulated workers ({label}): {s['n']} of {n} results")
        print(f"[emulation] step 3: {n} requests over 64 emulated workers from the MLP on "
              f"the {label}: {timed.calls} predict calls, "
              f"{timed.seconds / timed.calls * 1e6:.1f} us a call; p50 {s['p50'] * 1e3:.2f} ms")
    return ridge, mlp, X


class _TimedPredict:
    """A worker model whose ``predict`` calls are counted and timed (host wall)."""

    def __init__(self, model):
        self.model, self.calls, self.seconds = model, 0, 0.0

    def predict(self, feats, rng):
        t = time.perf_counter()
        out = self.model.predict(feats, rng)
        self.seconds += time.perf_counter() - t
        self.calls += 1
        return out


class _FeatureRange:
    """A worker model that keeps the largest value of each feature it was
    asked about (the range the emulated workers drove it over)."""

    def __init__(self, model):
        self.model, self.top = model, None

    def predict(self, feats, rng):
        import numpy as np
        self.top = feats if self.top is None else np.maximum(self.top, feats)
        return self.model.predict(feats, rng)


def _digest(text: str) -> str:
    import hashlib
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def _outcomes(sim, n):
    """Every request ends once: answered, failed (with its reason; a function
    error that the worker model drew has the empty reason) or shed by the
    gateway with its terminal reason. Returns the counts of the three."""
    from repro_torch.core.gateway import ADMISSION_REJECTED, RATE_LIMITED
    rids = [r.rid for r in sim.results]
    check(len(rids) == n == len(set(rids)),
          f"{len(rids)} results ({len(set(rids))} distinct) for {n} requests")
    out = {"ok": 0, "failed": 0, "shed": 0}
    for r in sim.results:
        out["ok" if r.ok else "shed" if r.error in (RATE_LIMITED, ADMISSION_REJECTED)
            else "failed"] += 1
    return out


def _study_cell(shape, policy, service, *, leaf_policy="least_loaded"):
    """One cell of ``examples/autoscale_study.py``: the static policy keeps
    the replicate recipe's 3 branches of 2 workers, the scalers start at 1."""
    from repro_torch.autoscale import Autoscaler, build_pool, get_autoscaler
    from repro_torch.core.config_store import ConfigStore
    from repro_torch.core.simulator import Simulator
    from repro_torch.workloads import build_scenario, install_demo_configs
    wl = build_scenario(shape, **STUDY_SHAPES[shape])
    store = ConfigStore()
    install_demo_configs(store, wl)
    sim = Simulator(build_pool(3 if policy == "static" else 1, 2, leaf_policy=leaf_policy),
                    store, service, seed=7, worker_capacity_slots=1)
    pol = (get_autoscaler("slo_aware", slo_p95_s=wl.slo_targets())
           if policy == "slo_aware" else policy)
    scaler = Autoscaler(pol, interval_s=0.25, window_s=2.0, min_replicas=1, max_replicas=8,
                        workers_per_replica=2, cooldown_s=2.0, leaf_policy=leaf_policy)
    sim.attach_autoscaler(scaler)
    n = sim.load(wl)
    sim.run()
    return sim, scaler, n


def _chaos_case(service):
    """Phase 4b's scale under faults, a gateway and ``slo_aware``: 1024
    workers in 64 branches of 16 across 4 zones, ``zone_outage`` at 5000
    requests/s for 4 s (zone z0 dark from 1.0 s to 2.5 s, one completion in a
    thousand lost), a retry budget of 2, the batch tenant ``embed`` held to
    600 requests/s by its quota and the platform to 2048 outstanding."""
    from repro_torch.autoscale import Autoscaler, build_pool, get_autoscaler
    from repro_torch.core.config_store import ConfigStore
    from repro_torch.core.gateway import GatewayConfig, TenantQuota
    from repro_torch.core.simulator import Simulator
    from repro_torch.workloads import build_scenario, install_demo_configs
    wl = build_scenario("zone_outage", rps=5000.0, duration_s=4.0, seed=3, outage_at=1.0,
                        outage_duration_s=1.5, lost_finish_p=1e-3)
    wl.gateway = GatewayConfig(
        quotas={"embed": TenantQuota(rate=600.0, burst=50.0, priority="batch")},
        max_inflight=2048, batch_share=0.25)
    store = ConfigStore()
    install_demo_configs(store, wl)
    sim = Simulator(build_pool(64, 16), store, service, seed=7, zones=4,
                    placer="spread_zones", retry_budget=2)
    scaler = Autoscaler(get_autoscaler("slo_aware", slo_p95_s=wl.slo_targets()),
                        interval_s=0.25, window_s=1.0, min_replicas=32, max_replicas=96,
                        workers_per_replica=16, cooldown_s=1.0)
    sim.attach_autoscaler(scaler)
    n = sim.load(wl)
    t = time.perf_counter()
    sim.run()
    return sim, scaler, n, time.perf_counter() - t


def _tenant_build(service_of, *, tenants=16, rps=300.0, duration_s=4.0, workers=1024):
    """``run_partitioned``'s builder: ``tenants`` Poisson tenant streams
    bucketed by ``partition_streams`` (the ``tenant_hash`` assignment), each
    partition a tree of ``workers / n`` emulated workers (fanout 16) served
    by ``service_of(k)``."""
    from repro_torch.core.config_store import ConfigStore
    from repro_torch.core.router import build_tree
    from repro_torch.core.simulator import Simulator
    from repro_torch.core.types import FunctionConfig
    from repro_torch.parallel import partition_streams
    from repro_torch.workloads import FunctionProfile, MixedWorkload, PoissonArrivals, SizeDist

    def build(k, n):
        streams = [MixedWorkload(PoissonArrivals(rps),
                                 [FunctionProfile(f"t{j}", size=SizeDist.lognormal(24, 0.5))],
                                 duration_s=duration_s, seed=100 + j, rid_base=j * 1_000_000)
                   for j in range(tenants)]
        mine = partition_streams(streams, n)[k]
        store = ConfigStore()
        for s in mine:
            store.put(FunctionConfig(name=s.profiles[0].fn, arch="tiny_lm", concurrency=4,
                                     gen_tokens=4, cold_start_s=0.2))
        sim = Simulator(build_tree(workers // n, fanout=16), store, service_of(k), seed=7 + k)
        for s in mine:
            sim.load(s)
        return sim
    return build


def phase_platform(ridge, mlp, X):
    """The platform layers of the port (gateway, faults, workflows, scenarios,
    the Azure trace, the autoscaler, the partitioned runner), host code driven
    by phase 4b's card-fitted worker models: the JAX package's goldens with
    the synthetic model; the autoscale study's matrix, a chaos case at phase
    4b's scale, ``ml_pipeline`` and the Azure ``trace_replay`` from the
    card-fitted ridge, each run twice for its digests; ``run_partitioned``
    inline against process mode from the ridge, and process mode refusing
    the MLP that lives on the card. ``X`` is the telemetry the models were
    fitted on."""
    from repro_torch.autoscale import list_autoscalers
    from repro_torch.core.config_store import ConfigStore
    from repro_torch.core.emulation import EmulatedServiceModel
    from repro_torch.core.faults import FaultConfig
    from repro_torch.core.gateway import GatewayConfig
    from repro_torch.core.router import build_tree
    from repro_torch.core.simulator import (Simulator, SyntheticServiceModel, stream_digest,
                                            summarize)
    from repro_torch.core.types import TelemetryRecord
    from repro_torch.parallel import run_partitioned
    from repro_torch.workloads import build_scenario, install_demo_configs, summarize_workflows

    smi = nvidia_smi()
    t = time.perf_counter()
    sim, scaler, _ = _study_cell("flash_crowd", "slo_aware", SyntheticServiceModel(seed=2),
                                 leaf_policy="warm_least_loaded")
    got = (stream_digest(sim), _digest(scaler.decision_log()))
    check(got == FLASH_GOLDEN, f"flash_crowd autoscaled golden: {got} != {FLASH_GOLDEN}")
    for name, (want, kw) in FAULTS_OFF_GOLDEN.items():
        wl = build_scenario(name, **kw)
        store = ConfigStore()
        install_demo_configs(store, wl)
        sim = Simulator(build_tree(8, fanout=4), store, SyntheticServiceModel(seed=2), seed=7,
                        zones=2, faults=FaultConfig())
        sim.load(wl)
        sim.run()
        check((stream_digest(sim), sim.fault_log()) == (want, ""),
              f"faults wired but off, {name}: {stream_digest(sim)} != {want}")
    gw = {}
    for label, cfg in (("none", None), ("disabled", GatewayConfig(enabled=False)),
                       ("unlimited", GatewayConfig())):
        wl = build_scenario("steady", rps=200.0, duration_s=4.0, seed=3)
        store = ConfigStore()
        install_demo_configs(store, wl)
        sim = Simulator(build_tree(2, fanout=2), store, SyntheticServiceModel(seed=2), seed=7,
                        gateway=cfg)
        sim.load(wl)
        sim.run()
        gw[label] = stream_digest(sim)
    check(len(set(gw.values())) == 1, f"a disabled or unlimited gateway moved the digest: {gw}")
    print(f"[platform] goldens of the JAX package's tests: flash_crowd autoscaled {got}, "
          f"faults wired but off {sorted(FAULTS_OFF_GOLDEN)}, gateway off = disabled = "
          f"unlimited {gw['none']}: equal, in {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    digests, seen = [], _FeatureRange(ridge)
    for rep in range(2):
        row = {}
        for shape in STUDY_SHAPES:
            for policy in list_autoscalers():
                sim, scaler, n = _study_cell(shape, policy, EmulatedServiceModel(seen, seed=2))
                out = _outcomes(sim, n)
                row[shape, policy] = (stream_digest(sim), _digest(scaler.decision_log()))
                if rep == 0:
                    s, sm = summarize(sim.results), scaler.summary()
                    print(f"[platform] study {shape:>11s} {policy:>18s} (ridge): n {n} "
                          f"p50 {s['p50'] * 1e3:.2f} p95 {s['p95'] * 1e3:.2f} p99 "
                          f"{s['p99'] * 1e3:.2f} ms fail {out['failed'] / n:.4f} cold "
                          f"{s['cold_rate']:.3f} worker_s {sm['worker_seconds']:.0f} ups "
                          f"{sm['scale_ups']} downs {sm['scale_downs']} events "
                          f"{sim.events_processed}")
        digests.append(row)
    check(digests[0] == digests[1], "the autoscale study's matrix differs between two runs")
    print(f"[platform] study matrix ({len(digests[0])} cells) run twice: stream and "
          f"decision-log digests equal, {time.perf_counter() - t:.2f} s for both runs; {smi}")
    names = ("queue_len", "gen_tokens")
    cols = [list(TelemetryRecord.FEATURE_NAMES).index(n) for n in names]
    print("[platform] the ridge's range: " + "; ".join(
        f"{n} fitted on {X[:, c].min():g}-{X[:, c].max():g} (log-latency slope "
        f"{ridge.w[c] / ridge.sd[c]:.4f} a unit), asked about up to {seen.top[c]:g} in the study"
        for n, c in zip(names, cols)))

    runs = []
    for _ in range(2):
        sim, scaler, n, wall = _chaos_case(EmulatedServiceModel(ridge, seed=2))
        runs.append((stream_digest(sim), _digest(scaler.decision_log())))
    check(runs[0] == runs[1], f"the chaos case differs between two runs: {runs}")
    out, s, sm = _outcomes(sim, n), summarize(sim.results), scaler.summary()
    check(out["ok"] > 0 and sim.faults.stats.zone_outages == 1,
          f"chaos case: {out}, faults {sim.faults.summary()}")
    print(f"[platform] chaos case (ridge; 1024 workers, zone_outage, gateway, slo_aware): "
          f"n {n} p50 {s['p50'] * 1e3:.2f} p95 {s['p95'] * 1e3:.2f} p99 {s['p99'] * 1e3:.2f} ms; "
          f"fail {out['failed'] / n:.4f} shed {out['shed'] / n:.4f}; faults "
          f"{sim.faults.summary()}; retries {sim.retries_scheduled}; scaling ups "
          f"{sm['scale_ups']} downs {sm['scale_downs']} of {sm['ticks']} ticks; "
          f"{sim.events_processed} events in {wall:.3f} s of host time, "
          f"{sim.events_processed / wall:.0f} events/s; two runs' digests equal {runs[0]}; {smi}")

    t = time.perf_counter()
    wl = build_scenario("ml_pipeline", duration_s=20.0, seed=3)
    store = ConfigStore()
    install_demo_configs(store, wl)
    sim = Simulator(build_tree(16, fanout=4, leaf_policy="workflow_aware",
                               inner_policy="workflow_aware"),
                    store, EmulatedServiceModel(ridge, seed=2), seed=7)
    n = sim.load(wl)
    sim.run()
    w = summarize_workflows(sim.workflow_results)
    check(w["n"] == n > 0 and w.get("ok", 0) > 0, f"ml_pipeline: {w} of {n} instances")
    wl = build_scenario("trace_replay", path=str(AZURE_SAMPLE), fmt="azure", aggregate=True,
                        time_scale=0.01, seed=5)
    store = ConfigStore()
    install_demo_configs(store, wl)
    trace = Simulator(build_tree(2, fanout=2), store, EmulatedServiceModel(ridge, seed=2),
                      seed=7)
    nt = trace.load(wl)
    trace.run()
    out = _outcomes(trace, nt)
    check(nt == 27, f"the Azure sample replays {nt} requests, not 27")
    print(f"[platform] ml_pipeline (ridge): {n} workflows, {w['tasks']} tasks, p50 "
          f"{w['p50'] * 1e3:.2f} p95 {w['p95'] * 1e3:.2f} ms, fail {w['fail_rate']:.4f}; "
          f"trace_replay of the Azure sample: {nt} requests, {out}; "
          f"{time.perf_counter() - t:.2f} s")

    build = _tenant_build(lambda k: EmulatedServiceModel(ridge, seed=k))
    merged, wall = {}, {}
    for mode in ("inline", "process"):
        t = time.perf_counter()
        merged[mode] = run_partitioned(build, 4, mode=mode)
        wall[mode] = time.perf_counter() - t
    a, b = merged["inline"], merged["process"]
    check(b.mode == "process" and a.digest() == b.digest() and a.digests == b.digests,
          f"run_partitioned inline {a.digest()} != process {b.digest()}")
    print(f"[platform] run_partitioned, 4 partitions of 256 workers (ridge): "
          f"{a.summary()['n']} requests, merged digest {a.digest()} inline = process; "
          f"inline {wall['inline']:.3f} s, process {wall['process']:.3f} s; {smi}")
    t = time.perf_counter()
    try:
        run_partitioned(_tenant_build(lambda k: EmulatedServiceModel(mlp, seed=k), tenants=4,
                                      duration_s=0.5), 4, mode="process")
        refused = None
    except RuntimeError as e:
        refused = str(e)
    check(refused is not None and refused.startswith("partition ") and "CUDA" in refused,
          f"process mode with the MLP on the card did not fail as documented: {refused}")
    print(f"[platform] process mode with the MLP on the card refused in "
          f"{time.perf_counter() - t:.2f} s: {refused.splitlines()[0]} "
          f"{[ln for ln in refused.splitlines() if 'CUDA' in ln][-1].strip()}")


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
                    ("gmm_tc_kernel", "flash_fwd_tc_kernel", "decode_kernel",
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
    from repro_torch.configs import get_config, reduced

    _parity(replace(get_config("tiny_lm"), dtype="float32"), "tiny_lm")
    for hd in (96, 256):     # the head dims of phi3_vision and gemma3_12b through B1/B2
        _parity(replace(reduced(get_config("tiny_lm")), head_dim=hd, dtype="float32"),
                f"tiny_lm reduced to 2 layers, head_dim {hd}")
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
    ridge, mlp, X = timed("emulation", phase_emulation)
    timed("platform", lambda: phase_platform(ridge, mlp, X))
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
