#!/usr/bin/env python3
"""Quickest proof that the PyTorch port starts, serves and trains on the GPU.

    python3 chip_smoke.py

Needs one CUDA card of compute capability 9.0 (an H100) and ``nvcc``; it
imports nothing of JAX. Phases, each of which fails the run:

1. environment: the card's name, power limit and max SM clock, torch, the
   capability;
2. build: the kernels of the serving and training paths (B1-B4, the flash
   backward B1b, the scan's backward B3b and the grouped matmul's backward
   B4b: its bf16 route at block_t 64-128 on wgmma and TMA in its own source,
   its other routes in B4's) from ``src/repro_torch/csrc``, one ``nvcc`` a
   source, all at once; registers and spills of every kernel;
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
   within 2e-3, greedy tokens equal, over a prefill and 4 decode steps;
8. train: ``repro_torch.launch.train`` trains ``train_100m`` at full width
   and depth in bfloat16 (12 layers, d_model 768, vocab 32768; 30 steps of 8
   sequences of 1024 tokens in 2 microbatches, a checkpoint every 10): the
   loss finite and falling, B1 (with its logsumexp) launched twice per layer
   per microbatch (once more by the recompute of ``remat``) and B1b once,
   step time, wall against device time, tokens/s and peak memory; a run of
   20 steps, then a run resumed from its step-10 checkpoint, whose losses
   at steps 11-20 must equal the first run's bit for bit; and 3 f32 train
   steps of ``train_100m`` cut to 2 layers at full width on the card against
   the same weights on the CPU, losses and parameters within 2e-3;
9. engine: the port's ``Engine`` serves 8 requests of ``gemma3_12b`` (c=2,
   ``max_len`` 2048) at full width and depth (48 layers, hd 256, window 1024,
   5 local layers to 1 global, bfloat16) with prompts of 1100-1500 tokens,
   so every local layer's ring of 1024 wraps: B1 on every layer of every
   prefill (windowed and global) and B2 on every layer of every decode step
   (the rings by the split route), as reckoned; cold start, each prefill's
   time (the first long one apart), decode tokens/s, a decode step's wall
   against device time, peak memory;
10. ``phi3_vision`` at full width and depth (bfloat16): ``LM.prefill`` of 2
   sequences of 576 patch embeddings and 64 tokens, finite logits that move
   when the patch embeddings move, then 4 greedy decode steps against a
   ``SlotCache``; B1 at hd 96 and B2 as reckoned;
11. train: ``hubert_xlarge`` at full width and depth (48 layers, d_model
   1280, bidirectional, bfloat16, f32 AdamW state) through the port's
   trainer, 10 steps on one batch of 8 x 1024 frames with labels and a loss
   mask in 4 microbatches: the loss falls, B1 (with its logsumexp, hd 80)
   and B1b launch the reckoned counts; steady step ms (wall, device),
   tokens/s, peak memory;
12. train: ``falcon_mamba_7b`` at full width cut to 8 layers (1.11 B
   parameters; bf16, f32 AdamW, ``remat``) through the port's trainer, 10
   steps of 8 x 1024 tokens in 2 microbatches: the loss falls, steps 1-3
   run twice from the same weights give bit-equal losses, B3 (with its
   states every 16 steps) launches twice per layer per microbatch and B3b
   once; steady step ms (wall, device), tokens/s, busy share, peak memory,
   the largest kernels and the share of B3 and of B3b's two kernels;
13. train: ``moonshot_v1_16b`` at full width cut to 2 layers (1.48 B
   parameters) the same way: B4 6 times per layer per microbatch, B4b's dx
   and dW 3 times each, B1 with its logsumexp twice and B1b once; the CE
   beside the aux loss, the share of assignments dropped by capacity and of
   padding rows in B4's layout, and per MoE layer what the router sees
   (experts chosen, logits' spread, the common share of its input), on a
   microbatch of the stream and on one of uniform tokens;
14. train on a device mesh: a one-rank NCCL group (no network) and a
   ``(1, 1)`` ``("data", "model")`` mesh, on which the launcher takes the
   mesh path although one device shards nothing (DTensor parameters and
   optimizer state placed by the sharding rules, ``shard_act``, every
   kernel through ``ops.run_local``): ``train_100m`` at full width and depth
   through ``launch/train.py`` (10 steps of 8 x 1024 tokens, 2
   microbatches, a sharded checkpoint every 5 steps, then a run resumed
   from step 5 whose losses equal the first run's bit for bit), and 3 f32
   steps of phase 7's cuts (``falcon_mamba_7b`` 2 layers,
   ``moonshot_v1_16b`` 1 layer); each against the plain path from the same
   seed, losses and gradient norms bit-equal (else within 2e-3, the gap
   printed); B1, B1b, B3, B3b, B4 and B4b each launched on the mesh path;
   then a steady step of ``train_100m`` on both paths (plain, mesh, mesh,
   plain), wall and device ms;
15. compression and the roofline on the card: a one-rank NCCL group and a
   ``(1, 1, 1)`` ``("pod", "data", "model")`` mesh; ``train_100m`` at full
   width and depth trains 10 steps (8 x 1024 tokens, 2 microbatches) with
   ``make_pod_grad_sync`` as its ``grad_transform`` (the error tree carried
   from step to step), once with ``int8`` and once with ``topk`` (0.05):
   the losses fall, the first step's synced gradients and new errors are
   bit-equal to the same functions on the CPU copy of that step's
   gradients, B1 and B1b are launched; the sync's ms a step (wall and
   device) and the step's MFU (``model_flops`` over device time x
   ``PEAK_FLOPS``); then the roofline's memory counter on a real step,
   against ``torch.cuda.max_memory_allocated()`` from a reset (both above
   what was allocated before the step), within ``MEM_BAND``.

Phase 7 also holds, in f32 card vs CPU within 2e-3: ``gemma3_12b`` cut to
one period (5 local layers, 1 global) at full width, a prompt of 1100
tokens (the rings wrap) and 4 decode steps; ``phi3_vision`` cut to 2 layers
at full width with its patch embeddings; 3 train steps each of
``hubert_xlarge`` cut to 2 layers, ``falcon_mamba_7b`` cut to 2 layers (2 x
128 tokens) and ``moonshot_v1_16b`` cut to 1 layer (2 x 64 tokens), at full
width.

Phase 3 also holds the scan's training path at ``falcon_mamba_7b``'s
microbatch (Bt 4, S 1024, DI 8192, N 16, f32) and a small shape with h0 and
dh_S: B3 with its states every 16 steps (y and h_S bit-equal to the call
without, the states against the plain forward's) and B3b against its plain
version within 2e-3, two calls bit-equal, with two of its blocks resident
on an SM (the runtime's occupancy from its registers and shared memory);
and B4b's dx and dW at
``moonshot_v1_16b``'s microbatch (4 x 1024 tokens routed to 64 experts,
T_pad 32 768, block_t 128; gate/up and down) within 2e-4 in f32 and 2e-2 in
bf16, two calls bit-equal, and, with dy zero on the padding rows (as
``used_blocks`` promises), dx and dW with the layout's ``used_blocks``
bit-equal to the calls without it; with times beside their bounds (over
the rows read) and, for B4b, ``torch._grouped_mm``'s backward over the
same blocks (timed here only), three ways in bf16: with ``used_blocks`` (as training calls
them), without it (every block), and with it on a layout where 8 experts
take every token and capacity drops ~85% of the assignments (as phase 13's
router does at its weights).

Phase 3 also holds B1's logsumexp (within 2e-4 in f32, 2e-2 in bf16) and
the flash backward B1b (dq, dk, dv within rtol 1e-3, atol 1e-4 in f32, the
reference's gradient tolerance, and 2e-2 in bf16) against their plain
versions at ``train_100m``'s microbatch, a GQA and a windowed shape, with
B1b's times beside the backward of ``scaled_dot_product_attention``
through autograd (timed here only) and B1's cost of writing the logsumexp.

Between the engine phases, and before phases 9-13, the image cache is
emptied, so that the card holds one large image at a time.

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
from contextlib import contextmanager
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.telemetry.roofline import HBM_BW as HBM_BYTES_S  # noqa: E402  H100 SXM HBM3
from repro_torch.telemetry.roofline import PEAK_FLOPS  # noqa: E402  dense tensor-core bf16

PEAK_FLOP_S = {"bfloat16": PEAK_FLOPS,
               "float32": 67e12}              # float32 outside the tensor cores
SMS = 132                                     # H100 SXM streaming multiprocessors
SFU_PER_CLOCK = 16                            # ex2 a clock per SM (compute capability 9.0)
TOL = {"float32": 2e-4, "bfloat16": 2e-2}     # tests/test_kernels.py:17-19
SCAN_TOL = {"float32": 2e-3, "bfloat16": 5e-2}   # tests/test_kernels.py:78-79
LOGIT_TOL = 2e-3                              # tests/test_decode_parity.py
GRAD_TOL = {"float32": (1e-3, 1e-4),          # (rtol, atol): tests/test_attention.py:40
            "bfloat16": (2e-2, 2e-2)}         # tests/test_kernels.py:18
TRAIN_TOL = 2e-3                              # train-step losses and parameters, card vs CPU
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
    # phase 9's prefills (prompts of 1100-1500 tokens bucket to 2048): the
    # local layers' window of 1024 and the global layers; phase 10's prefill
    # of 576 patch embeddings and 64 tokens in a batch of 2
    ("gemma3 S2048", 1, 2048, 16, 8, 256, True, 0),
    ("gemma3 local S2048", 1, 2048, 16, 8, 256, True, 1024),
    ("phi3 B2 S640", 2, 640, 32, 32, 96, True, 0),
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
    # phase 9's global layers (max_len 2048) and phase 10's decode (a
    # SlotCache of 1024 after a prefill of 640)
    ("gemma3 global c2 W2048", 2, 2048, 16, 8, 256, False),
    ("phi3 c2 W1024", 2, 1024, 32, 32, 96, False),
]
# the decode positions of those two cases: phase 9's prompts of 1100-1500
# tokens, phase 10's 640 and its 4 steps (the others draw theirs below)
DECODE_POS = {"gemma3 global c2 W2048": (1100, 1505), "phi3 c2 W1024": (640, 644)}
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
# (label, B, S, H, KV, hd, causal, window): the training attention of phase 8,
# B1 with its logsumexp and the backward B1b: train_100m's microbatch (8
# sequences of 1024 in 2 microbatches), a GQA shape and a windowed one
TRAIN_ATTN_CASES = [
    ("train_100m microbatch", 4, 1024, 12, 12, 64, True, 0),
    ("GQA H8 KV2", 4, 1024, 8, 2, 64, True, 0),
    ("window 256", 4, 1024, 12, 12, 64, True, 256),
    # phase 11: hubert_xlarge's microbatch (8 sequences of 1024 frames in 4
    # microbatches), bidirectional at hd 80
    ("hubert microbatch", 2, 1024, 16, 16, 80, False, 0),
]
TRAIN_BLOCK = 256        # the plain versions' block: launch/train.py's max(64, seq // 4)
# (label, Bt, S, DI, N, h0 and dh_S): the scan's training forward (B3 with its
# chunk states) and backward (B3b): falcon_mamba_7b's microbatch of phase 12
# (8 sequences of 1024 in 2 microbatches, float32 as mamba_forward casts
# them, from zeros), and a small case with h0 and dh_S
SCAN_BWD_CASES = [
    ("falcon_mamba_7b microbatch", 4, 1024, 8192, 16, False),
    ("small, h0 and dh_S", 2, 200, 256, 16, True),
]
# (label, B, S, D, F): B4b at moonshot_v1_16b's training microbatch of phase
# 13 (4 x 1024 tokens, 64 experts, top-6, capacity 1.25: C 120, block_t 128,
# T_pad 32 768), gate/up (2048 -> 1408) and down (1408 -> 2048)
GMM_BWD_CASES = [
    ("moonshot microbatch wg/wi", 4, 1024, 2048, 1408),
    ("moonshot microbatch wo", 4, 1024, 1408, 2048),
]
# (label, B, W, H, KV, hd, ring, ranges): B2's slot-range route, a cache split
# over ranks, each range's partial against the plain partial form and the
# ranges combined against B2's whole call. The first is the mesh path's call
# (phase 14: tiny_lm's decode on one rank, every slot its range); 4 ranks'
# shares of qwen3_32b's decode_32k cache (8 sequences, 64 heads on 8 kv
# heads, the 32 768 slots over 16 ranks: 2048 each, the split route);
# gemma3's ring, and its global layers with a short sequence (ranges with
# every slot masked) in uneven ranges
DECODE_PARTIAL_CASES = [
    ("tiny_lm c4 W64, one rank", 4, 64, 8, 4, 32, False, 1),
    ("tiny_lm c4 W64, 2 ranges", 4, 64, 8, 4, 32, False, 2),
    ("qwen3_32b decode_32k, 4 ranks' slots", 8, 8192, 64, 8, 128, False, 4),
    ("gemma3 local c2 W1024 ring, 2 ranges", 2, 1024, 16, 8, 256, True, 2),
    ("gemma3 global c2 W2048, 3 ranges, a short prompt", 2, 2048, 16, 8, 256, False, 3),
]
# the shapes the kernels line reports: the engine's commonest calls
FLASH_LINE = "tiny_lm S32"
DECODE_LINE = "tiny_lm c4 W64"
DECODE_PARTIAL_LINE = "tiny_lm c4 W64, one rank"
MAMBA_LINE = "falcon_mamba_7b S32"
GMM_LINE = "moonshot decode c2 wg/wi"    # 2 of B4's 3 calls per layer of a decode step
BWD_LINE = "train_100m microbatch"
SCAN_BWD_LINE = "falcon_mamba_7b microbatch"
GMM_BWD_LINE = "moonshot microbatch wg/wi"      # 2 of B4b's 3 products a layer, used_blocks
BWD_TIMED = (BWD_LINE, "hubert microbatch")     # B1b (and B1 with lse) timed at these


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
            elif label in DECODE_POS:
                pos = rng.integers(*DECODE_POS[label], B)
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
    rows.update(_check_decode_partial())
    rows.update(_check_mamba(gen))
    rows.update(_check_gmm(gen))
    rows.update(_check_train_attention())
    rows.update(_check_scan_bwd())
    rows.update(_check_gmm_bwd())
    print("[kernels] ms: CUDA events over back-to-back calls (host overhead "
          "included); device_ms: the profiler's kernel time per call")
    for (name, label, dname), r in rows.items():
        lib = f"library_ms none ({r['library'] or 'no PyTorch call computes it'})"
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


def _time_mamba(ms, args, dname, err, states=False):
    dt, x, Bc, Cc, A, D, h0 = args
    Bt, S, DI = x.shape
    N = Bc.shape[2]
    # each input read once, y and h_S (and the chunk states) written once; per
    # (t, channel, state) an exp and 6 float32 operations, per (t, channel) 3
    # (dt*x and D*x + y); the exps on the SFUs, 16 a clock per SM at the
    # card's max SM clock
    nc = -(-S // ms.state_chunk(N)) if states else 0
    nbytes = ((dt.numel() + 2 * x.numel() + Bc.numel() + Cc.numel()) * x.element_size()
              + (A.numel() + D.numel() + (1 + (h0 is not None) + nc) * Bt * DI * N) * 4)
    b_ms, b_by = bound_ms(nbytes, Bt * S * DI * (7.0 * N + 3), dname)
    sfu_ms = Bt * S * DI * N / (SFU_PER_CLOCK * SMS * MAX_SM_HZ) * 1e3
    if sfu_ms > b_ms:
        b_ms, b_by = sfu_ms, "operations"
    kern = lambda: ms.mamba_scan(*args, states=states)
    chunk = ms.state_chunk(N) if states else None
    plain = lambda: ms.mamba_scan_plain(*args, chunk=chunk)
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
             library="scaled_dot_product_attention", plain_iters=100, plain_row=None):
    """Times of a kernel, its plain version and the library call ``lib``
    (None where there is none: ``library`` then says why). ``plain_row``:
    a row of the same function on the same inputs whose plain times this
    row takes (``plain`` is then not timed)."""
    if plain_row is None:
        plain_times = {"plain_ms": time_ms(plain, iters=plain_iters,
                                           warmup=min(10, plain_iters)),
                       "plain_device_ms": device_ms(plain, iters=max(1, plain_iters // 2))}
    else:
        plain_times = {n: plain_row[n] for n in ("plain_ms", "plain_device_ms")}
    return {"shape": shape, "max_abs_err": err, "library": library,
            "ms": time_ms(kern), "device_ms": device_ms(kern, wrapper=wrapper), **plain_times,
            "library_ms": time_ms(lib) if lib else None,
            "library_device_ms": device_ms(lib) if lib else None,
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


def _check_decode_partial():
    """B2's slot-range route (:data:`DECODE_PARTIAL_CASES`): each range's
    partial against the plain partial form (m within 1e-5, l and acc / l
    within the type's tolerance; m = -inf, l = 0, acc = 0 where every slot
    is masked), the ranges combined against B2's whole call and the plain
    version; the mesh path's case timed."""
    import numpy as np
    import torch

    from repro_torch.kernels import decode_attention as dec
    rows = {}
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        tol = TOL[dname]
        for case in DECODE_PARTIAL_CASES:
            label, B, W, H, KV, hd, ring, nr = case
            g = _own_gen("decode_attention_partial", label, dname)
            q = _inputs(g, (B, H, hd), dtype)
            kc = _inputs(g, (B, W, KV, hd), dtype)
            vc = _inputs(g, (B, W, KV, hd), dtype)
            rng = np.random.default_rng(B * W + H)
            pos = rng.integers(W, 2 * W, B) if ring else rng.integers(16, W, B)
            if "short" in label:
                pos[0] = 30
            pos = torch.as_tensor(pos, dtype=torch.int32, device="cuda")
            bounds = [round(W * i / nr / 8) * 8 for i in range(nr + 1)]
            parts, err, masked = [], 0.0, 0
            for a, b in zip(bounds, bounds[1:]):
                k, v = kc[:, a:b], vc[:, a:b]
                acc, m, l = dec.decode_attention_partial(q, k, v, pos, ring=ring, offset=a,
                                                         total=W)
                wa, wm, wl = dec.decode_attention_partial_plain(q, k, v, pos, ring=ring,
                                                                offset=a, total=W)
                torch.cuda.synchronize()
                dead = torch.isinf(wm)
                masked += int(dead.sum())
                check(torch.equal(torch.isinf(m), dead) and bool((l[dead] == 0).all())
                      and bool((acc[dead] == 0).all()) and bool((m[dead] < 0).all()),
                      f"decode_attention_partial {label} {dname}: a masked range's partial")
                live = ~dead
                norm = lambda a_, l_: (a_ / l_.clamp_min(1e-30)[..., None])[live]  # noqa: E731
                e = max((m[live] - wm[live]).abs().max().item() if live.any() else 0.0,
                        ((l[live] - wl[live]).abs() / wl[live]).max().item()
                        if live.any() else 0.0,
                        (norm(acc, l) - norm(wa, wl)).abs().max().item() if live.any() else 0.0)
                check(e <= tol, f"decode_attention_partial {label} {dname} [{a}, {b}): {e}")
                err = max(err, e)
                parts.append((acc, m, l))
            out = dec.combine_partials(parts, dtype)
            whole = dec.decode_attention(q, kc, vc, pos, ring=ring)
            plain = dec.decode_attention_plain(q, kc, vc, pos, ring=ring)
            e_whole = (out.float() - whole.float()).abs().max().item()
            e_plain = (out.float() - plain.float()).abs().max().item()
            routes = sorted({dec.decode_route(B, KV, b - a, hd, q.element_size())[0]
                             for a, b in zip(bounds, bounds[1:])})
            ok = e_whole <= tol and e_plain <= tol
            print(f"[kernels] decode_attention_partial {label} B{B} W{W} H{H} KV{KV} hd{hd} "
                  f"ring={ring} {dname} [{', '.join(routes)}; {nr} range(s), {masked} "
                  f"(sequence, head) partials fully masked]: max_abs_err {err:.3e} against the "
                  f"plain partials; combined against B2 whole {e_whole:.3e}, plain "
                  f"{e_plain:.3e} (tol {tol:g}) {'ok' if ok else 'FAIL'}")
            check(ok, f"decode_attention_partial {label} {dname}: the combined partials disagree")
            if "short" in label:
                check(masked > 0, f"{label}: no range was fully masked")
            if label == DECODE_PARTIAL_LINE:
                rows[("decode_attention_partial", label, dname)] = _time_decode_partial(
                    dec, q, kc, vc, pos, ring, dname, err)
    return rows


def _time_decode_partial(dec, q, kc, vc, pos, ring, dname, err):
    """The partial route over every slot of one rank (the mesh path's call).
    A range's partial is the pair (out, lse), out = acc / l and lse = m + log
    l: the library call is the memory-efficient attention with its
    logsumexp, kv heads expanded and the range's slot mask as its bias."""
    import torch
    B, W, KV, hd = kc.shape
    H = q.shape[1]
    slot = torch.arange(W, device=q.device)
    valid = slot[None, :] <= pos[:, None].long()
    if ring:
        valid = valid | (pos[:, None].long() >= W)
    keys = int(valid.sum().item())
    nbytes = (q.numel() + 2 * keys * KV * hd) * q.element_size() + pos.numel() * 4 \
        + B * H * (hd + 2) * 4
    b_ms, b_by = bound_ms(nbytes, 4.0 * hd * keys * H, dname)
    qt = q[:, :, None]
    kt, vt = (c.transpose(1, 2).repeat_interleave(H // KV, 1) for c in (kc, vc))
    bias = torch.zeros((B, H, 1, W), dtype=q.dtype, device=q.device)
    bias.masked_fill_(~valid[:, None, None, :], float("-inf"))
    lib = lambda: torch.ops.aten._scaled_dot_product_efficient_attention(  # noqa: E731
        qt, kt, vt, bias, True)
    out, lse = lib()[:2]
    acc, m, l = dec.decode_attention_partial_plain(q, kc, vc, pos, ring=ring)
    lib_err = max((out[:, :, 0].float() - acc / l[..., None]).abs().max().item(),
                  (lse[:, :, 0].float() - (m + torch.log(l))).abs().max().item())
    kern = lambda: dec.decode_attention_partial(q, kc, vc, pos, ring=ring)  # noqa: E731
    plain = lambda: dec.decode_attention_partial_plain(q, kc, vc, pos, ring=ring)  # noqa: E731
    route = dec.decode_route(B, KV, W, hd, q.element_size())[0]
    return _timings(kern, dec.decode_attention_partial, plain, lib,
                    f"B{B} W{W} H{H} KV{KV} hd{hd}, {route}, one range", err, lib_err, b_ms, b_by,
                    library="_scaled_dot_product_efficient_attention with its logsumexp")


def _check_train_attention():
    """B1's logsumexp and the backward B1b against their plain versions at
    the training shapes, both types; B1b timed in bf16 at train_100m's
    microbatch (and B1 with and without its logsumexp)."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb

    rows = {}
    for case in TRAIN_ATTN_CASES:
        label, B, S, H, KV, hd, causal, window = case
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            g = _own_gen("flash_attention_bwd", label, dname)
            q, k, v, dout = (_inputs(g, (B, S, n, hd), dtype) for n in (H, KV, KV, H))
            out, lse = fa.flash_attention(q, k, v, causal=causal, window=window,
                                          return_lse=True)
            plain = fa.flash_attention(q, k, v, causal=causal, window=window)
            _, ref_lse = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                                  return_lse=True)
            torch.cuda.synchronize()
            tol = TOL[dname]
            lse_err = (lse - ref_lse).abs().max().item()
            ok = torch.equal(out, plain) and torch.allclose(lse, ref_lse, rtol=tol, atol=tol)
            print(f"[kernels] flash_attention lse {label} B{B} S{S} H{H} KV{KV} hd{hd} "
                  f"causal={causal} window={window} {dname}: lse max_abs_err {lse_err:.3e} "
                  f"(tol {tol:g}), out equal to the call without lse: "
                  f"{torch.equal(out, plain)} {'ok' if ok else 'FAIL'}")
            check(ok, f"flash_attention lse {label} {dname} disagrees with its plain version")
            args = (q, k, v, out, lse, dout)
            got = fb.flash_attention_bwd(*args, causal=causal, window=window)
            want = fb.flash_attention_bwd_plain(*args, causal=causal, window=window,
                                                block=TRAIN_BLOCK)
            again = fb.flash_attention_bwd(*args, causal=causal, window=window)
            torch.cuda.synchronize()
            rtol, atol = GRAD_TOL[dname]
            errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, want)]
            ok = all(torch.allclose(a.float(), b.float(), rtol=rtol, atol=atol)
                     for a, b in zip(got, want))
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            print(f"[kernels] flash_attention_bwd {label} B{B} S{S} H{H} KV{KV} hd{hd} "
                  f"causal={causal} window={window} {dname} ({fb.ROUTES[dtype]}): max_abs_err "
                  f"dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} (rtol {rtol:g} "
                  f"atol {atol:g}); two calls "
                  f"bit-equal: {same} {'ok' if ok and same else 'FAIL'}")
            check(ok, f"flash_attention_bwd {label} {dname} disagrees with its plain version")
            check(same, f"flash_attention_bwd {label} {dname} is not deterministic")
            if label in BWD_TIMED and dname == "bfloat16":
                rows[("flash_attention_bwd", label, dname)] = _time_flash_bwd(
                    fa, fb, args, causal, window, dname, max(errs), label)
    return rows


def _time_flash_bwd(fa, fb, args, causal, window, dname, err, label):
    import torch
    import torch.nn.functional as F
    q, k, v, out, lse, dout = args
    B, S, H, hd = q.shape
    KV = k.shape[2]
    kern = lambda: fb.flash_attention_bwd(*args, causal=causal, window=window)
    plain = lambda: fb.flash_attention_bwd_plain(*args, causal=causal, window=window,
                                                 block=TRAIN_BLOCK)
    # the library: the backward of SDPA through autograd, its forward run once
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    mask = None
    if window:
        i = torch.arange(S, device=q.device)
        mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
    ot = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                        is_causal=causal and mask is None, enable_gqa=True)
    dot = dout.transpose(1, 2)
    lib = lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)
    lib_err = max((a.transpose(1, 2).float() - b.float()).abs().max().item()
                  for a, b in zip(lib(), plain()))
    pairs = 0
    for t in range(S):   # (query, key) pairs the mask lets through
        lo = max(0, t - window + 1) if window else 0
        pairs += (t + 1 if causal else S) - lo
    # q, k, v, out, dout read and dq, dk, dv written once (lse: 4 bytes a row);
    # five products (s, dp, dv, dk, dq) of 2*hd operations per visible pair
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() + lse.numel() * 4
    b_ms, b_by = bound_ms(nbytes, 10.0 * hd * pairs * B * H, dname)
    r = _timings(kern, fb.flash_attention_bwd, plain, lib, f"B{B} S{S} H{H} KV{KV} hd{hd}",
                 err, lib_err, b_ms, b_by, library="scaled_dot_product_attention backward",
                 plain_iters=20)
    with_lse = lambda: fa.flash_attention(q, k, v, causal=causal, window=window,
                                          return_lse=True)
    without = lambda: fa.flash_attention(q, k, v, causal=causal, window=window)
    print(f"[kernels] flash_attention at {label} {dname}: the logsumexp's cost, device ms "
          f"without {_ms(device_ms(without, wrapper=fa.flash_attention))} with "
          f"{_ms(device_ms(with_lse, wrapper=fa.flash_attention))}; kernel_ms without "
          f"{time_ms(without):.4f} with {time_ms(with_lse):.4f}")
    # B1 with its logsumexp beside its plain version, its bound and the library
    # call that also returns the logsumexp (causal only, no GQA: timed where
    # the shape allows it); q, k, v read and out and lse written once, two
    # products of 2*hd operations per visible pair
    lse_plain = lambda: fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                                 return_lse=True)
    lse_lib = lse_lib_err = None
    if not window and H == KV:
        qc, kc, vc = (t.detach().contiguous() for t in (qt, kt, vt))
        lse_lib = lambda: torch.ops.aten._scaled_dot_product_flash_attention(
            qc, kc, vc, 0.0, causal)
        lib_lse = lse_lib()[1].transpose(1, 2)                     # [B,H,S] -> [B,S,H]
        lse_lib_err = (lib_lse.reshape(lse.shape) - lse).abs().max().item()
    b_ms, b_by = bound_ms((2 * q.numel() + 2 * k.numel()) * q.element_size() + lse.numel() * 4,
                          4.0 * hd * pairs * B * H, dname)
    lr = {"ms": time_ms(with_lse), "device_ms": device_ms(with_lse, wrapper=fa.flash_attention),
          "plain_ms": time_ms(lse_plain, iters=20),
          "plain_device_ms": device_ms(lse_plain, iters=10),
          "library_ms": time_ms(lse_lib) if lse_lib else None,
          "library_device_ms": device_ms(lse_lib) if lse_lib else None}
    print(f"[kernels] flash_attention with lse at {label} {dname}: ms {lr['ms']:.4f}, "
          f"device ms {_ms(lr['device_ms'])}, bound {b_ms:.4f} ({b_by}), plain ms "
          f"{lr['plain_ms']:.4f} (device {_ms(lr['plain_device_ms'])}), "
          f"_scaled_dot_product_flash_attention ms {_ms(lr['library_ms'])} (device "
          f"{_ms(lr['library_device_ms'])}; its lse max_abs_err {lse_lib_err})")
    return r


def _check_scan_bwd():
    """The scan's training path at falcon_mamba_7b's microbatch and at a small
    shape with h0 and dh_S: B3 with its chunk states (y and h_S bit-equal to
    the call without, the states against the plain forward's) and B3b
    against its plain version, twice, bit-equal; both timed at the
    microbatch."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import mamba_scan_bwd as msb

    rows = {}
    tol = SCAN_TOL["float32"]
    for case in SCAN_BWD_CASES:
        label, Bt, S, DI, N, with_h = case
        g = _own_gen("mamba_scan_bwd", *case)
        dt = F.softplus(torch.randn(Bt, S, DI, generator=g, device="cuda")) * 0.1
        x = _inputs(g, (Bt, S, DI), torch.float32)
        Bc, Cc = (_inputs(g, (Bt, S, N), torch.float32) for _ in range(2))
        A = -torch.exp(0.2 * torch.randn(DI, N, generator=g, device="cuda"))
        D = torch.randn(DI, generator=g, device="cuda")
        h0 = torch.randn(Bt, DI, N, generator=g, device="cuda") if with_h else None
        dy = _inputs(g, (Bt, S, DI), torch.float32)
        dh_S = torch.randn(Bt, DI, N, generator=g, device="cuda") if with_h else None
        fwd = (dt, x, Bc, Cc, A, D, h0)
        Tc = ms.state_chunk(N)
        y, h = ms.mamba_scan(*fwd)
        y2, h2, states = ms.mamba_scan(*fwd, states=True)
        _, _, ref_states = ms.mamba_scan_plain(*fwd, chunk=Tc)
        torch.cuda.synchronize()
        same = torch.equal(y, y2) and torch.equal(h, h2)
        st_err = (states - ref_states).abs().max().item()
        ok = same and torch.allclose(states, ref_states, rtol=tol, atol=tol)
        print(f"[kernels] mamba_scan with states {label} Bt{Bt} S{S} DI{DI} N{N} float32: y "
              f"and h_S bit-equal to the call without: {same}; states ({states.shape[1]} chunks "
              f"of {Tc}) max_abs_err {st_err:.3e} (tol {tol:g}) {'ok' if ok else 'FAIL'}")
        check(ok, f"mamba_scan with states {label} disagrees with the call without or with "
                  f"the plain forward's states")
        bwd = (dt, x, Bc, Cc, A, D, states, dy, dh_S)
        got = msb.mamba_scan_bwd(*bwd)
        again = msb.mamba_scan_bwd(*bwd)
        want = msb.mamba_scan_bwd_plain(*bwd, chunk=Tc)
        torch.cuda.synchronize()
        errs = {n: (a - b).abs().max().item() for n, a, b in zip(got._fields, got, want)}
        ok = all(torch.allclose(a, b, rtol=tol, atol=tol) for a, b in zip(got, want))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        print(f"[kernels] mamba_scan_bwd {label} Bt{Bt} S{S} DI{DI} N{N} h0/dh_S={with_h} "
              f"float32: max_abs_err " + " ".join(f"{n} {e:.3e}" for n, e in errs.items())
              + f" (rtol/atol {tol:g}); two calls bit-equal: {same} "
              f"{'ok' if ok and same else 'FAIL'}")
        check(ok, f"mamba_scan_bwd {label} disagrees with its plain version")
        check(same, f"mamba_scan_bwd {label} is not deterministic")
        blocks = msb.blocks_per_sm(N)
        print(f"[kernels] mamba_scan_bwd N{N}: {blocks} blocks of 256 threads resident on an "
              f"SM (registers and shared memory, as the runtime reckons them)")
        check(blocks >= 2, f"mamba_scan_bwd N{N} fits {blocks} block(s) on an SM, not 2")
        if label == SCAN_BWD_LINE:
            rows[("mamba_scan", label + ", with states", "float32")] = _time_mamba(
                ms, fwd, "float32", st_err, states=True)
            rows[("mamba_scan_bwd", label, "float32")] = _time_scan_bwd(
                msb, bwd, Tc, max(errs.values()))
    return rows


def _time_scan_bwd(msb, bwd, Tc, err):
    dt, x, Bc, Cc, A, D, states, dy, dh_S = bwd
    Bt, S, DI = x.shape
    N = Bc.shape[2]
    # dt, x, dy, B, C, A, D, the states (and dh_S) read once; ddt, dx, dB, dC,
    # dA, dD and dh0 written once; per (t, channel, state) one exp on the SFUs
    # (a_t = exp(dt_t A); the function needs no other, since a_t h_{t-1} =
    # h_t - dt_t x_t B_t: the kernel's second, in its recompute, is its own
    # choice) and ~16 float32 operations, per (t, channel) ~8
    reads = 3 * x.numel() + 2 * Bc.numel() + A.numel() + D.numel() + states.numel()
    writes = 2 * x.numel() + 2 * Bc.numel() + A.numel() + D.numel() + Bt * DI * N
    nbytes = (reads + writes + (0 if dh_S is None else dh_S.numel())) * 4
    b_ms, b_by = bound_ms(nbytes, Bt * S * DI * (16.0 * N + 8), "float32")
    sfu_ms = Bt * S * DI * N / (SFU_PER_CLOCK * SMS * MAX_SM_HZ) * 1e3
    if sfu_ms > b_ms:
        b_ms, b_by = sfu_ms, "operations"
    binds = "SFU exps" if b_ms == sfu_ms else b_by
    return _timings(lambda: msb.mamba_scan_bwd(*bwd), msb.mamba_scan_bwd,
                    lambda: msb.mamba_scan_bwd_plain(*bwd, chunk=Tc), None,
                    f"Bt{Bt} S{S} DI{DI} N{N}, bound by {binds}", err, None, b_ms, b_by,
                    library=None, plain_iters=2)


def _check_gmm_bwd():
    """B4b's dx and dW against their plain version at moonshot_v1_16b's
    training microbatch, on a layout routed from random router probabilities,
    gate/up and down, float32 (TF32 off) within 2e-4 and bfloat16 within
    2e-2; two calls bit-equal; with dy zero on the padding rows (as the
    model's backward gives it, and as used_blocks promises), dx and dW with
    the layout's used_blocks bit-equal to the calls without it; bf16 timed
    on those inputs with and without used_blocks, and with it on a layout
    that drops ~85% of the assignments."""
    import torch

    from repro_torch.kernels import moe_gmm
    from repro_torch.models import moe as tmoe

    rows = {}
    E, k = 64, 6
    for case in GMM_BWD_CASES:
        label, B, S, D, F = case
        g = _own_gen("grouped_matmul_bwd", *case)
        C = tmoe.capacity(S, k, E, 1.25)
        gate, eidx = torch.softmax(torch.randn(B, S, E, generator=g, device="cuda"),
                                   -1).topk(k)
        lay = tmoe.build_layout(eidx, gate / gate.sum(-1, keepdim=True), C,
                                tmoe.block_rows(B, C), E)
        bmap, bt, used = lay.block_to_expert, lay.block_t, lay.used_blocks
        T = lay.row_token.numel()
        pad = lay.row_token == B * S
        kept = int((~pad).sum())
        n_used = int(used.item())
        what = (f"B{B} S{S} C{C} T_pad{T} bt{bt} D{D} F{F} E{E}: {kept} of {B * S * k} "
                f"assignments kept, {int(torch.unique(bmap).numel())} experts, {n_used} of "
                f"{bmap.numel()} blocks used")
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            x = torch.cat([_inputs(g, (B * S, D), dtype),
                           torch.zeros(1, D, dtype=dtype, device="cuda")])[lay.row_token]
            w = _gmm_weights(g, E, D, F, dtype)
            dy = (_inputs(g, (T, F), torch.float32) / 16).to(dtype)   # dw of order 1
            dx = moe_gmm.grouped_matmul_dx(dy, w, bmap, bt)
            dw = moe_gmm.grouped_matmul_dw(x, dy, bmap, bt, E)
            dx2 = moe_gmm.grouped_matmul_dx(dy, w, bmap, bt)
            dw2 = moe_gmm.grouped_matmul_dw(x, dy, bmap, bt, E)
            # used_blocks promises x and dy zero past the used rows (x is, as
            # dispatched): with that, the calls with it equal those without
            dyz = dy.masked_fill(pad[:, None], 0)
            dxz = moe_gmm.grouped_matmul_dx(dyz, w, bmap, bt)
            dwz = moe_gmm.grouped_matmul_dw(x, dyz, bmap, bt, E)
            dxu = moe_gmm.grouped_matmul_dx(dyz, w, bmap, bt, used)
            dwu = moe_gmm.grouped_matmul_dw(x, dyz, bmap, bt, E, used)
            want_dx, want_dw = moe_gmm.grouped_matmul_bwd_plain(x, w, dy, bmap, bt)
            torch.cuda.synchronize()
            tol = TOL[dname]
            route = moe_gmm.bwd_route(dtype, bt)
            errs = {n: (a.float() - b.float()).abs().max().item()
                    for n, a, b in (("dx", dx, want_dx), ("dw", dw, want_dw))}
            ok = (torch.allclose(dx.float(), want_dx.float(), rtol=tol, atol=tol)
                  and torch.allclose(dw.float(), want_dw.float(), rtol=tol, atol=tol))
            same = torch.equal(dx, dx2) and torch.equal(dw, dw2)
            with_used = torch.equal(dxu, dxz) and torch.equal(dwu, dwz)
            print(f"[kernels] grouped_matmul_bwd {label} {what} {dname} [{route}]: "
                  f"max_abs_err dx {errs['dx']:.3e} dw {errs['dw']:.3e} (tol {tol:g}); two "
                  f"calls bit-equal: {same}; dy zero on the padding rows, with used_blocks "
                  f"dx and dW bit-equal to without: {with_used} "
                  f"{'ok' if ok and same and with_used else 'FAIL'}")
            check(ok, f"grouped_matmul_bwd {label} {dname} disagrees with its plain version")
            check(same, f"grouped_matmul_bwd {label} {dname} is not deterministic")
            check(with_used, f"grouped_matmul_bwd {label} {dname} changes with used_blocks")
            if dname == "bfloat16":
                for part in ("dx", "dw"):
                    row = rows[(f"grouped_matmul_{part}", label, dname)] = _time_gmm_bwd(
                        moe_gmm, part, x, w, dyz, bmap, bt, used, kept, errs[part])
                    rows[(f"grouped_matmul_{part}", label + ", all blocks", dname)] = (
                        _time_gmm_bwd(moe_gmm, part, x, w, dyz, bmap, bt, None, kept,
                                      errs[part], plain_row=row))
            del x, w, dy, dyz, dx, dw, dx2, dw2, dxz, dwz, dxu, dwu, want_dx, want_dw
            torch.cuda.empty_cache()
        rows.update(_check_gmm_bwd_dropped(moe_gmm, tmoe, label, B, S, D, F, E, k, C))
    return rows


def _check_gmm_bwd_dropped(moe_gmm, tmoe, label, B, S, D, F, E, k, C):
    """bf16 B4b on a layout where 8 experts take nearly every token's top 6
    and capacity drops ~85% of the assignments (phase 13's router at its
    weights), with used_blocks: within 2e-2 of the plain version, and timed.
    dy is zero on the padding rows, as the model's backward gives it."""
    import torch
    g = _own_gen("grouped_matmul_bwd dropped", B, S, D, F)
    logits = torch.randn(B, S, E, generator=g, device="cuda")
    logits[..., :8] += 8.0
    gate, eidx = torch.softmax(logits, -1).topk(k)
    lay = tmoe.build_layout(eidx, gate / gate.sum(-1, keepdim=True), C, tmoe.block_rows(B, C), E)
    bmap, bt, used = lay.block_to_expert, lay.block_t, lay.used_blocks
    T = lay.row_token.numel()
    pad = lay.row_token == B * S
    kept = int((~pad).sum())
    x = torch.cat([_inputs(g, (B * S, D), torch.bfloat16),
                   torch.zeros(1, D, dtype=torch.bfloat16, device="cuda")])[lay.row_token]
    w = _gmm_weights(g, E, D, F, torch.bfloat16)
    dy = (_inputs(g, (T, F), torch.float32) / 16).to(torch.bfloat16)
    dy[pad] = 0
    dx = moe_gmm.grouped_matmul_dx(dy, w, bmap, bt, used)
    dw = moe_gmm.grouped_matmul_dw(x, dy, bmap, bt, E, used)
    want_dx, want_dw = moe_gmm.grouped_matmul_bwd_plain(x, w, dy, bmap, bt, used_blocks=used)
    torch.cuda.synchronize()
    tol = TOL["bfloat16"]
    errs = {n: (a.float() - b.float()).abs().max().item()
            for n, a, b in (("dx", dx, want_dx), ("dw", dw, want_dw))}
    ok = (torch.allclose(dx.float(), want_dx.float(), rtol=tol, atol=tol)
          and torch.allclose(dw.float(), want_dw.float(), rtol=tol, atol=tol))
    print(f"[kernels] grouped_matmul_bwd {label}, 85% dropped: T_pad{T} bt{bt}: {kept} of "
          f"{B * S * k} assignments kept ({1 - kept / (B * S * k):.2%} dropped), "
          f"{int(used.item())} of {bmap.numel()} blocks used; bfloat16 "
          f"[{moe_gmm.bwd_route(torch.bfloat16, bt)}]: max_abs_err dx {errs['dx']:.3e} dw "
          f"{errs['dw']:.3e} (tol {tol:g}) {'ok' if ok else 'FAIL'}")
    check(ok, f"grouped_matmul_bwd {label}, 85% dropped, disagrees with its plain version")
    return {(f"grouped_matmul_{part}", label + ", 85% dropped", "bfloat16"): _time_gmm_bwd(
        moe_gmm, part, x, w, dy, bmap, bt, used, kept, errs[part]) for part in ("dx", "dw")}


def _time_gmm_bwd(moe_gmm, part, x, w, dy, bmap, bt, used, kept, err, plain_row=None):
    """B4b's ``part`` (dx or dw), with ``used`` blocks (None: all), timed
    beside its plain version (or ``plain_row``'s times of it), its bound and
    ``torch._grouped_mm``'s backward for the same input through autograd
    (timed here only), where the installed torch has it, over the same
    blocks."""
    import torch
    T, D = x.shape
    E, _, F = w.shape
    elt = x.element_size()
    nb = bmap.numel() if used is None else int(used.item())
    rows = nb * bt                  # the rows the function reads: none past used
    experts = int(torch.unique(bmap[:nb]).numel())
    # 2*D*F operations for each row that holds an assignment; dx reads dy's
    # used rows and each distinct expert's weights and writes all of dx, dW
    # reads x's and dy's used rows and writes every expert's dw
    flops = 2.0 * kept * D * F
    if part == "dx":
        b_ms, b_by = bound_ms((rows * F + experts * D * F + T * D) * elt + nb * 4,
                              flops, "bfloat16")
        kern = lambda: moe_gmm.grouped_matmul_dx(dy, w, bmap, bt, used)
        plain = lambda: moe_gmm.grouped_matmul_bwd_plain(x, w, dy, bmap, bt, used_blocks=used,
                                                         need_dw=False)
        wrapper = moe_gmm.grouped_matmul_dx
    else:
        b_ms, b_by = bound_ms((rows * D + rows * F + E * D * F) * elt + nb * 4, flops,
                              "bfloat16")
        kern = lambda: moe_gmm.grouped_matmul_dw(x, dy, bmap, bt, E, used)
        plain = lambda: moe_gmm.grouped_matmul_bwd_plain(x, w, dy, bmap, bt, used_blocks=used,
                                                         need_dx=False)
        wrapper = moe_gmm.grouped_matmul_dw
    lib, lib_err = None, None
    lib_name = "none: the installed torch has no torch._grouped_mm"
    if hasattr(torch, "_grouped_mm"):
        # groups over the same blocks as the kernel: with used, the last ends
        # at its rows, and the library leaves the padding past them out too
        offs = (torch.cumsum(torch.bincount(bmap[:nb].long(), minlength=E), 0)
                * bt).to(torch.int32)
        if part == "dx":       # dx only
            xr = x.detach().requires_grad_()
            out = torch._grouped_mm(xr, w, offs=offs)
            lib = lambda: torch.autograd.grad(out, xr, dy, retain_graph=True)[0]
        else:                  # dW only
            wr = w.detach().requires_grad_()
            out = torch._grouped_mm(x, wr, offs=offs)
            lib = lambda: torch.autograd.grad(out, wr, dy, retain_graph=True)[0]
        lib_name = "torch._grouped_mm backward through autograd"
        # held to the plain version on the rows it computes (its dx past
        # them is not written)
        got, want = lib(), moe_gmm.grouped_matmul_bwd_plain(x, w, dy, bmap, bt,
                                                             used_blocks=used)
        if part == "dx":
            got, want = got[:rows], want[0][:rows]
        else:
            want = want[1]
        lib_err = (got.float() - want.float()).abs().max().item()
    blocks = "all" if used is None else f"{nb} used"
    plain_note = "" if plain_row is None else ", plain timed with used_blocks"
    return _timings(kern, wrapper, plain, lib,
                    f"T_pad{T} bt{bt} D{D} F{F} E{E}, {kept} rows kept, {experts} experts, "
                    f"{blocks} of {bmap.numel()} blocks [{moe_gmm.bwd_route(x.dtype, bt)}]"
                    f"{plain_note}", err, lib_err, b_ms, b_by, library=lib_name,
                    plain_iters=6, plain_row=plain_row)


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
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import mamba_scan_bwd as msb
    from repro_torch.kernels import moe_gmm
    return {"flash_attention": fa.flash_attention, "decode_attention": dec.decode_attention,
            "decode_attention_partial": dec.decode_attention_partial,
            "mamba_scan": ms.mamba_scan, "grouped_matmul": moe_gmm.grouped_matmul,
            "flash_attention_bwd": fb.flash_attention_bwd,
            "mamba_scan_bwd": msb.mamba_scan_bwd,
            "grouped_matmul_dx": moe_gmm.grouped_matmul_dx,
            "grouped_matmul_dw": moe_gmm.grouped_matmul_dw}


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


def _serve_image(arch, fn, tag, n_req=8, max_len=64, prompt=(4, 24)):
    """``n_req`` requests of one large image (c=2, 4 generated tokens) through
    an Engine of ``max_len``, prompt sizes drawn from ``prompt`` (low,
    high) and run points as in phase 4's mix. Every launch count is set to 0
    just before and read just after; the model's prefill and decode_step
    calls are counted and timed (each to a synchronize, which the engine
    makes right after anyway: it reads the next token on the host), and the
    attention calls tallied by kind. Returns (engine, instances, launches,
    calls, kinds, timed): ``timed`` maps each call kind to its (tokens in,
    seconds) in order, the instance's warm-up included."""
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
    engine = Engine(build_tree(2, fanout=2), store, ImageRegistry(), max_len=max_len,
                    device="cuda")
    rng = np.random.default_rng(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    calls = {"prefill": 0, "decode_step": 0}
    timed = {name: [] for name in calls}
    originals = {name: getattr(LM, name) for name in calls}

    def counted(name):
        def call(self, *a, **kw):
            calls[name] += 1
            t = time.perf_counter()
            out = originals[name](self, *a, **kw)
            torch.cuda.synchronize()
            batch = a[-1]
            n = batch["tokens"].shape[1] if "tokens" in batch else batch["token"].shape[0]
            timed[name].append((n, time.perf_counter() - t))
            return out
        return call

    wrappers = _wrappers()
    for name in calls:
        setattr(LM, name, counted(name))
    try:
        with _attention_kinds() as kinds:
            for w in wrappers.values():
                w.launches = 0
            t0 = time.perf_counter()
            reqs, results = [], []
            for _ in range(n_req):
                req = Request(fn=fn, arrival_t=0.0, size=int(rng.integers(*prompt)))
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
    print(f"[{tag}] attention calls on the card by kind: {kinds}")
    return engine, insts, launches, calls, kinds, timed


@contextmanager
def _attention_kinds():
    """Tally the model's attention calls on the card by kind (B1: head dim and
    mask; B2: head dim, cache width, ring or not, and the route the wrapper
    takes); the wrappers' launch counts stay the count of record."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ops

    kinds = {}
    flash0, decode0 = ops.flash_attention, ops.decode_attention

    def tally(key):
        kinds[key] = kinds.get(key, 0) + 1

    def flash(q, k, v, *, causal=True, window=0, block=512):
        if q.is_cuda:
            mask = f"window {window}" if window else "causal" if causal else "bidirectional"
            tally(f"B1 hd{q.shape[-1]} {mask}")
        return flash0(q, k, v, causal=causal, window=window, block=block)

    def decode(q, k_cache, v_cache, positions, *, ring=False):
        if q.is_cuda:
            B, W, KV, hd = k_cache.shape
            route = dec.decode_route(B, KV, W, hd, q.element_size())[0]
            tally(f"B2 hd{hd} W{W} {'ring' if ring else 'no ring'} {route}")
        return decode0(q, k_cache, v_cache, positions, ring=ring)

    ops.flash_attention, ops.decode_attention = flash, decode
    try:
        yield kinds
    finally:
        ops.flash_attention, ops.decode_attention = flash0, decode0


def _time_model_calls(inst, tag, prefill_len=32):
    """One model call of each kind on the image's weights, after the counts
    were read: host wall per call (CUDA events) against device time."""
    import torch
    tok = torch.zeros(inst.slots, dtype=torch.int32, device="cuda")
    step = lambda: inst.model.decode_step(inst.kv.cache, {"token": tok,
                                                          "pos": inst.kv.positions()})
    prompt = torch.zeros((1, prefill_len), dtype=torch.int32, device="cuda")
    prefill = lambda: inst.model.prefill({"tokens": prompt})
    for name, fn in ((f"decode step ({inst.slots} slots)", step),
                     (f"prefill S{prefill_len}", prefill)):
        wall_ms, dev_ms = time_ms(fn, iters=10, warmup=2), device_ms(fn, iters=5)
        print(f"[{tag}] {name}: {wall_ms:.2f} ms per call, device {_ms(dev_ms)} ms "
              f"(busy {dev_ms / wall_ms:.1%})" if dev_ms else
              f"[{tag}] {name}: {wall_ms:.2f} ms per call, device not measured")


def phase_engine_mamba():
    """falcon_mamba_7b at full width and depth in bfloat16 through the Engine."""
    from repro_torch.core.types import Request

    engine, insts, launches, *_ = _serve_image("falcon_mamba_7b", "ssm-gen", "engine-ssm")
    check(launches["mamba_scan"] > 0, "the engine never launched mamba_scan")
    check(launches["flash_attention"] == launches["decode_attention"]
          == launches["grouped_matmul"] == 0,
          "an attention or MoE kernel ran in falcon_mamba_7b (attention-free, no MoE)")
    check(launches["mamba_scan_bwd"] == 0, "the engine ran the scan's backward (B3b)")
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

    engine, insts, launches, calls, *_ = _serve_image("moonshot_v1_16b", "moe-gen",
                                                      "engine-moe")
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
    check(launches["grouped_matmul_dx"] == launches["grouped_matmul_dw"] == 0,
          "the engine ran the grouped matmul's backward (B4b)")
    _time_model_calls(insts[0], "engine-moe")
    _profile_engine(engine, Request, "moe-gen", "moonshot_v1_16b", (4, 9, 14, 19),
                    ("gmm_tc_kernel", "flash_fwd_tc_kernel", "decode_kernel",
                     "decode_combine_kernel"))
    return {"grouped_matmul": launches["grouped_matmul"]}


def phase_engine_gemma3():
    """gemma3_12b at full width and depth in bfloat16 through the Engine:
    ``max_len`` 2048, prompts of 1100-1500 tokens (bucketed to 2048), so
    every local layer's cache is a ring of 1024 that wraps. B1 must run on
    every layer of every prefill, windowed (40 layers) and global (8); B2 on
    every layer of every decode step, the local rings by the split route."""
    from repro_torch.configs import get_config
    from repro_torch.core.types import Request

    cfg = get_config("gemma3_12b")
    engine, insts, launches, calls, kinds, timed = _serve_image(
        "gemma3_12b", "gemma-gen", "engine-gemma3", max_len=2048, prompt=(1100, 1501))
    layers, W, hd = cfg.num_layers, cfg.sliding_window, cfg.head_dim
    local = sum(cfg.is_local_attn(i) for i in range(layers))
    pf, dc = calls["prefill"], calls["decode_step"]
    want = {f"B1 hd{hd} window {W}": local * pf, f"B1 hd{hd} causal": (layers - local) * pf,
            f"B2 hd{hd} W{W} ring split": local * dc,
            f"B2 hd{hd} W2048 no ring split": (layers - local) * dc}
    print(f"[engine-gemma3] reckoned: B1 {layers} layers x {pf} prefills ({local} windowed, "
          f"{layers - local} global), B2 {layers} layers x {dc} decode steps: {want}")
    check(kinds == want, f"attention calls by kind {kinds}, not the reckoned {want}")
    check(launches["flash_attention"] == layers * pf
          and launches["decode_attention"] == layers * dc,
          f"B1/B2 launched {launches['flash_attention']}/{launches['decode_attention']} "
          f"times, not {layers * pf}/{layers * dc}")
    check(launches["mamba_scan"] == launches["grouped_matmul"] == 0,
          "a Mamba or MoE kernel ran in gemma3_12b")
    warm, *served = timed["prefill"]
    check(warm[0] == 16 and all(n == 2048 for n, _ in served),
          f"prefill lengths {[n for n, _ in timed['prefill']]}: not the warm-up's 16, then 2048")
    print(f"[engine-gemma3] prefills (tokens, s): warm-up {warm[0]} {warm[1]:.3f} s, the first "
          f"long prefill (the first call at its bucket) {served[0][1]:.3f} s, the rest "
          f"{[round(t, 3) for _, t in served[1:]]}")
    steps = timed["decode_step"][1:]               # the warm-up's decode step apart
    gen = 4 * len(served)                          # each request's 4 decoded tokens
    dec_s = sum(t for _, t in steps)
    print(f"[engine-gemma3] decode: {gen} tokens in {len(steps)} steps of "
          f"{insts[0].slots} slots, {dec_s:.3f} s of decode steps: "
          f"{gen / dec_s:.1f} tokens/s, {dec_s / len(steps) * 1e3:.1f} ms a step")
    _time_model_calls(insts[0], "engine-gemma3", prefill_len=2048)
    _profile_engine(engine, Request, "gemma-gen", "gemma3_12b", (1100, 1250, 1400, 1500),
                    ("flash_fwd_tc_kernel", "decode_kernel", "decode_combine_kernel"))
    return {}


def phase_phi3_vision(B=2, S=640, max_len=1024, steps=4):
    """phi3_vision at full width and depth in bfloat16: ``LM.prefill`` of a
    batch of 2 whose first 576 positions are patch embeddings (drawn from a
    seeded generator) and whose tokens fill the sequence to 640; the same
    prefill with every patch embedding moved by 1.0 must give other logits;
    then 4 greedy ``decode_step``s against a ``SlotCache`` holding both rows.
    B1 at hd 96 once per layer per prefill, B2 once per layer per step."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.models import LM
    from repro_torch.serving.engine import weight_seed
    from repro_torch.serving.kv_cache import SlotCache

    cfg = get_config("phi3_vision")
    P, D, L = cfg.num_patches, cfg.d_model, cfg.num_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    lm = LM(cfg, device="cuda", seed=weight_seed(cfg.name))
    torch.cuda.synchronize()
    materialize = time.perf_counter() - t
    gen = torch.Generator(device="cuda").manual_seed(23)
    patches = torch.randn((B, P, D), generator=gen, device="cuda").to(torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda",
                           dtype=torch.int32)
    wrappers = _wrappers()
    with _attention_kinds() as kinds:
        for w in wrappers.values():
            w.launches = 0
        t = time.perf_counter()
        logits, pcache = lm.prefill({"tokens": tokens, "patch_embeds": patches})
        torch.cuda.synchronize()
        first = time.perf_counter() - t
        moved, _ = lm.prefill({"tokens": tokens, "patch_embeds": patches + 1.0})
        kv = SlotCache(lm, B, max_len)
        for b in range(B):
            kv.admit(b, {"slots": [{n: c[:, b:b + 1] for n, c in sl.items()}
                                   for sl in pcache["slots"]]}, S, b, steps)
        out, lg = [], logits
        for _ in range(steps):
            tok = lg.argmax(-1).to(torch.int32)
            out.append(tok)
            lg, kv.cache = lm.decode_step(kv.cache, {"token": tok, "pos": kv.positions()})
            check(bool(torch.isfinite(lg.float()).all()), "phi3_vision decode logits not finite")
            kv.advance()
        torch.cuda.synchronize()
        launches = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    check(tuple(logits.shape) == (B, cfg.vocab_size) and bool(torch.isfinite(logits.float()).all()),
          f"phi3_vision prefill logits {tuple(logits.shape)} not finite")
    diff = (moved.float() - logits.float()).abs().max().item()
    check(diff > 0, "moving the patch embeddings left the logits as they were")
    hd = cfg.head_dim
    route = dec.decode_route(B, cfg.num_kv_heads, max_len, hd, 2)[0]
    want = {f"B1 hd{hd} causal": 2 * L, f"B2 hd{hd} W{max_len} no ring {route}": steps * L}
    check(kinds == want and launches["flash_attention"] == 2 * L
          and launches["decode_attention"] == steps * L,
          f"attention calls {kinds}, launches {launches}: not the reckoned {want}")
    check(launches["mamba_scan"] == launches["grouped_matmul"] == 0,
          "a Mamba or MoE kernel ran in phi3_vision")
    print(f"[phi3] phi3_vision {cfg.dtype}, {L} layers, {cfg.param_count() / 1e9:.2f} B "
          f"parameters, materialized in {materialize:.3f} s; prefill of B{B} S{S} ({P} patch "
          f"embeddings + {S - P} tokens) {first:.3f} s (its first call); logits finite, moved "
          f"by up to {diff:.3e} when the patch embeddings move by 1.0; {steps} greedy decode "
          f"steps, tokens {torch.stack(out, 1).tolist()}")
    print(f"[phi3] kernel launches {launches}; by kind {kinds} (reckoned {want}); peak "
          f"device memory {peak / 2**30:.2f} GiB")
    prefill = lambda: lm.prefill({"tokens": tokens, "patch_embeds": patches})
    step = lambda: lm.decode_step(kv.cache, {"token": out[-1], "pos": kv.positions()})
    for name, fn in ((f"decode step ({B} slots, W{max_len})", step),
                     (f"prefill B{B} S{S}", prefill)):
        wall_ms, dev_ms = time_ms(fn, iters=10, warmup=2), device_ms(fn, iters=5)
        print(f"[phi3] {name}: {wall_ms:.2f} ms per call, device "
              + (f"{dev_ms:.2f} ms (busy {dev_ms / wall_ms:.1%})" if dev_ms else "not measured"))
    return {}


def phase_train_hubert(steps=10, batch=8, seq=1024, profiled=2):
    """hubert_xlarge at full width and depth in bfloat16 through the port's
    trainer (AdamW, f32 state, ``remat`` as the config has it, its 4
    microbatches): 10 steps on one fixed batch of 8 x 1024 frames with
    labels and a loss mask, drawn from a seeded generator. The loss falls;
    B1 with its logsumexp runs twice per layer per microbatch (remat's
    recompute) and B1b once."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.schedule import warmup_cosine
    from repro_torch.train.trainer import make_train_step

    cfg = get_config("hubert_xlarge")
    micro = cfg.grad_accum
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lm = LM(cfg, device="cuda", seed=0)
    opt = make_optimizer("adamw", warmup_cosine(1e-3, 2, steps), cfg)
    params = {n: p.detach() for n, p in lm.params().items()}
    state, step = opt.init(params), make_train_step(lm, opt)
    gen = torch.Generator(device="cuda").manual_seed(31)
    data = {"frames": torch.randn((batch, seq, cfg.d_model), generator=gen,
                                  device="cuda").to(torch.bfloat16),
            "labels": torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                                    device="cuda"),
            "loss_mask": (torch.rand((batch, seq), generator=gen, device="cuda") < 0.8).float()}
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    losses, took = [], []
    for _ in range(steps):
        t = time.perf_counter()
        params, state, m = step(params, state, data)
        losses.append(float(m["loss"]))           # to the host: the step has ended
        took.append(time.perf_counter() - t)
    launches = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = np.asarray(losses)
    check(np.isfinite(losses).all(), f"hubert losses {losses}")
    first, last = losses[:3].mean(), losses[-3:].mean()
    print(f"[train-hubert] hubert_xlarge {cfg.dtype}, {cfg.num_layers} layers, "
          f"{cfg.param_count() / 1e9:.3f} B parameters, {steps} steps of {batch} x {seq} frames "
          f"({micro} microbatches): loss {losses[0]:.4f} -> {losses[-1]:.4f}, mean of the "
          f"first 3 {first:.4f}, of the last 3 {last:.4f}; losses {np.round(losses, 4).tolist()}")
    check(last < first, f"the loss did not fall: first 3 {first:.4f}, last 3 {last:.4f}")
    fwd = cfg.num_layers * micro * steps
    want = {**_no_launches(), "flash_attention": 2 * fwd, "flash_attention_bwd": fwd}
    print(f"[train-hubert] kernel launches {launches}; reckoned: B1 (with lse) "
          f"{cfg.num_layers} layers x {micro} microbatches x {steps} steps x 2 (remat) = "
          f"{2 * fwd}, B1b {fwd}")
    check(launches == want, f"launches {launches} are not the reckoned {want}")
    steady = float(np.mean(took[2:]))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            params, state, m = step(params, state, data)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values()) / profiled
    print(f"[train-hubert] steady step (steps 3-{steps}): {steady * 1e3:.1f} ms wall, "
          f"{busy:.1f} ms device ({busy / (steady * 1e3):.1%} busy), "
          f"{batch * seq / steady:.0f} tokens/s; first step {took[0] * 1e3:.1f} ms; peak "
          f"device memory {peak / 2**30:.2f} GiB; device time by kernel, per step:")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"[train-hubert]   {ms / profiled:8.3f} ms {ms / profiled / busy:6.1%}  {name[:90]}")
    from repro_torch.kernels.flash_attention_bwd import KERNELS
    bwd = [n for names in KERNELS.values() for n in names]
    for label, names in (("B1b", bwd), ("B1", ["flash_fwd"])):
        ms = sum(v for k, v in by_name.items() if any(n in k for n in names)) / profiled
        print(f"[train-hubert]   {ms:8.3f} ms {ms / busy:6.1%}  {label} (port)")
    return {}


def _train_cut(arch, layers, tag, want_fn, steps=10, batch=8, seq=1024, micro=2, rerun=3,
               profiled=2, kernels=()):
    """``arch`` at full width cut to ``layers`` layers, bf16 with f32 AdamW and
    ``remat`` as the config has them, through the port's trainer: ``rerun``
    steps from the seed's weights, then ``steps`` steps from the same weights
    and batches (8 x 1024 tokens of the seeded stream, 2 microbatches) with
    every launch count set to 0 just before and read just after. The loss is
    finite and falls, the first ``rerun`` losses of the two runs are
    bit-equal, and the launches are ``want_fn(cfg, steps, micro)``. Then
    ``profiled`` steps under the profiler: steady step ms (wall, device),
    tokens/s, busy share, peak memory, the largest kernels and the port's
    ``kernels`` (label, CUDA kernel names). Returns (lm, params, batches,
    launches)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.models import LM
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.schedule import warmup_cosine
    from repro_torch.train.trainer import make_train_step

    full = get_config(arch)
    cfg = replace(full, num_layers=layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = LM(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    drawn = time.perf_counter() - t0
    opt = make_optimizer("adamw", warmup_cosine(1e-3, 2, steps), cfg)
    step = make_train_step(lm, opt, accum=micro)
    start = {n: p.detach().clone() for n, p in lm.params().items()}
    stream = TokenStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                                    seed=0))
    batches = [stream.batch(i) for i in range(steps + profiled)]

    def run(n):
        params = {k: v.clone() for k, v in start.items()}
        state, losses, took = opt.init(params), [], []
        for b in batches[:n]:
            t = time.perf_counter()
            params, state, m = step(params, state, b)
            losses.append(float(m["loss"]))          # to the host: the step has ended
            took.append(time.perf_counter() - t)
        return params, state, losses, took

    _, _, first, _ = run(rerun)
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    params, state, losses, took = run(steps)
    launches = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    check(first == losses[:rerun], f"{arch}: steps 1-{rerun} run twice from the same weights "
                                   f"and batches gave {first} and {losses[:rerun]}")
    losses = np.asarray(losses)
    check(np.isfinite(losses).all(), f"{arch} losses {losses}")
    head, tail = losses[:3].mean(), losses[-3:].mean()
    print(f"[{tag}] {arch} {cfg.dtype} cut to {layers} of {full.num_layers} layers at full "
          f"width: {cfg.param_count() / 1e9:.3f} B parameters (the whole model "
          f"{full.param_count() / 1e9:.2f} B), drawn in {drawn:.1f} s; {steps} steps of "
          f"{batch} x {seq} tokens ({micro} microbatches): loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, mean of the first 3 {head:.4f}, of the last 3 {tail:.4f}; losses "
          f"{np.round(losses, 4).tolist()}")
    check(tail < head, f"the loss did not fall: first 3 {head:.4f}, last 3 {tail:.4f}")
    print(f"[{tag}] steps 1-{rerun} run twice from the same weights and batches: losses "
          f"bit-equal ({first})")
    want = want_fn(cfg, steps, micro)
    print(f"[{tag}] kernel launches {launches}; reckoned {want}")
    check(launches == want, f"launches {launches} are not the reckoned {want}")
    steady = float(np.mean(took[2:]))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for b in batches[steps:]:
            params, state, m = step(params, state, b)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values()) / profiled
    print(f"[{tag}] steady step (steps 3-{steps}): {steady * 1e3:.1f} ms wall, {busy:.1f} ms "
          f"device ({busy / (steady * 1e3):.1%} busy), {batch * seq / steady:.0f} tokens/s; "
          f"first step {took[0] * 1e3:.1f} ms; peak device memory {peak / 2**30:.2f} GiB "
          f"({peak / cfg.param_count():.1f} bytes a parameter); device time by kernel, per "
          f"step:")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[{tag}]   {ms / profiled:8.3f} ms {ms / profiled / busy:6.1%}  {name[:90]}")
    for label, names in kernels:
        ms = sum(v for k, v in by_name.items() if any(n in k for n in names)) / profiled
        print(f"[{tag}]   {ms:8.3f} ms {ms / busy:6.1%}  {label} (port)")
    return lm, params, batches, launches


def _no_launches():
    """0 launches for every kernel wrapper."""
    return dict.fromkeys(_wrappers(), 0)


def phase_train_falcon():
    """Phase 12: falcon_mamba_7b at full width cut to 8 layers (1.11 B
    parameters; the whole 7.27 B need ~116 GB for bf16 weights, gradients
    and f32 AdamW moments alone), 10 steps: B3 (with its chunk states) twice
    per layer per microbatch (the forward and remat's recompute), B3b once."""
    def want(cfg, steps, micro):
        fwd = cfg.num_layers * micro * steps
        return {**_no_launches(), "mamba_scan": 2 * fwd, "mamba_scan_bwd": fwd}
    _, _, _, launches = _train_cut("falcon_mamba_7b", 8, "train-falcon", want,
                                   kernels=(("B3", ("mamba_scan_kernel",)),
                                            ("B3b", ("mamba_scan_bwd_kernel",
                                                     "mamba_scan_bwd_sum_kernel"))))
    return {n: launches[n] for n in ("mamba_scan_bwd",)}


def phase_train_moonshot():
    """Phase 13: moonshot_v1_16b at full width cut to 2 layers (1.48 B
    parameters of the whole 27.7 B), 10 steps: per layer per microbatch B4
    6 times (3 products, forward and remat's recompute), B4b's dx and dW 3
    times each, B1 with its logsumexp twice and B1b once. Then the CE beside
    the aux loss, the share of assignments dropped by capacity and of padding
    rows in the layout, and what the router sees, on a microbatch of the
    stream and on one of uniform tokens."""
    import torch

    from repro_torch.kernels.flash_attention_bwd import KERNELS
    from repro_torch.models import moe as tmoe

    def want(cfg, steps, micro):
        fwd = cfg.num_layers * micro * steps
        return {**_no_launches(), "grouped_matmul": 6 * fwd, "grouped_matmul_dx": 3 * fwd,
                "grouped_matmul_dw": 3 * fwd, "flash_attention": 2 * fwd,
                "flash_attention_bwd": fwd}
    bwd = tuple(n for names in KERNELS.values() for n in names)
    lm, params, batches, launches = _train_cut(
        "moonshot_v1_16b", 2, "train-moe", want,
        kernels=(("B4 (forward)", ("gmm_tc_kernel<128, false>",)),
                 ("B4b dx", ("gmm_dx_wgmma_kernel",)), ("B4b dW", ("gmm_dw_wgmma_kernel",)),
                 ("B1", ("flash_fwd",)), ("B1b", bwd)))
    E, k, vocab = lm.cfg.moe.num_experts, lm.cfg.moe.top_k, lm.cfg.vocab_size
    route0, build0 = tmoe.route, tmoe.build_layout
    seen = []

    def routed(x, router, cfg):
        # what the router sees: the spread of its logits over the experts,
        # and the share of its input's energy that all tokens have in common
        eidx, gate = route0(x, router, cfg)
        x32 = x.float().reshape(-1, x.shape[-1])
        load = torch.bincount(eidx.reshape(-1), minlength=E)
        seen.append({"experts": int((load > 0).sum()),
                     "top_k_share": load.topk(k).values.sum().item() / eidx.numel(),
                     "logit_std": (x32 @ router.float()).std(-1).mean().item(),
                     "common": (x32.mean(0).square().sum() / x32.square().sum(1).mean()).item()})
        return eidx, gate

    def counted(eidx, gate, C, block_t, num_experts, experts=None):
        lay = build0(eidx, gate, C, block_t, num_experts, experts)
        kept = int((lay.token_rows < lay.row_token.numel()).sum())
        seen[-1].update(kept=kept, assigned=eidx.numel(), rows=lay.row_token.numel())
        return lay

    half = {n: torch.as_tensor(v[:4], device="cuda") for n, v in batches[0].items()}
    g = torch.Generator(device="cuda").manual_seed(13)
    uniform = torch.randint(2, vocab, (4, half["tokens"].shape[1] + 1), generator=g,
                            device="cuda", dtype=half["tokens"].dtype)
    inputs = {"the stream's": half, "uniform": {"tokens": uniform[:, :-1],
                                                 "labels": uniform[:, 1:]}}
    tmoe.route, tmoe.build_layout = routed, counted
    try:
        for what, b in inputs.items():
            seen.clear()
            with torch.no_grad():
                loss, met = lm.loss_fn(params, b)
            top = torch.bincount(b["tokens"].reshape(-1).long()).max().item() / b["tokens"].numel()
            dropped = 1 - sum(r["kept"] for r in seen) / sum(r["assigned"] for r in seen)
            print(f"[train-moe] after training, {what} tokens, a microbatch of "
                  f"{b['tokens'].shape[0]} x {b['tokens'].shape[1]} (its "
                  f"most frequent id {top:.2%} of tokens): loss {float(loss):.4f} = CE "
                  f"{float(met['ce']):.4f} + 0.01 x aux {float(met['aux']):.4f}; assignments "
                  f"dropped by capacity {dropped:.2%}")
            for i, r in enumerate(seen):
                drop, pad = 1 - r["kept"] / r["assigned"], 1 - r["kept"] / r["rows"]
                print(f"[train-moe]   MoE layer {i}: {r['experts']} of {E} experts chosen, the "
                      f"{k} busiest take {r['top_k_share']:.2%} of the assignments; router "
                      f"logits' std over experts {r['logit_std']:.4f}; common share of the "
                      f"router input {r['common']:.4f}; dropped {drop:.2%}; padding "
                      f"{pad:.2%} of the {r['rows']} rows of B4 and B4b")
    finally:
        tmoe.route, tmoe.build_layout = route0, build0
    return {n: launches[n] for n in ("grouped_matmul_dx", "grouped_matmul_dw")}


MESH_ARGS = ["--arch", "train_100m", "--seq", "1024", "--batch", "8", "--accum", "2",
             "--ckpt-every", "5"]
# phase 7's train cuts: (arch, layers, S) at full width, f32, 2 x S tokens
MESH_CUTS = (("falcon_mamba_7b", 2, 128), ("moonshot_v1_16b", 1, 64))
MESH_KERNELS = ("flash_attention", "flash_attention_bwd", "mamba_scan", "mamba_scan_bwd",
                "grouped_matmul", "grouped_matmul_dx", "grouped_matmul_dw",
                "decode_attention_partial")


def phase_train_mesh():
    """Phase 14: the mesh path of training on a one-rank NCCL group and a
    ``(1, 1)`` mesh, against the plain path; returns each kernel's launches
    on the mesh path (the counts set to 0 just before each meshed run and
    read just after)."""
    import os
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.launch import train
    from repro_torch.launch.mesh import init_process_group

    plain = train.main(MESH_ARGS + ["--steps", "10"])     # before the group: plain tensors
    dev = init_process_group()
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          f"process group {dist.get_backend()} of {dist.get_world_size()}")
    wrappers = _wrappers()
    counts = dict.fromkeys(wrappers, 0)

    def counted(fn):
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        out = fn()
        torch.cuda.synchronize()
        for n, w in wrappers.items():
            counts[n] += w.launches
        return out

    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "mesh")
        meshed = counted(lambda: train.main(MESH_ARGS + ["--steps", "10", "--ckpt", ck]))
        _same_run("train_100m bf16, 10 steps of 8 x 1024 tokens", meshed, plain)
        check(sorted(os.listdir(ck)) == ["step_000000005", "step_000000010"],
              f"checkpoints {sorted(os.listdir(ck))}")
        with open(os.path.join(ck, "step_000000005", "MANIFEST.json")) as f:
            leaves = json.load(f)["leaves"]
        shutil.rmtree(os.path.join(ck, "step_000000010"))
        resumed = counted(lambda: train.main(MESH_ARGS + ["--steps", "5", "--ckpt", ck]))
        check(resumed["start"] == 5 and resumed["losses"] == meshed["losses"][5:],
              f"resumed at {resumed['start']}: {resumed['losses']} != {meshed['losses'][5:]}")
        print(f"[mesh] sharded checkpoint at step 5 ({len(leaves)} leaves, "
              f"{sum(len(v['shards']) for v in leaves.values())} shard files on this mesh), "
              f"restored on the mesh: steps 6-10 equal the uninterrupted run's bit for bit")
    for arch, layers, S in MESH_CUTS:
        _mesh_cut(arch, layers, S, counted)
        gc.collect()
        torch.cuda.empty_cache()
    _mesh_decode(counted)
    launches = {n: counts[n] for n in MESH_KERNELS}
    print(f"[mesh] kernel launches on the mesh path {launches}")
    check(all(launches.values()), f"a kernel of the mesh path was not launched: {launches}")
    _mesh_steady()
    dist.destroy_process_group()
    print(f"[mesh] device {dev}; process group destroyed")
    return counts


def _same_run(name, meshed, plain):
    """The mesh path's losses and gradient norms against the plain path's:
    bit-equal, or within 2e-3 with the gap printed."""
    gaps = {k: max(abs(a - b) for a, b in zip(meshed[k], plain[k]))
            for k in ("losses", "grad_norms")}
    equal = all(meshed[k] == plain[k] for k in gaps)
    print(f"[mesh] {name}: mesh vs plain path losses {[round(x, 6) for x in meshed['losses']]}"
          f"; {'bit-equal' if equal else 'not bit-equal'} (max gaps: losses "
          f"{gaps['losses']:.3e}, grad norms {gaps['grad_norms']:.3e})")
    check(max(gaps.values()) <= TRAIN_TOL, f"{name}: mesh vs plain gaps {gaps}")


def _mesh_cut(arch, layers, S, counted, steps=3):
    """3 f32 steps of phase 7's cut of ``arch``, mesh path then plain path,
    from the same weights and batches."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import setup_training
    from repro_torch.models import LM
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.schedule import warmup_cosine

    cfg = replace(get_config(arch), dtype="float32", num_layers=layers)
    lm = LM(cfg, device="cuda", seed=11, attn_block=64)
    stream = TokenStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=2,
                                    seed=0))
    batches = [stream.batch(i) for i in range(steps)]
    mesh = make_local_mesh(model_axis=1)
    recs, last = {}, {}
    for path in ("mesh", "plain"):
        opt = make_optimizer("adamw", warmup_cosine(3e-3, 20, steps), cfg)
        params, state, step, ctx, _ = setup_training(
            lm, opt, mesh if path == "mesh" else None, rows=1, seq=S, accum=2)

        def run(params=params, state=state):
            rec = {"losses": [], "grad_norms": []}
            with ctx:
                for b in batches:
                    params, state, m = step(params, state, b)
                    rec["losses"].append(float(m["loss"]))
                    rec["grad_norms"].append(float(m["grad_norm"]))
            return rec, params
        recs[path], p = counted(run) if path == "mesh" else run()
        last[path] = {n: (t.full_tensor() if hasattr(t, "full_tensor") else t) for n, t in
                      p.items()}
    _same_run(f"{arch} cut to {layers} layer{'s' * (layers > 1)}, f32, {steps} steps of 2 x "
              f"{S} tokens", recs["mesh"], recs["plain"])
    err = max((last["mesh"][n] - last["plain"][n]).abs().max().item() for n in last["plain"])
    print(f"[mesh]   parameters after {steps} steps: mesh vs plain max_abs_err {err:.3e}")
    check(np.isfinite(err) and err <= TRAIN_TOL, f"{arch} parameters mesh vs plain {err}")


def _mesh_decode(counted, B=4, prompt=16, W=64, steps=4):
    """``tiny_lm`` at full width in float32 on the ``(1, 1)`` mesh, its
    cache's slots split over ``model`` (one rank: every slot its range):
    ``LM.decode_step`` after a prefill, the attention on B2's partial route
    (flash-decoding across the slot ranks, here one), against the same
    steps on plain tensors (B2's whole call): logits within 2e-3, greedy
    tokens equal, B2's partial route launched once a layer a step."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import NamedSharding, place
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import LM

    cfg = replace(get_config("tiny_lm"), dtype="float32")
    lm = LM(cfg, device="cuda", seed=5)
    mesh = make_local_mesh(model_axis=1)
    tokens = torch.randint(0, cfg.vocab_size, (B, prompt),
                           generator=torch.Generator().manual_seed(5)).cuda()
    with torch.no_grad():
        logits, pre = lm.prefill({"tokens": tokens})
        cache = lm.init_cache(B, W)
        for sb, sp in zip(cache["slots"], pre["slots"]):
            for n, t in sb.items():
                t[:, :, :prompt].copy_(sp[n])
        params = {n: place(p.detach(), NamedSharding(mesh, ())) for n, p in lm.params().items()}
        dcache = {"slots": [{n: place(t.clone(), NamedSharding(mesh, (None, None, "model")))
                             for n, t in sl.items()} for sl in cache["slots"]]}
        placements = sorted({repr(tuple(t.placements)) for sl in dcache["slots"]
                             for t in sl.values()})
        tok, err, n = logits.argmax(-1), 0.0, 0
        for i in range(steps):
            batch = {"token": tok, "pos": torch.full((B,), prompt + i, device="cuda")}
            want, cache = lm.decode_step(cache, batch)
            # counted() sets every count to 0 before the step: read this step's
            got, dcache = counted(lambda: lm.decode_step(dcache, batch, params=params))
            n += dec.decode_attention_partial.launches
            got = got.full_tensor() if hasattr(got, "full_tensor") else got
            err = max(err, (got - want).abs().max().item())
            check(torch.equal(got.argmax(-1), want.argmax(-1)),
                  f"mesh decode step {i}: greedy tokens differ")
            tok = want.argmax(-1)
    print(f"[mesh] tiny_lm f32 decode on the mesh, cache {placements} (slots on model): "
          f"{steps} steps against the plain path, logits max_abs_err {err:.3e} (tol "
          f"{LOGIT_TOL:g}); B2's partial route launched {n} times "
          f"({cfg.num_layers} layers x {steps} steps)")
    check(err <= LOGIT_TOL and n == cfg.num_layers * steps,
          f"mesh decode: err {err}, partial launches {n}")


def _mesh_steady(warm=2, timed=5, profiled=3):
    """A steady train step of train_100m on the plain path and the mesh path,
    in the order plain, mesh, mesh, plain: wall ms to a synchronize and
    device ms from the profiler."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import setup_training
    from repro_torch.models import LM
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.schedule import warmup_cosine

    cfg = get_config("train_100m")
    lm = LM(cfg, device="cuda", seed=0, attn_block=TRAIN_BLOCK)
    mesh = make_local_mesh(model_axis=1)
    stream = TokenStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=1024, global_batch=8))
    batches = [stream.batch(i) for i in range(warm + timed + profiled)]
    out = {"plain": [], "mesh": []}
    for path in ("plain", "mesh", "mesh", "plain"):
        opt = make_optimizer("adamw", warmup_cosine(3e-3, 20, 100), cfg)
        params, state, step, ctx, _ = setup_training(
            lm, opt, mesh if path == "mesh" else None, rows=4, seq=1024, accum=2)
        with ctx:
            for b in batches[:warm]:
                params, state, _ = step(params, state, b)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for b in batches[warm:warm + timed]:
                params, state, _ = step(params, state, b)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) / timed * 1e3
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for b in batches[warm + timed:]:
                    params, state, _ = step(params, state, b)
                torch.cuda.synchronize()
        busy = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == DeviceType.CUDA) / 1e3 / profiled
        out[path].append((wall, busy))
        print(f"[mesh] steady step of train_100m (8 x 1024 tokens, 2 microbatches), {path} "
              f"path: {wall:.1f} ms wall, {busy:.1f} ms device ({busy / wall:.1%} busy)")
        del params, state
    pw, pd = (float(np.mean([x[i] for x in out["plain"]])) for i in (0, 1))
    mw, md = (float(np.mean([x[i] for x in out["mesh"]])) for i in (0, 1))
    print(f"[mesh] mean of two runs each: plain {pw:.1f} ms wall, {pd:.1f} ms device; mesh "
          f"{mw:.1f} ms wall, {md:.1f} ms device: the mesh path's host cost {mw - pw:+.1f} ms "
          f"a step ({mw / pw:.2f}x the wall), device {md - pd:+.1f} ms")


MEM_BAND = 0.01      # the memory counter against max_memory_allocated, above the step's start
                     # (measured 0.00-0.03% apart, H100 80GB HBM3 at 700 W)
POD_SCHEMES = (("int8", 0.05), ("topk", 0.05))


def phase_compression_roofline(steps=10):
    """Phase 15: ``train_100m`` trained with the cross-pod gradient sync on a
    one-rank ``(1, 1, 1)`` mesh, each scheme; the roofline's memory counter
    on a real step. Returns each kernel's launches over the two runs (the
    counts set to 0 just before each run and read just after)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.distributed import compression as C
    from repro_torch.launch.mesh import init_process_group
    from repro_torch.launch.train import setup_training
    from repro_torch.models import LM
    from repro_torch.telemetry import roofline as R
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.schedule import warmup_cosine

    init_process_group()
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          f"process group {dist.get_backend()} of {dist.get_world_size()}")
    mesh = init_device_mesh("cuda", (1, 1, 1), mesh_dim_names=("pod", "data", "model"))
    print(f"[pod] on {nvidia_smi()}; a (1, 1, 1) (pod, data, model) mesh of one NCCL rank")
    cfg = get_config("train_100m")
    flops = R.model_flops(cfg, ShapeConfig("step", 1024, 8, "train"))
    stream = TokenStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=1024, global_batch=8))
    batches = [stream.batch(i) for i in range(steps)]
    wrappers = _wrappers()
    counts = dict.fromkeys(wrappers, 0)
    for scheme, frac in POD_SCHEMES:
        sync = C.make_pod_grad_sync(mesh, scheme, frac)
        st = {"err": None, "first": None, "wall": [], "device": []}

        def transform(grads, sync=sync, st=st, scheme=scheme, frac=frac):
            if st["err"] is None:
                st["err"] = {n: torch.zeros_like(g, dtype=torch.float32) for n, g in grads.items()}
                cpu = ({n: g.cpu() for n, g in grads.items()},
                       {n: e.cpu() for n, e in st["err"].items()})
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t = time.perf_counter()
            ev[0].record()
            with torch.profiler.record_function("pod_sync"):
                synced, st["err"] = sync(grads, st["err"])
            ev[1].record()
            torch.cuda.synchronize()
            st["wall"].append((time.perf_counter() - t) * 1e3)
            st["device"].append(ev[0].elapsed_time(ev[1]))
            if st["first"] is None:
                st["first"] = _pod_sync_on_the_cpu(C, scheme, frac, *cpu), (
                    {n: g.cpu() for n, g in synced.items()},
                    {n: e.cpu() for n, e in st["err"].items()})
            return synced

        lm = LM(cfg, device="cuda", seed=0, attn_block=TRAIN_BLOCK)
        opt = make_optimizer("adamw", warmup_cosine(3e-3, 20, 100), cfg)
        params, state, step, _, _ = setup_training(lm, opt, None, rows=4, seq=1024, accum=2,
                                                   grad_transform=transform)
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        losses = []
        for b in batches:
            params, state, m = step(params, state, b)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        for n, w in wrappers.items():
            counts[n] += w.launches
        busy = _step_device_ms(step, params, state, batches[-1])
        check(busy["step"] > 0, "the profiler saw no kernel of the step")
        (want_s, want_e), (got_s, got_e) = st["first"]
        equal = all(torch.equal(got_s[n], want_s[n]) and torch.equal(got_e[n], want_e[n])
                    for n in want_s)
        wall, dev = float(np.mean(st["wall"][1:])), float(np.mean(st["device"][1:]))
        print(f"[pod] train_100m with the {scheme} pod sync ({len(want_s)} leaves, error carried): "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; first step synced gradients and new "
              f"errors {'bit-equal' if equal else 'NOT bit-equal'} to the CPU's on its copy")
        print(f"[pod]   the sync: {wall:.2f} ms a step wall, {dev:.2f} ms device (CUDA events, "
              f"mean of steps 2-{steps}); a steady step {busy['step']:.1f} ms device, the sync "
              f"{busy['sync']:.2f} ms of it (profiler); MFU {flops / (busy['step'] / 1e3) / PEAK_FLOPS:.1%} "
              f"({flops / 1e12:.2f} TFLOP a step over {PEAK_FLOPS / 1e12:.0f} TFLOP/s)")
        check(np.isfinite(losses).all() and np.mean(losses[-3:]) < np.mean(losses[:3]),
              f"{scheme}: the loss did not fall: {losses}")
        check(equal, f"{scheme}: the card's first sync differs from the CPU's")
        del params, state, lm
        gc.collect()
        torch.cuda.empty_cache()
    launches = {n: counts[n] for n in ("flash_attention", "flash_attention_bwd")}
    print(f"[pod] kernel launches over both runs {launches}")
    check(all(launches.values()), f"a kernel of the path was not launched: {launches}")
    _memory_counter(cfg, batches[0])
    dist.destroy_process_group()
    return counts


def _pod_sync_on_the_cpu(C, scheme, frac, grads, err):
    """What the sync gives on one pod, by the module's functions on the CPU."""
    synced, new_err = {}, {}
    for n, g in grads.items():
        if scheme == "int8":
            q, scale, new_err[n] = C.ef_compress_int8(g, err[n])
            total = C.dequantize_int8(q, scale)
        else:
            total, new_err[n] = C.ef_compress_topk(g, err[n], frac)
        synced[n] = (total / total.new_tensor(1)).to(g.dtype)
    return synced, new_err


def _step_device_ms(step, params, state, batch):
    """One more step under the profiler: the device ms of its kernels, and of
    those under the ``pod_sync`` range."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(params, state, batch)
        torch.cuda.synchronize()
    total = sum(e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == DeviceType.CUDA) / 1e3
    sync = sum(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
               for e in prof.key_averages() if e.key == "pod_sync") / 1e3
    return {"step": total, "sync": sync}


def _memory_counter(cfg, batch):
    """The roofline's memory counter on one real train_100m step against the
    allocator's peak from a reset: each above what was allocated when the
    step began (the arguments, and anything else on the card)."""
    import torch

    from repro_torch.launch.train import setup_training
    from repro_torch.models import LM
    from repro_torch.telemetry import roofline as R
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.schedule import warmup_cosine

    lm = LM(cfg, device="cuda", seed=0, attn_block=TRAIN_BLOCK)
    opt = make_optimizer("adamw", warmup_cosine(3e-3, 20, 100), cfg)
    params, state, step, _, _ = setup_training(lm, opt, None, rows=4, seq=1024, accum=2)
    params, state, _ = step(params, state, batch)          # warm: workspaces, first calls
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mem = R.count_memory((params, state))
    with mem:
        out = step(params, state, batch)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counted, allocated = mem.peak - mem.argument_bytes, peak - base
    gap = abs(counted - allocated) / allocated
    print(f"[roofline] memory of one train_100m step (8 x 1024 tokens, 2 microbatches): the "
          f"counter's peak {mem.peak / 2**30:.3f} GiB (arguments {mem.argument_bytes / 2**30:.3f} "
          f"GiB), max_memory_allocated {peak / 2**30:.3f} GiB (allocated at the start "
          f"{base / 2**30:.3f} GiB); above the start: counted {counted} bytes, allocated "
          f"{allocated} bytes, gap {gap:.4%} (band {MEM_BAND:.0%})")
    check(gap <= MEM_BAND, f"memory counter {counted} vs allocator {allocated}: {gap:.2%}")
    del out, params, state, lm


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
    import numpy as np

    from repro_torch.configs import get_config, reduced

    _parity(replace(get_config("tiny_lm"), dtype="float32"), "tiny_lm")
    for hd in (96, 256):     # the head dims of phi3_vision and gemma3_12b through B1/B2
        _parity(replace(reduced(get_config("tiny_lm")), head_dim=hd, dtype="float32"),
                f"tiny_lm reduced to 2 layers, head_dim {hd}")
    _parity(replace(get_config("falcon_mamba_7b"), dtype="float32", num_layers=2),
            "falcon_mamba_7b (2 layers, full width)")
    _parity(replace(get_config("moonshot_v1_16b"), dtype="float32", num_layers=2),
            "moonshot_v1_16b (2 layers, full width)")
    # gemma3_12b cut to one period (5 local layers, 1 global) at full width:
    # a prompt of 1100 tokens wraps the local rings of 1024, then 4 steps
    gemma = get_config("gemma3_12b")
    _parity(replace(gemma, dtype="float32", num_layers=gemma.swa_period),
            "gemma3_12b (one period of 6 layers, full width)", B=1, S0=1100, W=2048)
    # phi3_vision cut to 2 layers at full width: 576 patch embeddings and 64
    # tokens, as phase 10 prefills them
    phi3 = replace(get_config("phi3_vision"), dtype="float32", num_layers=2)
    patches = np.random.default_rng(4).standard_normal(
        (2, phi3.num_patches, phi3.d_model)).astype(np.float32)
    _parity(phi3, "phi3_vision (2 layers, full width, patches)", S0=640, W=1024,
            extra={"patch_embeds": patches})
    _train_parity_hubert()
    _train_parity_scan_moe()


def _parity(cfg, label, B=2, S0=16, W=32, steps=4, extra=None):
    """The f32 model on the card (kernels) against the same weights on the CPU
    (plain versions): logits and greedy tokens at every step, then every
    cache tensor (k/v, or the conv window and the SSM state). ``extra``:
    further prefill inputs (numpy), as patch embeddings."""
    import copy

    import numpy as np
    import torch

    from repro_torch.models import LM

    gpu = LM(cfg, device="cuda", seed=11)
    cpu = copy.deepcopy(gpu).to("cpu")  # the card's weights: the CPU would draw others
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S0)).astype(np.int32)
    caches, logits = {}, {}
    t0 = time.perf_counter()
    for name, lm in (("gpu", gpu), ("cpu", cpu)):
        batch = {k: torch.as_tensor(v, device=lm.device)
                 for k, v in {"tokens": toks, **(extra or {})}.items()}
        lg, pc = lm.prefill(batch)
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
    print(f"[parity] {label} f32 prefill of B{B} S{S0} + {steps} decode steps (cache width "
          f"{W}), card vs CPU: logits max_abs_err {worst:.3e}, caches {errs} (tol "
          f"{LOGIT_TOL:g}), greedy tokens equal; {time.perf_counter() - t0:.1f} s")


TRAIN_ARGS = ["--arch", "train_100m", "--seq", "1024", "--batch", "8", "--accum", "2",
              "--ckpt-every", "10"]


def phase_train():
    """``train_100m`` at full width and depth through ``repro_torch.launch.train``
    (bf16, AdamW, remat): 30 steps with every launch count set to 0 just
    before and read just after; then a 20-step run and a run resumed from its
    step-10 checkpoint for 10 more, profiled; then the 2-layer f32 parity."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch import train

    cfg = get_config("train_100m")
    steps, micro = 30, 2
    wrappers = _wrappers()
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for w in wrappers.values():
            w.launches = 0
        rec = train.main(TRAIN_ARGS + ["--steps", str(steps), "--ckpt", os.path.join(tmp, "a")])
        launches = {name: w.launches for name, w in wrappers.items()}
        peak = torch.cuda.max_memory_allocated()
        losses = np.asarray(rec["losses"])
        check(len(losses) == steps and np.isfinite(losses).all(), f"losses {losses}")
        first, last = losses[:5].mean(), losses[-5:].mean()
        print(f"[train] train_100m {cfg.dtype}, {cfg.num_layers} layers, "
              f"{cfg.param_count() / 1e6:.1f} M parameters, {steps} steps of 8 x 1024 tokens "
              f"({micro} microbatches): loss {losses[0]:.4f} -> {losses[-1]:.4f}, mean of the "
              f"first 5 {first:.4f}, of the last 5 {last:.4f}")
        check(last < first, f"the loss did not fall: first 5 {first:.4f}, last 5 {last:.4f}")
        fwd = cfg.num_layers * micro * steps
        want = {**_no_launches(), "flash_attention": 2 * fwd, "flash_attention_bwd": fwd}
        print(f"[train] kernel launches {launches}; reckoned: B1 (with lse) {cfg.num_layers} "
              f"layers x {micro} microbatches x {steps} steps x 2 (remat) = {2 * fwd}, "
              f"B1b {fwd}")
        check(launches == want, f"launches {launches} are not the reckoned {want}")
        print(f"[train] {rec['seconds'] / steps * 1e3:.1f} ms a step (wall, the first step "
              f"and 3 checkpoints' host copies included), {rec['tokens'] / rec['seconds']:.0f} "
              f"tokens/s; peak device memory {peak / 2**30:.2f} GiB")

        ck = os.path.join(tmp, "b")
        full = train.main(TRAIN_ARGS + ["--steps", "20", "--ckpt", ck])
        shutil.rmtree(os.path.join(ck, "step_000000020"))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            resumed = train.main(TRAIN_ARGS + ["--steps", "10", "--ckpt", ck])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        busy = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == DeviceType.CUDA) / 1e6
        check(resumed["start"] == 10, f"resumed at step {resumed['start']}, not 10")
        check(resumed["losses"] == full["losses"][10:],
              f"resumed losses {resumed['losses']} != {full['losses'][10:]}")
        print(f"[train] resumed from step 10: steps 11-20 losses equal the uninterrupted "
              f"run's bit for bit ({resumed['losses'][0]:.6f} ... {resumed['losses'][-1]:.6f}); "
              f"the 20-step run's losses equal the 30-step run's first 20: "
              f"{full['losses'] == rec['losses'][:20]}")
        print(f"[train] resumed run under the profiler (restore and checkpoint included): wall "
              f"{wall:.3f} s, device busy {busy:.3f} s ({busy / wall:.1%}); per step "
              f"{wall / 10 * 1e3:.1f} ms wall, {busy / 10 * 1e3:.1f} ms device")
    _train_steady(cfg)
    _train_parity()
    return {name: launches[name] for name in ("flash_attention_bwd",)}


def _train_steady(cfg, warm=2, timed=5, profiled=3):
    """A steady train step of train_100m outside the launcher (no checkpoint,
    no first step): wall ms to a synchronize, then device time and the
    kernels that take it, from the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.models import LM
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.schedule import warmup_cosine
    from repro_torch.train.trainer import make_train_step

    lm = LM(cfg, device="cuda", seed=0, attn_block=TRAIN_BLOCK)
    opt = make_optimizer("adamw", warmup_cosine(3e-3, 20, 100), cfg)
    params = {n: p.detach() for n, p in lm.params().items()}
    state, step = opt.init(params), make_train_step(lm, opt, accum=2)
    stream = TokenStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=1024, global_batch=8))
    batches = [stream.batch(i) for i in range(warm + timed + profiled)]
    for b in batches[:warm]:
        params, state, _ = step(params, state, b)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for b in batches[warm:warm + timed]:
        params, state, _ = step(params, state, b)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) / timed
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for b in batches[warm + timed:]:
            params, state, _ = step(params, state, b)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values()) / profiled
    print(f"[train] steady step (8 x 1024 tokens, no checkpoint): {wall * 1e3:.1f} ms wall, "
          f"{busy:.1f} ms device ({busy / (wall * 1e3):.1%} busy), "
          f"{8 * 1024 / wall:.0f} tokens/s; device time by kernel, per step:")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[train]   {ms / profiled:8.3f} ms {ms / profiled / busy:6.1%}  {name[:90]}")
    from repro_torch.kernels.flash_attention_bwd import KERNELS
    bwd = [n for names in KERNELS.values() for n in names]    # B1b, both routes
    for kernel in (*bwd, "flash_fwd_tc_kernel"):
        ms = sum(v for k, v in by_name.items() if kernel in k) / profiled
        print(f"[train]   {ms:8.3f} ms {ms / busy:6.1%}  {kernel} (port)")
    ms = sum(v for k, v in by_name.items() if any(n in k for n in bwd)) / profiled
    print(f"[train]   {ms:8.3f} ms {ms / busy:6.1%}  B1b in all")


def _train_parity(steps=3):
    """3 f32 train steps of train_100m cut to 2 layers at full width, on the
    card (B1, B1b) and on the CPU (the plain versions) from the same weights
    and batches: each step's loss, then every parameter."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenStream

    cfg = replace(get_config("train_100m"), dtype="float32", num_layers=2)
    stream = TokenStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=256, global_batch=4,
                                    seed=0))
    _train_parity_of(cfg, "train_100m cut to 2 layers at full width",
                     [stream.batch(i) for i in range(steps)], "4 x 256 tokens")


def _train_parity_hubert(steps=3, B=4, S=256):
    """Phase 7's training case: hubert_xlarge cut to 2 layers at full width,
    3 f32 steps on frames with labels and a loss mask drawn from a numpy seed."""
    import numpy as np

    from repro_torch.configs import get_config

    cfg = replace(get_config("hubert_xlarge"), dtype="float32", num_layers=2)
    rng = np.random.default_rng(6)
    batches = [{"frames": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (B, S)),
                "loss_mask": (rng.random((B, S)) < 0.8).astype(np.float32)}
               for _ in range(steps)]
    _train_parity_of(cfg, "hubert_xlarge cut to 2 layers at full width", batches,
                     f"{B} x {S} frames")


def _train_parity_scan_moe(steps=3):
    """Phase 7's Mamba and MoE training cases, 3 f32 steps each, card (B3 with
    states, B3b; B1, B1b, B4, B4b) vs CPU: falcon_mamba_7b cut to 2 layers
    at full width on 2 x 128 tokens, and moonshot_v1_16b cut to 1 layer at
    full width on 2 x 64 tokens (one layer and the tied embedding are 0.9 B
    parameters: ~15 GB of f32 weights, gradients and AdamW moments a side)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenStream

    for arch, layers, S in (("falcon_mamba_7b", 2, 128), ("moonshot_v1_16b", 1, 64)):
        cfg = replace(get_config(arch), dtype="float32", num_layers=layers)
        stream = TokenStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=2,
                                        seed=0))
        _train_parity_of(cfg, f"{arch} cut to {layers} layer{'s' * (layers > 1)} at full width",
                         [stream.batch(i) for i in range(steps)], f"2 x {S} tokens")
        gc.collect()


def _train_parity_of(cfg, name, batches, what):
    """f32 train steps of ``cfg`` on the card (B1, B1b) and on the CPU (the
    plain versions) from the same weights and batches (AdamW, 2
    microbatches): each step's loss, then every parameter, within 2e-3."""
    import copy

    import torch

    from repro_torch.models import LM
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.schedule import warmup_cosine
    from repro_torch.train.trainer import make_train_step

    steps = len(batches)
    gpu = LM(cfg, device="cuda", seed=11, attn_block=64)
    cpu = copy.deepcopy(gpu).to("cpu")   # the card's weights: the CPU would draw others
    start = {n: p.detach() for n, p in cpu.params().items()}   # the steps make new tensors
    sched = warmup_cosine(3e-3, 20, steps)
    runs = {}
    for dev, lm in (("gpu", gpu), ("cpu", cpu)):
        opt = make_optimizer("adamw", sched, cfg)
        params = {n: p.detach() for n, p in lm.params().items()}
        state, step, losses = opt.init(params), make_train_step(lm, opt, accum=2), []
        t = time.perf_counter()
        for batch in batches:
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
        runs[dev] = (losses, params, state, time.perf_counter() - t)
    (gl, gp, _, gs), (cl, cp, cstate, cs) = runs["gpu"], runs["cpu"]
    loss_err = max(abs(a - b) for a, b in zip(gl, cl))
    check(all(abs(a - b) <= TRAIN_TOL * (1 + abs(b)) for a, b in zip(gl, cl)),
          f"train-step losses card {gl} vs CPU {cl}")
    param_err, worst = -1.0, None                # worst: the first leaf at the largest error
    for n, c in cp.items():
        g = gp[n].cpu()
        err = (g - c).abs()
        if err.max().item() > param_err:
            param_err, worst = err.max().item(), (n, int(err.argmax()), g)
        check(torch.allclose(g, c, rtol=TRAIN_TOL, atol=TRAIN_TOL),
              f"parameter {n} after {steps} steps: card vs CPU max_abs_err "
              f"{err.max().item():.3e}")
    # where the parameters differ most: each side's update of that element
    # against the steps' learning rates, and the CPU's gradient scale there
    # (AdamW's sqrt(v_hat), beside its eps 1e-8)
    n, i, g = worst
    p0 = start[n].reshape(-1)[i].item()
    v = cstate["v"][n].reshape(-1)[i].item() / (1 - 0.95 ** steps)
    lrs = [float(sched(torch.tensor(s))) for s in range(1, steps + 1)]
    print(f"[train] parity: {name}, f32, {steps} steps of "
          f"{what} (2 microbatches), card vs CPU: losses {[round(x, 6) for x in gl]}, "
          f"max_abs_err {loss_err:.3e}; parameters max_abs_err {param_err:.3e} (tol "
          f"{TRAIN_TOL:g}), largest at {n}[flat {i}]: updated by "
          f"{g.reshape(-1)[i].item() - p0:+.3e} on the card, "
          f"{cp[n].reshape(-1)[i].item() - p0:+.3e} on the CPU (learning rates "
          f"{[f'{x:.2e}' for x in lrs]}; the CPU's sqrt(v_hat) there {v ** 0.5:.3e}); "
          f"{gs:.2f} s on the card, {cs:.2f} s on the CPU")


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
    launches.update(timed("train", phase_train))
    release_images()
    timed("engine gemma3_12b", phase_engine_gemma3)
    release_images()
    timed("phi3_vision", phase_phi3_vision)
    release_images()
    timed("train hubert_xlarge", phase_train_hubert)
    release_images()
    launches.update(timed("train falcon_mamba_7b", phase_train_falcon))
    release_images()
    launches.update(timed("train moonshot_v1_16b", phase_train_moonshot))
    release_images()
    mesh_launches = timed("train on a mesh", phase_train_mesh)
    pod_launches = timed("compression and the roofline", phase_compression_roofline)

    kernels = []
    for name, label, dname, replaces, source in (
            ("flash_attention", FLASH_LINE, "bfloat16",
             "src/repro/kernels/flash_attention.py:103",
             "src/repro_torch/csrc/flash_attention.cu"),
            ("decode_attention", DECODE_LINE, "bfloat16",
             "src/repro/kernels/decode_attention.py:84",
             "src/repro_torch/csrc/decode_attention.cu"),
            # B2's slot-range route: the mesh path's decode over split slots
            ("decode_attention_partial", DECODE_PARTIAL_LINE, "bfloat16",
             "src/repro/kernels/decode_attention.py:84",
             "src/repro_torch/csrc/decode_attention.cu"),
            ("mamba_scan", MAMBA_LINE, "float32", "src/repro/kernels/mamba_scan.py:68",
             "src/repro_torch/csrc/mamba_scan.cu"),
            ("grouped_matmul", GMM_LINE, "bfloat16", "src/repro/kernels/moe_gmm.py:71",
             "src/repro_torch/csrc/moe_gmm.cu"),
            # no pallas_call: the backward of attend_blocked's custom VJP
            ("flash_attention_bwd", BWD_LINE, "bfloat16", "src/repro/models/attention.py:150",
             "src/repro_torch/csrc/flash_attention_bwd.cu"),
            # no pallas_call: autodiff of the chunked scan and of the expert einsums
            ("mamba_scan_bwd", SCAN_BWD_LINE, "float32", "src/repro/models/mamba.py:24",
             "src/repro_torch/csrc/mamba_scan_bwd.cu"),
            ("grouped_matmul_dx", GMM_BWD_LINE, "bfloat16", "src/repro/models/moe.py:88",
             "src/repro_torch/csrc/moe_gmm_bwd.cu"),
            ("grouped_matmul_dw", GMM_BWD_LINE, "bfloat16", "src/repro/models/moe.py:88",
             "src/repro_torch/csrc/moe_gmm_bwd.cu")):
        r = rows[(name, label, dname)]
        # the slot-range route runs on the mesh path only (phase 14's decode):
        # none on the main path
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches.get(name, 0),
                        "launches_mesh": mesh_launches[name],
                        "launches_pod_sync": pod_launches.get(name, 0),
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
