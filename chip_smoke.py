#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. card:    print the card's name and power limit (nvidia-smi);
2. build:   build the hand-written kernels from src/repro_torch/kernels/csrc
            with nvcc for sm_90a; print every kernel's ptxas lines
            (registers, spill bytes) and the flash and SSD kernels' HGMMA
            / HMMA counts from `cuobjdump -sass`;
3. kernels: hold each kernel against its plain PyTorch version on the card
            (flash-attention forward: out and lse; flash-attention
            backward: dq, dk, dv, both also at the live plans' S=32, at
            phase 15's train-step (B, S) grid and at granite-moe's group
            of 3 query heads a KV head; both at head_dim 80
            (hubert-xlarge: bidirectional and causal in bf16 at its
            training shape, on views of a fused QKV, ragged and GQA in
            fp32, two calls bit for bit, timed beside SDPA and the bound,
            the backward by stage) and at stablelm's and qwen2-vl's
            training shapes (the backward at stablelm's also two calls
            bit for bit and by stage, with the dq and dk/dv kernels'
            TFLOP/s), the backward at the edges of the dk/dv kernel's
            64-key blocks (S 64, 127, 191; Sq 192 with Sk 320) at hd 80
            and 64, the forward at the edges of its hd <= 80 schedule's
            64-key units and 128-key stages (S 64, 127, 129, 191, 255,
            causal and bidirectional; Sq 192 with Sk 320; a group of 3)
            in bf16 and fp32 and, two calls bit for bit, on the device
            beside SDPA at hubert-xlarge's encode (hd 80) and
            stablelm-1.6b's training shape (hd 64, causal);
            the forward also at the groups of phase 18
            (1, 6, 8, 12); the RMSNorm forward
            and backward kernels at every width the port normalises, the
            backward also against autograd over the plain forward and
            two of its calls bit for bit; the SSD scan
            at the mamba2 and zamba2 shapes and phase 15's grid, on views
            of one conv output as the Mamba2 block cuts them, and two
            calls bit for bit; event select, bit for bit, at the fleet
            engine's widths) and time the kernel, the plain version and,
            where one exists, one PyTorch library call, with TFLOP/s and
            the share of the bound reached (the flash forward also at the
            training shape and at zamba2's; the SSD scan by stage, with its
            host time per call); at the four training shapes of the norms,
            both RMSNorm kernels' device time (torch.profiler) and
            host-paced per-call time beside their bounds, F.rms_norm's
            forward and backward and the autograd recompute the backward
            kernel replaced; the host cost of RMSNorm's
            dispatch through its autograd Function; the SSD backward
            (autograd over the plain version);
4-7b. qwen3-1.7b (dense), full width:
   4. prefill: B=1, S=2048 through `launch.steps.make_prefill_step`, which
            must launch the flash kernel once per layer and the RMSNorm
            kernel once per norm;
   5. serve: `Session.serve` (4 requests x 16 tokens after a 32-token
            prompt), greedy, twice with one seed: identical streams,
            RMSNorm launches as predicted per step, and the gateway's
            logits at the last prompt position agree with prefill's;
   6. train: `Session.train` (4 steps, B=2, S=2048, AdamW): 28 flash
            forward, 28 flash backward and 113 RMSNorm forward and 113
            backward launches per step, finite losses and gradient norms,
            a first loss near ln(vocab), every parameter changed by step
            1; step time, tokens/s, MFU, peak memory, the device's busy
            share and RMSNorm's device time and kernels in a step;
   7. parity: one `make_train_step` cut to 2 layers at full width, on the
            card (kernels) and on the CPU (plain versions), from one set
            of weights and one batch: loss, gradient norm and every
            gradient leaf agree;
   7b. resume: checkpoint and resume on the card (SMOKE config): 2 steps,
            a new Session that restores at step 2 and runs 2 more, against
            4 uninterrupted steps;
8-11. mamba2-1.3b (Mamba2 SSD), full width: prefill (48 SSD and 97
            RMSNorm launches), serve (97 RMSNorm launches a decode step,
            no SSD: decode is the recurrence), train (48 SSD and 97
            RMSNorm forward and backward launches a step) and parity, as
            in 4-7; prefill and serve launch no backward;
12. zamba2-1.2b (Mamba2 + one shared attention block), full width:
            prefill (38 SSD, 6 flash, 89 RMSNorm launches) and serve (89
            RMSNorm launches a decode step), as in 4-5;
13. fleet: the §VI-A fleet simulator's device engine on the
            `regional_wave` chaos scenario at 65,536 trajectories, built
            as the reference's `benchmarks/mc_speed.py:bench_jit_engine`
            builds it: `Session.simulate(samples=65536, engine="jit")`
            (one event-select launch per round) and warm `run_jit`
            calls, held against the port's NumPy `run_batched` on the
            same draws (counts and `finished` exact, times to rtol 1e-9);
            then the six configurations of tests/test_engine_parity.py's
            corpus at 1,024 trajectories on the card, held the same way.
14. live loop: the §VI-B loop through `Session.chaos(scenario,
            smoke=True)`, the chaos runner's live branch: qwen3-1.7b
            trains on the card (B=4, S=32) under a virtual clock while
            silent faults fire. `ps_crash` (60 steps, full width): the PS
            drops to 10% at step 20 and the controller walks none -> int8
            -> topk, the payload dropping by the compression ratio at each
            switch; `straggler` (80 steps, full width, recalibration
            armed): no action, a drift alarm and a refit, the next check
            back inside 6.7%; `ckpt_outage` (60 steps, resilience armed)
            at the SMOKE config, as a full-width save every 5 steps would
            write over 100 GB: failed, retried and recovered saves and the
            fallback drill. Each scenario's gates must pass, every live
            step launch the flash kernels 28 times each way and RMSNorm
            113 times each way, and its ledger (checks, mitigations, drift
            alarms, refits, virtual seconds) equal the port's CPU run of the
            scenario at SMOKE; each scheme's step ms, each rebuild's ms,
            peak memory and each scenario's seconds are printed.
15. model leg: the paper's §III-§V models fitted on the card's own
            numbers. (a) `make_train_step` at full width (bf16) for
            qwen3-1.7b and mamba2-1.3b over 8 (B, S) points from (1, 512)
            to (2, 2048) (phase 3 holds the flash and SSD kernels at each
            of these shapes), 2 warm-up steps, the median of 3 steps timed
            by CUDA events beside their median wall time, and one
            profiled step's device busy time; each point launching the
            kernels a step as phases 6 and 10 predict; rows {arch, gpu,
            c_m, step_time} with C_m = flops_per_token(S) B S / 1e9
            (benchmarks/lm_speed_models.py). (b) OLS on min-max C_m and
            the RBF SVR's grid search (k-fold MAE, the Pearson r), on the
            step time and on the device busy time, each fit's predictions
            at the grid's rows finite and positive;
            `WorkerSpeedPredictor` with (2, 1024) of each arch held out,
            and what the Table I transfer predicts for the card at 989
            TFLOP/s. (c) 8 param trees (1.4 MB to 2.05 GB)
            saved twice each through `Checkpointer` into temporary
            directories, `table4_models` and `CheckpointTimePredictor` on
            the rows (benchmarks/fig5_checkpoint.py), then the full-width
            qwen3-1.7b params (6.88 GB) saved once against the predicted
            T_c. (d) `Session.predict` (Eq (4)) for gcp, aws and azure with
            that T_c; `Session.plan(score="sim", engine="jit")` over the
            32 GCP (region, hour) cells that sell v100 at 8,192
            trajectories a cell (one event-select launch a round), then at
            1,024 held against the CPU's batched plan (the fleet
            contract). The fits are printed, not gated, beyond being
            finite and positive.
16. recorded trace and serving fleet: (a) `Session.chaos(
            "recorded_trace", engine="jit", smoke=True)` on a SMOKE qwen3
            session at 65,536 trajectories: the replayed trace's faults on
            the device engine, its gates passing, at least one
            event-select launch a round and no other kernel; the faulted
            ensemble at 1,024 held against the CPU session's batched
            engine (counts and `finished` exact, times and costs to rtol
            1e-9), at SMOKE and at full width; the same call at full
            width at 65,536, counted the same way but with no gate (the
            reference's own `min_extra_time_s` gate fails at that width);
            the warm engine's wall and busy share at both widths. (b) `serve_wave`
            through `Session.chaos(smoke=True)` (4 replicas, 400 requests
            at 2 req/s, 32 samples): four gates, exact engine parity, and
            a scorecard equal to a CPU session's. (c)
            `Session.plan_serving()` at full width equal to the CPU
            session's plans; 16 decode rounds of a full-width
            `GatewayEngine` with the plan's 8 slots (113 RMSNorm launches
            a round), the last round's logits held against a prefill of
            the same tokens, their p50 printed beside the plan's
            `token_time_s`.
17. MoE and MLA, full width: granite-moe-3b-a800m (40 experts top-8,
            GQA 24/8 heads of 64) and deepseek-v2-lite-16b (MLA, 64
            experts top-6 and 2 shared, a dense first layer). Each: the
            bf16 prefill (B=1, S=2048) as in 4, launching 32 flash and 65
            RMSNorm (granite) or 82 RMSNorm and no flash (deepseek: ln1,
            kv_norm and ln2 a layer, and the final norm), with the pairs
            its published capacity drops and its parts (expert casts,
            routing, dispatch, expert products, combine, `_chunked_attn`)
            timed at layer 0's shapes; serve as in 5 (the prefill's
            RMSNorm count a decode step), gateway vs prefill held in fp32
            at the no-drop capacity (capacity_factor = E / k); the train
            step at 2 layers, full width, fp32, card vs CPU as in 7, with
            every MoE group's routing equal and the aux loss within 1e-5.
18. dense and VLM, full width, one arch after another, each freed
            before the next: stablelm-1.6b (MHA 32/32 of 64, partial
            rotary), qwen2-vl-2b (M-RoPE, 12/2 of 128; its prefill batch
            has three distinct t/h/w position rows), yi-6b (32/4) and
            starcoder2-15b (48/4, GELU MLP; 63.8 GB of fp32 weights). Each:
            the bf16 prefill as in 4 (one flash launch a layer, 2 RMSNorm a
            layer and the final norm), serve as in 5 (gateway vs prefill in
            bf16 within 5e-2), and the forward cut to 2 layers at full width
            in fp32, card vs CPU, logits within 1e-4 of max |logit|.
            stablelm and qwen2-vl, which fit AdamW on one card, also train
            as in 6 (24 / 28 flash and 49 / 57 RMSNorm launches each way a
            step) and take the depth-2 fp32 train step card vs CPU as in 7
            (qwen2-vl's batch with three distinct position rows).
19. hubert-xlarge (the audio encoder, head_dim 80), full width: the
            bf16 encode of 2048 frames (48 flash launches at hd 80, 97
            RMSNorm), the depth-2 fp32 forward card vs CPU as in 18,
            `Session.train` on frame features as in 6 (48 flash launches
            each way at hd 80, bidirectional, and 97 RMSNorm a step; MFU
            over every key of every query) and the depth-2 fp32 train step
            card vs CPU as in 7.
20. the paper's CIFAR-10 CNN zoo (§III-A): each of the 20 specs 10 SGD
            steps (lr 0.05) on 128 CIFAR-shaped images after 3 warm-ups,
            step ms by CUDA events and images/s, with cuDNN's default TF32;
            the Pearson r of step time against C_m over the zoo, printed;
            resnet_15 and shake_shake_small card vs CPU: in fp64 the loss
            and every gradient leaf (1e-12, 1e-8 of its max); in fp32 with
            TF32 off the loss within 1e-5 of fp64's, the leaves printed.
21. qwen3-1.7b at full width on three paths no earlier phase drives:
            (a) the §II asynchronous-PS emulation, `Session.train(mode=
            "async_ps")`: 8 updates of 4 workers paced 0.1-0.4 (B=2,
            S=2048, bf16), each a gradient pass at a stale snapshot and a
            forward for the post-update loss (56 flash forward, 28 flash
            backward, 226 RMSNorm forward and 113 backward launches an
            update), finite losses, a staleness histogram of 8 with some
            staleness, ms an update and peak memory; cut to 2 layers in
            fp32, 4 updates on the card against the CPU from one set of
            weights (losses within 1e-3, histogram and update counts
            equal). (b) `remat` "none", "full" and "dots" from one set of
            weights and one batch (B=2, S=2048): the loss bit-equal, the
            gradient norm within 1e-6 and each leaf within 1e-5 of its max,
            the recompute's launches (56 flash forward, 225 RMSNorm forward
            a gradient pass), then 4 AdamW steps each, step ms and peak;
            "full" at B=6, where a step without checkpointing would not
            fit, its peak, busy time and tokens/s. (c) the int8 KV cache:
            phase 5's serve with `kv_quant=True` twice (identical greedy
            replay) and with the bf16 cache once on the same weights,
            decode p50/p95 and tokens/s side by side, the cache's bytes a
            token, the gateway's logits against bf16 prefill with each
            cache; cut to 2 layers in fp32, 10 tokens decoded with the int8
            cache against prefill within the reference's own bounds
            (relative 0.05, correlation 0.999).
22. the dry run against the card: `launch/dryrun.count_cell` on the
            1x1 mesh (qwen3-1.7b, full width, counted on the meta device)
            predicts the "full" train steps of phase 21 (B=2 and B=6,
            S=2048) and phase 4's B=1 prefill: each kernel's launches
            exactly, the train steps' peak memory within 10% of the
            measured, and a roofline (the counted FLOPs and bytes over the
            card's peaks) whose larger term the measured busy time is not
            below (0.95 x); no new step runs on the card.
23. the paper's table and figure drivers on the card, in this process:
            `repro_torch.bench.run.main` with `lm_speed_models` (every
            SMOKE arch's forward loss: the flash forward at hd 32, causal
            and hubert's bidirectional, RMSNorm and the SSD scan),
            `fig2_stability` (FIG2_STEPS SGD steps, so the profiler's
            0.5 s warm-up leaves windows), `fig10_replacement`,
            `fig5_checkpoint` (the zoo drawn on the card and saved) and
            `serving`: exit 0, finite rows, a row per arch, fig2's speed
            above 0, `serve_wave`'s smoke and fig10's cold > warm; then
            `examples.quickstart` and `examples.transient_train` train on
            the card (the flash and RMSNorm kernels both ways; its loss
            assert holds); the phase launches the flash forward and
            backward, both RMSNorm kernels and the SSD scan; fig5's sizes
            and serving's host rows equal CPU runs'; every SMOKE arch's
            logits on lm_speed's batch, the card's fp32 and bf16 forwards
            against an fp32 CPU forward of the same weights (phase 3
            holds each kernel at these shapes against its plain
            version).

Then one JSON line per the kernels (launches summed over the prefill,
serve, train, fleet, live, model-leg, trace/serving, MoE, dense, VLM,
encoder, async, remat, int8 and bench phases, each counted from 0), the
card line again, and the result line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the repository beside it, it fails
before printing any result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time
import types

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# the card's published peaks (dense bf16 and fp32, fp64, HBM): the port's
# one copy. Without the port's sources beside this script the import fails
# and the script exits non-zero before it prints anything.
sys.path.insert(0, str(SRC))
from repro_torch.device import (H100_HBM_BYTES_PER_S as HBM_BYTES_PER_S,  # noqa: E402
                                H100_PEAK_FLOPS as PEAK_FLOPS)

PEAK_F64_FLOPS = PEAK_FLOPS["float64"]
TOL = {"bfloat16": 2e-2, "float32": 2e-5}  # as tests/test_kernels.py
# flash backward: fp32 as tests/test_kernels.py holds the Pallas gradients
# (3e-4, elementwise). bf16, where p and ds are rounded to bf16 for their
# products: max |got - want| against the largest |gradient|, and
# |got - want| / |want| over the whole tensor (Frobenius), which holds the
# many small gradients past the first tiles that the first cannot (causal
# gradients are heavy-tailed: on an H100 at the train shape max |dv| was
# 7.25 and its median 0.031). The norm error measured there was 2.5e-3 to
# 2.7e-3 for each of dq, dk, dv at both bf16 shapes: about 3.7x margin
BWD_TOL = {"bfloat16": 2e-2, "float32": 3e-4}
BWD_NORM_TOL = 1e-2
# RMSNorm backward kernel vs the plain backward and vs autograd over the
# plain forward: (dx of max |dx|, dx in Frobenius norm, dscale of max
# |dscale|). fp32 as the flash backward; bf16 dx is rounded once in each,
# after sums taken in another order; dscale is fp32 in both
RN_BWD_TOL = {"bfloat16": (2e-2, 1e-2, 1e-3), "float32": (3e-4, 3e-4, 3e-4)}
# train step on the card (bf16, kernels) vs the CPU (bf16, plain versions),
# 2 layers at full width. Calibrated on the first chip run (PERF.md §6),
# which gave 3.6e-5, 1.9e-4 and 1.2e-2: the scalars differ only by the
# order of bf16 sums (about 30x margin); a gradient leaf also carries the
# kernel's bf16 rounding of p and ds, largest on the small qk-norm scales
# (4x margin)
PARITY_TOL = {"loss": 1e-3, "grad_norm": 5e-3, "grad_leaf": 5e-2}
# decode-vs-prefill logits, scale-relative: the two paths round in bf16 at
# different places (bf16 KV cache and fp32 softmax over it vs the flash
# kernel's bf16 output) across 28 layers
SERVE_VS_PREFILL_TOL = 5e-2

# mamba2 and zamba2 with random weights scale up bf16 rounding with depth
# (the gated RMSNorm renormalises small rows; tests/test_torch_ssm.py): on
# the CPU at full width the bf16 decode and prefill paths drift apart by
# 0.6% of max |logit| at 2 layers, 4.9% at 8, 8.2% at 16, and on an H100
# by 54% at mamba2-1.3b's 48 (PERF.md, PR 13). In fp32, with an fp32
# decode state, they agreed to 1.9e-5 at 16 layers on the CPU; so the SSM
# models are held in fp32, and their bf16 distance is printed
SSM_SERVE_VS_PREFILL_TOL = 1e-3
# mamba2 train step on the card vs the CPU, 2 layers at full width.
# Calibrated on the first chip run with this phase (PERF.md §6, PR 13),
# which gave 2.2e-5, 3.8e-3 and 4.3e-2 (layers/mixer/conv_w): the bf16
# sums run in another order, and the gated RMSNorm scales up rounding
# (tests/test_torch_ssm.py); 46x, 5.3x and 3.4x margins
SSM_PARITY_TOL = {"loss": 1e-3, "grad_norm": 2e-2, "grad_leaf": 1.5e-1}
# SSD kernel vs plain: (max |got - want| / max |want|, Frobenius); fp32 as
# tests/test_kernels.py holds the Pallas scan, bf16 as the flash backward
SSD_TOL = {"bfloat16": (2e-2, 1e-2), "float32": (5e-4, 5e-4)}
# (b, s, h, p, g, n, chunk, dtype): the mamba2-1.3b prefill and train
# shapes, zamba2-1.2b's, grouped B/C, one short ragged tile, many of the
# bf16 kernels' 128-token chunks with a ragged tail, a sequence shorter
# than one, grouped B/C at the SMOKE widths (n=16, p=32), phase 23's
# SMOKE mamba2 and zamba2 forwards (one group, one 32-token chunk), fp32
SSD_CASES = [(1, 2048, 64, 64, 1, 128, 256, "bfloat16"),
             (2, 2048, 64, 64, 1, 128, 256, "bfloat16"),
             (1, 2048, 64, 64, 1, 64, 256, "bfloat16"),
             (1, 256, 8, 64, 2, 32, 128, "bfloat16"),
             (1, 32, 64, 64, 1, 128, 32, "bfloat16"),
             (1, 2000, 8, 64, 1, 128, 250, "bfloat16"),
             (2, 100, 8, 64, 2, 64, 100, "bfloat16"),
             (2, 640, 8, 32, 4, 16, 128, "bfloat16"),
             (2, 32, 8, 32, 1, 16, 32, "bfloat16"),
             (2, 128, 4, 32, 2, 16, 64, "float32"),
             (1, 200, 8, 64, 2, 64, 200, "float32")]
# x, B and C as views of one conv output, as `models.ssm.mamba2_block`
# cuts them: mamba2-1.3b's prefill, and a ragged grouped SMOKE-width one
SSD_VIEW_CASES = [(1, 2048, 64, 64, 1, 128, 256, "bfloat16"),
                  (2, 200, 8, 32, 2, 16, 200, "bfloat16")]

SEQ, N_TOKENS, N_BATCH, PROMPT_LEN = 2048, 16, 4, 32
# qwen3-1.7b's train step (B=2, S=2048) as the port ran it with RMSNorm's
# backward as autograd over the plain forward: RMSNorm's device ms and
# kernels a step, and the step's kernels and copies (measured by
# scripts/rmsnorm_step_share.py on an H100 80GB HBM3 at 700 W; PERF.md §6)
NORM_STEP_RECOMPUTE = {"qwen3-1.7b": (55.189, 2938, 7112)}
# what `chaos.runner._run_live` trains at (global_batch=4, seq_len=32)
LIVE_BATCH, LIVE_SEQ = 4, 32
TRAIN_STEPS, TRAIN_BATCH = 4, 2
KERNELS = ("flash_attention_fwd", "flash_attention_bwd", "rmsnorm_fwd",
           "rmsnorm_bwd", "ssd_scan_fwd", "event_select_fwd")
# the fleet engines' contract (tests/test_engine_parity.py:_assert_parity):
# counts exact, times and costs to rtol 1e-9, accruals to 1e-6
FLEET_N, FLEET_CORPUS_N = 65536, 1024
FLEET_TOL = {"total_time_s": (1e-9, 0.0), "monetary_cost": (1e-9, 1e-9),
             "checkpoint_time_s": (1e-6, 1e-6), "lost_steps": (1e-6, 1e-6),
             "paused_s": (1e-6, 1e-6), "restore_delay_s": (1e-6, 1e-6)}
# tests/test_engine_parity.py's CORPUS: (provider, region, gpu, workers,
# handover, replace, compression, i_c, horizon_h, start_h, seed)
FLEET_CORPUS = [
    ("gcp", "us-central1", "v100", 4, True, True, "none", 4000, 48.0, 0.0, 0),
    ("gcp", "europe-west1", "k80", 8, False, True, "none", 1000, 32.0, 0.0,
     3),
    ("gcp", "us-west1", "k80", 2, True, False, "none", 4000, 100.0, 7.0, 5),
    ("aws", "us-east-1", "v100", 6, False, True, "none", 1000, 80.0, 9.0, 2),
    ("azure", "southeastasia", "v100", 4, False, True, "int8", 4000, 60.0,
     13.5, 1),
    ("azure", "southcentralus", "v100", 1, True, True, "none", 4000, 12.0,
     23.75, 7)]


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, warmup: int = 5, iters: int = 25) -> float:
    """Median device time of one call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def host_ms(torch, fn, batches: int = 10, iters: int = 20) -> float:
    """Host time of one call: the least, over batches, of the mean of
    back-to-back calls that never wait for the card, whose queue absorbs
    the kernels, so the clock sees the host's own cost (Python, ctypes,
    tensor maps, launch); the least, as other work on the host only adds
    to it."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        per.append((time.perf_counter() - t0) * 1e3 / iters)
        torch.cuda.synchronize()
    return min(per)


def wrapper_calls(torch, fa, ops, rn, dev) -> tuple:
    """Each kernel wrapper as the main path calls it, as (name, fn) pairs
    for `host_ms`, bf16 unless named: `ops.flash_attention` under no_grad
    at qwen3's prefill (1, 2048, 16/8 heads of 128, causal) and
    `flash_attention_bwd` at its training shape (B=2); `ops.rmsnorm` at a
    4-slot decode row (4, 2048) and `rmsnorm_bwd` at the training rows
    (4096, 2048); `ops.ssd_scan` at mamba2's prefill (1, 2048, 64 heads of
    64, one group, d_state 128); `ops.event_select` on the fleet engine's
    (65536, 8) float64 events. ``fa``, ``ops`` and ``rn`` are the wrapper
    modules to call (`scripts/wrapper_host_time.py` passes another
    tree's); the inputs are drawn from seed 0."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    q, k, v = randn(1, 2048, 16, 128), randn(1, 2048, 8, 128), randn(
        1, 2048, 8, 128)
    q2, k2, v2 = randn(2, 2048, 16, 128), randn(2, 2048, 8, 128), randn(
        2, 2048, 8, 128)
    out2, lse2 = fa.flash_attention_fwd(q2, k2, v2, causal=True)
    do2 = randn(2, 2048, 16, 128)
    xd, scale = randn(4, 2048), torch.linspace(0.5, 1.5, 2048, device=dev)
    xt, dyt = randn(4096, 2048), randn(4096, 2048)
    x_ssd, B_ssd, C_ssd = randn(1, 2048, 64, 64), randn(
        1, 2048, 1, 128), randn(1, 2048, 1, 128)
    dt_ssd = torch.rand((1, 2048, 64), generator=gen, device=dev) * 0.1
    A_ssd = -torch.rand((64,), generator=gen, device=dev)
    ev = torch.rand((65536, 8), generator=gen, device=dev,
                    dtype=torch.float64)
    return (
        ("ops.flash_attention fwd (1, 2048, 16/8, 128)",
         lambda: ops.flash_attention(q, k, v, True)),
        ("flash_attention_bwd (2, 2048, 16/8, 128)",
         lambda: fa.flash_attention_bwd(q2, k2, v2, out2, lse2, do2,
                                        causal=True)),
        ("ops.rmsnorm (4, 2048)", lambda: ops.rmsnorm(xd, scale)),
        ("rmsnorm_bwd (4096, 2048)", lambda: rn.rmsnorm_bwd(xt, scale, dyt)),
        ("ops.ssd_scan (1, 2048, 64, 64; n 128)",
         lambda: ops.ssd_scan(x_ssd, dt_ssd, A_ssd, B_ssd, C_ssd, 256)),
        ("ops.event_select (65536, 8) float64",
         lambda: ops.event_select(ev)),
    )


def device_profile(torch, fn, n: int, count=None, host: bool = True,
                   tries: int = 5):
    """Run ``fn`` n times under torch.profiler. Returns the device time per
    call summed over kernels and copies (ms) and that time by kernel name,
    largest first; a dict given as ``count`` receives the number of
    device events per call under "events", and by name under "by_name".
    The profiler slows the host, so host wall times are taken without it;
    ``host=False`` leaves the host's ops out of the trace, which a train
    step's tens of thousands of them make slow to read back. A trace that
    holds no device event at all (the tracer dropped it; on the H100 it
    once dropped three traces of one call in a row) is taken again after
    a second's pause with twice the calls, up to ``tries`` times in all,
    and then fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU] * host + [ProfilerActivity.CUDA]
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        by_name, n_by_name, events = {}, {}, 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                events += 1
                by_name[e.name] = (by_name.get(e.name, 0.0)
                                   + e.time_range.elapsed_us() / 1e3 / n)
                n_by_name[e.name] = n_by_name.get(e.name, 0) + 1 / n
        if events:
            break
        say(f"  the profiler saw no device event in {n} call(s); again "
            f"with {2 * n}")
        n *= 2
        time.sleep(1.0)
    else:
        fail(f"the profiler saw no device event in {tries} traces")
    if count is not None:
        count["events"] = events / n
        count["by_name"] = n_by_name
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return sum(by_name.values()), ranked


def device_ms(torch, fn, n: int, fragment: str = "", flush=None) -> float:
    """Device ms a call of ``fn``'s kernels whose names hold ``fragment``
    (all of them when it is empty). With ``flush``, a tensor larger than
    the 50 MB L2, an argmax over it runs before each call, so the call
    finds its inputs in device memory and L2 full of clean lines (a read
    leaves nothing to write back); the argmax's kernels, which no kernel
    measured here runs, are left out."""
    if flush is None:
        run = fn
    else:
        def run():
            torch.argmax(flush)
            fn()
    _, ranked = device_profile(torch, run, n)
    return sum(t for name, t in ranked
               if fragment in name and "ArgMax" not in name)


# kernel-name fragments -> the category a breakdown sums them under
CATEGORIES = (("flash_fwd_", "flash forward (ours)"),
              ("flash_bwd_", "flash backward (ours)"),
              ("rmsnorm_", "RMSNorm forward and backward (ours)"),
              ("ssd_", "SSD scan (ours)"),
              ("nvjet", "cuBLAS GEMM"), ("gemm", "cuBLAS GEMM"),
              ("copy_kernel", "copies and dtype casts"),
              ("topk", "top-k selection (torch.topk)"),
              ("Sort", "sorts (MoE routing and dispatch)"),
              ("index", "indexing (MoE dispatch and combine, embedding)"),
              ("softmax", "softmax"),
              ("reduce_kernel", "reductions"),
              ("elementwise", "other elementwise"))


def say_profile(what: str, wall_ms: float, device_ms: float, ranked,
                top: int = 6, by_category: bool = False) -> None:
    if device_ms == 0.0:
        say(f"  {what}: device time not measured (the profiler saw no "
            "CUDA activity)")
        return
    say(f"  {what}: device busy {device_ms:.3f} ms of {wall_ms:.3f} ms "
        f"wall ({100 * device_ms / wall_ms:.1f}% busy, "
        f"{100 - 100 * device_ms / wall_ms:.1f}% idle); top kernels:")
    for name, ms in ranked[:top]:
        say(f"    {ms:9.4f} ms  {100 * ms / device_ms:5.1f}%  {name[:90]}")
    if by_category:
        sums = {}
        for name, ms in ranked:
            cat = next((c for frag, c in CATEGORIES if frag in name), "other")
            sums[cat] = sums.get(cat, 0.0) + ms
        say("    by category:")
        for cat, ms in sorted(sums.items(), key=lambda kv: -kv[1]):
            say(f"    {ms:9.4f} ms  {100 * ms / device_ms:5.1f}%  {cat}")


def kernel_name(mangled: str) -> str:
    """flash_fwd_bf16_kernel<128> for the mangled name of that kernel
    (flash_bwd_delta_kernel<f, 32> for one with a type and a value,
    ssd_out_bf16_kernel<128, 64> for one with two values): the last
    length-prefixed name that ends in _kernel (a hash before it may read
    as a longer one), with its template arguments."""
    found = None
    for m in re.finditer(r"(?=(\d+)([A-Za-z]\w*))", mangled):
        n, rest = int(m.group(1)), m.group(2)
        if len(rest) >= n and rest[:n].endswith("_kernel"):
            found = rest[:n], rest[n:]
    if found is None:
        return mangled[:80]
    name, tail = found
    args, i = [], 1
    while tail.startswith("I") and i < len(tail) and tail[i] != "E":
        if tail.startswith("Li", i):           # an int: Li<value>E
            j = tail.index("E", i)
            args.append(tail[i + 2:j])
            i = j + 1
        elif tail[i].isdigit():                # a named type: <len><name>
            k = re.match(r"\d+", tail[i:]).group()
            args.append(tail[i + len(k):i + len(k) + int(k)])
            i += len(k) + int(k)
        else:                                  # a builtin type: f, d, ...
            args.append(tail[i])
            i += 1
    return f"{name}<{', '.join(args)}>" if args else name


def say_build(build) -> None:
    """The ptxas lines (registers, shared memory, spill bytes) of every
    kernel of the last build, each under its source and beside its entry's
    name, then the HGMMA (wgmma) and HMMA (mma.sync) instructions of each
    flash and SSD kernel in the library's SASS."""
    entry = ""
    for line in build.last_build_log.splitlines():
        line = line.strip()
        if line.startswith("=="):
            say(f"      {line}")
        elif "Compiling entry function" in line:
            entry = kernel_name(line.split("'")[1] if "'" in line else line)
        elif "spill" in line or "registers" in line:
            say(f"      {entry}: {line.replace('ptxas info    : ', '')}")
        elif "ptxas" in line and ("arning" in line
                                  or "Performance" in line):  # C75xx
            say(f"      {line}")
    nvcc = pathlib.Path(build.nvcc_path())
    cuobjdump = nvcc.parent / "cuobjdump"
    if not cuobjdump.exists():
        say("      HGMMA count: not available (no cuobjdump in the toolkit)")
        return
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(build.library_path())],
                          capture_output=True, text=True, timeout=300)
    if sass.returncode != 0:
        say(f"      HGMMA count: not available ({sass.stderr.strip()[:200]})")
        return
    func, per = "", {}
    for line in sass.stdout.splitlines():
        if "Function :" in line:
            func = line.split("Function :")[1].strip()
        elif "flash" in func or "ssd_" in func:
            n = per.setdefault(func, [0, 0])
            n[0] += "HGMMA" in line
            n[1] += " HMMA" in line
    for func, (hgmma, hmma) in sorted(per.items()):
        say(f"      SASS {kernel_name(func)}: {hgmma} HGMMA, {hmma} HMMA")


def attn_step_flops(cfg, batch: int, seq: int) -> float:
    """The attention products of a train step: 14 hd a pair and head (4
    forward, 10 backward) over the pairs the mask keeps, S(S+1)/2 for a
    causal config and S^2 for a bidirectional one."""
    pairs = seq * (seq + 1) // 2 if cfg.causal else seq * seq
    return 14.0 * cfg.head_dim * pairs * cfg.n_heads * batch * cfg.n_layers


def say_rate(name: str, ms: float, flops: float, bound_ms: float) -> None:
    say(f"    {name}: {flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s, "
        f"{100 * bound_ms / ms:.1f}% of its bound ({bound_ms:.4f} ms)")


def kernel_ms(ranked, needle: str) -> float:
    return sum(ms for name, ms in ranked if needle in name)


def compare(torch, name, got, want, dtype, tol=None) -> float:
    """max |got - want|; fails unless |got - want| <= tol + tol |want|."""
    tol = TOL[dtype] if tol is None else tol
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        fail(f"{name}: non-finite values")
    err = (g - w).abs()
    bad = int((err > tol + tol * w.abs()).sum())
    max_err = float(err.max())
    say(f"  {name}: max_abs_err={max_err:.3e} tol={tol} "
        f"{'ok' if bad == 0 else f'{bad} elements out of tolerance'}")
    if bad:
        fail(f"{name} disagrees with its plain version")
    return max_err


def compare_scaled(torch, name, got, want, tol, norm_tol) -> float:
    """max |got - want|; fails unless it is <= tol * max |want| and
    |got - want| / |want| (Frobenius) <= norm_tol."""
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        fail(f"{name}: non-finite values")
    max_err = float((g - w).abs().max())
    limit = tol * float(w.abs().max())
    norm_err = float((g - w).norm() / w.norm())
    ok = max_err <= limit and norm_err <= norm_tol
    say(f"  {name}: max_abs_err={max_err:.3e} <= {tol} * max|want| = "
        f"{limit:.3e} (median|want|={float(w.abs().median()):.3e}); "
        f"|err|/|want|={norm_err:.3e} <= {norm_tol} "
        f"{'ok' if ok else 'OUT OF TOLERANCE'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return max_err


def fingerprint(torch, tree, flatten):
    """Per-leaf (sum, sum of squares) in fp64: cheap evidence of change."""
    out = {}
    for path, t in flatten(tree):
        t64 = t.detach().double()
        out[path] = (float(t64.sum()), float((t64 * t64).sum()))
    return out


def release(torch) -> None:
    """Free what a phase left: its Session and the bus handlers that refer
    to it form cycles, which hold device memory until collected."""
    gc.collect()
    torch.cuda.empty_cache()


def counts(**kw):
    """Launch counts of every kernel: those named, and 0 for the rest."""
    return {name: kw.get(name, 0) for name in KERNELS}


def norm_count(cfg) -> int:
    """RMSNorm launches of a decoder or encoder forward: ln1 and ln2 a
    layer, the q- and k-norm where the config has them, the final norm."""
    return (4 if cfg.qk_norm else 2) * cfg.n_layers + 1


def prefill_batch(c, cfg, batch: int = 1, seq: int = 0, seed: int = 0):
    """A prefill batch on the card from `seed`: `seq` (SEQ by default)
    tokens, for the VLM
    with three distinct t/h/w position rows (equal rows would compute
    plain RoPE), or frame features for the audio encoder."""
    torch = c.torch
    seq = seq or SEQ
    c.gen.manual_seed(seed)
    if cfg.family == "audio":
        return {"features": torch.randn((batch, seq, cfg.frontend_dim),
                                        generator=c.gen, device=c.dev)}
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq),
                                   generator=c.gen, device=c.dev)}
    if cfg.family == "vlm":
        hw = torch.randint(0, 3 * seq, (2, batch, seq), generator=c.gen,
                           device=c.dev)
        t = torch.arange(seq, device=c.dev).expand(1, batch, seq)
        out["positions"] = torch.cat([t, hw])
    return out


def state_bytes(*trees) -> int:
    """Bytes of the card's tensors in ``trees`` (nested dicts, lists and
    tuples of tensors), each storage once."""
    seen, total = set(), 0
    stack = list(trees)
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
        elif hasattr(t, "untyped_storage") and t.is_cuda:
            st = t.untyped_storage()
            if st.data_ptr() not in seen:
                seen.add(st.data_ptr())
                total += st.nbytes()
    return total


def phase_prefill(c, tag: str, arch: str, want: dict):
    """A full-width prefill (B=1, S=SEQ, random weights from seed 0)
    through `make_prefill_step`, whose launches must be `want`; its
    launches, peak, device busy time and the bytes the process held
    outside the prefill's arguments are kept in ``c.measured`` for
    phase 22. Returns (session, params, launches)."""
    torch = c.torch
    cfg = c.get_config(arch, smoke=False)
    say(f"[{tag}] prefill: {cfg.name} full width (L={cfg.n_layers} "
        f"d={cfg.d_model} V={cfg.vocab_size}), B=1 S={SEQ}, {cfg.dtype}")
    session = c.Session.from_arch(arch, smoke=False)
    t0 = time.monotonic()
    params = session.params
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in c.flatten(params))
    say(f"  init {n_params / 1e9:.3f} B fp32 params on the card in "
        f"{time.monotonic() - t0:.2f}s")
    prefill = c.make_prefill_step(cfg)
    batch = prefill_batch(c, cfg)
    prefill(params, batch)                         # warm-up (cuBLAS, build)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    outside = torch.cuda.memory_allocated() - state_bytes(params, batch)
    c.ops.reset_launches()
    t0 = time.monotonic()
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    first_ms = (time.monotonic() - t0) * 1e3
    launches = dict(c.ops.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    say(f"  launches {launches} (predicted {want})")
    if launches != want:
        fail("prefill did not launch the kernels as predicted")
    if tuple(logits.shape) != (1, SEQ, cfg.vocab_size):
        fail(f"prefill logits shape {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        fail("prefill logits are not finite")
    walls = []
    for _ in range(3):
        t0 = time.monotonic()
        prefill(params, batch)
        torch.cuda.synchronize()
        walls.append((time.monotonic() - t0) * 1e3)
    prefill_ms = statistics.median(walls)
    say(f"  prefill {prefill_ms:.2f} ms median of 3 (counted run "
        f"{first_ms:.2f} ms), {SEQ / prefill_ms * 1e3:.0f} tok/s, peak "
        f"memory {peak_gb:.2f} GB")
    busy_ms, ranked = device_profile(torch, lambda: prefill(params, batch), 2)
    say_profile("prefill", prefill_ms, busy_ms, ranked, by_category=True)
    vars(c).setdefault("measured", {})[("prefill", arch)] = dict(
        launches=launches, peak_gb=peak_gb, busy_ms=busy_ms,
        outside_gb=outside / 1e9)
    return session, params, launches


def phase_serve(c, tag: str, session, params, per_step: dict, tol: float,
                in_fp32: bool = False, fp32_cfg=None):
    """`Session.serve` twice with one seed: identical greedy streams,
    `per_step` launches in each decode step, and the gateway's logits at
    the last prompt position within `tol` (of max |logit|) of prefill's:
    in the model's dtype with the engine's bf16 state, or with `in_fp32`
    in an fp32 model and state (the bf16 distance is then printed only),
    of `fp32_cfg` where one is given (an MoE config at its no-drop
    capacity, whose bf16 distance is printed too). Returns the
    launches."""
    torch = c.torch
    cfg = session.cfg
    steps = PROMPT_LEN + N_TOKENS - 1
    say(f"[{tag}] serve: {cfg.name} Session.serve(tokens={N_TOKENS}, "
        f"batch={N_BATCH}, prompt_len={PROMPT_LEN}), greedy, twice; "
        f"{steps} steps each")
    c.ops.reset_launches()
    reps = [session.serve(tokens=N_TOKENS, batch=N_BATCH,
                          prompt_len=PROMPT_LEN, seed=1) for _ in range(2)]
    torch.cuda.synchronize()
    serve_launches = dict(c.ops.launches)
    want = {k: 2 * steps * n for k, n in per_step.items()}
    say(f"  launches {serve_launches} (predicted {want}: {per_step} per "
        "decode step)")
    if serve_launches != want:
        fail("serve did not launch the kernels as predicted")
    a, b = (r.generated for r in reps)
    if a.shape != (N_BATCH, N_TOKENS) or not torch.equal(a, b):
        fail(f"greedy replay differs: {a.tolist()} vs {b.tolist()}")
    say(f"  greedy replay identical; slot 0 tokens {a[0].tolist()}")
    for i, r in enumerate(reps):
        say(f"  run {i}: {r.tokens_per_second:.1f} tok/s, decode p50 "
            f"{r.decode_ms_p50:.3f} ms p95 {r.decode_ms_p95:.3f} ms p99 "
            f"{r.decode_ms_p99:.3f} ms, prompt feed {r.prefill_seconds:.3f}s")

    # the gateway's logits at the last prompt position vs prefill's
    c.gen.manual_seed(7)
    prompt = torch.randint(0, cfg.vocab_size, (N_BATCH, PROMPT_LEN),
                           generator=c.gen, device=c.dev)

    def gateway_vs_prefill(cfg, state_dtype):
        eng = c.GatewayEngine(cfg, params, slots=N_BATCH,
                              max_len=PROMPT_LEN + N_TOKENS, seed=1)
        if state_dtype is not None:   # in place of the engine's bf16 state
            eng.state, eng._axes = c.model_api.init_decode_state(
                cfg, N_BATCH, PROMPT_LEN + N_TOKENS, dtype=state_dtype,
                device=c.dev)
        for slot in range(N_BATCH):
            eng.join(slot, rid=slot, prompt=prompt[slot].tolist(),
                     max_new=N_TOKENS)
        for _ in range(PROMPT_LEN):
            eng.step()
        served = eng.last_logits.float()
        pre = c.make_prefill_step(cfg)(params, {"tokens": prompt})[:, -1]
        pre = pre.float()
        rel = float((served - pre).abs().max() / pre.abs().max())
        agree = float((served.argmax(-1) == pre.argmax(-1)).float().mean())
        say(f"  gateway vs prefill logits at position {PROMPT_LEN - 1}, "
            f"{cfg.dtype} model, "
            f"{'fp32' if state_dtype is torch.float32 else 'bf16'} state: "
            f"max|diff|/max|prefill| = {rel:.4e}, argmax agreement "
            f"{agree:.2f}")
        return rel, eng

    rel, eng = gateway_vs_prefill(cfg, None)
    if fp32_cfg is not None:     # bf16 without the prefill's drops
        gateway_vs_prefill(fp32_cfg, None)
    if in_fp32:
        rel, _ = gateway_vs_prefill((fp32_cfg or cfg).with_(dtype="float32"),
                                    torch.float32)
    say(f"  held: {rel:.4e} <= {tol} ({'fp32' if in_fp32 else 'bf16'})")
    if not math.isfinite(rel) or rel > tol:
        fail("the serving path disagrees with the prefill path")
    say_profile(f"one gateway decode step ({N_BATCH} slots)",
                reps[1].decode_ms_p50, *device_profile(torch, eng.step, 4))
    return serve_launches


def phase_train(c, tag: str, arch: str, per_step: dict,
                extra_flops: float, what: str):
    """`Session.train` at full width (TRAIN_STEPS steps, B=TRAIN_BATCH,
    S=SEQ, AdamW, batches from the arch's source: frame features for the
    encoder): `per_step` launches in each step, finite losses, a first
    loss near ln(vocab), every parameter changed by step 1; step time,
    tokens/s, MFU (6 N per token plus `extra_flops` a step), peak memory,
    the busy share and the profiled step's device time by category.
    Returns the launches."""
    torch = c.torch
    t_phase = time.monotonic()
    cfg = c.get_config(arch, smoke=False)
    tokens_per_step = TRAIN_BATCH * SEQ
    step_flops = 6.0 * cfg.param_count() * tokens_per_step + extra_flops
    say(f"[{tag}] train: {cfg.name} Session.train({TRAIN_STEPS} steps, "
        f"global_batch={TRAIN_BATCH}, seq_len={SEQ}), AdamW, full width; "
        f"{step_flops / 1e12:.2f} TFLOP per step ({what})")
    tsess = c.Session.from_arch(arch, smoke=False, checkpoint_interval=0)
    # the trainer draws its weights as `model_api.init` does, from a
    # generator seeded with 0 on the card: two draws must agree for the
    # "changed by step 1" check below to mean anything
    before = fingerprint(torch, c.model_api.init(cfg, device=c.dev)[0],
                         c.flatten)
    if fingerprint(torch, c.model_api.init(cfg, device=c.dev)[0],
                   c.flatten) != before:
        fail("two seeded draws of the weights differ")
    torch.cuda.empty_cache()
    after_step1 = {}

    def on_step(kind, payload):
        if payload["step"] == 0:
            after_step1.update(fingerprint(
                torch, tsess.trainer.state.params, c.flatten))
    tsess.bus.subscribe("step", on_step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c.ops.reset_launches()
    with tempfile.TemporaryDirectory() as ckdir:
        rep = tsess.train(TRAIN_STEPS, global_batch=TRAIN_BATCH, seq_len=SEQ,
                          members=1, checkpoint_dir=ckdir)
    torch.cuda.synchronize()
    train_launches = dict(c.ops.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {k: TRAIN_STEPS * n for k, n in per_step.items()}
    say(f"  launches {train_launches} (predicted {want}: {per_step} per "
        "step)")
    if train_launches != want:
        fail("the train steps did not launch the kernels as predicted")
    say(f"  losses {rep.losses}; grad norms {rep.grad_norms}")
    if not all(math.isfinite(x) for x in rep.losses + rep.grad_norms):
        fail("a loss or gradient norm is not finite")
    ln_v = math.log(cfg.vocab_size)
    if abs(rep.losses[0] - ln_v) > 1.5:
        fail(f"first loss {rep.losses[0]:.3f} is not within 1.5 of "
             f"ln({cfg.vocab_size}) = {ln_v:.3f}")
    unchanged = [p for p in before if before[p] == after_step1[p]]
    say(f"  {len(before) - len(unchanged)} of {len(before)} parameter leaves "
        "changed by step 1")
    if unchanged or len(after_step1) != len(before):
        fail(f"parameter leaves unchanged by step 1: {unchanged}")
    times = [r.t for r in tsess.trainer.profiler.records]
    step_s = statistics.median(b - a for a, b in zip(times, times[1:]))
    mfu = step_flops / step_s / PEAK_FLOPS["bfloat16"]
    say(f"  step {step_s * 1e3:.1f} ms (median of steps 2-{TRAIN_STEPS}), "
        f"{tokens_per_step / step_s:.0f} tokens/s, MFU {100 * mfu:.2f}% "
        f"of 989 TFLOP/s, peak memory {peak_gb:.2f} GB, first loss "
        f"{rep.losses[0]:.4f} (ln V = {ln_v:.4f})")
    trainer = tsess.trainer
    loader = c.ShardedLoader(c.source_for_config(cfg, SEQ, seed=1),
                             TRAIN_BATCH)
    batch = {k_: torch.from_numpy(v_).to(c.dev)
             for k_, v_ in loader.next_global(1).items()}
    n_ev = {}
    busy_ms, ranked = device_profile(
        torch, lambda: trainer.train_step(trainer.state, batch), 1,
        count=n_ev)
    say_profile("one train step", step_s * 1e3, busy_ms, ranked, top=12,
                by_category=True)
    norm_ms = kernel_ms(ranked, "rmsnorm_")
    norm_n = sum(k for name, k in n_ev["by_name"].items()
                 if "rmsnorm_" in name)
    was = NORM_STEP_RECOMPUTE.get(arch)
    say(f"  RMSNorm forward and backward on the device: {norm_ms:.3f} ms "
        f"in {norm_n:.0f} kernels a step ({100 * norm_ms / busy_ms:.2f}% of "
        f"the busy time; {n_ev['events']:.0f} kernels and copies in the "
        "step)" + ("" if was is None else
                   f"; with the backward as autograd over the plain forward"
                   f" it took {was[0]} ms in {was[1]} kernels of {was[2]}"))
    state = trainer.state
    zeros = c.tree_map(torch.zeros_like, state.params)
    opt_ms = time_ms(torch, lambda: trainer.opt.update(
        zeros, state.opt, state.params, state.step), warmup=1, iters=3)
    n_params = sum(t.numel() for _, t in c.flatten(state.params))
    say(f"  AdamW update alone ({n_params / 1e9:.2f} B fp32 params, CUDA "
        f"events): {opt_ms:.2f} ms, {100 * opt_ms / (step_s * 1e3):.1f}% of "
        "the step")
    del tsess, trainer, rep, batch, state, zeros
    release(torch)
    say(f"  train ({cfg.name}) in {time.monotonic() - t_phase:.1f} s")
    return train_launches


@contextlib.contextmanager
def recording_routes(layers, out: list):
    """While open, every MoE group's dispatch appends (top_e, kept-pair
    mask) to ``out``, on the host."""
    dispatch = layers._group_dispatch

    def recorded(xg, eid, w, n_experts, cap):
        buf, meta = dispatch(xg, eid, w, n_experts, cap)
        out.append((eid.cpu(), meta[3].cpu()))
        return buf, meta
    layers._group_dispatch = recorded
    try:
        yield out
    finally:
        layers._group_dispatch = dispatch


def phase_parity(c, tag: str, arch: str, want_step: dict, tol: dict,
                 dtype: str = "bfloat16"):
    """One `make_train_step` of `arch` cut to 2 layers at full width, on
    the card (kernels) and on the CPU (plain versions), from one set of
    weights and one batch: loss, gradient norm and every gradient leaf
    within `tol`. For an MoE config also the forward's routing (every
    group's top_e and kept-pair mask) equal and its aux loss within 1e-5
    relative. The batch comes from the arch's source (frame features for
    the encoder); the VLM's also carries three distinct position rows, as
    `prefill_batch` draws them."""
    torch = c.torch
    t_phase = time.monotonic()
    pcfg = c.get_config(arch, smoke=False).with_(n_layers=2, dtype=dtype)
    p_seq = 256
    say(f"[{tag}] parity: make_train_step on {pcfg.name} cut to "
        f"{pcfg.n_layers} layers at full width, B=1 S={p_seq} {dtype}, on "
        "the card (kernels) and on the CPU (plain versions)")
    cpu_gen = torch.Generator().manual_seed(3)
    cpu_params, _ = c.model_api.init(pcfg, cpu_gen, device="cpu")
    np_batch = c.ShardedLoader(c.source_for_config(pcfg, p_seq, seed=2),
                               1).next_global(1)
    if pcfg.family == "vlm":
        np_batch["positions"] = prefill_batch(
            c, pcfg, seq=p_seq, seed=2)["positions"].cpu().numpy()
    results = {}
    for where in ("cuda", "cpu"):
        device = c.dev if where == "cuda" else torch.device("cpu")
        params = c.tree_map(lambda t: t.to(device, copy=True), cpu_params)
        batch = {k_: torch.from_numpy(v_).to(device)
                 for k_, v_ in np_batch.items()}
        t0 = time.monotonic()
        routes = []
        if pcfg.moe is not None:
            with recording_routes(c.layers, routes), torch.no_grad():
                _, aux = c.model_api.forward(params, pcfg, batch["tokens"])
            aux = float(aux)
        live = c.tree_map(lambda t: t.detach().requires_grad_(), params)
        c.model_api.loss_fn(live, pcfg, batch).backward()
        grads = {p_: t.grad.float().cpu() for p_, t in c.flatten(live)}
        del live
        train_step, opt = c.steps.make_train_step(pcfg, c.RunConfig())
        state = c.steps.TrainState(params, opt.init(params),
                                   torch.zeros((), dtype=torch.int32))
        start = fingerprint(torch, params, c.flatten)
        c.ops.reset_launches()
        state, metrics = train_step(state, batch)
        if where == "cuda":
            torch.cuda.synchronize()
            step_launches = dict(c.ops.launches)
        changed = fingerprint(torch, state.params, c.flatten)
        results[where] = dict(loss=float(metrics["loss"]),
                              grad_norm=float(metrics["grad_norm"]),
                              grads=grads, seconds=time.monotonic() - t0,
                              routes=routes,
                              aux=aux if pcfg.moe is not None else None,
                              unchanged=[p_ for p_ in start
                                         if start[p_] == changed[p_]])
        del params, state, batch, train_step, opt
    release(torch)
    gpu, cpu = results["cuda"], results["cpu"]
    say(f"  card train step launches {step_launches} (predicted "
        f"{want_step}); gradient pass + step: card {gpu['seconds']:.1f}s, "
        f"CPU {cpu['seconds']:.1f}s")
    if step_launches != want_step:
        fail("the card's train step did not launch the kernels as predicted")
    if gpu["unchanged"]:
        fail(f"leaves unchanged by the card's step: {gpu['unchanged']}")
    rel = {k_: abs(gpu[k_] - cpu[k_]) / abs(cpu[k_])
           for k_ in ("loss", "grad_norm")}
    leaf_rel = {p_: float((gpu["grads"][p_] - g).abs().max())
                / float(g.abs().max()) for p_, g in cpu["grads"].items()}
    worst = max(leaf_rel.items(), key=lambda kv: kv[1])
    say(f"  loss card {gpu['loss']:.6f} CPU {cpu['loss']:.6f} (rel "
        f"{rel['loss']:.3e}, tol {tol['loss']}); grad norm card "
        f"{gpu['grad_norm']:.6f} CPU {cpu['grad_norm']:.6f} (rel "
        f"{rel['grad_norm']:.3e}, tol {tol['grad_norm']}); worst "
        f"gradient leaf {worst[0]}: max|diff|/max|leaf| {worst[1]:.3e} "
        f"(tol {tol['grad_leaf']})")
    say("  every leaf: " + ", ".join(f"{p_} {r:.2e}"
                                     for p_, r in sorted(leaf_rel.items())))
    if (rel["loss"] > tol["loss"] or rel["grad_norm"] > tol["grad_norm"]
            or not worst[1] <= tol["grad_leaf"]):
        fail("the card's train step disagrees with the plain path")
    say(f"  parity ({pcfg.name}) in {time.monotonic() - t_phase:.1f} s")
    if pcfg.moe is None:
        return
    same = len(gpu["routes"]) == len(cpu["routes"]) and all(
        torch.equal(ge, ce) and torch.equal(gk, ck)
        for (ge, gk), (ce, ck) in zip(gpu["routes"], cpu["routes"]))
    aux_rel = abs(gpu["aux"] - cpu["aux"]) / abs(cpu["aux"])
    kept = [int(k.sum()) for _, k in cpu["routes"]]
    say(f"  routing of {len(cpu['routes'])} MoE group(s): card and CPU "
        f"{'equal' if same else 'DIFFER'} (kept pairs {kept} of "
        f"{[k.numel() for _, k in cpu['routes']]}); aux loss card "
        f"{gpu['aux']:.8f} CPU {cpu['aux']:.8f} (rel {aux_rel:.3e}, tol "
        "1e-5)")
    if not same or not aux_rel <= 1e-5:
        fail("the card's MoE routing or aux loss disagrees with the CPU's")


def fleet_raw(results):
    """`SimResult`s as the arrays `run_batched(raw=True)` returns."""
    import numpy as np
    return {key: np.array([getattr(r, key) for r in results])
            for key in ("total_time_s", "steps_done", "revocations",
                        "replacements", "checkpoint_time_s", "lost_steps",
                        "monetary_cost", "paused_s", "restore_delay_s")}


def fleet_parity(name: str, got: dict, want: dict, total_steps: int) -> dict:
    """Hold the device engine's per-trajectory stats against the batched
    engine's under the fleet contract; fail on any breach. Returns the
    largest relative error of each continuous stat."""
    import numpy as np
    for key in ("revocations", "replacements"):
        bad = np.flatnonzero(np.asarray(got[key]) != np.asarray(want[key]))
        if bad.size:
            j = int(bad[0])
            fail(f"{name}: {key} differ in {bad.size} trajectories (first: "
                 f"trajectory {j}, {got[key][j]} vs {want[key][j]})")
    fin_g = int((got["steps_done"] >= total_steps).sum())
    fin_w = int((want["steps_done"] >= total_steps).sum())
    if fin_g != fin_w or np.abs(got["steps_done"]
                                - want["steps_done"]).max() > 1:
        fail(f"{name}: finished {fin_g} vs {fin_w}, or steps_done off by "
             "more than 1")
    errs = {}
    for key, (rtol, atol) in FLEET_TOL.items():
        g, w = np.asarray(got[key], float), np.asarray(want[key], float)
        diff = np.abs(g - w)
        if not (diff <= atol + rtol * np.abs(w)).all():
            j = int(np.argmax(diff - rtol * np.abs(w)))
            fail(f"{name}: {key} out of tolerance at trajectory {j}: "
                 f"{g[j]!r} vs {w[j]!r}")
        errs[key] = float((diff / np.maximum(np.abs(w), 1e-300)).max())
    return dict(errs, finished=fin_g)


def phase_fleet(c, tag: str) -> dict:
    """The fleet simulator's device engine on the card: regional_wave at
    FLEET_N trajectories through `Session.simulate` (the counted main
    path), warm `run_jit` timings and busy share, then the corpus. Returns
    the launches of the counted run."""
    import numpy as np
    from repro_torch.chaos.injectors import keyed_uniforms
    from repro_torch.chaos.scenarios import get_scenario
    from repro_torch.core.transient.fleet_batched import (FleetDraws,
                                                          run_batched)
    from repro_torch.core.transient.fleet_jit import run_jit
    torch = c.torch
    sc = get_scenario("regional_wave")
    ses = c.Session.from_arch("qwen3-1.7b", smoke=True)
    fleet_kw = dict(n_workers=sc.n_workers, gpu=sc.gpu, region=sc.region,
                    steps=sc.total_steps, seed=0, handover=sc.handover,
                    provider=sc.provider)
    sim, n_steps = ses._fleet_sim(**fleet_kw)
    sim.chaos = sc.timeline(sim._roster, seed=0)
    n = FLEET_N
    args = (n_steps, n, sc.max_hours, 0.0)
    say(f"[{tag}] fleet: regional_wave ({sc.description}), {sc.n_workers} x "
        f"{sc.gpu} in {sc.region} on {sc.provider}, {n_steps} steps, "
        f"{sc.max_hours:.0f} h horizon, {n} trajectories; device engine vs "
        "the port's batched engine on the same draws")
    t0 = time.monotonic()
    draws = FleetDraws(sim, n, 0.0)
    t1 = time.monotonic()
    want = run_batched(sim, *args, draws=draws, raw=True)
    batched_s = time.monotonic() - t1
    say(f"  FleetDraws {t1 - t0:.3f}s; run_batched(raw=True) on the host "
        f"{batched_s:.3f}s (once), {n / batched_s:.0f} trajectories/s")

    # the counted main path: the entry point a user calls
    torch.cuda.synchronize()
    c.ops.reset_launches()
    t0 = time.monotonic()
    ens = ses.simulate(samples=n, engine="jit", chaos=sim.chaos,
                       max_hours=sc.max_hours, **fleet_kw)
    torch.cuda.synchronize()
    cold_s = time.monotonic() - t0
    main_launches = launches = dict(c.ops.launches)
    say(f"  Session.simulate(samples={n}, engine='jit') on "
        f"{ses.device}: {cold_s:.3f}s cold (pools built, {len(ens)} "
        f"SimResults); launches {launches}")
    if launches["event_select_fwd"] == 0 or any(
            v for k, v in launches.items() if k != "event_select_fwd"):
        fail("the device engine did not launch event_select alone")
    errs = fleet_parity("Session.simulate vs run_batched",
                        fleet_raw(ens.results), want, n_steps)
    st = ens.stats
    say(f"  held: counts exact, finished {errs['finished']}/{n}; max "
        "relative error " + ", ".join(
            f"{k} {v:.2e}" for k, v in errs.items() if k != "finished"))
    say(f"  ensemble: time p50 {st.time_p50_s:.1f}s p90 "
        f"{st.time_p90_s:.1f}s, cost mean ${st.cost_mean:.4f}, "
        f"revocations mean {st.revocations_mean:.3f} p90 "
        f"{st.revocations_p90:.1f}, replacements mean "
        f"{st.replacements_mean:.3f}")

    # warm engine core, as bench_jit_engine times it
    stats = {}
    got = run_jit(sim, *args, draws=draws, raw=True, stats=stats,
                  device=ses.device)
    torch.cuda.synchronize()
    fleet_parity("run_jit(raw=True) vs run_batched", got, want, n_steps)
    walls = []
    for _ in range(3):
        t0 = time.monotonic()
        run_jit(sim, *args, draws=draws, raw=True, device=ses.device)
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
    warm_s = min(walls)
    say(f"  run_jit(raw=True) warm: best of 3 {warm_s:.4f}s ({walls}), "
        f"{n / warm_s:.0f} trajectories/s; {stats['rounds']} rounds, "
        f"{stats['entries']} loop entries, {stats['doublings']} pool "
        f"doublings, {stats['levels']} levels; batched/device "
        f"{batched_s / warm_s:.2f}x (host NumPy vs card, not a claim)")
    prof_count = {}
    say_profile("one warm run_jit", warm_s * 1e3, *device_profile(
        torch, lambda: run_jit(sim, *args, draws=draws, raw=True,
                               device=ses.device), 1, count=prof_count),
                top=8)
    say(f"  {prof_count['events']:.0f} device kernels and copies in the "
        f"run, {prof_count['events'] / stats['rounds']:.0f} per round; "
        f"{warm_s * 1e3 / stats['rounds']:.2f} ms of wall per round")

    # the keyed join draws the pools need, per key and vectorized
    keys = np.stack([np.zeros(2000, np.int64), np.full(2000, 0xC4A15),
                     np.zeros(2000, np.int64), np.arange(2000),
                     np.arange(2000) % 4, np.ones(2000, np.int64)], 1)
    t0 = time.monotonic()
    for k in keys:
        np.random.default_rng(np.random.SeedSequence(
            tuple(int(v) for v in k))).random()
    per_key_us = (time.monotonic() - t0) / len(keys) * 1e6
    big = np.stack([np.zeros(4 * n, np.int64), np.full(4 * n, 0xC4A15),
                    np.zeros(4 * n, np.int64), np.arange(4 * n) // 4,
                    np.arange(4 * n) % 4, np.ones(4 * n, np.int64)], 1)
    t0 = time.monotonic()
    keyed_uniforms(big)
    vec_s = time.monotonic() - t0
    say(f"  keyed join draws on the host: one Generator per key "
        f"{per_key_us:.1f} µs each ({len(keys)} keys), keyed_uniforms "
        f"{vec_s:.4f} s for the {4 * n} keys of one pool level "
        f"({vec_s / (4 * n) * 1e6:.3f} µs each)")

    # the corpus on CUDA's f64 math: aws/azure laws, graceful
    # checkpoints, replace=False
    corpus_launches = 0
    for (prov, region, gpu, nw, ho, rep, comp, i_c, mh, sh,
         seed) in FLEET_CORPUS:
        workers = [c.SimWorker(i, gpu, region, 4.56) for i in range(nw)]
        csim = c.FleetSim(
            workers, model_gflops=1.54, model_bytes=1.87e6,
            step_speed_of=lambda g: 4.56, checkpoint_interval_steps=i_c,
            checkpoint_time_s=3.84, n_ps=1, seed=seed, handover=ho,
            replace=rep, price_of={gpu: 0.74}, provider=prov,
            grad_compression=comp)
        cdraws = FleetDraws(csim, FLEET_CORPUS_N, sh)
        cargs = (250_000, FLEET_CORPUS_N, mh, sh)
        cwant = run_batched(csim, *cargs, draws=cdraws, raw=True)
        before = c.ops.launches["event_select_fwd"]
        cstats = {}
        cgot = run_jit(csim, *cargs, draws=cdraws, raw=True, stats=cstats,
                       device=ses.device)
        torch.cuda.synchronize()
        corpus_launches += c.ops.launches["event_select_fwd"] - before
        cerr = fleet_parity(f"corpus {prov}/{region}/{gpu}", cgot, cwant,
                            250_000)
        say(f"  corpus {prov} {region} {nw}x{gpu} handover={ho} "
            f"replace={rep} {comp}: held ({cstats['rounds']} rounds, "
            f"revocations {int(np.sum(cgot['revocations']))}, finished "
            f"{cerr['finished']}/{FLEET_CORPUS_N}, time rel err "
            f"{cerr['total_time_s']:.1e})")
    say(f"  event_select launches: {main_launches['event_select_fwd']} in "
        f"the counted Session.simulate run, {corpus_launches} in the corpus "
        "runs (not counted)")
    del ses, sim, draws, ens
    release(torch)
    return main_launches


# the ledger the live chaos runs are held to, card against CPU: every
# controller check, mitigation, drift alarm and refit, field for field
LEDGER_KINDS = ("detection", "mitigation", "model_drift", "model_refit")
# (scenario, armed, on the full-width config): ckpt_outage saves every 5
# steps, and a full-width save is ~20.6 GB (fp32 params 6.9 GB, two AdamW
# moments 13.8 GB), so its 60 steps would write over 100 GB: it runs at
# the SMOKE config on the card
LIVE_SCENARIOS = (("ps_crash", None, True),
                  ("straggler", "recalibration", True),
                  ("ckpt_outage", "resilience", False))


def phase_live(c, tag: str) -> dict:
    """The §VI-B live loop through `Session.chaos(scenario, smoke=True)`:
    the chaos runner's live branch trains qwen3-1.7b on the card under a
    virtual clock while silent faults fire, and the scenario's gates
    score what the controller detected and did. Each scenario's ledger
    (controller checks, mitigations, drift alarms, refits, virtual
    seconds) must equal that of the port's own CPU run of the scenario at
    SMOKE in fp32 (the clock prices a step from the plan and the mitigated
    PS alone); every live step must launch the flash kernels once per
    layer each way and RMSNorm once per norm each way. Prints each
    compression scheme's step ms, the time of each mitigation's step
    rebuild, peak memory against its reckoning, and each scenario's
    seconds. Returns the launches."""
    import dataclasses
    from repro_torch.api import session as session_mod
    from repro_torch.calibration import RecalibrationConfig
    from repro_torch.core.trainer import TransientTrainer
    from repro_torch.dist.compression import compression_ratio
    from repro_torch.resilience import ResilienceConfig
    torch = c.torch
    say(f"[{tag}] live loop: Session.chaos(smoke=True) on qwen3-1.7b, the "
        "chaos runner's live branch (B=4, S=32, virtual clock), held "
        "against the port's CPU run of each scenario at SMOKE in fp32")

    # instrumentation, not the path: keep the child sessions the runner
    # builds (their buses hold the histories), time each train step and
    # each mitigation (the step rebuild and the residual's allocation)
    children, steps_ms, rebuild_ms = [], [], []

    class Recording(session_mod.Session):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            children.append(self)

    make_step = c.steps.make_train_step

    def timed_make_step(cfg, run):
        train_step, opt = make_step(cfg, run)

        def timed(state, batch):
            t0 = time.perf_counter()
            out = train_step(state, batch)
            if batch["tokens"].is_cuda:
                torch.cuda.synchronize()
            steps_ms.append((run.grad_compression,
                             (time.perf_counter() - t0) * 1e3))
            return out
        return timed, opt

    apply_mitigation = TransientTrainer.apply_mitigation

    def timed_mitigation(self, action, state, step=0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = apply_mitigation(self, action, state, step=step)
        torch.cuda.synchronize()
        rebuild_ms.append((step, self.run.grad_compression,
                           (time.perf_counter() - t0) * 1e3))
        return out

    session_mod.Session = Recording
    c.steps.make_train_step = timed_make_step
    TransientTrainer.apply_mitigation = timed_mitigation

    def ledger(child, card):
        hist = [(e.kind, e.payload) for e in child.bus.history
                if e.kind in LEDGER_KINDS]
        live = card["live"]
        return hist, {k: live[k] for k in ("virtual_seconds",
                                           "final_compression",
                                           "final_n_ps", "actions_applied")}

    total = counts()
    for name, armed, full in LIVE_SCENARIOS:
        run_kw = {"recalibration": RecalibrationConfig()} if \
            armed == "recalibration" else {"resilience": ResilienceConfig()} \
            if armed == "resilience" else {}
        cfg = c.get_config("qwen3-1.7b", smoke=not full)
        card_sess = c.Session.from_arch("qwen3-1.7b", smoke=not full,
                                        **run_kw)
        del steps_ms[:], rebuild_ms[:]
        release(torch)
        torch.cuda.reset_peak_memory_stats()
        c.ops.reset_launches()
        t0 = time.monotonic()
        out = card_sess.chaos(name, smoke=True)
        torch.cuda.synchronize()
        card_s = time.monotonic() - t0
        launches = dict(c.ops.launches)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        child = children[-1]
        sc_card = out["scenarios"][name]
        live = sc_card["live"]
        n_steps = live["n_steps"]
        L = cfg.n_layers
        n_norms = norm_count(cfg)
        want = counts(flash_attention_fwd=L * n_steps,
                      flash_attention_bwd=L * n_steps,
                      rmsnorm_fwd=n_norms * n_steps,
                      rmsnorm_bwd=n_norms * n_steps)
        n_params = sum(t.numel() for _, t in c.flatten(
            child.trainer.state.params))
        # fp32 params, gradients and two AdamW moments; with compression
        # also the residual and the error-feedback round trip's three new
        # trees (g + r, its compressed form, the new residual)
        resid = child.trainer.run.grad_compression != "none"
        reckoned_gb = 4 * n_params * (4 + 4 * resid) / 1e9
        scale = ("full width" if full else "SMOKE: a save every 5 steps "
                 "would write ~20.6 GB at full width")
        armed_note = f", {armed} armed" if armed else ""
        say(f"  {name} ({scale}; L={L} d={cfg.d_model}{armed_note}): "
            f"{card_s:.1f}s on {card_sess.device}, {n_steps} steps, peak "
            f"memory {peak_gb:.2f} GB (reckoned {reckoned_gb:.2f} GB: fp32 "
            "params, grads, two AdamW moments"
            f"{', the residual and the round trip' if resid else ''} of "
            f"{n_params / 1e9:.3f} B)")
        say(f"    launches {launches} (predicted {want})")
        if launches != want:
            fail(f"{name}: the live steps did not launch the kernels as "
                 "predicted")
        if not out["passed"]:
            fail(f"{name}: the scenario's gates failed: "
                 f"{sc_card['smoke']['failures']}")
        losses = [e.payload["loss"] for e in child.bus.of_kind("step")]
        if len(losses) != n_steps or not all(map(math.isfinite, losses)):
            fail(f"{name}: the losses are not all finite: {losses}")
        by_scheme = {}
        for scheme, ms in steps_ms:
            by_scheme.setdefault(scheme, []).append(ms)
        say("    step ms by scheme: " + "; ".join(
            f"{k} median {statistics.median(v):.1f} of {len(v)} (min "
            f"{min(v):.1f}, max {max(v):.1f})" for k, v in by_scheme.items()))
        for step, scheme, ms in rebuild_ms:
            say(f"    mitigation at step {step} -> {scheme}: step rebuilt "
                f"in {ms:.1f} ms")
        say(f"    losses {losses[0]:.4f} -> {losses[-1]:.4f}; detections "
            f"{live['detections']}, latency {live['detection_latency_steps']}"
            f" steps, actions {live['actions_applied']}, final compression "
            f"{live['final_compression']}, virtual "
            f"{live['virtual_seconds']} s")
        if name == "ps_crash":
            # one step of each scheme on the run's last state and a live
            # batch, under the profiler (the optimizer moves the weights,
            # after the run)
            trainer = child.trainer
            loader = c.ShardedLoader(c.SyntheticTokenSource(
                cfg.vocab_size, LIVE_SEQ, seed=1), LIVE_BATCH)
            batch = {k_: torch.from_numpy(v_).to(c.dev)
                     for k_, v_ in loader.next_global(1).items()}
            for scheme in ("none", "int8", "topk"):
                step_fn, _ = make_step(cfg, dataclasses.replace(
                    trainer.run, grad_compression=scheme))
                say_profile(f"one {scheme} step", statistics.median(
                    by_scheme[scheme]), *device_profile(
                        torch, lambda: step_fn(trainer.state, batch), 1),
                    top=8, by_category=True)
            del trainer, batch, step_fn
            payload = {}
            for e in child.bus.of_kind("step"):
                if "payload_bytes" in e.payload:
                    payload.setdefault(e.payload["grad_compression"],
                                       e.payload["payload_bytes"])
            full_bytes = 4.0 * n_params
            say(f"    payload bytes: none {full_bytes:.0f} (fp32), int8 "
                f"{payload.get('int8')}, topk {payload.get('topk')}")
            if list(payload) != ["int8", "topk"] or not (
                    math.isclose(payload["int8"], full_bytes
                                 * compression_ratio("int8"), rel_tol=1e-12)
                    and math.isclose(payload["topk"], payload["int8"]
                                     * compression_ratio("topk")
                                     / compression_ratio("int8"),
                                     rel_tol=1e-12)):
                fail("the payload did not drop by the compression ratio "
                     "at each switch")
        if name == "straggler":
            recal = live["recalibration"]
            say(f"    drift events {recal['drift_events']}; refits "
                f"{recal['refits']}; post-refit deviation "
                f"{recal['post_refit_deviation']}")
            if live["actions_applied"] or not recal["drift_events"] or \
                    not recal["refits"] or not (
                        abs(recal["post_refit_deviation"]) < 0.067):
                fail("straggler: no drift/refit, an action, or the refit "
                     "missed")
        if name == "ckpt_outage":
            rec = live["recovery"]
            drill = rec["fallback_drill"]
            say(f"    saves failed {rec['save_failures']}, recovered "
                f"{rec['recovered_saves']}, retries {rec['retries']}, drill "
                f"{drill}")
            if rec["save_failures"] < 3 or rec["recovered_saves"] < 1 or \
                    drill["ok"] is not True or \
                    drill["restored_step"] != drill["corrupted_step"] - 5:
                fail("ckpt_outage: the saves, retries or drill missed")
        card_ledger = ledger(child, sc_card)
        # the oracle: the same scenario on the CPU at SMOKE in fp32
        cpu_sess = c.Session(
            c.get_config("qwen3-1.7b", smoke=True).with_(dtype="float32"),
            card_sess.run, arch="qwen3-1.7b", device="cpu")
        t0 = time.monotonic()
        cpu_out = cpu_sess.chaos(name, smoke=True)
        cpu_ledger = ledger(children[-1], cpu_out["scenarios"][name])
        n_entries = len(card_ledger[0])
        say(f"    ledger: {n_entries} entries "
            f"({', '.join(sorted({k for k, _ in card_ledger[0]}))}) and "
            f"{card_ledger[1]}; the CPU SMOKE run's "
            f"({time.monotonic() - t0:.1f}s) "
            f"{'equal field for field' if card_ledger == cpu_ledger else 'DIFFERS'}")
        if card_ledger != cpu_ledger:
            for a, b in zip(card_ledger[0], cpu_ledger[0]):
                if a != b:
                    say(f"    card {a}\n    cpu  {b}")
            fail(f"{name}: the card's ledger differs from the CPU run's")
        for k in total:
            total[k] += launches[k]
        del card_sess, cpu_sess, child, out, cpu_out
        children.clear()
    session_mod.Session = Recording.__bases__[0]
    c.steps.make_train_step = make_step
    TransientTrainer.apply_mitigation = apply_mitigation
    release(torch)
    return total



# phase 15 (§III): the (B, S) grid of measured train steps, from B=1, S=512
# up to the B=2, S=2048 step phase 6 takes (46.4 GB for qwen3), and the
# point of each arch held out of the fitted predictor
SPEED_ARCHS = ("qwen3-1.7b", "mamba2-1.3b")
SPEED_GRID = ((1, 512), (1, 1024), (2, 768), (1, 1536), (2, 1024),
              (1, 2048), (2, 1536), (2, 2048))
SPEED_HELD = (2, 1024)
# mamba2-1.3b's SSD scan at the grid's other (B, S), as its train step
# calls it (chunk min(256, S)); phase 3 holds these against the plain
# version, as it holds the flash kernels at qwen3's grid shapes
SPEED_SSD_CASES = [(b, s, 64, 64, 1, 128, min(256, s), "bfloat16")
                   for b, s in SPEED_GRID if s != SEQ]
# (3 timed steps a point keep the 23 phases well inside the time limit)
STEP_WARMUP, STEP_TIMED = 2, 3
# phase 15 (§IV): the saved trees, (arch, SMOKE?, depth or None) from
# 1.4 MB to 2.05 GB of fp32 params, each saved CKPT_SAVES times, then the
# full-width qwen3-1.7b params (6.88 GB) once as the held-out point; under
# 25 GB written in all
CKPT_TREES = (("qwen3-1.7b", True, None), ("mamba2-1.3b", True, None),
              ("qwen3-1.7b", True, 48), ("mamba2-1.3b", False, 1),
              ("mamba2-1.3b", False, 4), ("qwen3-1.7b", False, 1),
              ("mamba2-1.3b", False, 8), ("qwen3-1.7b", False, 4))
CKPT_SAVES, CKPT_MAX_BYTES = 2, 25e9
# phase 15 (§V-C): the reference CLI's plan defaults, trajectories a cell
# on the card, and the count at which the card's plan is held against the
# CPU's batched plan (the fleet contract: revocation means, finished and
# the chosen cell exact, time and cost to rtol 1e-9, the stderr and the
# percentiles to 1e-6)
PLAN_KW = dict(gpu="v100", n_workers=4, steps=2000, checkpoint_interval=200,
               score="sim")
PLAN_N, PLAN_CHECK_N = 8192, 1024
PLAN_EXACT = ("region", "launch_hour", "samples", "expected_revocations",
              "finished")
PLAN_TOL = {"expected_time_s": 1e-9, "expected_cost": 1e-9,
            "revocation_stderr": 1e-6, "time_p50_s": 1e-6,
            "time_p90_s": 1e-6, "cost_p50": 1e-6, "cost_p90": 1e-6}


def speed_rows(c, per_step: dict):
    """§III measure: `make_train_step` at full width (bf16, random weights
    from a seed) over SPEED_GRID for each arch; STEP_WARMUP steps, then
    STEP_TIMED timed ones, each between two CUDA events, and one more
    under the profiler. A row's step time is the median of the events'
    times; the median wall time and the profiled step's device busy time
    (its kernels and copies summed) stand beside it. Each step must
    launch `per_step[arch]` kernels. Returns the rows and the launches."""
    torch = c.torch
    rows, total = [], counts()
    for arch in SPEED_ARCHS:
        cfg = c.get_config(arch, smoke=False)
        params, _ = c.model_api.init(cfg, device=c.dev)
        train_step, opt = c.steps.make_train_step(cfg, c.RunConfig())
        state = c.steps.TrainState(params, opt.init(params),
                                   torch.zeros((), dtype=torch.int32))
        torch.cuda.reset_peak_memory_stats()
        for b, s in SPEED_GRID:
            loader = c.ShardedLoader(c.SyntheticTokenSource(
                cfg.vocab_size, s, seed=1), b)
            batch = {k: torch.from_numpy(v).to(c.dev)
                     for k, v in loader.next_global(1).items()}
            torch.cuda.synchronize()
            c.ops.reset_launches()
            walls, events, losses = [], [], []
            for _ in range(STEP_WARMUP + STEP_TIMED):
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                t0 = time.perf_counter()
                start.record()
                state, metrics = train_step(state, batch)
                end.record()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                events.append(start.elapsed_time(end) / 1e3)
                losses.append(float(metrics["loss"]))

            n = STEP_WARMUP + STEP_TIMED

            def one_step():
                nonlocal state, n
                state, _ = train_step(state, batch)
                n += 1
            busy_ms, _ = device_profile(torch, one_step, 1, host=False)
            launches = dict(c.ops.launches)
            want = {k: n * v for k, v in per_step[arch].items()}
            step_s = statistics.median(events[STEP_WARMUP:])
            wall_s = statistics.median(walls[STEP_WARMUP:])
            c_m = cfg.flops_per_token(s) * b * s / 1e9
            rows.append({"arch": arch, "gpu": "h100", "c_m": c_m,
                         "step_time": step_s, "wall_time": wall_s,
                         "device_busy": busy_ms / 1e3, "B": b, "S": s})
            say(f"  {arch} B={b} S={s}: C_m {c_m:.1f} GFLOP, step "
                f"{step_s * 1e3:.2f} ms (events, median of {STEP_TIMED}; "
                f"all {[round(x * 1e3, 2) for x in events]}), wall "
                f"{wall_s * 1e3:.2f} ms, device busy {busy_ms:.2f} ms "
                f"({100 * busy_ms / (step_s * 1e3):.0f}% of the step), "
                f"{b * s / step_s:.0f} tokens/s; loss {losses[-1]:.4f}")
            if launches != want:
                fail(f"{arch} B={b} S={s}: launches {launches}, predicted "
                     f"{want} ({per_step[arch]} a step)")
            if not all(map(math.isfinite, losses)):
                fail(f"{arch} B={b} S={s}: a loss is not finite: {losses}")
            for k in total:
                total[k] += launches[k]
            del batch
        say(f"  {arch}: every point launched {per_step[arch]} a step; peak "
            f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        del params, state, train_step, opt
        release(torch)
    return rows, total


def speed_models(c, rows) -> None:
    """§III model: OLS on min-max C_m and the RBF SVR's grid search, k-fold
    MAE, for both archs and each; `WorkerSpeedPredictor` with SPEED_HELD
    of each arch held out; the Pearson r of C_m and step time, and of
    C_m and device busy time; the step time the Table I transfer
    predicts for the card. Fails only on a fit that is not finite or
    predicts a time at a grid row that is not positive."""
    import numpy as np
    from repro_torch.calibration import transfer_step_time_model
    from repro_torch.core.perf_model.features import minmax_apply, minmax_fit
    from repro_torch.core.perf_model.regression import (LinearModel,
                                                        kfold_mae, mape)
    from repro_torch.core.perf_model.speed_model import WorkerSpeedPredictor
    from repro_torch.core.perf_model.svr import grid_search_svr

    def ols(X, y):
        return LinearModel().fit(X, y)

    for col, what in (("step_time", "step time"),
                      ("device_busy", "device busy time")):
        say(f"  C_m against the {what}:")
        for name, sel in (("both archs", rows),
                          *((a, [r for r in rows if r["arch"] == a])
                            for a in SPEED_ARCHS)):
            c_m = np.array([r["c_m"] for r in sel])
            t = np.array([r[col] for r in sel])
            x = minmax_apply(c_m, *minmax_fit(c_m))[:, None]
            km_ols, ks_ols = kfold_mae(ols, x, t, k=5)
            svr, info = grid_search_svr(x, t, "rbf", k=5)
            r = float(np.corrcoef(c_m, t)[0, 1])
            slope = float(ols(c_m[:, None], t).w[0])
            say(f"    {name} ({len(sel)} rows): Pearson r {r:.4f}; k-fold "
                f"MAE OLS {km_ols * 1e3:.3f} ms (std {ks_ols * 1e3:.3f}), "
                f"SVR-RBF {info['kfold_mae'] * 1e3:.3f} ms (std "
                f"{info['kfold_mae_std'] * 1e3:.3f}; C={info['C']:g}, "
                f"eps={info['epsilon']:.2f}); OLS slope "
                f"{slope * 1e6:.3f} us/GFLOP")
            fitted = np.concatenate([ols(x, t).predict(x), svr.predict(x)])
            if not (math.isfinite(km_ols + info["kfold_mae"])
                    and np.isfinite(fitted).all() and (fitted > 0).all()):
                fail(f"{name} ({what}): a §III fit is not finite, or "
                     "predicts a time that is not positive at a grid row")
    held = [r for r in rows if (r["B"], r["S"]) == SPEED_HELD]
    fit_rows = [r for r in rows if (r["B"], r["S"]) != SPEED_HELD]
    pred = WorkerSpeedPredictor.fit(fit_rows, "h100")
    c_fit = np.array([r["c_m"] for r in fit_rows])
    lo, hi = minmax_fit(c_fit)
    lin = ols(minmax_apply(c_fit, lo, hi)[:, None],
              np.array([r["step_time"] for r in fit_rows]))
    t_held = [r["step_time"] for r in held]
    svr_t = [pred.predict(r["c_m"]) for r in held]
    ols_t = list(lin.predict(minmax_apply(
        np.array([r["c_m"] for r in held]), lo, hi)[:, None]))
    for r, s_, o_ in zip(held, svr_t, ols_t):
        say(f"  held out {r['arch']} B={r['B']} S={r['S']}: measured "
            f"{r['step_time'] * 1e3:.2f} ms, WorkerSpeedPredictor (SVR-RBF) "
            f"{s_ * 1e3:.2f} ms (APE {mape([r['step_time']], [s_]):.2f}%), "
            f"OLS {o_ * 1e3:.2f} ms (APE {mape([r['step_time']], [o_]):.2f}"
            "%)")
    svr_mape, ols_mape = mape(t_held, svr_t), mape(t_held, ols_t)
    fitted = [pred.predict(r["c_m"]) for r in rows]
    say(f"  held-out MAPE: SVR-RBF {svr_mape:.2f}%, OLS {ols_mape:.2f}% "
        f"({len(held)} points); params_hash {pred.params_hash()[:12]}")
    if not all(math.isfinite(v) and v > 0 for v in fitted + ols_t):
        fail("WorkerSpeedPredictor or the held-out OLS gives a step time "
             "that is not finite and positive")
    # the Table I curves (k80, p100, v100) moved to the card by peak
    # FLOP/s: C_m here is GFLOP a step, Table I's GFLOP an image
    tf = PEAK_FLOPS["bfloat16"] / 1e12
    transfer = transfer_step_time_model("h100", target_teraflops=tf)
    ratios = [transfer.predict(r["c_m"]) / r["step_time"] for r in rows]
    say(f"  transfer_step_time_model('h100', target_teraflops={tf:g}): "
        "predicted / measured " + ", ".join(
            f"{r['arch'][:5]} {r['B']}x{r['S']} {q:.3g}"
            for r, q in zip(rows, ratios)))
    say(f"    {sum(0.5 <= q <= 2.0 for q in ratios)} of {len(ratios)} "
        f"points within 2x (ratios {min(ratios):.3g} to {max(ratios):.3g})")


def ckpt_rows(c):
    """§IV measure and model: each of CKPT_TREES (weights drawn on the
    card) saved CKPT_SAVES times through `Checkpointer` in a temporary
    directory removed after it; `CkptRow`s of the sizes and the mean
    seconds; `table4_models` and `CheckpointTimePredictor`; then the
    full-width qwen3-1.7b params saved once, held out. Returns the
    predicted T_c of the held-out save."""
    import numpy as np
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.core.perf_model.checkpoint_model import (
        CheckpointTimePredictor, CkptRow, table4_models)
    torch = c.torch
    rows, written = [], 0

    def save(cfg, n):
        nonlocal written
        params, _ = c.model_api.init(cfg, device=c.dev)
        torch.cuda.synchronize()
        secs = []
        with tempfile.TemporaryDirectory() as d:
            ck = Checkpointer(d, holder="phase-15")
            for i in range(n):
                sizes = ck.save(i, params)
                secs.append(ck.last_save_seconds)
        written += n * sizes.total
        del params
        release(torch)
        return sizes, secs

    for arch, smoke, depth in CKPT_TREES:
        cfg = c.get_config(arch, smoke=smoke)
        cfg = cfg if depth is None else cfg.with_(n_layers=depth)
        sizes, secs = save(cfg, CKPT_SAVES)
        name = f"{arch}{' SMOKE' if smoke else ''} L={cfg.n_layers}"
        rows.append(CkptRow(name, sizes.s_d, sizes.s_m, sizes.s_i,
                            float(np.mean(secs))))
        say(f"  {name}: S_d {sizes.s_d / 1e6:.2f} MB, S_m {sizes.s_m} B, "
            f"S_i {sizes.s_i} B; saves {[round(x, 4) for x in secs]} s "
            f"({sizes.total / np.mean(secs) / 1e9:.2f} GB/s)")
    s_c = [r.s_c for r in rows]
    say(f"  {len(rows)} trees, S_c {min(s_c) / 1e6:.2f} MB to "
        f"{max(s_c) / 1e9:.3f} GB ({math.log10(max(s_c) / min(s_c)):.1f} "
        "orders of magnitude)")
    if math.log10(max(s_c) / min(s_c)) < 3:
        fail("the saved trees span under 3 orders of magnitude")
    for rep in table4_models(rows):
        say(f"  table4 {rep.name} ({rep.input_feature}): k-fold MAE "
            f"{rep.kfold_mae:.4f} s (std {rep.kfold_mae_std:.4f}), test MAE "
            f"{rep.test_mae:.4f} s, MAPE {rep.test_mape:.2f}%")
        if not all(math.isfinite(v) for v in (rep.kfold_mae, rep.test_mae,
                                              rep.test_mape)):
            fail(f"table4 {rep.name}: a fit is not finite")
    pred = CheckpointTimePredictor.fit(rows)
    slope = float(pred.lm.w[0])
    say(f"  CheckpointTimePredictor: T_c = {pred.lm.b:.4f} s + "
        f"{slope * 1e3:.4f} ms/MB")
    if not math.isfinite(slope + pred.lm.b):
        fail("the T_c law is not finite")
    cfg = c.get_config("qwen3-1.7b", smoke=False)
    sizes, secs = save(cfg, 1)
    t_c = pred.predict(sizes.total)
    say(f"  held out qwen3-1.7b full width ({sizes.total / 1e9:.3f} GB, "
        f"4 x {cfg.param_count()} params): measured {secs[0]:.3f} s, "
        f"predicted {t_c:.3f} s ({100 * (t_c - secs[0]) / secs[0]:+.1f}%); "
        f"{written / 1e9:.2f} GB written by the phase")
    if not (math.isfinite(t_c) and t_c > 0):
        fail("the held-out T_c prediction is not finite and positive")
    if written > CKPT_MAX_BYTES:
        fail(f"the phase wrote {written / 1e9:.1f} GB")
    return t_c


def plan_on_card(c, t_c: float) -> dict:
    """§V/§V-C on the card: Eq (4) `Session.predict` for three markets,
    then the sim-scored `Session.plan` on the device engine over every
    GCP (region, hour) cell at PLAN_N trajectories (the counted path),
    and at PLAN_CHECK_N against the CPU's batched plan. Returns the
    counted plan's launches."""
    import dataclasses
    torch = c.torch
    ses = c.Session.from_arch("qwen3-1.7b", smoke=False)
    for prov in ("gcp", "aws", "azure"):
        rep = ses.predict(gpu="v100", n_workers=4, t_c=t_c, provider=prov,
                          steps=PLAN_KW["steps"],
                          checkpoint_interval=PLAN_KW["checkpoint_interval"])
        say(f"  predict {prov}/{rep.region}: worker "
            f"{rep.worker_speed:.4f} steps/s, cluster {rep.cluster_speed:.4f}"
            f"{' (PS-bottlenecked)' if rep.ps_bottlenecked else ''}, T_c "
            f"{rep.checkpoint_seconds:.3f} s, T_p {rep.provision_seconds:.1f}"
            f" s, T_s {rep.replacement_seconds:.1f} s, E[revocations] "
            f"{rep.expected_revocations:.4f}, Eq (4) "
            f"{rep.total_time_seconds:.1f} s")
        if not (math.isfinite(rep.total_time_seconds)
                and rep.total_time_seconds > 0):
            fail(f"predict {prov}: Eq (4) is not finite and positive")
    torch.cuda.synchronize()
    c.ops.reset_launches()
    t0 = time.monotonic()
    best, plans = ses.plan(engine="jit", samples=PLAN_N, t_c=t_c, **PLAN_KW)
    torch.cuda.synchronize()
    plan_s = time.monotonic() - t0
    launches = dict(c.ops.launches)
    regions = sorted({p.region for p in plans})
    say(f"  plan(score='sim', engine='jit') on {ses.device}: "
        f"{len(plans)} cells ({len(regions)} regions {regions} x "
        f"{len(plans) // len(regions)} hours) x {PLAN_N} trajectories in "
        f"{plan_s:.2f} s, {plan_s / len(plans):.3f} s a cell; "
        f"event_select launches {launches['event_select_fwd']} "
        f"({launches['event_select_fwd'] / len(plans):.1f} a cell)")
    if launches["event_select_fwd"] < len(plans) or any(
            v for k, v in launches.items() if k != "event_select_fwd"):
        fail("the sim-scored plan did not launch event_select alone, at "
             "least once a cell")
    say(f"  chosen: {best.region} @ {best.launch_hour:02d}h, E[cost] "
        f"${best.expected_cost:.4f}, E[time] {best.expected_time_s:.1f} s "
        f"(p50 {best.time_p50_s:.1f}, p90 {best.time_p90_s:.1f}), "
        f"E[revocations] {best.expected_revocations:.4f} "
        f"± {best.revocation_stderr:.4f}, finished "
        f"{best.finished}/{best.samples}")
    for p in plans:
        if not (p.finished > 0 and math.isfinite(p.expected_cost)
                and p.expected_cost > 0):
            fail(f"plan cell {p.region} @ {p.launch_hour}h: no finished "
                 "trajectory or a cost that is not finite and positive")
    # the same plan at PLAN_CHECK_N: the card's device engine against the
    # CPU's batched engine, over the same cells and seed
    t0 = time.monotonic()
    gbest, gplans = ses.plan(engine="jit", samples=PLAN_CHECK_N, t_c=t_c,
                             **PLAN_KW)
    torch.cuda.synchronize()
    card_s = time.monotonic() - t0
    cpu = c.Session.from_arch("qwen3-1.7b", smoke=False, device="cpu")
    t0 = time.monotonic()
    bbest, bplans = cpu.plan(engine="batched", samples=PLAN_CHECK_N,
                             t_c=t_c, **PLAN_KW)
    cpu_s = time.monotonic() - t0
    worst = {k: 0.0 for k in PLAN_TOL}
    for g, w in zip(gplans, bplans):
        gd, wd = dataclasses.asdict(g), dataclasses.asdict(w)
        if any(gd[k] != wd[k] for k in PLAN_EXACT):
            fail(f"plan cell {w.region} @ {w.launch_hour}h: "
                 + ", ".join(f"{k} {gd[k]} vs {wd[k]}" for k in PLAN_EXACT
                             if gd[k] != wd[k]))
        for k, tol in PLAN_TOL.items():
            diff = abs(gd[k] - wd[k])
            if diff > tol * (1.0 + abs(wd[k])):
                fail(f"plan cell {w.region} @ {w.launch_hour}h: {k} "
                     f"{gd[k]!r} vs {wd[k]!r}")
            worst[k] = max(worst[k], diff / max(abs(wd[k]), 1e-300))
    if len(gplans) != len(bplans) or (gbest.region, gbest.launch_hour) != (
            bbest.region, bbest.launch_hour):
        fail("the card's plan chose another cell than the CPU's")
    say(f"  held at {PLAN_CHECK_N} a cell: card {card_s:.2f} s against the "
        f"CPU's batched {cpu_s:.2f} s; counts, finished and the chosen "
        f"cell ({gbest.region} @ {gbest.launch_hour:02d}h) exact; largest "
        "relative error " + ", ".join(f"{k} {v:.1e}"
                                      for k, v in worst.items()))
    del ses, cpu
    release(torch)
    return launches


def phase_models(c, tag: str, per_step: dict) -> dict:
    """Phase 15, the paper's model leg on the card: (a) §III step times of
    full-width train steps, (b) the §III regressions fitted to them, (c)
    the §IV T_c law from the port's own saves, (d) Eq (4) and the
    sim-scored §V-C plan on the device engine. Returns the launches of
    (a) and of (d)'s counted plan."""
    say(f"[{tag}] model leg: §III step times of full-width train steps "
        f"(make_train_step, bf16, {len(SPEED_GRID)} (B, S) points x "
        f"{len(SPEED_ARCHS)} archs)")
    t0 = time.monotonic()
    rows, launches = speed_rows(c, per_step)
    say(f"[{tag}] §III models on the card's {len(rows)} rows (measured in "
        f"{time.monotonic() - t0:.1f} s)")
    speed_models(c, rows)
    say(f"[{tag}] §IV: Checkpointer saves of {len(CKPT_TREES)} param trees "
        "(each saved twice), then the full-width qwen3-1.7b params held out")
    t0 = time.monotonic()
    t_c = ckpt_rows(c)
    say(f"[{tag}] Eq (4) predict and the sim-scored plan, qwen3-1.7b full "
        f"width, 4 x v100, T_c {t_c:.3f} s from the §IV law (the saves "
        f"took {time.monotonic() - t0:.1f} s)")
    t0 = time.monotonic()
    plan_launches = plan_on_card(c, t_c)
    say(f"  predict and plan in {time.monotonic() - t0:.1f} s")
    for k in launches:
        launches[k] += plan_launches[k]
    return launches


# phase 16: the recorded-trace replay held at 1,024 trajectories against
# the CPU's batched engine, and the decode rounds a `plan_serving` replica
# runs (SERVE_SLOTS, the plan's batch_ceiling, over its prompt +
# max_tokens cache; phase 3 holds RMSNorm at these rows)
TRACE_HOLD_N, TRACE_FULL_N, DECODE_ROUNDS = 1024, 32, 16
SERVE_SLOTS = 8


def trace_sim(session):
    """`recorded_trace`'s faulted fleet as the chaos runner's ensembles
    run it (seed 0): (scenario, sim, step budget)."""
    from repro_torch.chaos.runner import scenario_fleet
    from repro_torch.chaos.scenarios import get_scenario
    sc = get_scenario("recorded_trace")
    return (sc,) + scenario_fleet(session, sc, seed=0)


def counted_trace_chaos(c, session, what: str):
    """`Session.chaos("recorded_trace", engine="jit")` at FLEET_N
    trajectories, its launches counted from 0: fails unless it launched
    event select alone, at least once a device-engine round (each
    `run_jit` call's rounds read through a wrapper: the engine runs as
    the user's call runs it). Returns (scorecard, launches)."""
    from repro_torch.core.transient import fleet_jit
    torch = c.torch
    rounds = []
    run_jit = fleet_jit.run_jit

    def counted_run_jit(*args, **kwargs):
        kwargs.setdefault("stats", {})
        out = run_jit(*args, **kwargs)
        rounds.append(kwargs["stats"]["rounds"])
        return out
    fleet_jit.run_jit = counted_run_jit
    try:
        torch.cuda.synchronize()
        c.ops.reset_launches()
        t0 = time.monotonic()
        out = session.chaos("recorded_trace", engine="jit", live=False,
                            smoke=True, samples=FLEET_N)
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
        launches = dict(c.ops.launches)
    finally:
        fleet_jit.run_jit = run_jit
    card = out["scenarios"]["recorded_trace"]
    simc = card["sim"]
    say(f"  {what}: {wall_s:.3f}s; {len(rounds)} device-engine runs "
        f"(faulted and baseline at {FLEET_N}, the parity probe at "
        f"{simc['parity']['trajectories']}), rounds {rounds}; launches "
        f"{launches}")
    say(f"  impact {simc['impact']}; faulted finished "
        f"{simc['faulted']['finished']}, baseline finished "
        f"{simc['baseline']['finished']}; parity {simc['parity']}; gates "
        f"{card['smoke']}")
    if launches["event_select_fwd"] < sum(rounds) or not rounds or any(
            v for k, v in launches.items() if k != "event_select_fwd"):
        fail(f"{what} did not launch event_select alone, once a round")
    return out, launches


def warm_trace_engine(c, session, what: str, reps: int) -> None:
    """The warm device engine on the faulted fleet, as phase 13 times it:
    one `run_jit(raw=True)` for its stats, the best of `reps` timed, and
    one profiled for the device's busy share."""
    from repro_torch.core.transient import fleet_jit
    from repro_torch.core.transient.fleet_batched import FleetDraws
    torch = c.torch
    sc, sim, n_steps = trace_sim(session)
    draws = FleetDraws(sim, FLEET_N, 0.0)
    args = (sim, n_steps, FLEET_N, sc.max_hours, 0.0)
    stats = {}

    def run(**kw):
        fleet_jit.run_jit(*args, draws=draws, raw=True,
                          device=session.device, **kw)
    run(stats=stats)
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
    warm_s = min(walls)
    say(f"  {what}, warm run_jit(raw=True) on the faulted fleet at "
        f"{FLEET_N}: best of {reps} {warm_s:.4f}s ({walls}), "
        f"{stats['rounds']} rounds, {FLEET_N / warm_s:.0f} trajectories/s")
    say_profile(f"one warm run_jit ({what} recorded_trace)", warm_s * 1e3,
                *device_profile(torch, run, 1), top=4)


def trace_held(card_sess, cpu_sess, what: str) -> None:
    """The faulted ensemble at TRACE_HOLD_N trajectories on the card's
    device engine against the CPU session's batched engine (the fleet
    contract: counts and `finished` exact, times and costs to rtol 1e-9)."""
    sc, sim_g, n_steps = trace_sim(card_sess)
    _, sim_w, _ = trace_sim(cpu_sess)
    got = sim_g.run_many(n_steps, TRACE_HOLD_N, max_hours=sc.max_hours,
                         engine="jit", device=card_sess.device)
    want = sim_w.run_many(n_steps, TRACE_HOLD_N, max_hours=sc.max_hours,
                          engine="batched")
    errs = fleet_parity(what, fleet_raw(got.results), fleet_raw(want.results),
                        n_steps)
    say(f"  {what}: held at {TRACE_HOLD_N} trajectories (counts exact, "
        f"finished {errs['finished']}/{TRACE_HOLD_N}; max relative error "
        f"time {errs['total_time_s']:.1e}, cost {errs['monetary_cost']:.1e})")


def phase_trace_serving(c, tag: str) -> dict:
    """Phase 16, the recorded trace and the serving fleet. (a)
    `Session.chaos("recorded_trace", engine="jit")` on a SMOKE qwen3
    session at FLEET_N trajectories, the counted main path: its gates
    pass, and it launches event_select at least once a device-engine round
    and nothing else; the same call on a full-width session, counted the
    same way but with no gate (the reference's `min_extra_time_s` gate
    fails there: ROADMAP.md's reference caveat 5); the faulted ensemble
    held at 1,024 against the CPU's batched engine at both widths; the
    warm device engine's wall and busy share at both widths. (b)
    `serve_wave` through `Session.chaos`: its four gates pass, engine
    parity is exact, and its scorecard equals a CPU session's. (c) `Session.plan_serving()` at full
    width equals the CPU session's, and 16 counted decode rounds of a
    full-width `GatewayEngine` with the plan's SERVE_SLOTS slots launch
    RMSNorm once per norm a round, and the last round's logits agree with
    a prefill of the same tokens; their p50 is printed beside the plan's
    `token_time_s` (caveat 6). Returns the launches of (a)'s SMOKE call
    and (c)'s rounds."""
    import dataclasses

    from repro_torch.serving import ServingWorkload
    torch = c.torch
    t_phase = time.monotonic()
    card_sess = c.Session.from_arch("qwen3-1.7b", smoke=True)
    cpu_sess = c.Session.from_arch("qwen3-1.7b", smoke=True, device="cpu")
    sc, _, n_steps = trace_sim(card_sess)
    say(f"[{tag}] recorded trace: Session.chaos('recorded_trace', "
        f"engine='jit', samples={FLEET_N}, smoke=True) on SMOKE qwen3 "
        f"({sc.description}; {len(sc.faults)} faults, {sc.n_workers} x "
        f"{sc.gpu} in {sc.region}, {n_steps} steps, {sc.max_hours:.0f} h "
        "horizon)")

    # (a) the counted main path, gated at SMOKE
    out, main_launches = counted_trace_chaos(c, card_sess, "SMOKE, counted")
    if not out["passed"]:
        fail("recorded_trace's gates failed: "
             f"{out['scenarios']['recorded_trace']['smoke']['failures']}")
    trace_held(card_sess, cpu_sess, "SMOKE recorded_trace, card jit vs "
               "CPU batched")
    warm_trace_engine(c, card_sess, "SMOKE", 3)

    # the same scenario at full width: counted and timed the same way,
    # with no gate (caveat 5), and held against the CPU's batched engine
    full_card = c.Session.from_arch("qwen3-1.7b", smoke=False)
    full_cpu = c.Session.from_arch("qwen3-1.7b", smoke=False, device="cpu")
    counted_trace_chaos(c, full_card, "full width, counted (no gate)")
    warm_trace_engine(c, full_card, "full width", 2)
    t0 = time.monotonic()
    fc = full_card.chaos("recorded_trace", engine="jit", live=False,
                         smoke=True, samples=TRACE_FULL_N)
    full_s = time.monotonic() - t0
    fw = full_cpu.chaos("recorded_trace", engine="batched", live=False,
                        smoke=True, samples=TRACE_FULL_N)
    fcs, fws = (x["scenarios"]["recorded_trace"]["sim"] for x in (fc, fw))
    say(f"  full width, {TRACE_FULL_N} trajectories on jit ({full_s:.3f}s): "
        f"impact {fcs['impact']}, faulted finished "
        f"{fcs['faulted']['finished']}/{TRACE_FULL_N}, time mean "
        f"{fcs['faulted']['time_mean_s']:.1f}s; gates (not held) "
        f"{fc['scenarios']['recorded_trace']['smoke']}")
    for part in ("faulted", "baseline"):
        for key in ("revocations_mean", "replacements_mean", "finished"):
            if fcs[part][key] != fws[part][key]:
                fail(f"full-width recorded_trace: {part} {key} "
                     f"{fcs[part][key]} vs the CPU's {fws[part][key]}")
        if not math.isclose(fcs[part]["time_mean_s"],
                            fws[part]["time_mean_s"], rel_tol=1e-9):
            fail(f"full-width recorded_trace: {part} time differs")
    trace_held(full_card, full_cpu, "full-width recorded_trace, card jit "
               "vs CPU batched")

    # (b) serve_wave: host NumPy on both sessions, so equal field for field
    say(f"[{tag}] serve_wave: Session.chaos('serve_wave', smoke=True), 4 "
        "replicas, 400 requests at 2 req/s, batch ceiling 8, 32 samples; "
        "the card session's scorecard against a CPU session's")
    t0 = time.monotonic()
    sw = card_sess.chaos("serve_wave", smoke=True)
    sw_s = time.monotonic() - t0
    sw_cpu = cpu_sess.chaos("serve_wave", smoke=True)
    serving = sw["scenarios"]["serve_wave"]["serving"]
    say(f"  {sw_s:.3f}s; impact {serving['impact']}; parity "
        f"{serving['parity']}; gates {sw['scenarios']['serve_wave']['smoke']}")
    if not sw["passed"] or not serving["parity"]["counts_equal"] or \
            serving["parity"]["time_max_rel_err"] != 0.0:
        fail("serve_wave: a gate failed or the engines differ")
    if sw != sw_cpu:
        fail("serve_wave: the card session's scorecard differs from the "
             "CPU session's")
    say("  the scorecard equals the CPU session's field for field")

    # (c) plan_serving at full width, and the decode round it prices
    best, plans = full_card.plan_serving(batch_ceiling=SERVE_SLOTS)
    cbest, cplans = full_cpu.plan_serving(batch_ceiling=SERVE_SLOTS)
    if [dataclasses.asdict(p) for p in plans] != \
            [dataclasses.asdict(p) for p in cplans] or \
            plans.index(best) != cplans.index(cbest):
        fail("plan_serving on the card session differs from the CPU's")
    say(f"[{tag}] plan_serving, full-width qwen3: {len(plans)} cells equal "
        f"the CPU session's; token_time_s {best.token_time_s} s on the "
        f"{best.gpu} (the §III rule over batch_ceiling x (prompt + max) "
        f"tokens); best {best.provider} {best.region} x{best.replicas} "
        f"meets_slo={best.meets_slo} p99 {best.latency_p99_s} s shed "
        f"{best.shed_frac:.1%}")
    wl = ServingWorkload()
    cfg = full_card.cfg
    slots = SERVE_SLOTS
    eng = c.GatewayEngine(cfg, full_card.params, slots=slots,
                          max_len=wl.prompt_tokens + wl.max_tokens, seed=1,
                          device=full_card.device)
    c.gen.manual_seed(11)
    prompt = torch.randint(0, cfg.vocab_size, (slots, wl.prompt_tokens),
                           generator=c.gen, device=c.dev)
    for slot in range(slots):
        eng.join(slot, rid=slot, prompt=prompt[slot].tolist(),
                 max_new=wl.max_tokens)
    emitted = [[] for _ in range(slots)]        # the tokens each round fed
    for _ in range(wl.prompt_tokens):           # the prompts, uncounted
        for ev in eng.step():
            emitted[ev["slot"]].append(ev["token"])
    torch.cuda.synchronize()
    n_norms = norm_count(cfg)
    c.ops.reset_launches()
    round_ms = []
    for _ in range(DECODE_ROUNDS):
        t0 = time.perf_counter()
        events = eng.step()
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t0) * 1e3)
        for ev in events:
            emitted[ev["slot"]].append(ev["token"])
    decode_launches = dict(c.ops.launches)
    want = counts(rmsnorm_fwd=n_norms * DECODE_ROUNDS)
    say(f"  {DECODE_ROUNDS} decode rounds of a full-width GatewayEngine, "
        f"{slots} slots, cache {wl.prompt_tokens + wl.max_tokens}: "
        f"launches {decode_launches} (predicted {want})")
    if decode_launches != want:
        fail("the decode rounds did not launch RMSNorm once per norm")
    # the last round's logits against a prefill of the tokens it had
    # read: each prompt and the DECODE_ROUNDS tokens the rounds fed back
    fed = torch.cat([prompt, torch.tensor(
        [row[:DECODE_ROUNDS] for row in emitted], device=c.dev)], dim=1)
    served = eng.last_logits.float()
    pre = c.make_prefill_step(cfg)(full_card.params,
                                   {"tokens": fed})[:, -1].float()
    rel = float((served - pre).abs().max() / pre.abs().max())
    agree = float((served.argmax(-1) == pre.argmax(-1)).float().mean())
    say(f"  round {DECODE_ROUNDS}'s logits vs a prefill of the same "
        f"{fed.shape[1]} tokens ({slots} rows): max|diff|/max|prefill| = "
        f"{rel:.4e} (held <= {SERVE_VS_PREFILL_TOL}), argmax agreement "
        f"{agree:.2f}")
    if not math.isfinite(rel) or rel > SERVE_VS_PREFILL_TOL:
        fail("the 8-slot decode round disagrees with the prefill path")
    del served, pre, fed
    p50 = statistics.median(round_ms)
    say(f"  decode round p50 {p50:.3f} ms (min {min(round_ms):.3f}, max "
        f"{max(round_ms):.3f}) on the card, against the plan's token_time_s "
        f"{best.token_time_s * 1e3:.1f} ms on the {best.gpu}: "
        f"{best.token_time_s * 1e3 / p50:.0f}x (a finding; the plan is not "
        "re-priced)")
    say_profile(f"one decode round ({slots} slots)", p50,
                *device_profile(torch, eng.step, 2), top=4)
    launches = counts(event_select_fwd=main_launches["event_select_fwd"],
                      rmsnorm_fwd=decode_launches["rmsnorm_fwd"])
    del eng, full_card, full_cpu, card_sess, cpu_sess
    release(torch)
    say(f"  phase 16 in {time.monotonic() - t_phase:.1f} s")
    return launches


# phase 17: the MoE family at full width. decode-vs-prefill in fp32 at the
# no-drop capacity (capacity_factor = E / k), as the SSM models are held:
# the two paths then differ only by fp32 sums in another order
MOE_ARCHS = ("granite-moe-3b-a800m", "deepseek-v2-lite-16b")
MOE_SERVE_VS_PREFILL_TOL = 1e-3


def no_drop(cfg):
    """An MoE config at capacity_factor = E / k: a group's capacity is its
    size, so no (token, expert) pair is dropped."""
    mo = cfg.moe
    return cfg.with_(moe=dataclasses.replace(
        mo, capacity_factor=mo.n_experts / mo.top_k))


def moe_parts(c, cfg, params) -> None:
    """Device ms of a bf16 prefill's parts (B=1, S=SEQ; CUDA events) on
    the first MoE layer's weights: the expert weights' casts, routing,
    dispatch, the expert products, the combine and, for MLA,
    `_chunked_attn`; each a layer and over the layers that run it."""
    torch, L = c.torch, c.layers
    silu = torch.nn.functional.silu
    bf16 = torch.bfloat16
    mo = cfg.moe
    E, k, d, f = mo.n_experts, mo.top_k, cfg.d_model, mo.expert_d_ff
    n_moe = cfg.n_layers - cfg.first_k_dense
    mp = c.tree_map(lambda t: t[0], params["layers"]["moe"])
    c.gen.manual_seed(11)
    x = torch.randn((1, SEQ, d), generator=c.gen, device=c.dev).to(bf16)
    g = min(mo.group_size, SEQ)
    cap = L.moe_capacity(cfg, g)
    xf = x.reshape(SEQ // g, g, d)
    ws = [mp[n].to(bf16) for n in ("wg", "wi", "wo")]
    _, top_w, top_e = L.moe_route(mp, cfg, xf)
    buf, meta = L._group_dispatch(xf[0], top_e[0], top_w[0], E, cap)
    b3 = buf.view(E, cap, d)

    def experts():
        return torch.bmm(silu(torch.bmm(b3, ws[0])) * torch.bmm(b3, ws[1]),
                         ws[2])
    out_buf = experts().view(E * cap, d)
    parts = [
        ("expert weight casts (wg, wi, wo fp32 -> bf16)",
         lambda: [mp[n].to(bf16) for n in ("wg", "wi", "wo")], n_moe),
        ("routing (router product, fp32 softmax, sort)",
         lambda: L.moe_route(mp, cfg, xf), n_moe),
        ("dispatch (sort, slots, gather into E x cap rows)",
         lambda: L._group_dispatch(xf[0], top_e[0], top_w[0], E, cap),
         n_moe),
        (f"expert products ({E} x ({cap}, {d}) x ({d}, {f}), 3 bmm)",
         experts, n_moe),
        ("combine (gather, weight, sum over k)",
         lambda: L._group_combine(out_buf, meta, g, k, d), n_moe)]
    if cfg.mla is not None:
        m, H = cfg.mla, cfg.n_heads
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        q, kf = (torch.randn((1, SEQ, H, qk), generator=c.gen,
                             device=c.dev).to(bf16) for _ in range(2))
        v = torch.randn((1, SEQ, H, m.v_head_dim), generator=c.gen,
                        device=c.dev).to(bf16)
        parts.append(("_chunked_attn (MLA prefill, fp32 logits)",
                      lambda: L._chunked_attn(q, kf, v, True, 0),
                      cfg.n_layers))
    cast_bytes = 3 * E * d * f * (4 + 2)
    say(f"  prefill parts at layer 0's shapes (g={g}, cap={cap}; CUDA "
        "events, median of 10):")
    for name, fn, n in parts:
        ms = time_ms(torch, fn, warmup=2, iters=10)
        say(f"    {ms:9.4f} ms a layer, {ms * n:8.2f} ms over {n} layers  "
            f"{name}")
    say(f"    (the casts' bound: {cast_bytes / 1e9:.3f} GB a layer / 3.35 "
        f"TB/s = {cast_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms)")


def phase_moe(c, tag: str, arch: str) -> dict:
    """An MoE arch at full width, weights from seed 0: the bf16 prefill
    (its launches, drops and parts), `Session.serve` (identical greedy
    replays, the prefill's RMSNorm count a decode step, gateway vs prefill
    in fp32 at the no-drop capacity) and the train step at depth 2 in
    fp32 against the CPU (routing and aux loss too). Returns the prefill
    and serve launches."""
    torch = c.torch
    t_phase = time.monotonic()
    release(torch)
    say(f"[{tag}] {arch}: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        "held on the card from earlier phases")
    cfg = c.get_config(arch, smoke=False)
    n_flash = 0 if cfg.mla is not None else cfg.n_layers
    per_layer = 3 if cfg.mla is not None else 2   # ln1, (kv_norm), ln2
    n_norms = per_layer * cfg.n_layers + 1
    session, params, launches = phase_prefill(
        c, tag, arch, counts(flash_attention_fwd=n_flash,
                             rmsnorm_fwd=n_norms))
    total = dict(launches)
    routes = []
    tokens = prefill_batch(c, cfg)["tokens"]     # phase_prefill's tokens
    with recording_routes(c.layers, routes):
        c.make_prefill_step(cfg)(params, {"tokens": tokens})
    kept = sum(int(keep.sum()) for _, keep in routes)
    pairs = sum(keep.numel() for _, keep in routes)
    say(f"  the published capacity (factor {cfg.moe.capacity_factor}, cap "
        f"{c.layers.moe_capacity(cfg, min(cfg.moe.group_size, SEQ))} of "
        f"{min(cfg.moe.group_size, SEQ)} tokens a group) drops "
        f"{pairs - kept} of {pairs} (token, expert) pairs in the "
        f"prefill's {len(routes)} routing group(s) "
        f"({100 * (pairs - kept) / pairs:.2f}%)")
    moe_parts(c, cfg, params)
    n_params = sum(t.numel() for _, t in c.flatten(params))
    say(f"  a bf16 decode step casts every fp32 weight, as the reference "
        f"does: {n_params * 4 / 1e9:.1f} GB read, {n_params * 2 / 1e9:.1f} "
        f"GB written, {n_params * 6 / HBM_BYTES_PER_S * 1e3:.2f} ms at 3.35 "
        "TB/s by bytes alone")
    serve = phase_serve(c, tag, session, params, counts(rmsnorm_fwd=n_norms),
                        MOE_SERVE_VS_PREFILL_TOL, in_fp32=True,
                        fp32_cfg=no_drop(cfg))
    for name in total:
        total[name] += serve[name]
    del session, params, tokens, routes
    release(torch)
    phase_parity(c, tag, arch, counts(
        flash_attention_fwd=2 * (n_flash > 0),
        flash_attention_bwd=2 * (n_flash > 0),
        rmsnorm_fwd=2 * per_layer + 1, rmsnorm_bwd=2 * per_layer + 1),
        PARITY_TOL, dtype="float32")
    release(torch)
    say(f"  phase {tag.split('/')[0]} ({cfg.name}) in "
        f"{time.monotonic() - t_phase:.1f} s")
    return total


DENSE_ARCHS = ("stablelm-1.6b", "qwen2-vl-2b", "yi-6b", "starcoder2-15b")
# the archs of phases 18-19 whose weights, gradients and two AdamW moments
# (16 bytes a parameter: 15.1, 26.3 and 24.7 GB) fit one 80 GB card beside
# a B=2, S=2048 step; yi-6b (97.0 GB) and starcoder2-15b (255 GB) do not
TRAIN_ARCHS = ("hubert-xlarge", "stablelm-1.6b", "qwen2-vl-2b")
# fp32 logits of the depth-2 forward, card (kernels) vs CPU (plain
# versions), as tests/test_torch_model.py holds fp32 prefill: 1e-4 of max
FORWARD_PARITY_TOL, FORWARD_PARITY_SEQ = 1e-4, 256


def phase_forward_parity(c, tag: str, arch: str) -> None:
    """The forward of `arch` cut to 2 layers at full width in fp32, on the
    card (kernels: 2 flash and the norms' RMSNorm launches) and on the CPU
    (plain versions), from one set of weights and one batch (the VLM's
    with three distinct position rows, the encoder's frame features):
    logits within FORWARD_PARITY_TOL of max |logit|."""
    torch = c.torch
    pcfg = c.get_config(arch, smoke=False).with_(n_layers=2,
                                                 dtype="float32")
    want = counts(flash_attention_fwd=2, rmsnorm_fwd=norm_count(pcfg))
    say(f"[{tag}] forward parity: {pcfg.name} cut to 2 layers at full "
        f"width, B=1 S={FORWARD_PARITY_SEQ} fp32, card (kernels) vs CPU "
        "(plain versions)")
    t0 = time.monotonic()
    cpu_params, _ = c.model_api.init(pcfg, torch.Generator().manual_seed(3),
                                     device="cpu")
    batch = prefill_batch(c, pcfg, seq=FORWARD_PARITY_SEQ, seed=4)
    prefill = c.make_prefill_step(pcfg)
    want_logits = prefill(cpu_params, {k: v.cpu() for k, v in batch.items()})
    cpu_s = time.monotonic() - t0
    params = c.tree_map(lambda t: t.to(c.dev), cpu_params)
    del cpu_params
    c.ops.reset_launches()
    got = prefill(params, batch)
    torch.cuda.synchronize()
    launches = dict(c.ops.launches)
    got = got.float().cpu()
    rel = float((got - want_logits).abs().max() / want_logits.abs().max())
    say(f"  launches {launches} (predicted {want}); logits card vs CPU: "
        f"max|diff|/max|CPU| = {rel:.3e} (tol {FORWARD_PARITY_TOL}), argmax "
        f"agreement {float((got.argmax(-1) == want_logits.argmax(-1)).float().mean()):.4f}; "
        f"CPU init and forward {cpu_s:.1f} s")
    if launches != want:
        fail("the card's forward did not launch the kernels as predicted")
    if not bool(torch.isfinite(got).all()) or not rel <= FORWARD_PARITY_TOL:
        fail(f"{arch}: the card's forward disagrees with the CPU's")
    del params, got, want_logits, batch
    release(torch)


def phase_fit_train(c, tag: str, arch: str) -> dict:
    """An arch of TRAIN_ARCHS trains at full width as in phase 6 (one flash
    launch each way a layer, the norms' RMSNorm launches each way) and
    takes the depth-2 fp32 train step card vs CPU as in phase 7. Returns
    the train launches."""
    cfg = c.get_config(arch, smoke=False)
    n_norms = norm_count(cfg)
    launches = phase_train(
        c, tag, arch, counts(flash_attention_fwd=cfg.n_layers,
                             flash_attention_bwd=cfg.n_layers,
                             rmsnorm_fwd=n_norms, rmsnorm_bwd=n_norms),
        attn_step_flops(cfg, TRAIN_BATCH, SEQ),
        "6 N per token plus the attention products, "
        + ("causal" if cfg.causal else "every key of every query"))
    pcfg = cfg.with_(n_layers=2)
    phase_parity(c, tag, arch,
                 counts(flash_attention_fwd=2, flash_attention_bwd=2,
                        rmsnorm_fwd=norm_count(pcfg),
                        rmsnorm_bwd=norm_count(pcfg)),
                 PARITY_TOL, dtype="float32")
    return launches


def phase_dense(c, tag: str, arch: str) -> dict:
    """A dense or VLM arch at full width, weights from seed 0: the bf16
    prefill (one flash launch a layer, the norms' RMSNorm launches; the
    VLM's batch with three distinct position rows), `Session.serve` (4
    slots: identical greedy replays, the RMSNorm count a decode step,
    gateway vs prefill in bf16), for TRAIN_ARCHS `phase_fit_train`, and
    the depth-2 fp32 forward against the CPU. Returns the prefill, serve
    and train launches."""
    torch = c.torch
    t_phase = time.monotonic()
    release(torch)
    say(f"[{tag}] {arch}: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        "held on the card from earlier phases")
    cfg = c.get_config(arch, smoke=False)
    n_norms = norm_count(cfg)
    session, params, launches = phase_prefill(
        c, tag, arch, counts(flash_attention_fwd=cfg.n_layers,
                             rmsnorm_fwd=n_norms))
    total = dict(launches)
    serve = phase_serve(c, tag, session, params, counts(rmsnorm_fwd=n_norms),
                        SERVE_VS_PREFILL_TOL)
    for name in total:
        total[name] += serve[name]
    del session, params
    release(torch)
    if arch in TRAIN_ARCHS:
        train = phase_fit_train(c, tag, arch)
        for name in total:
            total[name] += train[name]
    phase_forward_parity(c, tag, arch)
    say(f"  phase {tag.split('/')[0]} ({cfg.name}) in "
        f"{time.monotonic() - t_phase:.1f} s")
    return total


def phase_encoder(c, tag: str) -> dict:
    """hubert-xlarge at full width (head_dim 80): the bf16 encode (B=1,
    S=SEQ frames; 48 flash launches at hd 80, 97 RMSNorm), the depth-2
    fp32 forward against the CPU, and `phase_fit_train` (frame features,
    48 flash launches each way at hd 80 and 97 RMSNorm a step). Returns
    the encode's and the train steps' launches."""
    torch = c.torch
    t_phase = time.monotonic()
    release(torch)
    arch = "hubert-xlarge"
    cfg = c.get_config(arch, smoke=False)
    session, params, launches = phase_prefill(
        c, tag, arch, counts(flash_attention_fwd=cfg.n_layers,
                             rmsnorm_fwd=norm_count(cfg)))
    del session, params
    release(torch)
    phase_forward_parity(c, tag, arch)
    train = phase_fit_train(c, tag, arch)
    for name in launches:
        launches[name] += train[name]
    say(f"  phase {tag.split('/')[0]} ({cfg.name}) in "
        f"{time.monotonic() - t_phase:.1f} s")
    return launches


CNN_BATCH, CNN_WARMUP, CNN_STEPS = 128, 3, 10
CNN_PARITY, CNN_PARITY_BATCH = ("resnet_15", "shake_shake_small"), 32
# card vs CPU: in fp64 every gradient leaf within 1e-8 of its max and the
# loss within 1e-12 relative; in fp32 (TF32 off) the loss within 1e-5 of
# the fp64 loss, each leaf's distance printed beside the CPU fp32's. A
# leaf is not held in fp32: a batch-normed conv whose channel variances
# are small amplifies rounding, and multiplying every conv output by
# 1 + 1e-7 N(0, 1) in fp64 moves one of shake_shake_small's last-stage
# leaves by 3.3e-2 of its max at B=32 (on the CPU)
CNN_TOL = {"loss64": 1e-12, "grad_leaf64": 1e-8, "loss32": 1e-5}


def phase_cnn(c, tag: str) -> None:
    """The paper's CIFAR-10 zoo (§III-A): each of the 20 specs trains
    CNN_STEPS timed SGD steps (the gradient of `loss_fn`, then SGD at
    0.05, as benchmarks/fig2_stability.py steps) on CNN_BATCH CIFAR-shaped
    images after CNN_WARMUP warm-ups, timed by CUDA events; images/s, and
    the Pearson r of step time against C_m (`flops_per_image`) over the
    zoo, printed, not gated. Then resnet_15 and shake_shake_small card
    vs CPU: the loss and every gradient leaf in fp64, the loss in fp32
    (CNN_TOL)."""
    torch, cnn, flatten = c.torch, c.cnn, c.flatten
    t_phase = time.monotonic()
    release(torch)
    data = c.CIFARLikeSource(seed=0).batch(0, 0, 1, CNN_BATCH)
    images = torch.from_numpy(data["images"]).to(c.dev)
    labels = torch.from_numpy(data["labels"]).to(c.dev)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    # the zoo trains as a user's fp32 convolutions run by default: cuDNN
    # with TF32
    torch.backends.cudnn.allow_tf32 = True
    say(f"[{tag}] CNN zoo: {len(cnn.ZOO)} specs, SGD at 0.05, "
        f"{CNN_BATCH} CIFAR-shaped images a step, {CNN_WARMUP} warm-ups "
        f"then {CNN_STEPS} steps by CUDA events (median), fp32 with cuDNN "
        "TF32 (PyTorch's default)")
    rows = []
    for name, spec in cnn.ZOO.items():
        params = cnn.init_params(torch.Generator(device=c.dev).manual_seed(0),
                                 spec)
        leaves = [t.requires_grad_() for _, t in flatten(params)]

        def step():
            loss = cnn.loss_fn(params, spec, images, labels)
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                torch._foreach_add_(leaves, grads, alpha=-0.05)
            return loss.detach()
        ms = time_ms(torch, step, warmup=CNN_WARMUP, iters=CNN_STEPS)
        loss = float(step())
        if not math.isfinite(loss):
            fail(f"{name}: the loss is not finite after "
                 f"{CNN_WARMUP + CNN_STEPS + 1} steps")
        c_m = cnn.flops_per_image(spec)
        rows.append((name, c_m, ms))
        say(f"  {name:18s} C_m {c_m / 1e9:7.4f} GFLOP/image, "
            f"{cnn.param_count(spec) / 1e6:7.3f} M params: step "
            f"{ms:8.3f} ms, {CNN_BATCH / ms * 1e3:9.0f} images/s, "
            f"{3 * c_m * CNN_BATCH / (ms * 1e-3) / 1e12:6.2f} TFLOP/s "
            f"(3 C_m a trained image), loss {loss:.4f}")
        del params, leaves
    r = statistics.correlation([m for _, m, _ in rows],
                               [t for _, _, t in rows])
    say(f"  Pearson r of step time against C_m over the zoo: {r:.4f} "
        "(the paper's §III-A C_m claim; printed, not gated)")

    # TF32 off for the comparison only: TF32 keeps about three decimal
    # digits of each fp32 product, the CPU's fp32 oracle keeps all
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = torch.device("cpu")
    for name in CNN_PARITY:
        spec = cnn.ZOO[name]
        cpu_params = cnn.init_params(torch.Generator().manual_seed(1), spec)

        def gradient(dev, dtype):
            params = c.tree_map(lambda t: t.to(dev, dtype, copy=True)
                                .requires_grad_(), cpu_params)
            loss = cnn.loss_fn(params, spec,
                               images[:CNN_PARITY_BATCH].to(dev, dtype),
                               labels[:CNN_PARITY_BATCH].to(dev))
            paths, leaves = zip(*flatten(params))
            grads = torch.autograd.grad(loss, leaves)
            return float(loss.detach()), {p_: g.double().cpu()
                                          for p_, g in zip(paths, grads)}
        want_loss, want = gradient(cpu, torch.float64)

        def dist(grads):
            return {p_: float((grads[p_] - g).abs().max())
                    / float(g.abs().max()) for p_, g in want.items()}
        loss64, got64 = gradient(c.dev, torch.float64)
        loss32, got32 = gradient(c.dev, torch.float32)
        cpu32 = dist(gradient(cpu, torch.float32)[1])
        d64, d32 = dist(got64), dist(got32)
        rel64 = abs(loss64 - want_loss) / abs(want_loss)
        rel32 = abs(loss32 - want_loss) / abs(want_loss)
        worst64 = max(d64, key=d64.get)
        worst32 = max(d32, key=d32.get)
        say(f"  {name} card vs CPU, B={CNN_PARITY_BATCH}, {len(want)} "
            f"gradient leaves: fp64 loss rel {rel64:.2e} (tol "
            f"{CNN_TOL['loss64']}), worst leaf {worst64} {d64[worst64]:.2e} "
            f"of its max (tol {CNN_TOL['grad_leaf64']}); fp32 (TF32 off) "
            f"against the fp64 oracle: loss rel {rel32:.2e} (tol "
            f"{CNN_TOL['loss32']}), worst leaf {worst32} {d32[worst32]:.2e} "
            f"(the CPU fp32's there {cpu32[worst32]:.2e}, its worst "
            f"{max(cpu32.values()):.2e})")
        if not (rel64 <= CNN_TOL["loss64"]
                and d64[worst64] <= CNN_TOL["grad_leaf64"]
                and rel32 <= CNN_TOL["loss32"]):
            fail(f"{name}: the card's CNN loss or gradient disagrees with "
                 "the CPU's")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    del images, labels
    release(torch)
    say(f"  phase {tag.split('/')[0]} (CNN zoo) in "
        f"{time.monotonic() - t_phase:.1f} s")


# the §II asynchronous-PS emulation, activation checkpointing and the int8
# KV cache at full qwen3-1.7b width (phase 21)
ASYNC_PACES = (0.1, 0.2, 0.3, 0.4)
ASYNC_UPDATES = 8
ASYNC_PARITY = {"updates": 4, "seq": 256, "loss": 1e-3}
REMAT_STEPS = 4                  # AdamW steps a policy; the first warms up
# a batch whose step phase 6's reckoning (27.5 GB of AdamW state, 18.9 GB
# of activations a B=2 step) puts beyond the card without checkpointing
# (84.2 GB) and "full" under the 72 GB fit (60.3 GB between the B=2 and
# B=8 peaks "full" reached on an H100 80GB HBM3: 34.64 and 73.14 GB)
REMAT_BIG_BATCH = 6
REMAT_TOL = {"grad_norm": 1e-6, "grad_leaf": 1e-5}
KV_DEPTH2 = {"batch": 2, "seq": 10, "rel": 0.05, "corr": 0.999}
FIT_GB = 72.0


@contextlib.contextmanager
def drawn_from(c, params):
    """While open, `model_api.init` gives a copy of ``params`` on the
    device it is asked for: a session on the card and one on the CPU
    start from one set of weights."""
    api = c.model_api
    init = api.init

    def copied(cfg, generator=None, *, device=None):
        return c.tree_map(lambda t: t.to(device, copy=True), params), None
    api.init = copied
    try:
        yield
    finally:
        api.init = init


def phase_async(c, tag: str) -> dict:
    """(a) `Session.train(mode="async_ps")` at full width: ASYNC_UPDATES
    updates of len(ASYNC_PACES) workers (B=TRAIN_BATCH, S=SEQ, bf16), each
    update a gradient pass at its worker's snapshot and a forward for the
    post-update loss; finite losses, the staleness histogram, the launches
    an update; ms an update and peak memory. Then the same emulation cut
    to 2 layers in fp32, ASYNC_PARITY["updates"] updates on the card and
    on the CPU from one set of weights: losses within ASYNC_PARITY["loss"]
    relative, the histogram and the update counts equal. Returns the
    full-width run's launches."""
    torch = c.torch
    t_phase = time.monotonic()
    cfg = c.get_config("qwen3-1.7b", smoke=False)
    L, n = cfg.n_layers, norm_count(cfg)
    per_update = counts(flash_attention_fwd=2 * L, flash_attention_bwd=L,
                        rmsnorm_fwd=2 * n, rmsnorm_bwd=n)
    workers = len(ASYNC_PACES)
    say(f"[{tag}a] async PS: {cfg.name} Session.train(mode='async_ps', "
        f"{ASYNC_UPDATES} updates, {workers} workers paced "
        f"{list(ASYNC_PACES)}, global_batch={TRAIN_BATCH}, seq_len={SEQ}), "
        f"full width, {cfg.dtype}, SGD at the run's lr")
    sess = c.Session.from_arch("qwen3-1.7b", smoke=False)
    stamps = []
    sess.bus.subscribe("async_step",
                       lambda kind, payload: stamps.append(time.monotonic()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c.ops.reset_launches()
    t0 = time.monotonic()
    rep = sess.train(ASYNC_UPDATES, global_batch=TRAIN_BATCH, seq_len=SEQ,
                     members=workers, mode="async_ps",
                     worker_step_times=list(ASYNC_PACES))
    torch.cuda.synchronize()
    launches = dict(c.ops.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    (stale,) = [e.payload for e in sess.bus.of_kind("staleness")]
    want = {k: ASYNC_UPDATES * v for k, v in per_update.items()}
    say(f"  launches {launches} (predicted {want}: {per_update} an update)")
    if launches != want:
        fail("the async updates did not launch the kernels as predicted")
    hist = stale["hist"]
    say(f"  losses {rep.losses}; staleness histogram {hist}; updates by "
        f"worker {stale['worker_updates']}; paces {stale['worker_step_time']}")
    if not all(math.isfinite(x) for x in rep.losses):
        fail("an async loss is not finite")
    if sum(hist.values()) != ASYNC_UPDATES or max(hist) < 1:
        fail(f"the staleness histogram {hist} does not count "
             f"{ASYNC_UPDATES} updates with some staleness")
    per = [b - a for a, b in zip(stamps, stamps[1:])]
    ms = statistics.median(per) * 1e3
    say(f"  {ms:.1f} ms an update (median of updates 2-{ASYNC_UPDATES}, "
        f"host clock between async_step events: gradient pass, update, "
        f"post-update loss; spread {min(per) * 1e3:.1f}-"
        f"{max(per) * 1e3:.1f}), {TRAIN_BATCH * SEQ / ms * 1e3:.0f} "
        f"gradient tokens/s; the first update {1e3 * (stamps[0] - t0):.1f}"
        f" ms after the call (weights drawn); peak memory {peak_gb:.2f} GB "
        f"(reckoned ~60: {workers} snapshots and the current fp32 trees, "
        f"a gradient tree, a step's activations; {FIT_GB:.0f} GB the fit)")
    if peak_gb > FIT_GB:
        say(f"  the peak is over {FIT_GB:.0f} GB: fewer workers would fit")
    del sess, rep
    release(torch)

    pcfg = cfg.with_(n_layers=2, dtype="float32")
    p_seq, p_upd = ASYNC_PARITY["seq"], ASYNC_PARITY["updates"]
    say(f"  depth 2, fp32: {p_upd} async updates of B=1, S={p_seq} on the "
        "card and on the CPU from one set of weights")
    cpu_params, _ = c.model_api.init(pcfg, torch.Generator().manual_seed(3),
                                     device="cpu")
    runs = {}
    for where in ("cuda", "cpu"):
        s = c.Session(pcfg, c.RunConfig(), arch="qwen3-1.7b",
                      device=c.dev if where == "cuda" else "cpu")
        t0 = time.monotonic()
        with drawn_from(c, cpu_params):
            r = s.train(p_upd, global_batch=1, seq_len=p_seq,
                        members=workers, mode="async_ps",
                        worker_step_times=list(ASYNC_PACES))
        runs[where] = (r.losses, s.bus.of_kind("staleness")[0].payload,
                       time.monotonic() - t0)
        del s, r
    release(torch)
    (gl, gs, gt), (cl, cs, ct) = runs["cuda"], runs["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    say(f"  losses card {gl} CPU {cl} (max rel {rel:.3e}, tol "
        f"{ASYNC_PARITY['loss']}); histogram card {gs['hist']} CPU "
        f"{cs['hist']}; updates by worker card {gs['worker_updates']} CPU "
        f"{cs['worker_updates']}; card {gt:.1f} s, CPU {ct:.1f} s")
    if (not rel <= ASYNC_PARITY["loss"] or gs["hist"] != cs["hist"]
            or gs["worker_updates"] != cs["worker_updates"]):
        fail("the card's async updates disagree with the CPU's")
    say(f"  async PS in {time.monotonic() - t_phase:.1f} s")
    return launches


def phase_remat(c, tag: str) -> dict:
    """(b) Activation checkpointing at full width, B=TRAIN_BATCH, S=SEQ,
    bf16, from one set of weights and one batch under "none", "full" and
    "dots": a gradient pass (`loss_fn` and its backward) whose loss must
    be bit-equal to "none"'s, its gradient norm within
    REMAT_TOL["grad_norm"] relative and each gradient leaf within
    REMAT_TOL["grad_leaf"] of its max, with the recompute's launches
    (each layer's flash forward and four RMSNorm forwards again); then
    REMAT_STEPS AdamW steps (`make_train_step`) from the same weights,
    step ms (the median after the first) and peak memory. Last, "full"
    at B=REMAT_BIG_BATCH, a batch whose step phase 6's reckoning puts
    beyond the card without checkpointing: its peak, busy time and
    tokens/s. The "full" steps' launches a step, peaks, busy times and
    the bytes held outside the step's arguments are kept in
    ``c.measured`` for phase 22. Returns the launches."""
    torch, flatten = c.torch, c.flatten
    t_phase = time.monotonic()
    cfg = c.get_config("qwen3-1.7b", smoke=False)
    L, n = cfg.n_layers, norm_count(cfg)
    plain = counts(flash_attention_fwd=L, flash_attention_bwd=L,
                   rmsnorm_fwd=n, rmsnorm_bwd=n)
    again = counts(flash_attention_fwd=2 * L, flash_attention_bwd=L,
                   rmsnorm_fwd=n + 4 * L, rmsnorm_bwd=n)
    want = {"none": plain, "full": again, "dots": again}
    say(f"[{tag}b] remat: {cfg.name} full width, B={TRAIN_BATCH} S={SEQ} "
        f"{cfg.dtype}; a gradient pass and {REMAT_STEPS} AdamW steps under "
        "each policy from one set of weights and one batch")
    params, _ = c.model_api.init(cfg, device=c.dev)
    host = [t.to("cpu", copy=True) for _, t in flatten(params)]

    def restore():
        for (_, t), h in zip(flatten(params), host):
            t.copy_(h)

    def batch_of(b):
        loader = c.ShardedLoader(c.source_for_config(cfg, SEQ, seed=1), b)
        return {k_: torch.from_numpy(v_).to(c.dev)
                for k_, v_ in loader.next_global(1).items()}
    batch = batch_of(TRAIN_BATCH)
    total = counts()
    ref = None
    rows = {}
    for pol in ("none", "full", "dots"):
        pcfg = cfg.with_(remat=pol)
        restore()
        live = c.tree_map(lambda t: t.detach().requires_grad_(), params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        c.ops.reset_launches()
        t0 = time.monotonic()
        loss = c.model_api.loss_fn(live, pcfg, batch)
        loss.backward()
        torch.cuda.synchronize()
        grad_ms = (time.monotonic() - t0) * 1e3
        grad_peak = torch.cuda.max_memory_allocated() / 1e9
        got = dict(c.ops.launches)
        for k_ in total:
            total[k_] += got[k_]
        say(f"  {pol}: gradient pass launches {got} (predicted {want[pol]})")
        if got != want[pol]:
            fail(f"remat={pol!r}: the gradient pass did not launch the "
                 "kernels as predicted")
        grads = [t.grad for _, t in flatten(live)]
        del live
        norm = float(torch.sqrt(sum((g.float() ** 2).sum() for g in grads)))
        loss = loss.detach().cpu()
        if ref is None:
            ref = (loss, norm, [g.cpu() for g in grads])
            line = "the reference"
        else:
            worst = max(float((g - r.to(c.dev)).abs().max())
                        / float(r.abs().max()) for g, r in zip(grads, ref[2]))
            norm_rel = abs(norm - ref[1]) / ref[1]
            same_loss = torch.equal(loss, ref[0])
            line = (f"loss {'bit-equal' if same_loss else 'DIFFERS'}, grad "
                    f"norm {'bit-equal' if norm == ref[1] else 'differs'} "
                    f"(rel {norm_rel:.3e}, tol {REMAT_TOL['grad_norm']}), "
                    f"worst leaf {worst:.3e} of its max (tol "
                    f"{REMAT_TOL['grad_leaf']})")
            if (not same_loss or not norm_rel <= REMAT_TOL["grad_norm"]
                    or not worst <= REMAT_TOL["grad_leaf"]):
                fail(f"remat={pol!r} changed the loss or the gradients")
        del grads
        say(f"  {pol}: loss {float(loss):.6f}, grad norm {norm:.6f}: {line};"
            f" gradient pass {grad_ms:.1f} ms (host clock, one call), peak "
            f"{grad_peak:.2f} GB")
        restore()
        release(torch)
        step, opt = c.steps.make_train_step(pcfg, c.RunConfig())
        state = c.steps.TrainState(params, opt.init(params),
                                   torch.zeros((), dtype=torch.int32))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        outside = (torch.cuda.memory_allocated()
                   - state_bytes(state.params, state.opt, batch))
        c.ops.reset_launches()
        times = []
        for _ in range(REMAT_STEPS):
            t0 = time.monotonic()
            state, _m = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.monotonic() - t0) * 1e3)
        got = dict(c.ops.launches)
        for k_ in total:
            total[k_] += got[k_]
        if got != {k_: REMAT_STEPS * v for k_, v in want[pol].items()}:
            fail(f"remat={pol!r}: the AdamW steps did not launch the "
                 "kernels as predicted")
        rows[pol] = (statistics.median(times[1:]),
                     torch.cuda.max_memory_allocated() / 1e9)
        busy_ms, _ = device_profile(torch, lambda: step(state, batch), 1,
                                    host=False)
        if pol == "full":
            vars(c).setdefault("measured", {})[("train", TRAIN_BATCH)] = dict(
                launches={k_: v // REMAT_STEPS for k_, v in got.items()},
                peak_gb=rows[pol][1], busy_ms=busy_ms,
                outside_gb=outside / 1e9)
        each = ", ".join(f"{t:.1f}" for t in times)
        say(f"  {pol}: AdamW step {rows[pol][0]:.1f} ms (median of steps "
            f"2-{REMAT_STEPS}, host clock; {each}), "
            f"{TRAIN_BATCH * SEQ / rows[pol][0] * 1e3:.0f} tokens/s, peak "
            f"{rows[pol][1]:.2f} GB; one more step's device busy time "
            f"{busy_ms:.1f} ms ({100 * busy_ms / rows[pol][0]:.1f}% of the "
            "step)")
        del state, opt, step
        release(torch)
    base_ms, base_gb = rows["none"]
    say("  against none: " + "; ".join(
        f"{p}: {rows[p][0] / base_ms:.3f}x the step ms, "
        f"{rows[p][1] - base_gb:+.2f} GB" for p in ("full", "dots")))

    big = REMAT_BIG_BATCH
    restore()
    del host
    release(torch)
    acts = 46.39 - 27.5
    say(f"  full at B={big}: phase 6's reckoning puts a step without "
        f"checkpointing at 27.5 + {big / TRAIN_BATCH:g} x {acts:.1f} = "
        f"{27.5 + big / TRAIN_BATCH * acts:.1f} GB (AdamW's 16 bytes a "
        "parameter, and the activations of its B=2 peak)")
    bcfg = cfg.with_(remat="full")
    bbatch = batch_of(big)
    step, opt = c.steps.make_train_step(bcfg, c.RunConfig())
    state = c.steps.TrainState(params, opt.init(params),
                               torch.zeros((), dtype=torch.int32))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    outside = (torch.cuda.memory_allocated()
               - state_bytes(state.params, state.opt, bbatch))
    c.ops.reset_launches()
    times = []
    for _ in range(3):
        t0 = time.monotonic()
        state, m = step(state, bbatch)
        torch.cuda.synchronize()
        times.append((time.monotonic() - t0) * 1e3)
    got = dict(c.ops.launches)
    for k_ in total:
        total[k_] += got[k_]
    if got != {k_: 3 * v for k_, v in want["full"].items()}:
        fail(f"remat='full' at B={big}: the steps did not launch the "
             "kernels as predicted")
    big_ms = statistics.median(times[1:])
    big_gb = torch.cuda.max_memory_allocated() / 1e9
    big_busy, _ = device_profile(torch, lambda: step(state, bbatch), 1,
                                 host=False)
    vars(c).setdefault("measured", {})[("train", big)] = dict(
        launches={k_: v // 3 for k_, v in got.items()}, peak_gb=big_gb,
        busy_ms=big_busy, outside_gb=outside / 1e9)
    say(f"  full at B={big}: step {big_ms:.1f} ms (median of steps 2-3; "
        f"{', '.join(f'{t:.1f}' for t in times)}), "
        f"{big * SEQ / big_ms * 1e3:.0f} tokens/s, peak {big_gb:.2f} GB, "
        f"one more step's device busy time {big_busy:.1f} ms, "
        f"loss {float(m['loss']):.4f}")
    if not math.isfinite(float(m["loss"])):
        fail("the checkpointed large-batch step's loss is not finite")
    if big_gb > FIT_GB:
        say(f"  the peak is over {FIT_GB:.0f} GB: a smaller batch would fit")
    del state, opt, step, params, bbatch, batch
    release(torch)
    say(f"  remat in {time.monotonic() - t_phase:.1f} s")
    return total


# the dry run against the card (phase 22): the largest gap of a predicted
# train peak from the measured one, and the least share of the roofline's
# larger term that the measured busy time may take
DRYRUN_PEAK_TOL = 0.10
DRYRUN_BUSY_FLOOR = 0.95


def phase_dryrun(c, tag: str) -> None:
    """The dry run (`launch/dryrun.count_cell`, qwen3-1.7b at full width
    counted on the meta device, the 1x1 mesh) against what phases 4 and
    21 measured (``c.measured``): the "full" train step at B=TRAIN_BATCH
    and B=REMAT_BIG_BATCH, S=SEQ, and the B=1 prefill. Each kernel's
    launches must equal the card's; a train step's predicted peak (the
    counted live bytes plus what the process held outside the step's
    arguments when it ran) must lie within DRYRUN_PEAK_TOL of the
    measured; the measured busy time must be at least DRYRUN_BUSY_FLOOR
    of the roofline's larger term (the counted FLOPs and bytes over the
    card's peaks). That gate is one-sided: it catches FLOPs or bytes
    counted too high, never too few (the busy time lies 1.4-1.8x the
    memory term); `tests/test_torch_dryrun.py` holds the counts against
    closed forms from both sides. Runs nothing on the card."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    t_phase = time.monotonic()
    cfg = c.get_config("qwen3-1.7b", smoke=False)
    mesh = make_host_mesh()
    measured = vars(c).get("measured", {})
    say(f"[{tag}] dry run against the card: {cfg.name} full width, counted "
        f"on the meta device, mesh {mesh.axis_sizes}; roofline at "
        f"{PEAK_FLOPS['bfloat16'] / 1e12:.0f} TFLOP/s and "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    for what, shape, key in (
            (f"train remat=full B={TRAIN_BATCH}",
             ShapeConfig("train", SEQ, TRAIN_BATCH, "train"),
             ("train", TRAIN_BATCH)),
            (f"train remat=full B={REMAT_BIG_BATCH}",
             ShapeConfig("train", SEQ, REMAT_BIG_BATCH, "train"),
             ("train", REMAT_BIG_BATCH)),
            ("prefill B=1", ShapeConfig("prefill", SEQ, 1, "prefill"),
             ("prefill", "qwen3-1.7b"))):
        if key not in measured:
            fail(f"phase 22: no measurement of {what}")
        m = measured[key]
        t0 = time.monotonic()
        pcfg = cfg.with_(remat="full") if shape.kind == "train" else cfg
        got, _ = dryrun.count_cell("qwen3-1.7b", shape, mesh, cfg=pcfg)
        count_s = time.monotonic() - t0
        launches = counts(**{k: v["calls"]
                             for k, v in got["kernels"].items()})
        pred_gb = got["peak_bytes"] / 1e9 + m["outside_gb"]
        gap = (pred_gb - m["peak_gb"]) / m["peak_gb"]
        terms = dryrun.roofline(got["flops"], got["bytes"])
        bound = max(terms["compute_s"], terms["memory_s"]) * 1e3
        by = ("memory" if terms["memory_s"] > terms["compute_s"]
              else "compute")
        say(f"  {what} (counted in {count_s:.1f} s, {got['aten_ops']} aten "
            f"ops): {got['flops'] / 1e12:.2f} TFLOP, "
            f"{got['bytes'] / 1e9:.1f} GB moved; roofline compute "
            f"{terms['compute_s'] * 1e3:.1f} ms, memory "
            f"{terms['memory_s'] * 1e3:.1f} ms ({by}-bound) against "
            f"{m['busy_ms']:.1f} ms measured busy "
            f"({m['busy_ms'] / bound:.2f}x the larger term)")
        say(f"    peak predicted {pred_gb:.2f} GB "
            f"({got['peak_bytes'] / 1e9:.2f} counted + "
            f"{m['outside_gb']:.2f} held outside the arguments) vs "
            f"measured {m['peak_gb']:.2f} GB: {100 * gap:+.2f}%")
        say(f"    launches predicted {launches}")
        say(f"    launches measured  {m['launches']}")
        if launches != m["launches"]:
            fail(f"phase 22: the dry run's launches of {what} differ from "
                 "the card's")
        if shape.kind == "train" and abs(gap) > DRYRUN_PEAK_TOL:
            fail(f"phase 22: the predicted peak of {what} lies "
                 f"{100 * gap:+.1f}% from the measured")
        if m["busy_ms"] < DRYRUN_BUSY_FLOOR * bound:
            fail(f"phase 22: {what} was busy {m['busy_ms']:.1f} ms, below "
                 f"{DRYRUN_BUSY_FLOOR} x the roofline's {bound:.1f} ms")
    say(f"  dry run in {time.monotonic() - t_phase:.1f} s")


def phase_int8(c, tag: str) -> dict:
    """(c) The int8 KV cache at full width: `Session.serve` (as phase 5:
    N_BATCH slots, PROMPT_LEN-token prompts, N_TOKENS tokens) with the
    bf16 cache and with `kv_quant=True` in turns (bf16, int8, int8, bf16)
    on the same weights: each cache's replay identical, the RMSNorm
    launches a decode step as phase 5's, decode p50/p95 and tokens/s side
    by side; the cache's bytes a token; the gateway's logits at the last
    prompt position against bf16 prefill's with each cache (printed), and
    one gateway decode step's device time with each. Then the model cut to 2
    layers in fp32 on the card, KV_DEPTH2's tokens decoded with the int8
    cache against the fp32 prefill, as the reference's own test holds
    them (tests/test_kv_quant.py: relative distance and correlation).
    Returns the launches."""
    torch = c.torch
    t_phase = time.monotonic()
    cfg = c.get_config("qwen3-1.7b", smoke=False)
    qcfg = cfg.with_(kv_quant=True)
    n = norm_count(cfg)
    steps = PROMPT_LEN + N_TOKENS - 1
    say(f"[{tag}c] int8 KV cache: {cfg.name} full width, Session.serve("
        f"tokens={N_TOKENS}, batch={N_BATCH}, prompt_len={PROMPT_LEN}) with "
        "the bf16 cache and with kv_quant=True in turns (bf16, int8, int8, "
        "bf16); greedy")
    bsess = c.Session(cfg, arch="qwen3-1.7b")
    qsess = c.Session(qcfg, arch="qwen3-1.7b")
    if fingerprint(torch, bsess.params, c.flatten) != fingerprint(
            torch, qsess.params, c.flatten):
        fail("the two sessions drew different weights")
    c.ops.reset_launches()
    kw = dict(tokens=N_TOKENS, batch=N_BATCH, prompt_len=PROMPT_LEN, seed=1)
    turns = [("bf16", bsess), ("int8", qsess), ("int8", qsess),
             ("bf16", bsess)]
    reps = [(what, sess.serve(**kw)) for what, sess in turns]
    torch.cuda.synchronize()
    launches = dict(c.ops.launches)
    want = counts(rmsnorm_fwd=len(turns) * steps * n)
    say(f"  launches {launches} (predicted {want}: {n} RMSNorm a decode "
        "step)")
    if launches != want:
        fail("the int8 serve did not launch the kernels as predicted")
    (_, b1), (_, q1), (_, q2), (_, b2) = reps
    for what, x, y in (("int8", q1, q2), ("bf16", b1, b2)):
        a, b = x.generated, y.generated
        if a.shape != (N_BATCH, N_TOKENS) or not torch.equal(a, b):
            fail(f"the {what} greedy replay differs: {a.tolist()} vs "
                 f"{b.tolist()}")
    agree = float((q1.generated == b1.generated).float().mean())
    say(f"  int8 and bf16 greedy replays identical; int8 slot 0 tokens "
        f"{q1.generated[0].tolist()}; {100 * agree:.1f}% of the tokens "
        "equal the bf16 cache's")
    for what, r in reps:
        say(f"  {what} cache: {r.tokens_per_second:.1f} tok/s, decode p50 "
            f"{r.decode_ms_p50:.3f} ms p95 {r.decode_ms_p95:.3f} ms p99 "
            f"{r.decode_ms_p99:.3f} ms")
    per_token = {}
    for what, cf in (("bf16", cfg), ("int8", qcfg)):
        state, _ = c.model_api.init_decode_state(cf, 1, 1, device="meta")
        per_token[what] = sum(t.numel() * t.element_size()
                              for _, t in c.flatten(state))
    say(f"  cache bytes a token: int8 {per_token['int8']:,} (28 layers x K, "
        f"V x 8 heads x (128 int8 + a 4-byte scale)) against bf16 "
        f"{per_token['bf16']:,}: {per_token['int8'] / per_token['bf16']:.3f}x")

    c.gen.manual_seed(7)
    prompt = torch.randint(0, cfg.vocab_size, (N_BATCH, PROMPT_LEN),
                           generator=c.gen, device=c.dev)
    params = bsess.params
    pre = c.make_prefill_step(cfg)(params, {"tokens": prompt})[:, -1].float()
    for what, cf in (("bf16", cfg), ("int8", qcfg)):
        eng = c.GatewayEngine(cf, params, slots=N_BATCH,
                              max_len=PROMPT_LEN + N_TOKENS, seed=1)
        for slot in range(N_BATCH):
            eng.join(slot, rid=slot, prompt=prompt[slot].tolist(),
                     max_new=N_TOKENS)
        for _ in range(PROMPT_LEN):
            eng.step()
        served = eng.last_logits.float()
        rel = float((served - pre).abs().max() / pre.abs().max())
        top = float((served.argmax(-1) == pre.argmax(-1)).float().mean())
        say(f"  gateway with the {what} cache vs bf16 prefill at position "
            f"{PROMPT_LEN - 1}: max|diff|/max|prefill| = {rel:.4e}, argmax "
            f"agreement {top:.2f}")
        busy_ms, ranked = device_profile(torch, eng.step, 4)
        say(f"  one gateway decode step ({N_BATCH} slots) with the {what} "
            f"cache: {busy_ms:.3f} ms on the device in {len(ranked)} kinds "
            "of kernel")
        del eng
    del bsess, qsess, params, pre
    release(torch)

    pcfg = cfg.with_(n_layers=2, dtype="float32", kv_quant=True)
    bz, s = KV_DEPTH2["batch"], KV_DEPTH2["seq"]
    params, _ = c.model_api.init(
        pcfg, torch.Generator(device=c.dev).manual_seed(4), device=c.dev)
    c.gen.manual_seed(8)
    toks = torch.randint(0, cfg.vocab_size, (bz, s), generator=c.gen,
                         device=c.dev)
    state, _ = c.model_api.init_decode_state(pcfg, bz, s,
                                             dtype=torch.float32,
                                             device=c.dev)
    with torch.no_grad():
        for i in range(s):
            lg, state = c.model_api.decode_step(params, pcfg, state,
                                                toks[:, i], i)
        full = c.model_api.prefill(params, pcfg.with_(kv_quant=False),
                                   {"tokens": toks})[:, -1]
    rel = float((lg - full).abs().max() / full.abs().max())
    corr = float(torch.corrcoef(torch.stack([lg.flatten(),
                                             full.flatten()]))[0, 1])
    say(f"  depth 2, fp32, B={bz}: {s} tokens decoded with the int8 cache "
        f"vs the fp32 prefill: max|diff|/max|prefill| = {rel:.4e} (tol "
        f"{KV_DEPTH2['rel']}), correlation {corr:.6f} (tol > "
        f"{KV_DEPTH2['corr']})")
    if not (rel < KV_DEPTH2["rel"] and corr > KV_DEPTH2["corr"]):
        fail("the int8 decode drifts from prefill beyond the reference's "
             "bounds")
    del params, state
    release(torch)
    say(f"  int8 KV cache in {time.monotonic() - t_phase:.1f} s")
    return launches


# the bench modules phase 23 runs on the card through `bench.run.main`
BENCH_ON_CARD = ("lm_speed_models", "fig2_stability", "fig10_replacement",
                 "fig5_checkpoint", "serving")
# fig2's steps on the card: the profiler discards the steps within
# warmup_seconds (0.5 s) of the first record, and the reference's 30 SGD
# steps of bench_tiny take well under that on the card (reference caveat 9)
FIG2_STEPS = 600
QUICKSTART_STEPS = 20
TRANSIENT_STEPS = 60
# the index's crc32s and the metadata's creation time are written as
# decimal digits: two draws of the same tree differ by those digits
CKPT_DIGIT_BYTES = 32
# each SMOKE arch's logits on lm_speed_models's batch against the CPU's
# fp32 forward of the same weights. The card's fp32 forward (the kernels'
# fp32 paths) is held at every token to FORWARD_PARITY_TOL of max |logit|.
# Its bf16 forward, the path lm_speed_models times, is held by the median
# over tokens of each token's max |diff| / max |logit|: a bf16 rounding
# may flip an MoE route (the top k of near-tied bf16 router logits),
# which moves that token's logits by O(1) (granite-moe's worst token sat
# 0.916 of max |logit| from the CPU's on an H100; PERF.md §6), while the
# other tokens stay at bf16's rounding distance, 5e-3 to 2e-2 on the CPU
SMOKE_BF16_MEDIAN_TOL = 5e-2


@contextlib.contextmanager
def recording(mod, name: str, seen: dict):
    """While open, ``mod.<name>`` keeps in ``seen[mod.__name__]`` what
    each call returns."""
    fn = getattr(mod, name)

    def recorded(*a, **kw):
        seen[mod.__name__] = fn(*a, **kw)
        return seen[mod.__name__]
    setattr(mod, name, recorded)
    try:
        yield
    finally:
        setattr(mod, name, fn)


def bench_rows(text: str) -> dict:
    """``name -> (value, derived)`` of the driver's CSV rows."""
    rows = {}
    for line in text.splitlines():
        if line.startswith("#") or line == "name,value,derived":
            continue
        name, value, derived = line.split(",", 2)
        rows[name] = (float(value), derived)
    return rows


def phase_bench(c, tag: str) -> dict:
    """Phase 23, the paper's table and figure drivers and the examples on
    the card. `bench.run.main` runs BENCH_ON_CARD in this process
    (`lm_speed_models`: every SMOKE arch's forward loss; `fig2_stability`
    at FIG2_STEPS SGD steps; `fig10_replacement`; `fig5_checkpoint`: the
    20 zoo trees drawn on the card and saved; `serving`); it must return
    0 with every row finite, a row per arch and both summary rows of
    `lm_speed`, fig2's speed above 0, `serve_wave`'s smoke passing and
    fig10's `cold>warm=1`. Then `examples.quickstart` (QUICKSTART_STEPS)
    and `examples.transient_train` (TRANSIENT_STEPS, whose own assert
    holds that the loss falls) train on the card. The phase's launches of
    the flash forward and backward, both RMSNorm kernels and the SSD scan
    are each above 0. Held against CPU runs: fig5's S_d per tree exactly
    and S_c to the digits of its crc32s and creation time
    (CKPT_DIGIT_BYTES); serving's `serve_wave` and `plan` rows; each
    SMOKE arch's logits on lm_speed's batch (`smoke_logits_held`).
    Returns the phase's launches."""
    import functools
    import io

    from repro_torch.bench import fig2_stability, fig5_checkpoint, serving
    from repro_torch.bench import run as bench_run
    from repro_torch.configs import ARCH_IDS
    from repro_torch.examples import quickstart, transient_train

    torch = c.torch
    t_phase = time.monotonic()
    release(torch)
    say(f"[{tag}] bench on the card: {', '.join(BENCH_ON_CARD)} through "
        f"`bench.run.main` (fig2 at {FIG2_STEPS} steps), then quickstart "
        f"({QUICKSTART_STEPS} steps) and transient_train ({TRANSIENT_STEPS} "
        "steps)")
    seen = {}
    out = io.StringIO()
    c.ops.reset_launches()
    fig2_run = fig2_stability.run
    fig2_stability.run = functools.partial(fig2_run, steps=FIG2_STEPS)
    try:
        with recording(fig5_checkpoint, "measure", seen), \
                contextlib.redirect_stdout(out):
            rc = bench_run.main(["--only", ",".join(BENCH_ON_CARD)])
    finally:
        fig2_stability.run = fig2_run
    t_main = time.monotonic() - t_phase
    for line in out.getvalue().splitlines():
        say(f"  {line}")
    if rc != 0:
        fail(f"bench.run.main returned {rc}")
    rows = bench_rows(out.getvalue())
    bad = [name for name, (v, _) in rows.items() if not math.isfinite(v)]
    if bad:
        fail(f"bench rows with a value that is not finite: {bad}")
    want = {f"lm_speed/{a}" for a in ARCH_IDS} | {
        "lm_speed/corr_step_time_vs_flops", "lm_speed/kfold_mae_ols_vs_svr"}
    if not want <= set(rows):
        fail(f"lm_speed rows missing: {sorted(want - set(rows))}")
    speed, cov = rows[f"fig2/real_{c.dev.type}_speed_steps_per_s"]
    say(f"  fig2 ran {FIG2_STEPS} steps: {speed} steps/s, {cov}")
    if not speed > 0:
        fail("fig2's steps after the profiler's warm-up left no window")
    if "smoke=pass" not in rows["serving/serve_wave"][1]:
        fail("serve_wave's smoke gates failed on the card")
    if "cold>warm=1" not in rows["fig10/real/resnet15_cold_s"][1]:
        fail("fig10's cold start was not slower than the warm restart")

    t0 = time.monotonic()
    quickstart.main(["--steps", str(QUICKSTART_STEPS)])
    try:
        transient_train.main(["--steps", str(TRANSIENT_STEPS)])
    except AssertionError as e:
        fail(f"transient_train: {e}")
    torch.cuda.synchronize()
    launches = dict(c.ops.launches)
    say(f"  examples in {time.monotonic() - t0:.1f} s; the phase's launches "
        f"{launches}")
    for name in ("flash_attention_fwd", "flash_attention_bwd", "rmsnorm_fwd",
                 "rmsnorm_bwd", "ssd_scan_fwd"):
        if launches[name] == 0:
            fail(f"phase 23 never launched {name}")

    # card against the CPU
    t0 = time.monotonic()
    card5 = seen[fig5_checkpoint.__name__]
    cpu5 = fig5_checkpoint.measure(repeats=1, remote=False, device="cpu")
    for g, w in zip(card5, cpu5):
        if g.model != w.model or g.s_d != w.s_d or \
                abs(g.s_c - w.s_c) > CKPT_DIGIT_BYTES:
            fail(f"fig5 {g.model}: card s_d {g.s_d} s_c {g.s_c} against "
                 f"the CPU's {w.model} {w.s_d} {w.s_c}")
    say(f"  fig5: {len(card5)} trees, s_d equal to the CPU's, s_c within "
        f"{max(abs(g.s_c - w.s_c) for g, w in zip(card5, cpu5)):.0f} bytes")
    cpu_serving = {r["name"]: (r["value"], r["derived"].replace(",", ";"))
                   for r in serving.run(device="cpu")}
    for name in ("serving/serve_wave", "serving/plan"):
        if rows[name] != cpu_serving[name]:
            fail(f"{name}: the card's row {rows[name]} differs from the "
                 f"CPU's {cpu_serving[name]}")
    say(f"  serving's serve_wave and plan rows equal the CPU's "
        f"({time.monotonic() - t0:.1f} s)")
    smoke_logits_held(c)
    say(f"  bench in {t_main:.1f} s, phase in "
        f"{time.monotonic() - t_phase:.1f} s")
    release(torch)
    return launches


def smoke_logits_held(c) -> None:
    """Every SMOKE arch's forward on `lm_speed_models`'s batch (B, S),
    weights drawn on the CPU from seed 0, against the CPU's fp32 forward
    of the same weights (the plain versions): the card's fp32 logits
    within FORWARD_PARITY_TOL of max |logit| at every token, its bf16
    logits (the kernels at lm_speed's shapes) within
    SMOKE_BF16_MEDIAN_TOL at the median token."""
    from repro_torch.bench import lm_speed_models
    from repro_torch.configs import ARCH_IDS, TRAIN_4K

    torch, api = c.torch, c.model_api
    t0 = time.monotonic()
    dists = []

    def fp32(t):
        return t.float() if t.is_floating_point() else t

    def forward(cfg, params, batch):
        with torch.no_grad():
            return api.prefill(
                c.tree_map(lambda t: t.to(c.dev), params), cfg,
                {k: v.to(c.dev) for k, v in batch.items()}).float().cpu()
    for arch in ARCH_IDS:
        cfg = c.get_config(arch, smoke=True)
        params, _ = api.init(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        batch = api.make_batch(cfg, TRAIN_4K,
                               batch_override=lm_speed_models.B,
                               seq_override=lm_speed_models.S, device="cpu")
        cfg32, params32 = cfg.with_(dtype="float32"), c.tree_map(fp32, params)
        batch32 = {k: fp32(v) for k, v in batch.items()}
        with torch.no_grad():
            want = api.prefill(params32, cfg32, batch32)
        scale = want.abs().max()
        got32 = forward(cfg32, params32, batch32)
        got16 = forward(cfg, params, batch)
        rel32 = float((got32 - want).abs().max() / scale)
        tokens = (got16 - want).abs().amax(dim=-1) / scale
        rel16, worst16 = float(tokens.median()), float(tokens.max())
        dists.append(f"{arch} {rel32:.2e} / {rel16:.2e} ({worst16:.2e})")
        if not (bool(torch.isfinite(got16).all())
                and rel32 <= FORWARD_PARITY_TOL
                and rel16 <= SMOKE_BF16_MEDIAN_TOL):
            fail(f"{arch}: the card's SMOKE logits against the CPU's fp32 "
                 f"forward: fp32 {rel32:.3e} of max |logit| (tol "
                 f"{FORWARD_PARITY_TOL}), bf16 {rel16:.3e} at the median "
                 f"token (tol {SMOKE_BF16_MEDIAN_TOL})")
    say("  SMOKE logits against the CPU's fp32 forward, max|diff|/max|CPU|: "
        "the card's fp32 at the worst token / bf16 at the median (worst) "
        f"token: {', '.join(dists)} (tol {FORWARD_PARITY_TOL} / "
        f"{SMOKE_BF16_MEDIAN_TOL}; {time.monotonic() - t0:.1f} s)")
    release(torch)


def rmsnorm_kernels(k, cfg, randn, report: dict) -> None:
    """Phase 3's RMSNorm part. The forward and backward kernels held
    against the plain versions at every width the port normalises (the
    backward also against autograd over the plain forward, and two of its
    calls bit for bit); both timed at the four training shapes beside
    their bounds, F.rms_norm's forward and backward and the autograd
    recompute; the dispatch's host cost. Adds the two kernels' rows to
    `report`. ``k`` carries torch, F, rn, ref, ops, get_config and dev."""
    torch, F, rn, ref, ops, dev = k.torch, k.F, k.rn, k.ref, k.ops, k.dev
    H, KV, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    # RMSNorm, forward and backward kernels, at every width the port
    # normalises: qwen3's residual, q- and k-norm at the train shape (B=2,
    # S=2048) and prefill's (B=1), mamba2's gated norm, the rows of a
    # decode step at phase 5's N_BATCH and phase 16's SERVE_SLOTS slots,
    # the masked instances at SMOKE widths, and fp32 as the fp32 models
    # run them; the backward held against the plain backward and
    # against autograd over the plain forward (the parent's recompute)
    mcfg_ = k.get_config("mamba2-1.3b", smoke=False)
    d_gated = mcfg_.ssm.expand * mcfg_.d_model
    d_granite = k.get_config("granite-moe-3b-a800m", smoke=False).d_model
    d_latent = k.get_config("deepseek-v2-lite-16b",
                            smoke=False).mla.kv_lora_rank
    eps = cfg.norm_eps
    rn_errs, rnb_errs = [], []
    for rows, dim, dtype in [
            (SEQ, d, "bfloat16"), (TRAIN_BATCH * SEQ, d, "bfloat16"),
            (TRAIN_BATCH * SEQ * H, hd, "bfloat16"),
            (TRAIN_BATCH * SEQ * KV, hd, "bfloat16"),
            (TRAIN_BATCH * SEQ, d_gated, "bfloat16"),
            (N_BATCH, d, "bfloat16"), (N_BATCH * KV, hd, "bfloat16"),
            (SERVE_SLOTS, d, "bfloat16"), (SERVE_SLOTS * H, hd, "bfloat16"),
            (SERVE_SLOTS * KV, hd, "bfloat16"), (37, 256, "bfloat16"),
            (N_BATCH, d, "float32"), (3, hd, "float32"),
            (N_BATCH, d_gated, "float32"), (5, 32, "float32"),
            # phase 17: granite's width and deepseek's kv_norm latent, at
            # prefill, a decode step and the fp32 depth-2 step (S=256)
            (SEQ, d_granite, "bfloat16"), (SEQ, d_latent, "bfloat16"),
            (N_BATCH, d_granite, "bfloat16"), (N_BATCH, d_latent, "bfloat16"),
            (256, d_granite, "float32"), (256, d_latent, "float32"),
            (256, d, "float32"), (N_BATCH, d_granite, "float32"),
            (N_BATCH, d_latent, "float32"),
            # phases 18-19: hubert's 1280 and starcoder2's 6144 at prefill,
            # a decode step and the fp32 depth-2 forward
            (SEQ, 1280, "bfloat16"), (SEQ, 6144, "bfloat16"),
            (N_BATCH, 6144, "bfloat16"), (FORWARD_PARITY_SEQ, 1280, "float32"),
            (FORWARD_PARITY_SEQ, 6144, "float32"),
            # phase 23's SMOKE widths in bf16: lm_speed_models's B=2, S=32
            # (the q/k norms' head_dim 32 over 4 heads, and d 128, 192
            # and 256), quickstart's B=8, S=64 and transient_train's
            # B=16, S=128
            (2 * 32 * 4, 32, "bfloat16"), (2 * 32, 128, "bfloat16"),
            (2 * 32, 192, "bfloat16"), (2 * 32, 256, "bfloat16"),
            (8 * 64, 128, "bfloat16"), (16 * 128, 256, "bfloat16")]:
        x = randn((rows, dim), getattr(torch, dtype), 4)
        dy = randn((rows, dim), getattr(torch, dtype), 8)
        scale = torch.linspace(0.5, 1.5, dim, device=dev)
        tag = f"rmsnorm ({rows}, {dim}) {dtype}"
        got = rn.rmsnorm_fwd(x, scale, eps)
        want = ref.rmsnorm_ref(x, scale, eps)
        torch.cuda.synchronize()
        rn_errs.append(compare(torch, tag, got, want, dtype))
        dx, ds = rn.rmsnorm_bwd(x, scale, dy, eps)
        xr = x.detach().requires_grad_()
        sr = scale.detach().requires_grad_()
        oracles = (("plain", ref.rmsnorm_bwd_ref(x, scale, dy, eps)),
                   ("autograd", torch.autograd.grad(
                       ref.rmsnorm_ref(xr, sr, eps), (xr, sr), dy)))
        torch.cuda.synchronize()
        tol_dx, norm_dx, tol_ds = RN_BWD_TOL[dtype]
        for oracle, (w_dx, w_ds) in oracles:
            rnb_errs.append(compare_scaled(
                torch, f"{tag} bwd dx vs {oracle}", dx, w_dx, tol_dx,
                norm_dx))
            rnb_errs.append(compare_scaled(
                torch, f"{tag} bwd dscale vs {oracle}", ds, w_ds, tol_ds,
                tol_ds))
        del x, dy, got, want, dx, ds, xr, sr, oracles
    for rows, dim in ((TRAIN_BATCH * SEQ, d), (TRAIN_BATCH * SEQ * H, hd)):
        x = randn((rows, dim), torch.bfloat16, 4)
        dy = randn((rows, dim), torch.bfloat16, 8)
        scale = torch.linspace(0.5, 1.5, dim, device=dev)
        first = rn.rmsnorm_bwd(x, scale, dy, eps)
        again = rn.rmsnorm_bwd(x, scale, dy, eps)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(first, again))
        say(f"  rmsnorm_bwd ({rows}, {dim}) bf16: two calls "
            f"{'bit for bit equal' if same else 'DIFFER'}")
        if not same:
            fail("two RMSNorm backward calls differ")
        del x, dy, first, again

    # time both kernels at the four training shapes beside their bounds,
    # F.rms_norm forward and backward (torch's own kernels, a bf16
    # weight) and the autograd recompute the backward kernel replaced:
    # device time with L2 warm (the call repeated, its last outputs
    # still dirty in L2) and clean (`device_ms` with a flush)
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device=dev)
    def recompute(x, scale, dy):
        xr = x.detach().requires_grad_()
        sr = scale.detach().requires_grad_()
        return torch.autograd.grad(ref.rmsnorm_ref(xr, sr, eps), (xr, sr),
                                   dy)

    for what, rows, dim in (("qwen3 residual", TRAIN_BATCH * SEQ, d),
                            ("qwen3 q-norm", TRAIN_BATCH * SEQ * H, hd),
                            ("qwen3 k-norm", TRAIN_BATCH * SEQ * KV, hd),
                            ("mamba2 gated", TRAIN_BATCH * SEQ, d_gated)):
        x = randn((rows, dim), torch.bfloat16, 4)
        dy = randn((rows, dim), torch.bfloat16, 8)
        scale = torch.linspace(0.5, 1.5, dim, device=dev)
        xl = x.detach().requires_grad_()
        wl = scale.to(torch.bfloat16).requires_grad_()
        yl = F.rms_norm(xl, (dim,), wl, eps)

        def fwd():
            rn.rmsnorm_fwd(x, scale, eps)

        def bwd():
            rn.rmsnorm_bwd(x, scale, dy, eps)

        def lib_fwd():
            F.rms_norm(x, (dim,), wl, eps)

        def lib_bwd():
            torch.autograd.grad(yl, (xl, wl), dy, retain_graph=True)
        f_ms, b_ms = time_ms(torch, fwd), time_ms(torch, bwd)
        f_dev, _ = device_profile(torch, fwd, 20)
        n_b = {}
        b_dev, b_ranked = device_profile(torch, bwd, 20, count=n_b)
        lf_dev, lf_ranked = device_profile(torch, lib_fwd, 20)
        lb_dev, lb_ranked = device_profile(torch, lib_bwd, 20)
        n_rec = {}
        rec_dev, _ = device_profile(torch, lambda: recompute(x, scale, dy),
                                    5, count=n_rec)
        f_cold, b_cold, lf_cold, lb_cold = (
            device_ms(torch, fn, 20, frag, flush) for fn, frag in (
                (fwd, "rmsnorm_"), (bwd, "rmsnorm_"), (lib_fwd, ""),
                (lib_bwd, "")))
        _, f_bytes = rn.fwd_cost(rows, dim)
        b_flops, b_bytes = rn.bwd_cost(rows, dim)
        f_bound = f_bytes / HBM_BYTES_PER_S * 1e3
        b_bound = b_bytes / HBM_BYTES_PER_S * 1e3
        say(f"  rmsnorm {what} ({rows}, {dim}) bf16, device ms with L2 "
            f"warm / clean: forward {f_dev:.4f} / {f_cold:.4f} "
            f"({100 * f_bound / f_dev:.0f}% / {100 * f_bound / f_cold:.0f}% "
            f"of its bound, {f_bound:.4f} ms for {f_bytes / 1e6:.2f} MB), "
            f"{f_ms:.4f} ms per call; F.rms_norm {lf_dev:.4f} / "
            f"{lf_cold:.4f} ({f_dev / lf_dev:.2f}x / {f_cold / lf_cold:.2f}x)"
            f"; backward {b_dev:.4f} / {b_cold:.4f} in "
            f"{n_b['events']:.0f} kernel(s) ({100 * b_bound / b_dev:.0f}% / "
            f"{100 * b_bound / b_cold:.0f}% of its bound, {b_bound:.4f} ms "
            f"for {b_bytes / 1e6:.2f} MB), {b_ms:.4f} ms per call; "
            f"F.rms_norm's backward {lb_dev:.4f} / {lb_cold:.4f} "
            f"({b_dev / lb_dev:.2f}x / {b_cold / lb_cold:.2f}x); the "
            f"autograd recompute it replaced {rec_dev:.4f} (warm) in "
            f"{n_rec['events']:.0f} kernels")
        for name, t_ in b_ranked:
            say(f"    backward kernel: {t_:.4f} ms  {name[:80]}")
        for label, ranked in (("forward", lf_ranked),
                              ("backward", lb_ranked)):
            for name, t_ in ranked:
                say(f"    F.rms_norm {label}: {t_:.4f} ms  {name[:80]}")
        if what == "qwen3 residual":
            plain_ms = time_ms(torch, lambda: ref.rmsnorm_bwd_ref(
                x, scale, dy, eps))
            lib_ms = time_ms(torch, lib_bwd)
            flops = b_flops      # x^2, g, g x, dx and dy x r, per element
            report["rmsnorm_bwd"] = dict(
                route="cuda", source="src/repro_torch/kernels/csrc/rmsnorm.cu",
                replaces="src/repro/kernels/ops.py:104",
                max_abs_err=max(rnb_errs), ms=b_ms, plain_ms=plain_ms,
                bound_ms=max(b_bytes / HBM_BYTES_PER_S,
                             flops / PEAK_FLOPS["float32"]) * 1e3,
                bound_by=("bytes" if b_bytes / HBM_BYTES_PER_S
                          >= flops / PEAK_FLOPS["float32"]
                          else "operations"),
                library_ms=lib_ms)
            say(f"    rmsnorm_bwd: kernel {b_ms:.4f} ms per call, plain "
                f"{plain_ms:.4f} ms, F.rms_norm's backward {lib_ms:.4f} ms "
                "per call")
        del x, dy, scale, xl, wl, yl
    del flush

    scale_main = torch.linspace(0.5, 1.5, d, device=dev)
    x = randn((SEQ, d), torch.bfloat16, 4)
    w_lib = scale_main.to(torch.bfloat16)
    ms = time_ms(torch, lambda: rn.rmsnorm_fwd(x, scale_main, eps))
    plain_ms = time_ms(torch, lambda: ref.rmsnorm_ref(x, scale_main, eps))
    lib_ms = time_ms(torch, lambda: F.rms_norm(x, (d,), w_lib, eps))
    flops, nbytes = rn.fwd_cost(SEQ, d)
    bound = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["float32"])
    report["rmsnorm_fwd"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm.py:23",
        max_abs_err=max(rn_errs), ms=ms, plain_ms=plain_ms,
        bound_ms=bound * 1e3,
        bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                  >= flops / PEAK_FLOPS["float32"] else "operations"),
        library_ms=lib_ms)
    rn_dev_ms, _ = device_profile(
        torch, lambda: rn.rmsnorm_fwd(x, scale_main, eps), 20)
    # F.rms_norm's own device time (all its kernels) beside the kernel's:
    # both calls are host-paced, so their per-call times compare the host
    lib_dev_ms, lib_ranked = device_profile(
        torch, lambda: F.rms_norm(x, (d,), w_lib, eps), 20)
    say(f"  rmsnorm_fwd @ ({SEQ}, {d}) bf16: kernel {ms:.4f} ms per call "
        f"({rn_dev_ms:.4f} ms on the device), plain "
        f"{plain_ms:.4f} ms, F.rms_norm {lib_ms:.4f} ms per call "
        f"({lib_dev_ms:.4f} ms on the device in {len(lib_ranked)} "
        f"kernel(s)), bound {bound * 1e3:.4f} ms ({nbytes / 1e6:.2f} MB / "
        f"3.35 TB/s); on the device the kernel takes "
        f"{rn_dev_ms / lib_dev_ms:.2f}x F.rms_norm's time and "
        f"{100 * bound * 1e3 / rn_dev_ms:.0f}% of its bound")
    say_rate("kernel", ms, flops, bound * 1e3)
    # host cost of dispatch through the autograd Function, at the decode
    # shape and under no_grad as a decode step calls it (113 per step)
    xd = randn((N_BATCH, d), torch.bfloat16, 4)
    host_us = {}
    with torch.no_grad():
        for label, fn in (("ops.rmsnorm", ops.rmsnorm),
                          ("rmsnorm_fwd", rn.rmsnorm_fwd)):
            for _ in range(200):
                fn(xd, scale_main, eps)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2000):
                fn(xd, scale_main, eps)
            torch.cuda.synchronize()
            host_us[label] = (time.perf_counter() - t0) / 2000 * 1e6
    extra_us = host_us["ops.rmsnorm"] - host_us["rmsnorm_fwd"]
    say(f"  dispatch @ ({N_BATCH}, {d}) bf16, no_grad: ops.rmsnorm "
        f"{host_us['ops.rmsnorm']:.2f} us per call, bare wrapper "
        f"{host_us['rmsnorm_fwd']:.2f} us: the autograd Function adds "
        f"{extra_us:.2f} us, {extra_us * 113 / 1e3:.3f} ms per decode step")
    torch.cuda.synchronize()


def main() -> int:
    t_start = time.monotonic()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a "
             "CUDA card")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"the port's sources are not beside this script ({SRC})")
    import torch.nn.functional as F

    from repro_torch.api import Session
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.data.pipeline import (CIFARLikeSource, ShardedLoader,
                                           SyntheticTokenSource,
                                           source_for_config)
    from repro_torch.core.transient.fleet import FleetSim, SimWorker
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import event_select as es
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch import steps as st
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import api as model_api
    from repro_torch.models import cnn
    from repro_torch.models import layers as model_layers
    from repro_torch.optim import global_norm
    from repro_torch.serving.engine import GatewayEngine
    from repro_torch.tree import flatten, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)

    def randn(shape, dtype, seed):
        gen.manual_seed(seed)
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # ---------------------------------------------------------- 1. card
    card = card_line()
    say(f"[1/23] card: {card}")
    say(f"      torch {torch.__version__} cuda {torch.version.cuda} "
        f"device_count={torch.cuda.device_count()}")

    # --------------------------------------------------------- 2. build
    t0 = time.monotonic()
    _build.library()
    say(f"[2/23] build: {_build.library_path().name} in "
        f"{time.monotonic() - t0:.1f}s (nvcc {_build.last_build_seconds:.1f}s)")
    say_build(_build)

    # ------------------------------------------------ 3. kernels vs plain
    say("[3/23] kernels vs plain versions")
    cfg = get_config("qwen3-1.7b", smoke=False)
    H, KV, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    report = {}

    fa_errs = []
    for (B, Sq, Sk, h, kv, hdim, causal, dtype) in [
            (1, SEQ, SEQ, H, KV, hd, True, "bfloat16"),      # main path
            (TRAIN_BATCH, SEQ, SEQ, H, KV, hd, True, "bfloat16"),  # train
            (1, SEQ, SEQ, 32, 32, 64, True, "bfloat16"),     # zamba2-1.2b
            (2, 200, 200, H, KV, hd, True, "bfloat16"),      # ragged
            (1, 129, 129, H, KV, hd, True, "bfloat16"),      # a tile + 1
            (LIVE_BATCH, LIVE_SEQ, LIVE_SEQ, H, KV, hd, True,
             "bfloat16"),                                     # live plans
            (2, 192, 320, 4, 2, 64, False, "float32"),       # bidirectional
            (1, 100, 100, 4, 1, 32, True, "float32"),
            # granite-moe-3b-a800m: 24 query heads over 8 KV heads of 64,
            # a group of 3 (phase 17's prefill), and ragged in fp32
            (1, SEQ, SEQ, 24, 8, 64, True, "bfloat16"),
            (1, 100, 100, 6, 2, 64, True, "float32"),
            # hubert-xlarge (phase 19): 16/16 heads of 80, bidirectional,
            # causal, ragged in fp32 and its depth-2 fp32 forward
            (1, SEQ, SEQ, 16, 16, 80, False, "bfloat16"),
            (1, SEQ, SEQ, 16, 16, 80, True, "bfloat16"),
            # the training shapes at hd <= 80, stablelm's and hubert's:
            # persistent blocks walking several tiles of both batches
            (TRAIN_BATCH, SEQ, SEQ, 32, 32, 64, True, "bfloat16"),
            (TRAIN_BATCH, SEQ, SEQ, 16, 16, 80, False, "bfloat16"),
            (1, 100, 100, 4, 4, 80, True, "float32"),
            (1, FORWARD_PARITY_SEQ, FORWARD_PARITY_SEQ, 16, 16, 80, False,
             "float32"),
            # phase 18's groups: stablelm's 1 (32/32 of 64), qwen2-vl's 6
            # (12/2 of 128), yi's 8 (32/4), starcoder2's 12 (48/4), at
            # prefill in bf16 and at the depth-2 forward in fp32
            (1, SEQ, SEQ, 32, 32, 64, True, "bfloat16"),
            (1, SEQ, SEQ, 12, 2, 128, True, "bfloat16"),
            (1, SEQ, SEQ, 32, 4, 128, True, "bfloat16"),
            (1, SEQ, SEQ, 48, 4, 128, True, "bfloat16"),
            *[(1, FORWARD_PARITY_SEQ, FORWARD_PARITY_SEQ, h_, kv_, hd_, True,
               "float32")
              for h_, kv_, hd_ in ((32, 32, 64), (12, 2, 128), (32, 4, 128),
                                   (48, 4, 128))],
            # phase 15's train steps at the other (B, S) of SPEED_GRID
            *[(b, s, s, H, KV, hd, True, "bfloat16")
              for b, s in SPEED_GRID if s != SEQ],
            # the edges of the hd <= 80 schedule's 64-key units and
            # 128-key stages (hd 80 and 64): one unit, ragged last units
            # and stages, a tile + 1; Sq 192 with Sk 320; a group of 3
            *[(2, s_, s_, 4, 2, hd_, causal_, dtype_)
              for s_ in (64, 127, 129, 191, 255) for hd_ in (80, 64)
              for causal_ in (True, False)
              for dtype_ in ("bfloat16", "float32")],
            *[(2, 192, 320, 4, 2, hd_, False, dtype_) for hd_ in (80, 64)
              for dtype_ in ("bfloat16", "float32")],
            (2, 255, 255, 6, 2, 64, True, "bfloat16"),
            # phase 23's SMOKE widths at hd 32 in bf16: lm_speed_models's
            # forwards (B=2, S=32: groups of 2 and 3, MHA, and hubert's
            # bidirectional), quickstart's qwen3 (B=8, S=64, 4/2 heads)
            # and transient_train's lm-14m (8/4 heads, S=128, B=16 and
            # the 15 of a step after a member left)
            *[(2, 32, 32, h_, kv_, 32, causal_, "bfloat16")
              for h_, kv_, causal_ in ((4, 2, True), (6, 2, True),
                                       (4, 4, True), (4, 4, False))],
            (8, 64, 64, 4, 2, 32, True, "bfloat16"),
            *[(b_, 128, 128, 8, 4, 32, True, "bfloat16") for b_ in (16, 15)]]:
        dt = getattr(torch, dtype)
        q = randn((B, Sq, h, hdim), dt, 1)
        k = randn((B, Sk, kv, hdim), dt, 2)
        v = randn((B, Sk, kv, hdim), dt, 3)
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        want_out, want_lse = ref.flash_attention_ref(q, k, v, causal)
        torch.cuda.synchronize()
        tag = f"flash B={B} Sq={Sq} Sk={Sk} H={h} KV={kv} hd={hdim} " \
              f"causal={causal} {dtype}"
        fa_errs.append(compare(torch, tag + " out", out, want_out, dtype))
        fa_errs.append(compare(torch, tag + " lse", lse, want_lse, dtype))

    def sdpa_fwd(q, k, v, causal=True):
        """One SDPA call on the same inputs (the yardstick, not a path)."""
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        h, kv = q.shape[2], k.shape[2]
        if h == kv:
            sdpa_kw = {}
        elif tuple(int(p) for p in torch.__version__.split(".")[:2]) >= (2, 5):
            sdpa_kw = {"enable_gqa": True}
        else:  # no GQA switch before torch 2.5: give SDPA expanded heads
            kt, vt = (x.repeat_interleave(h // kv, dim=1) for x in (kt, vt))
            sdpa_kw = {}
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, **sdpa_kw)

    # the training shape and zamba2-1.2b's shared attention (MHA, hd=64)
    for (B, h, kv, hdim) in [(TRAIN_BATCH, H, KV, hd), (1, 32, 32, 64)]:
        q = randn((B, SEQ, h, hdim), torch.bfloat16, 1)
        k = randn((B, SEQ, kv, hdim), torch.bfloat16, 2)
        v = randn((B, SEQ, kv, hdim), torch.bfloat16, 3)
        f_ms = time_ms(torch, lambda: fa.flash_attention_fwd(q, k, v,
                                                             causal=True))
        s_ms = time_ms(torch, sdpa_fwd(q, k, v))
        flops, nbytes = fa.fwd_cost(B, SEQ, SEQ, h, kv, hdim, True)
        bound = max(flops / PEAK_FLOPS["bfloat16"], nbytes / HBM_BYTES_PER_S)
        say(f"  flash_attention_fwd @ B={B} S={SEQ} H={h} KV={kv} hd={hdim} "
            f"causal bf16: kernel {f_ms:.4f} ms per call, sdpa {s_ms:.4f} ms "
            f"({f_ms / s_ms:.2f}x sdpa)")
        say_rate("kernel", f_ms, flops, bound * 1e3)
        say_rate("sdpa", s_ms, flops, bound * 1e3)
        del q, k, v

    q = randn((1, SEQ, H, hd), torch.bfloat16, 1)
    k = randn((1, SEQ, KV, hd), torch.bfloat16, 2)
    v = randn((1, SEQ, KV, hd), torch.bfloat16, 3)
    ms = time_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, causal=True))
    plain_ms = time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, True),
                       warmup=2, iters=20)
    lib_ms = time_ms(torch, sdpa_fwd(q, k, v))
    flops, nbytes = fa.fwd_cost(1, SEQ, SEQ, H, KV, hd, True)
    bound = max(flops / PEAK_FLOPS["bfloat16"], nbytes / HBM_BYTES_PER_S)
    report["flash_attention_fwd"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
        replaces="src/repro/kernels/flash_attention.py:77",
        max_abs_err=max(fa_errs), ms=ms, plain_ms=plain_ms,
        bound_ms=bound * 1e3,
        bound_by=("operations" if flops / PEAK_FLOPS["bfloat16"]
                  >= nbytes / HBM_BYTES_PER_S else "bytes"),
        library_ms=lib_ms)
    _, ranked = device_profile(
        torch, lambda: fa.flash_attention_fwd(q, k, v, causal=True), 10)
    host = host_ms(torch, lambda: fa.flash_attention_fwd(q, k, v,
                                                         causal=True))
    say(f"  flash_attention_fwd @ B=1 S={SEQ} H={H} KV={KV} hd={hd} causal "
        f"bf16: kernel {ms:.4f} ms per call "
        f"({kernel_ms(ranked, 'flash_fwd_'):.4f} ms on the device, "
        f"{host:.4f} ms of host time with 3 tensor maps), "
        f"plain {plain_ms:.4f} ms, sdpa "
        f"{lib_ms:.4f} ms, bound {bound * 1e3:.4f} ms "
        f"({flops / 1e9:.2f} GFLOP / 989 TFLOP/s; {nbytes / 1e6:.1f} MB); "
        f"{ms / lib_ms:.2f}x sdpa")
    say_rate("kernel", ms, flops, bound * 1e3)
    say_rate("sdpa", lib_ms, flops, bound * 1e3)

    # the head dims below 128, after two calls bit for bit, on the device
    # beside SDPA and the bound: head_dim 80 at hubert-xlarge's encode
    # (B=1, S=SEQ, 16/16 heads, bidirectional: every key of every query)
    # and head_dim 64 at stablelm-1.6b's training shape (B=2, 32/32 heads,
    # causal), each held against the plain version in the list above
    for B, h, hdim, causal, who in ((1, 16, 80, False, "hubert-xlarge"),
                                    (TRAIN_BATCH, 32, 64, True,
                                     "stablelm-1.6b")):
        q, k, v = (randn((B, SEQ, h, hdim), torch.bfloat16, seed)
                   for seed in (1, 2, 3))

        def fwd_call():
            return fa.flash_attention_fwd(q, k, v, causal=causal)
        first = fwd_call()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(first, fwd_call())):
            fail(f"two hd-{hdim} flash forward calls differ")
        f_ms = time_ms(torch, fwd_call)
        _, ranked = device_profile(torch, fwd_call, 10)
        f_dev = kernel_ms(ranked, "flash_fwd_")
        f_plain = time_ms(torch, lambda: ref.flash_attention_ref(
            q, k, v, causal), warmup=2, iters=10)
        f_lib = time_ms(torch, sdpa_fwd(q, k, v, causal=causal))
        lib_dev, _ = device_profile(torch, sdpa_fwd(q, k, v, causal=causal),
                                    10)
        flops, nbytes = fa.fwd_cost(B, SEQ, SEQ, h, h, hdim, causal)
        bound = max(flops / PEAK_FLOPS["bfloat16"], nbytes / HBM_BYTES_PER_S)
        say(f"  flash_attention_fwd @ B={B} S={SEQ} H={h} KV={h} hd={hdim} "
            f"{'causal' if causal else 'bidirectional'} bf16 ({who}): two "
            f"calls bit for bit; kernel {f_ms:.4f} ms per call ({f_dev:.4f} "
            f"ms on the device, {flops / f_dev / 1e9:.1f} TFLOP/s), plain "
            f"{f_plain:.4f} ms, sdpa {f_lib:.4f} ms per call ({lib_dev:.4f} "
            f"ms on the device, {flops / lib_dev / 1e9:.1f} TFLOP/s), bound "
            f"{bound * 1e3:.4f} ms ({flops / 1e9:.2f} GFLOP / 989 TFLOP/s); "
            f"on the device {f_dev / lib_dev:.2f}x sdpa, "
            f"{100 * bound * 1e3 / f_dev:.1f}% of the bound")
        say_rate("kernel", f_ms, flops, bound * 1e3)
        say_rate("sdpa", f_lib, flops, bound * 1e3)
        del q, k, v, first

    def bwd_inputs(B, Sq, Sk, h, kv, hdim, dtype, fused=False):
        """q, k, v, dO from fixed seeds; with `fused`, q, k and v are
        views of one (B, S, h + 2 kv, hd) tensor, as a fused QKV
        projection gives them."""
        dt = getattr(torch, dtype)
        q = randn((B, Sq, h, hdim), dt, 1)
        k = randn((B, Sk, kv, hdim), dt, 2)
        v = randn((B, Sk, kv, hdim), dt, 3)
        if fused:
            qkv = torch.cat([q, k, v], dim=2)
            q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kv], qkv[:, :, h + kv:]
        return q, k, v, randn((B, Sq, h, hdim), dt, 5)

    bwd_errs = []
    bwd_cases = [
            (TRAIN_BATCH, SEQ, SEQ, H, KV, hd, True, "bfloat16"),  # train
            (2, 200, 200, H, KV, hd, True, "bfloat16"),      # ragged GQA
            (1, 129, 129, H, KV, hd, True, "bfloat16"),      # a tile + 1
            # the live plans' S=32: below one 64-row TMA box
            (LIVE_BATCH, LIVE_SEQ, LIVE_SEQ, H, KV, hd, True, "bfloat16"),
            (2, 192, 320, 4, 2, 64, False, "float32"),       # bidirectional
            (1, 100, 100, 4, 1, 32, True, "float32"),        # MQA
            # a group of 3: granite's heads, and ragged in fp32 (phase
            # 17's depth-2 step runs fp32 at S=256)
            (1, 256, 256, 24, 8, 64, True, "bfloat16"),
            (1, 100, 100, 6, 2, 64, True, "float32"),
            (1, 256, 256, 24, 8, 64, True, "float32"),
            # phase 15's train steps at the other (B, S) of SPEED_GRID
            *[(b, s, s, H, KV, hd, True, "bfloat16")
              for b, s in SPEED_GRID if (b, s) != (TRAIN_BATCH, SEQ)],
            # hubert-xlarge at hd 80 (phase 19): its training shape,
            # bidirectional and causal, ragged and GQA in fp32, and its
            # depth-2 fp32 step
            (TRAIN_BATCH, SEQ, SEQ, 16, 16, 80, False, "bfloat16"),
            (TRAIN_BATCH, SEQ, SEQ, 16, 16, 80, True, "bfloat16"),
            (1, 100, 100, 4, 4, 80, True, "float32"),
            (1, 100, 100, 4, 2, 80, False, "float32"),
            (1, 256, 256, 16, 16, 80, False, "float32"),
            # phase 18's training: stablelm (MHA 32/32 of 64) and qwen2-vl
            # (12/2 of 128), at the train shape and the depth-2 fp32 step
            (TRAIN_BATCH, SEQ, SEQ, 32, 32, 64, True, "bfloat16"),
            (TRAIN_BATCH, SEQ, SEQ, 12, 2, 128, True, "bfloat16"),
            (1, 256, 256, 32, 32, 64, True, "float32"),
            (1, 256, 256, 12, 2, 128, True, "float32"),
            # the edges of the dk/dv kernel's 64-key blocks and 64-query
            # stages (hd 80 and 64, GQA): S = 64 (one whole block), 127
            # and 191 (a ragged last block); Sq 192 with Sk 320,
            # bidirectional
            *[(2, s_, s_, 4, 2, hd_, causal_, "bfloat16")
              for s_, hd_, causal_ in ((64, 80, False), (64, 64, True),
                                       (127, 80, True), (127, 64, False),
                                       (191, 80, False), (191, 64, True))],
            (2, 192, 320, 4, 2, 80, False, "bfloat16"),
            (2, 192, 320, 4, 2, 64, False, "bfloat16"),
            # phase 23's training examples at hd 32: quickstart's qwen3
            # SMOKE (B=8, S=64, 4/2 heads) and transient_train's lm-14m
            # (8/4 heads, S=128, B=16 and 15)
            (8, 64, 64, 4, 2, 32, True, "bfloat16"),
            *[(b_, 128, 128, 8, 4, 32, True, "bfloat16") for b_ in (16, 15)]]
    # and hd 80 on views of one fused QKV projection
    for (B, Sq, Sk, h, kv, hdim, causal, dtype), fused in (
            [(case, False) for case in bwd_cases]
            + [((2, 192, 192, 4, 2, 80, False, "bfloat16"), True)]):
        q, k, v, do = bwd_inputs(B, Sq, Sk, h, kv, hdim, dtype, fused)
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
        want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal)
        torch.cuda.synchronize()
        tag = f"flash bwd B={B} Sq={Sq} Sk={Sk} H={h} KV={kv} hd={hdim} " \
              f"causal={causal} {dtype}{' (views of a fused QKV)' * fused}"
        for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
            if dtype == "bfloat16":
                bwd_errs.append(compare_scaled(torch, f"{tag} {name}", g_,
                                               w_, BWD_TOL[dtype],
                                               BWD_NORM_TOL))
            else:
                bwd_errs.append(compare(torch, f"{tag} {name}", g_, w_,
                                        dtype, tol=BWD_TOL[dtype]))
        del q, k, v, do, out, lse, got, want

    B = TRAIN_BATCH
    q, k, v, do = bwd_inputs(B, SEQ, SEQ, H, KV, hd, "bfloat16")
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    ms = time_ms(torch, lambda: fa.flash_attention_bwd(q, k, v, out, lse, do,
                                                      causal=True))
    plain_ms = time_ms(torch, lambda: ref.flash_attention_bwd_ref(
        q, k, v, out, lse, do, True), warmup=2, iters=10)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    dot = do.transpose(1, 2)
    lib_ms = time_ms(torch, lambda: torch.autograd.grad(
        sdpa_out, (qt, kt, vt), dot, retain_graph=True))
    flops, nbytes = fa.bwd_cost(B, SEQ, SEQ, H, KV, hd, True)
    bound = max(flops / PEAK_FLOPS["bfloat16"], nbytes / HBM_BYTES_PER_S)
    report["flash_attention_bwd"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention.py:223",
        max_abs_err=max(bwd_errs), ms=ms, plain_ms=plain_ms,
        bound_ms=bound * 1e3,
        bound_by=("operations" if flops / PEAK_FLOPS["bfloat16"]
                  >= nbytes / HBM_BYTES_PER_S else "bytes"),
        library_ms=lib_ms)
    _, ranked = device_profile(torch, lambda: fa.flash_attention_bwd(
        q, k, v, out, lse, do, causal=True), 5)
    host = host_ms(torch, lambda: fa.flash_attention_bwd(
        q, k, v, out, lse, do, causal=True))
    # delta reads dO and out and writes one fp32 per row, each once
    delta_bound = (2 * 2 * do.numel() + 4 * lse.numel()) / HBM_BYTES_PER_S
    say(f"  flash_attention_bwd @ B={B} S={SEQ} H={H} KV={KV} hd={hd} causal "
        f"bf16: kernel {ms:.4f} ms per call (delta "
        f"{kernel_ms(ranked, 'flash_bwd_delta_'):.4f} [bound "
        f"{delta_bound * 1e3:.4f}] + dq "
        f"{kernel_ms(ranked, 'flash_bwd_dq_'):.4f} + dk/dv "
        f"{kernel_ms(ranked, 'flash_bwd_dkv_'):.4f} ms on the device, "
        f"{host:.4f} ms of host time with 8 tensor maps), "
        f"plain {plain_ms:.4f} ms, sdpa backward {lib_ms:.4f} ms, bound "
        f"{bound * 1e3:.4f} ms ({flops / 1e9:.2f} GFLOP / 989 TFLOP/s; "
        f"{nbytes / 1e6:.1f} MB; the two passes execute 1.4x the FLOP); "
        f"{ms / lib_ms:.2f}x sdpa backward")
    say_rate("kernel", ms, flops, bound * 1e3)
    say_rate("sdpa backward", lib_ms, flops, bound * 1e3)
    del q, k, v, do, out, lse, qt, kt, vt, sdpa_out, dot

    # the head dims below 128, by stage beside the plain version, SDPA's
    # backward and the bound, after two calls bit for bit:
    # hubert-xlarge's training shape at hd 80 (B=2, S=SEQ, 16/16 heads,
    # bidirectional) and stablelm-1.6b's at hd 64 (32/32 heads, causal)
    for h, hdim, causal, who in ((16, 80, False, "hubert-xlarge"),
                                 (32, 64, True, "stablelm-1.6b")):
        q, k, v, do = bwd_inputs(TRAIN_BATCH, SEQ, SEQ, h, h, hdim,
                                 "bfloat16")
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)

        def bwd_call():
            return fa.flash_attention_bwd(q, k, v, out, lse, do,
                                          causal=causal)
        first = bwd_call()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(first, bwd_call())):
            fail(f"two hd-{hdim} flash backward calls differ")
        del first
        bwd_ms = time_ms(torch, bwd_call)
        _, ranked = device_profile(torch, bwd_call, 5)
        stages = [kernel_ms(ranked, f"flash_bwd_{s_}_")
                  for s_ in ("delta", "dq", "dkv")]
        bwd_plain = time_ms(torch, lambda: ref.flash_attention_bwd_ref(
            q, k, v, out, lse, do, causal), warmup=2, iters=10)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)
        dot = do.transpose(1, 2)

        def sdpa_bwd():
            return torch.autograd.grad(sdpa_out, (qt, kt, vt), dot,
                                       retain_graph=True)
        bwd_lib = time_ms(torch, sdpa_bwd)
        lib_dev, _ = device_profile(torch, sdpa_bwd, 5)
        flops, nbytes = fa.bwd_cost(TRAIN_BATCH, SEQ, SEQ, h, h, hdim,
                                     causal)
        bound = max(flops / PEAK_FLOPS["bfloat16"], nbytes / HBM_BYTES_PER_S)
        say(f"  flash_attention_bwd @ B={TRAIN_BATCH} S={SEQ} H={h} KV={h} "
            f"hd={hdim} {'causal' if causal else 'bidirectional'} bf16 "
            f"({who}): two calls bit for bit; kernel {bwd_ms:.4f} ms per "
            f"call ({sum(stages):.4f} ms on the device: delta "
            f"{stages[0]:.4f} + dq {stages[1]:.4f} + dk/dv {stages[2]:.4f}),"
            f" plain {bwd_plain:.4f} ms, sdpa backward {bwd_lib:.4f} ms per "
            f"call ({lib_dev:.4f} ms on the device), bound "
            f"{bound * 1e3:.4f} ms ({flops / 1e9:.2f} GFLOP / 989 TFLOP/s; "
            f"{nbytes / 1e6:.1f} MB); on the device "
            f"{sum(stages) / lib_dev:.2f}x sdpa backward, "
            f"{100 * bound * 1e3 / sum(stages):.1f}% of the bound")
        # dq runs three of the five products, dk/dv four (the score
        # products twice between them)
        say(f"    on the device: dq {0.6 * flops / stages[1] / 1e9:.1f} "
            f"TFLOP/s, dk/dv {0.8 * flops / stages[2] / 1e9:.1f} TFLOP/s")
        say_rate("kernel", bwd_ms, flops, bound * 1e3)
        say_rate("sdpa backward", bwd_lib, flops, bound * 1e3)
        del q, k, v, do, out, lse, qt, kt, vt, sdpa_out, dot

    rmsnorm_kernels(types.SimpleNamespace(
        torch=torch, F=F, rn=rn, ref=ref, ops=ops, get_config=get_config,
        dev=dev), cfg, randn, report)

    ssd_errs = []

    def ssd_inputs(b, s, h, p, g, n, dtype, seed=6, views=False):
        """x, dt, A, B, C as tests/test_kernels.py draws them; with
        `views`, x, B and C are views of one (b, s, h p + 2 g n) tensor,
        cut as `models.ssm.mamba2_block` cuts its conv output."""
        gen.manual_seed(seed)

        def normal(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        if views:
            xbc = normal(b, s, h * p + 2 * g * n).to(dtype)
            x = xbc[..., :h * p].reshape(b, s, h, p)
            Bm = xbc[..., h * p:h * p + g * n].reshape(b, s, g, n)
            Cm = xbc[..., h * p + g * n:].reshape(b, s, g, n)
        else:
            x = normal(b, s, h, p).to(dtype)
        dt = F.softplus(normal(b, s, h))
        A = -torch.exp(normal(h) * 0.5)
        if not views:
            Bm, Cm = (normal(b, s, g, n).to(dtype),
                      normal(b, s, g, n).to(dtype))
        return x, dt, A, Bm, Cm

    for case in ([c + (False,) for c in SSD_CASES + SPEED_SSD_CASES]
                 + [c + (True,) for c in SSD_VIEW_CASES]):
        b, s, h, p, g, n, chunk, dtype, views = case
        ins = ssd_inputs(b, s, h, p, g, n, getattr(torch, dtype), views=views)
        if views and ins[0].stride(1) != h * p + 2 * g * n:
            fail("the SSD inputs are not views of one conv output")
        got = ss.ssd_scan_fwd(*ins, chunk)
        want = ref.ssd_scan_ref(*ins, chunk)
        torch.cuda.synchronize()
        ssd_errs.append(compare_scaled(
            torch, f"ssd b={b} s={s} h={h} p={p} g={g} n={n} chunk={chunk} "
            f"{dtype}{' (views of xbc)' if views else ''}", got, want,
            *SSD_TOL[dtype]))
        del ins, got, want

    def stage_name(name: str) -> str:
        m = re.search(r"\w+_kernel(<[^>]*>)?", name)
        return m.group(0) if m else name[:60]

    # the main path's shapes (mamba2-1.3b prefill and train, zamba2-1.2b)
    # on views of one conv output, as the Mamba2 block hands them over:
    # device time by stage, host time per call
    ssd_dev_ms = []
    for b, s, h, p, g, n, chunk, _ in SSD_CASES[:3]:
        ins = ssd_inputs(b, s, h, p, g, n, torch.bfloat16, views=True)
        flops, nbytes = ss.cost(b, s, h, p, g, n, chunk)
        bound = max(flops / PEAK_FLOPS["bfloat16"], nbytes / HBM_BYTES_PER_S)
        _, ranked = device_profile(
            torch, lambda: ss.ssd_scan_fwd(*ins, chunk), 10)
        stages = [(stage_name(nm), t) for nm, t in ranked if "ssd_" in nm]
        if not stages:
            fail("the profiler saw no SSD kernel on the device")
        dev_ms = sum(t for _, t in stages)
        ssd_dev_ms.append(dev_ms)
        host = host_ms(torch, lambda: ss.ssd_scan_fwd(*ins, chunk))
        say(f"  ssd_scan_fwd @ b={b} s={s} h={h} p={p} g={g} n={n} bf16 "
            f"(views of xbc): {dev_ms:.4f} ms on the device in "
            f"{len(stages)} kernels, {host:.4f} ms of host time per call "
            f"(5 tensor maps, 3 launches); bound {bound * 1e3:.4f} ms: "
            f"{dev_ms / (bound * 1e3):.1f}x the bound, "
            f"{flops / (dev_ms * 1e-3) / 1e12:.2f} TFLOP/s, "
            f"{nbytes / (dev_ms * 1e-3) / 1e9:.0f} GB/s")
        for nm, t in stages:
            say(f"    {t:.4f} ms  {nm}")
        del ins

    b, s, h, p, g, n, chunk, _ = SSD_CASES[0]       # mamba2-1.3b prefill
    ins = ssd_inputs(b, s, h, p, g, n, torch.bfloat16)
    first = ss.ssd_scan_fwd(*ins, chunk)
    again = ss.ssd_scan_fwd(*ins, chunk)
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        fail("two calls of the SSD kernel differ")
    say("  ssd_scan_fwd: two calls at the prefill shape bit for bit")
    del first, again
    ms = time_ms(torch, lambda: ss.ssd_scan_fwd(*ins, chunk))
    plain_ms = time_ms(torch, lambda: ref.ssd_scan_ref(*ins, chunk),
                       warmup=2, iters=10)
    flops, nbytes = ss.cost(b, s, h, p, g, n, chunk)
    bound = max(flops / PEAK_FLOPS["bfloat16"], nbytes / HBM_BYTES_PER_S)
    report["ssd_scan_fwd"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:64",
        max_abs_err=max(ssd_errs), ms=ms, plain_ms=plain_ms,
        bound_ms=bound * 1e3,
        bound_by=("operations" if flops / PEAK_FLOPS["bfloat16"]
                  >= nbytes / HBM_BYTES_PER_S else "bytes"),
        library_ms=None)     # no single PyTorch call computes the SSD scan
    say(f"  ssd_scan_fwd @ b={b} s={s} h={h} p={p} g={g} n={n} chunk={chunk} "
        f"bf16: kernel {ms:.4f} ms per call ({ssd_dev_ms[0]:.4f} ms on the "
        f"device, above; a call shorter than its host time waits for it), "
        f"plain {plain_ms:.4f} ms, no library call, bound "
        f"{bound * 1e3:.4f} ms ({flops / 1e9:.2f} GFLOP / 989 TFLOP/s; "
        f"{nbytes / 1e6:.1f} MB / 3.35 TB/s); kernel at "
        f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s, "
        f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s")
    say_rate("kernel", ms, flops, bound * 1e3)
    # the backward is the plain version's, by recompute (`ops._SSDScan`)
    b = TRAIN_BATCH
    ins = [t.requires_grad_() for t in ssd_inputs(b, s, h, p, g, n,
                                                  torch.bfloat16)]
    y = ops.ssd_scan(*ins, chunk)
    dy = torch.randn_like(y)
    bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
        y, ins, dy, retain_graph=True), warmup=1, iters=5)
    say(f"  ops.ssd_scan backward @ b={b} (autograd over the plain version, "
        f"by recompute): {bwd_ms:.3f} ms per call")
    del ins, y, dy
    torch.cuda.synchronize()

    es_errs = []

    def es_matrix(n, m, dtype, seed):
        """Event times in [0, 1e6) with 30% masked, from a seeded draw on
        the card, and the edge rows where n allows: all masked, a full
        tie, -inf twice, a NaN."""
        gen.manual_seed(seed)
        ev = torch.rand((n, m), generator=gen, device=dev,
                        dtype=torch.float64) * 1e6
        ev[torch.rand((n, m), generator=gen, device=dev) < 0.3] = math.inf
        if n >= 4:
            ev[0] = math.inf
            ev[1] = 7.0
            ev[2, 1] = ev[2, m - 1] = -math.inf
            ev[3, 1] = math.nan
        return ev.to(dtype)

    for n, m in ((FLEET_N, 8), (4096, 8), (1, 2), (257, 17)):
        for dtype in (torch.float64, torch.float32):
            ev = es_matrix(n, m, dtype, 8)
            t, i = es.event_select_fwd(ev)
            want_t, want_i = ref.event_select_ref(ev)
            torch.cuda.synchronize()
            bits = torch.int64 if dtype == torch.float64 else torch.int32
            same = (torch.equal(i, want_i)
                    and torch.equal(t.view(bits), want_t.view(bits)))
            fin = torch.isfinite(want_t)
            err = float((t[fin] - want_t[fin]).abs().max()) if bool(
                fin.any()) else 0.0
            es_errs.append(err)
            say(f"  event_select ({n}, {m}) {str(dtype)[6:]}: "
                f"{'bit for bit' if same else 'DIFFERS'} (t and i; "
                f"{int((~fin).sum())} rows inf/NaN)")
            if not same:
                fail("event_select disagrees with its plain version")
    # the engine's first-round shape: every row active, 4 revocation
    # timers (some inf) and 4 disarmed join timers
    ev = es_matrix(FLEET_N, 8, torch.float64, 9)
    ev[:, 4:] = math.inf
    ms = time_ms(torch, lambda: es.event_select_fwd(ev), warmup=20,
                 iters=200)
    plain_ms = time_ms(torch, lambda: ref.event_select_ref(ev), warmup=5,
                       iters=50)
    lib_ms = time_ms(torch, lambda: torch.min(ev, dim=1), warmup=20,
                     iters=200)
    n_es, m_es = ev.shape
    ops_es, nbytes = es.cost(n_es, m_es)               # comparisons; bytes
    bound = max(nbytes / HBM_BYTES_PER_S, ops_es / PEAK_F64_FLOPS)
    report["event_select_fwd"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/event_select.cu",
        replaces="src/repro/kernels/event_select.py:35",
        max_abs_err=max(es_errs), ms=ms, plain_ms=plain_ms,
        bound_ms=bound * 1e3,
        bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                  >= ops_es / PEAK_F64_FLOPS else "operations"),
        library_ms=lib_ms)
    _, ranked = device_profile(torch, lambda: es.event_select_fwd(ev), 50)
    # the library call's own device time (all its kernels) beside the
    # kernel's, and the host time of each call: like against like
    min_dev_ms, min_ranked = device_profile(
        torch, lambda: torch.min(ev, dim=1), 50)
    es_dev_ms = kernel_ms(ranked, 'event_select_kernel')
    es_host_us = 1e3 * host_ms(torch, lambda: es.event_select_fwd(ev))
    min_host_us = 1e3 * host_ms(torch, lambda: torch.min(ev, dim=1))
    say(f"  event_select_fwd @ ({n_es}, {m_es}) float64: kernel {ms:.4f} ms "
        f"per call ({es_dev_ms:.4f} ms on the device, {es_host_us:.2f} us "
        f"of host time), plain {plain_ms:.4f} ms, torch.min {lib_ms:.4f} ms "
        f"per call ({min_dev_ms:.4f} ms on the device in "
        f"{len(min_ranked)} kernel(s), {min_host_us:.2f} us of host time), "
        f"bound {bound * 1e3:.5f} ms ({nbytes / 1e6:.2f} MB / 3.35 TB/s); "
        f"on the device the kernel takes {es_dev_ms / min_dev_ms:.2f}x "
        "torch.min's time")
    for name, t in min_ranked:
        say(f"    torch.min: {t:.4f} ms  {name[:80]}")
    say_rate("kernel (fp64 comparisons)", ms, ops_es, bound * 1e3)
    del ev
    torch.cuda.synchronize()
    # the host's own cost of each wrapper as the main path calls it: what
    # the card path adds before a launch
    with torch.no_grad():
        for name, fn in wrapper_calls(torch, fa, ops, rn, dev):
            say(f"  host time a call: {name}: "
                f"{host_ms(torch, fn) * 1e3:.2f} us")
    torch.cuda.synchronize()

    c = types.SimpleNamespace(
        torch=torch, dev=dev, gen=gen, ops=ops, Session=Session,
        get_config=get_config, RunConfig=RunConfig, flatten=flatten,
        tree_map=tree_map, model_api=model_api, layers=model_layers,
        steps=st,
        make_prefill_step=make_prefill_step, GatewayEngine=GatewayEngine,
        ShardedLoader=ShardedLoader,
        SyntheticTokenSource=SyntheticTokenSource,
        source_for_config=source_for_config, FleetSim=FleetSim,
        SimWorker=SimWorker, cnn=cnn, CIFARLikeSource=CIFARLikeSource)
    main_path = counts()

    def add(launches):
        """Count a phase's launches; print the script's seconds so far."""
        for name in main_path:
            main_path[name] += launches[name]
        say(f"  ({time.monotonic() - t_start:.1f} s since the start)")

    say(f"  ({time.monotonic() - t_start:.1f} s since the start)")
    # --------------------------------------------- 4-7. qwen3-1.7b, dense
    L = cfg.n_layers
    n_norms = norm_count(cfg)
    session, params, launches = phase_prefill(
        c, "4/23", "qwen3-1.7b",
        counts(flash_attention_fwd=L, rmsnorm_fwd=n_norms))
    add(launches)
    add(phase_serve(c, "5/23", session, params,
                    counts(rmsnorm_fwd=n_norms), SERVE_VS_PREFILL_TOL))
    del session, params
    release(torch)
    train_step_launches = {"qwen3-1.7b": counts(
        flash_attention_fwd=L, flash_attention_bwd=L, rmsnorm_fwd=n_norms,
        rmsnorm_bwd=n_norms)}
    add(phase_train(
        c, "6/23", "qwen3-1.7b", train_step_launches["qwen3-1.7b"],
        attn_step_flops(cfg, TRAIN_BATCH, SEQ),
        "6 N per token plus the attention products"))
    phase_parity(c, "7/23", "qwen3-1.7b",
                 counts(flash_attention_fwd=2, flash_attention_bwd=2,
                        rmsnorm_fwd=4 * 2 + 1, rmsnorm_bwd=4 * 2 + 1),
                 PARITY_TOL)

    # --------------------------------------- 7b. checkpoint and resume
    say("[7b/23] resume: SMOKE config, checkpoint_interval=2; 4 steps "
        "straight vs 2 steps + a new Session restoring at step 2 for 2 more")
    kw = dict(global_batch=4, seq_len=128)
    with tempfile.TemporaryDirectory() as dir_a, \
            tempfile.TemporaryDirectory() as dir_b:
        run_a = Session.from_arch("qwen3-1.7b", checkpoint_interval=2).train(
            4, checkpoint_dir=dir_a, **kw)
        Session.from_arch("qwen3-1.7b", checkpoint_interval=2).train(
            2, checkpoint_dir=dir_b, **kw)
        resumed = Session.from_arch("qwen3-1.7b", checkpoint_interval=2)
        run_b = resumed.train(2, checkpoint_dir=dir_b, **kw)
    restored = [e.payload["step"] for e in resumed.bus.of_kind("restore")]
    ran = [e.payload["step"] for e in resumed.bus.of_kind("step")]
    rel = [abs(b - a) / abs(a) for a, b in zip(run_a.losses[2:], run_b.losses)]
    say(f"  restore events {restored}, resumed steps {ran}; losses straight "
        f"{run_a.losses[2:]} vs resumed {run_b.losses} (rel {rel})")
    if restored != [2] or ran != [2, 3] or max(rel) > 1e-5:
        fail("the resumed run does not continue the uninterrupted one")

    # ------------------------------------------- 8-11. mamba2-1.3b, SSM
    mcfg = get_config("mamba2-1.3b", smoke=False)
    ms_ = mcfg.ssm
    L = mcfg.n_layers
    n_norms = 2 * L + 1                       # ln and gated norm, final
    session, params, launches = phase_prefill(
        c, "8/23", "mamba2-1.3b", counts(ssd_scan_fwd=L, rmsnorm_fwd=n_norms))
    add(launches)
    add(phase_serve(c, "9/23", session, params,
                    counts(rmsnorm_fwd=n_norms), SSM_SERVE_VS_PREFILL_TOL,
                    in_fp32=True))
    del session, params
    release(torch)
    heads = ms_.expand * mcfg.d_model // ms_.head_dim
    # the SSD products, forward and backward (3x), in each layer
    ssd_step = 3.0 * L * ss.cost(TRAIN_BATCH, SEQ, heads, ms_.head_dim,
                                 ms_.n_groups, ms_.d_state,
                                 ms_.chunk_size)[0]
    train_step_launches["mamba2-1.3b"] = counts(ssd_scan_fwd=L,
                                                rmsnorm_fwd=n_norms,
                                                rmsnorm_bwd=n_norms)
    add(phase_train(c, "10/23", "mamba2-1.3b",
                    train_step_launches["mamba2-1.3b"], ssd_step,
                    "6 N per token plus the SSD products"))
    phase_parity(c, "11/23", "mamba2-1.3b",
                 counts(ssd_scan_fwd=2, rmsnorm_fwd=2 * 2 + 1,
                        rmsnorm_bwd=2 * 2 + 1),
                 SSM_PARITY_TOL)

    # ----------------------------------------- 12. zamba2-1.2b, hybrid
    zcfg = get_config("zamba2-1.2b", smoke=False)
    L = zcfg.n_layers
    n_shared = L // zcfg.shared_attn_every
    n_norms = 2 * L + 2 * n_shared + 1
    session, params, launches = phase_prefill(
        c, "12/23", "zamba2-1.2b",
        counts(ssd_scan_fwd=L, flash_attention_fwd=n_shared,
               rmsnorm_fwd=n_norms))
    add(launches)
    add(phase_serve(c, "12/23", session, params,
                    counts(rmsnorm_fwd=n_norms), SSM_SERVE_VS_PREFILL_TOL,
                    in_fp32=True))
    del session, params
    release(torch)

    # --------------------------------------- 13. the fleet device engine
    add(phase_fleet(c, "13/23"))

    # ------------------------------------- 14. the §VI-B live chaos loop
    add(phase_live(c, "14/23"))

    # ------------------------- 15. the §III-§V model leg, fitted on the card
    add(phase_models(c, "15/23", train_step_launches))

    # ------------------- 16. the recorded trace and the serving fleet
    add(phase_trace_serving(c, "16/23"))

    # ------------------ 17. MoE and MLA: granite-moe and deepseek-v2-lite
    for arch in MOE_ARCHS:
        add(phase_moe(c, "17/23", arch))

    # ---------- 18. the dense and VLM archs: stablelm, qwen2-vl, yi, starcoder2
    for arch in DENSE_ARCHS:
        add(phase_dense(c, "18/23", arch))

    # ------------------------- 19. the audio encoder: hubert-xlarge, hd 80
    add(phase_encoder(c, "19/23"))

    # ----------------------------------- 20. the paper's CIFAR-10 CNN zoo
    phase_cnn(c, "20/23")
    say(f"  ({time.monotonic() - t_start:.1f} s since the start)")

    # ---- 21. async PS, remat and the int8 KV cache at full qwen3 width
    add(phase_async(c, "21/23"))
    add(phase_remat(c, "21/23"))
    add(phase_int8(c, "21/23"))

    # ------------- 22. the dry run's accounting against phases 4 and 21
    phase_dryrun(c, "22/23")

    # -------- 23. the paper's table and figure drivers and the examples
    add(phase_bench(c, "23/23"))

    # ------------------------------------------------------------ result
    kernels = []
    for name in KERNELS:
        row = report[name]
        if main_path[name] == 0:
            fail(f"{name} never launched on the main path")
        kernels.append({"name": name, "route": row["route"],
                        "source": row["source"], "replaces": row["replaces"],
                        "launches": main_path[name],
                        "max_abs_err": row["max_abs_err"],
                        "ms": row["ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    say(f"phases 1-23 in {time.monotonic() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
