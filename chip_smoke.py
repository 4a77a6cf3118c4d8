#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. card:    print the card's name and power limit (nvidia-smi);
2. build:   build the hand-written kernels from src/repro_torch/kernels/csrc
            with nvcc for sm_90a;
3. kernels: hold each kernel against its plain PyTorch version on the card
            (flash-attention forward: out and lse; RMSNorm) and time the
            kernel, the plain version and one PyTorch library call;
4. prefill: a full-width qwen3-1.7b prefill (B=1, S=2048, random weights
            from seed 0) through `launch.steps.make_prefill_step`, which must
            launch the flash kernel once per layer and the RMSNorm kernel
            once per norm;
5. serve:   `Session.serve` at full width (4 requests x 16 tokens after a
            32-token prompt), greedy, twice with one seed: identical
            streams, RMSNorm launches as predicted per step, and the
            gateway's logits at the last prompt position agree with the
            prefill path's.

Then one JSON line per the kernels (launches from phases 4 and 5), the
card line again, and the result line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the repository beside it, it fails
before printing any result.
"""
from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (dense): bf16 tensor cores, fp32 CUDA cores, HBM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
TOL = {"bfloat16": 2e-2, "float32": 2e-5}  # as tests/test_kernels.py
# decode-vs-prefill logits, scale-relative: the two paths round in bf16 at
# different places (bf16 KV cache and fp32 softmax over it vs the flash
# kernel's bf16 output) across 28 layers
SERVE_VS_PREFILL_TOL = 5e-2

SEQ, N_TOKENS, N_BATCH, PROMPT_LEN = 2048, 16, 4, 32


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


def device_profile(torch, fn, n: int):
    """Run ``fn`` n times under torch.profiler. Returns the device time per
    call summed over kernels and copies (ms) and that time by kernel name,
    largest first. The profiler slows the host, so host wall times are
    taken without it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / n)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return sum(by_name.values()), ranked


def say_profile(what: str, wall_ms: float, device_ms: float, ranked) -> None:
    if device_ms == 0.0:
        say(f"  {what}: device time not measured (the profiler saw no "
            "CUDA activity)")
        return
    say(f"  {what}: device busy {device_ms:.3f} ms of {wall_ms:.3f} ms "
        f"wall ({100 * device_ms / wall_ms:.1f}% busy, "
        f"{100 - 100 * device_ms / wall_ms:.1f}% idle); top kernels:")
    for name, ms in ranked[:6]:
        say(f"    {ms:9.4f} ms  {100 * ms / device_ms:5.1f}%  {name[:90]}")


def kernel_ms(ranked, needle: str) -> float:
    return sum(ms for name, ms in ranked if needle in name)


def compare(torch, name, got, want, dtype) -> float:
    """max |got - want|; fails unless |got - want| <= tol + tol |want|."""
    tol = TOL[dtype]
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a "
             "CUDA card")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"the port's sources are not beside this script ({SRC})")
    sys.path.insert(0, str(SRC))
    import torch.nn.functional as F

    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.serving.engine import GatewayEngine
    from repro_torch.tree import flatten

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)

    def randn(shape, dtype, seed):
        gen.manual_seed(seed)
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # ---------------------------------------------------------- 1. card
    card = card_line()
    say(f"[1/5] card: {card}")
    say(f"      torch {torch.__version__} cuda {torch.version.cuda} "
        f"device_count={torch.cuda.device_count()}")

    # --------------------------------------------------------- 2. build
    t0 = time.monotonic()
    _build.library()
    say(f"[2/5] build: {_build.library_path().name} in "
        f"{time.monotonic() - t0:.1f}s (nvcc {_build.last_build_seconds:.1f}s)")
    for line in _build.last_build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            say(f"      {line.strip()}")

    # ------------------------------------------------ 3. kernels vs plain
    say("[3/5] kernels vs plain versions")
    cfg = get_config("qwen3-1.7b", smoke=False)
    H, KV, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    report = {}

    fa_errs = []
    for (B, Sq, Sk, h, kv, hdim, causal, dtype) in [
            (1, SEQ, SEQ, H, KV, hd, True, "bfloat16"),      # main path
            (2, 200, 200, H, KV, hd, True, "bfloat16"),      # ragged
            (2, 192, 320, 4, 2, 64, False, "float32"),       # bidirectional
            (1, 100, 100, 4, 1, 32, True, "float32")]:
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

    q = randn((1, SEQ, H, hd), torch.bfloat16, 1)
    k = randn((1, SEQ, KV, hd), torch.bfloat16, 2)
    v = randn((1, SEQ, KV, hd), torch.bfloat16, 3)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if tuple(int(p) for p in torch.__version__.split(".")[:2]) >= (2, 5):
        sdpa_kw = {"enable_gqa": True}
    else:  # no GQA switch before torch 2.5: give SDPA the expanded heads
        kt, vt = (x.repeat_interleave(H // KV, dim=1) for x in (kt, vt))
        sdpa_kw = {}
    ms = time_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, causal=True))
    plain_ms = time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, True),
                       warmup=2, iters=20)
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, **sdpa_kw))
    pairs = SEQ * (SEQ + 1) // 2                       # causal (q, k) pairs
    flops = 4.0 * H * hd * pairs                       # QK^T and PV
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel()) + 4 * H * SEQ
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
    say(f"  flash_attention_fwd @ B=1 S={SEQ} H={H} KV={KV} hd={hd} causal "
        f"bf16: kernel {ms:.4f} ms per call "
        f"({kernel_ms(ranked, 'flash_fwd_'):.4f} ms on the device), "
        f"plain {plain_ms:.4f} ms, sdpa "
        f"{lib_ms:.4f} ms, bound {bound * 1e3:.4f} ms "
        f"({flops / 1e9:.2f} GFLOP / 989 TFLOP/s; {nbytes / 1e6:.1f} MB); "
        f"kernel at {flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s")

    rn_errs = []
    scale_main = torch.linspace(0.5, 1.5, d, device=dev)
    for rows, dim, dtype in [(SEQ, d, "bfloat16"), (N_BATCH, d, "bfloat16"),
                             (SEQ * H, hd, "bfloat16"), (N_BATCH, d, "float32"),
                             (3, hd, "float32")]:
        x = randn((rows, dim), getattr(torch, dtype), 4)
        scale = torch.linspace(0.5, 1.5, dim, device=dev)
        got = rn.rmsnorm_fwd(x, scale, cfg.norm_eps)
        want = ref.rmsnorm_ref(x, scale, cfg.norm_eps)
        torch.cuda.synchronize()
        rn_errs.append(compare(torch, f"rmsnorm ({rows}, {dim}) {dtype}",
                               got, want, dtype))
    x = randn((SEQ, d), torch.bfloat16, 4)
    w_lib = scale_main.to(torch.bfloat16)
    ms = time_ms(torch, lambda: rn.rmsnorm_fwd(x, scale_main, cfg.norm_eps))
    plain_ms = time_ms(torch, lambda: ref.rmsnorm_ref(x, scale_main,
                                                      cfg.norm_eps))
    lib_ms = time_ms(torch, lambda: F.rms_norm(x, (d,), w_lib, cfg.norm_eps))
    nbytes = 2 * x.numel() * 2 + 4 * d
    flops = 4.0 * x.numel()
    bound = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["float32"])
    report["rmsnorm_fwd"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm.py:23",
        max_abs_err=max(rn_errs), ms=ms, plain_ms=plain_ms,
        bound_ms=bound * 1e3,
        bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                  >= flops / PEAK_FLOPS["float32"] else "operations"),
        library_ms=lib_ms)
    _, ranked = device_profile(
        torch, lambda: rn.rmsnorm_fwd(x, scale_main, cfg.norm_eps), 20)
    say(f"  rmsnorm_fwd @ ({SEQ}, {d}) bf16: kernel {ms:.4f} ms per call "
        f"({kernel_ms(ranked, 'rmsnorm_kernel'):.4f} ms on the device), plain "
        f"{plain_ms:.4f} ms, F.rms_norm {lib_ms:.4f} ms, bound "
        f"{bound * 1e3:.4f} ms ({nbytes / 1e6:.2f} MB / 3.35 TB/s); kernel at "
        f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s")
    torch.cuda.synchronize()

    # ------------------------------------------------ 4. prefill, full width
    say(f"[4/5] prefill: {cfg.name} full width (L={cfg.n_layers} d={d} "
        f"H={H}/KV={KV} hd={hd} V={cfg.vocab_size}), B=1 S={SEQ}, "
        f"{cfg.dtype}")
    session = Session.from_arch("qwen3-1.7b", smoke=False)
    t0 = time.monotonic()
    params = session.params
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in flatten(params))
    say(f"  init {n_params / 1e9:.3f} B fp32 params on the card in "
        f"{time.monotonic() - t0:.2f}s")
    prefill = make_prefill_step(cfg)
    gen.manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (1, SEQ), generator=gen,
                           device=dev)
    prefill(params, {"tokens": tokens})            # warm-up (cuBLAS, build)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.monotonic()
    logits = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    first_ms = (time.monotonic() - t0) * 1e3
    launches = {"flash_attention_fwd": ops.flash_attention.launches,
                "rmsnorm_fwd": ops.rmsnorm.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_norms = 2 * cfg.n_layers + 1 + (2 * cfg.n_layers if cfg.qk_norm else 0)
    want_launches = {"flash_attention_fwd": cfg.n_layers,
                     "rmsnorm_fwd": n_norms}
    say(f"  launches {launches} (predicted {want_launches})")
    if launches != want_launches:
        fail("prefill did not launch the kernels as predicted")
    if tuple(logits.shape) != (1, SEQ, cfg.vocab_size):
        fail(f"prefill logits shape {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        fail("prefill logits are not finite")
    walls = []
    for _ in range(3):
        t0 = time.monotonic()
        prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        walls.append((time.monotonic() - t0) * 1e3)
    prefill_ms = statistics.median(walls)
    say(f"  prefill {prefill_ms:.2f} ms median of 3 (counted run "
        f"{first_ms:.2f} ms), {SEQ / prefill_ms * 1e3:.0f} tok/s, peak "
        f"memory {peak_gb:.2f} GB")
    say_profile("prefill", prefill_ms, *device_profile(
        torch, lambda: prefill(params, {"tokens": tokens}), 2))
    del logits

    # -------------------------------------------------- 5. serve, full width
    steps = PROMPT_LEN + N_TOKENS - 1
    say(f"[5/5] serve: Session.serve(tokens={N_TOKENS}, batch={N_BATCH}, "
        f"prompt_len={PROMPT_LEN}), greedy, twice; {steps} steps each")
    ops.reset_launches()
    reps = [session.serve(tokens=N_TOKENS, batch=N_BATCH,
                          prompt_len=PROMPT_LEN, seed=1) for _ in range(2)]
    torch.cuda.synchronize()
    serve_launches = {"flash_attention_fwd": ops.flash_attention.launches,
                      "rmsnorm_fwd": ops.rmsnorm.launches}
    want_serve = {"flash_attention_fwd": 0,
                  "rmsnorm_fwd": 2 * steps * n_norms}
    say(f"  launches {serve_launches} (predicted {want_serve}: "
        f"{n_norms} RMSNorm launches per decode step)")
    if serve_launches != want_serve:
        fail("serve did not launch the RMSNorm kernel as predicted")
    a, b = (r.generated for r in reps)
    if a.shape != (N_BATCH, N_TOKENS) or not torch.equal(a, b):
        fail(f"greedy replay differs: {a.tolist()} vs {b.tolist()}")
    say(f"  greedy replay identical; slot 0 tokens {a[0].tolist()}")
    for i, r in enumerate(reps):
        say(f"  run {i}: {r.tokens_per_second:.1f} tok/s, decode p50 "
            f"{r.decode_ms_p50:.3f} ms p95 {r.decode_ms_p95:.3f} ms p99 "
            f"{r.decode_ms_p99:.3f} ms, prompt feed {r.prefill_seconds:.3f}s")

    # the gateway's logits at the last prompt position vs prefill's
    gen.manual_seed(7)
    prompt = torch.randint(0, cfg.vocab_size, (N_BATCH, PROMPT_LEN),
                           generator=gen, device=dev)
    eng = GatewayEngine(cfg, params, slots=N_BATCH,
                        max_len=PROMPT_LEN + N_TOKENS, seed=1)
    for slot in range(N_BATCH):
        eng.join(slot, rid=slot, prompt=prompt[slot].tolist(),
                 max_new=N_TOKENS)
    for _ in range(PROMPT_LEN):
        eng.step()
    served = eng.last_logits.float().clone()
    pre = prefill(params, {"tokens": prompt})[:, -1].float()
    rel = float((served - pre).abs().max() / pre.abs().max())
    agree = float((served.argmax(-1) == pre.argmax(-1)).float().mean())
    say(f"  gateway vs prefill logits at position {PROMPT_LEN - 1}: "
        f"max|diff|/max|prefill| = {rel:.4e} (tol {SERVE_VS_PREFILL_TOL}), "
        f"argmax agreement {agree:.2f}")
    if not math.isfinite(rel) or rel > SERVE_VS_PREFILL_TOL:
        fail("the serving path disagrees with the prefill path")
    say_profile("one gateway decode step (4 slots)",
                reps[1].decode_ms_p50, *device_profile(torch, eng.step, 4))

    # ------------------------------------------------------------ result
    kernels = []
    for name, row in report.items():
        n = launches[name] + serve_launches[name]
        if n == 0:
            fail(f"{name} never launched on the main path")
        kernels.append({"name": name, "route": row["route"],
                        "source": row["source"], "replaces": row["replaces"],
                        "launches": n, "max_abs_err": row["max_abs_err"],
                        "ms": row["ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    say(json.dumps({"kernels": kernels}))
    say(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
