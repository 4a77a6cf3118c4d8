"""What RMSNorm costs a qwen3-1.7b train step on the card, forward and
backward, whichever way the port's `kernels.ops.rmsnorm` computes them.

    python3 scripts/rmsnorm_step_share.py [--src DIR]   # with a CUDA card

``--src`` names the ``src`` directory whose `repro_torch` is measured
(default: this checkout's), so one call can measure two trees in turn.
Prints the card's name and power limit first, then:

1. at each of the training shapes of the norms (qwen3-1.7b at B=2,
   S=2048: residual (4096, 2048), q-norm (65536, 128), k-norm
   (32768, 128); mamba2-1.3b's gated norm (4096, 4096); bf16 rows, fp32
   scale), the forward and the backward as `ops.rmsnorm` runs them under
   autograd: ms per call (CUDA events, median of 25), device ms and the
   number of device kernels per call (`torch.profiler`), and the host
   ms per call (back-to-back calls that never wait for the card);
2. the full-width qwen3-1.7b train step (`launch.steps.make_train_step`,
   AdamW) at B=2, S=2048 and at the live loop's B=4, S=32: step ms
   (CUDA events, median of 5 after 2 warm-up steps), peak memory, and
   one profiled step's device busy ms and kernel count, with the device
   ms and kernels of RMSNorm's forward (the `_RMSNorm` op and what runs
   inside it) and backward (`_RMSNormBackward`) and their shares.

Prints only.
"""
from __future__ import annotations

import argparse
import pathlib
import statistics
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = (("qwen3 residual", 4096, 2048), ("qwen3 q-norm", 65536, 128),
          ("qwen3 k-norm", 32768, 128), ("mamba2 gated", 4096, 4096))
STEPS = (("phase 6", 2, 2048), ("live", 4, 32))


def norm_share(prof, DeviceType):
    """Device ms and kernels under the RMSNorm forward and backward ops
    (each op and its descendants), and the trace's totals."""
    out = {"fwd": [0.0, 0], "bwd": [0.0, 0]}

    def walk(e, slot):
        for k in e.kernels:
            slot[0] += k.duration / 1e3
            slot[1] += 1
        for child in e.cpu_children:
            walk(child, slot)

    busy, kernels = 0.0, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            busy += e.time_range.elapsed_us() / 1e3
            kernels += 1
        elif e.name == "_RMSNorm":
            walk(e, out["fwd"])
        elif e.name == "_RMSNormBackward":
            walk(e, out["bwd"])
    return out, busy, kernels


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", default=str(ROOT / "src"))
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card")
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    import chip_smoke as cs
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import RunConfig, get_config
    from repro_torch.data.pipeline import ShardedLoader, SyntheticTokenSource
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as st
    from repro_torch.models import api as model_api

    print(cs.card_line(), flush=True)
    print(f"measuring {ops.__file__}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    cfg = get_config("qwen3-1.7b", smoke=False)
    eps = cfg.norm_eps
    for what, rows, d in SHAPES:
        x = torch.randn((rows, d), generator=gen, device=dev).to(
            torch.bfloat16).requires_grad_()
        dy = torch.randn((rows, d), generator=gen, device=dev).to(
            torch.bfloat16)
        scale = torch.linspace(0.5, 1.5, d, device=dev).requires_grad_()
        with torch.no_grad():
            fwd = lambda: ops.rmsnorm(x, scale, eps)  # noqa: E731
            f_ms = cs.time_ms(torch, fwd)
            f_count = {}
            f_dev, _ = cs.device_profile(torch, fwd, 10, count=f_count)
            f_host = cs.host_ms(torch, fwd)
        y = ops.rmsnorm(x, scale, eps)

        def bwd():
            torch.autograd.grad(y, (x, scale), dy, retain_graph=True)
        b_ms = cs.time_ms(torch, bwd)
        b_count = {}
        b_dev, b_ranked = cs.device_profile(torch, bwd, 10, count=b_count)
        b_host = cs.host_ms(torch, bwd)
        print(f"{what} ({rows}, {d}) bf16: forward {f_ms:.4f} ms per call, "
              f"{f_dev:.4f} ms on the device in {f_count['events']:.0f} "
              f"kernel(s), {f_host * 1e3:.1f} us of host time; backward "
              f"{b_ms:.4f} ms per call, {b_dev:.4f} ms on the device in "
              f"{b_count['events']:.0f} kernel(s), {b_host * 1e3:.1f} us of "
              "host time", flush=True)
        for name, t in b_ranked[:6]:
            print(f"    backward: {t:.4f} ms  {name[:80]}")
        del x, dy, scale, y
    torch.cuda.empty_cache()

    params, _ = model_api.init(cfg, device=dev)
    train_step, opt = st.make_train_step(cfg, RunConfig())
    state = st.TrainState(params, opt.init(params),
                          torch.zeros((), dtype=torch.int32))
    for what, b, s in STEPS:
        loader = ShardedLoader(SyntheticTokenSource(cfg.vocab_size, s,
                                                    seed=1), b)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in loader.next_global(1).items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(7):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            state, _ = train_step(state, batch)
            end.record()
            torch.cuda.synchronize()
            if i >= 2:
                times.append(start.elapsed_time(end))
        peak = torch.cuda.max_memory_allocated() / 1e9
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, _ = train_step(state, batch)
            torch.cuda.synchronize()
        share, busy, kernels = norm_share(prof, DeviceType)
        if not kernels:
            print(f"{what} step: the profiler saw no device event")
            return 1
        (f_dev, f_n), (b_dev, b_n) = share["fwd"], share["bwd"]
        print(f"{what} step B={b} S={s}: {statistics.median(times):.1f} ms "
              f"(CUDA events, median of 5: "
              f"{', '.join(f'{t:.1f}' for t in times)}), peak "
              f"{peak:.2f} GB; profiled step: {busy:.2f} ms busy in "
              f"{kernels} kernels and copies; RMSNorm forward {f_dev:.3f} "
              f"ms in {f_n} kernels ({100 * f_dev / busy:.2f}% of busy, "
              f"{100 * f_n / kernels:.2f}% of kernels), backward "
              f"{b_dev:.3f} ms in {b_n} kernels ({100 * b_dev / busy:.2f}% "
              f"of busy, {100 * b_n / kernels:.2f}% of kernels)", flush=True)
        del batch
    return 0


if __name__ == "__main__":
    sys.exit(main())
