"""Where a live chaos step's wall time goes on the card.

    python3 scripts/live_step_host.py        # on a machine with a CUDA card

The chaos runner's live branch trains qwen3-1.7b at B=4, S=32
(`chaos.runner._run_live`), where the step does little work per token and
much per parameter. This builds the full-width train step as the trainer
does (`launch.steps.make_train_step`, fp32 weights and AdamW on the card),
once per compression scheme of the §VI-B ladder (none, int8, topk), and
for each prints:

1. the wall time of a step (host clock around a synchronised step, the
   median of 5 after 3 warm-up steps) and the device's busy time in one
   step (`torch.profiler`);
2. the caching allocator's counters over those 5 steps: device
   allocations and frees (`cudaMalloc` / `cudaFree`), and allocation
   retries (a retry frees the cache and waits for the card);
3. the host operations that took the most host time in one profiled step
   (self CPU time, calls), and the CUDA runtime calls among them.

Prints the card's name and power limit first. Prints only.
"""
from __future__ import annotations

import dataclasses
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, S = 4, 32


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card")
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import RunConfig, get_config
    from repro_torch.data.pipeline import ShardedLoader, SyntheticTokenSource
    from repro_torch.launch import steps as st

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    cfg = get_config("qwen3-1.7b", smoke=False)
    run = RunConfig(warmup_steps=1, total_steps=100)
    state = st.init_train_state(cfg, run, device=dev)
    loader = ShardedLoader(SyntheticTokenSource(cfg.vocab_size, S), B)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in loader.next_global(1).items()}
    for scheme in ("none", "int8", "topk"):
        srun = dataclasses.replace(run, grad_compression=scheme)
        step, _ = st.make_train_step(cfg, srun)
        if scheme == "int8":
            state = state._replace(residual=st.init_residual(state.params,
                                                             srun))

        def one():
            out = step(state, batch)
            torch.cuda.synchronize()
            return out

        for _ in range(3):
            state, _ = one()
        before = torch.cuda.memory_stats()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            state, _ = one()
            walls.append((time.perf_counter() - t0) * 1e3)
        after = torch.cuda.memory_stats()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, _ = one()
        device_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                        if e.device_type == DeviceType.CUDA
                        and not e.is_user_annotation) / 1e3
        rows = sorted(prof.key_averages(),
                      key=lambda r: -r.self_cpu_time_total)
        host_ms = sum(r.self_cpu_time_total for r in rows) / 1e3
        delta = {k: after.get(k, 0) - before.get(k, 0)
                 for k in ("num_device_alloc", "num_device_free",
                           "num_alloc_retries")}
        print(f"{scheme}: step {statistics.median(walls):.1f} ms wall "
              f"(median of 5: {', '.join(f'{w:.1f}' for w in walls)}); "
              f"device busy {device_ms:.1f} ms, host ops {host_ms:.1f} ms "
              f"of self CPU time in the profiled step; allocator over the "
              f"5 steps: {delta}; peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
              flush=True)
        for r in rows[:14]:
            print(f"    {r.self_cpu_time_total / 1e3:9.2f} ms  "
                  f"{r.count:6d} calls  {r.key[:70]}")
        runtime = [r for r in rows if r.key.startswith("cuda")]
        print("    CUDA runtime: " + "; ".join(
            f"{r.key} {r.self_cpu_time_total / 1e3:.2f} ms / {r.count}"
            for r in runtime[:8]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
