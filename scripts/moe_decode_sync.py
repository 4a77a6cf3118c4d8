"""What a host sync in the MoE dispatch costs a full-width decode step on
the card.

    python3 scripts/moe_decode_sync.py       # with a CUDA card

`models.layers._group_dispatch` finds each expert's first sorted pair
with `torch.searchsorted`. Counting the pairs with `torch.bincount`
instead makes the host wait for the card once a MoE layer (bincount
reads the largest id back to size its output). For
granite-moe-3b-a800m and deepseek-v2-lite-16b at full width (weights
from seed 0, bf16, fp32 weights cast at use) this times one decode step
of 4 slots against a 48-token bf16 cache (`launch.steps.make_serve_step`,
per-row positions as the gateway gives them), with the dispatch as the
port has it and with the bincount variant patched in, in turns (port,
bincount, bincount, port, ... 4 of each): the wall ms of a step (host
clock over 8 steps ending in a synchronise) and the device busy ms of
one step (`torch.profiler`). Prints the card's name and power limit
first, then one line a turn and the medians. Prints only.
"""
from __future__ import annotations

import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("granite-moe-3b-a800m", "deepseek-v2-lite-16b")
SLOTS, MAX_LEN, STEPS = 4, 48, 8


def bincount_dispatch(torch):
    """`_group_dispatch` with the slots counted by `torch.bincount`."""
    def dispatch(xg, eid, w, n_experts, cap):
        g, k = eid.shape
        flat_e = eid.reshape(-1)
        order = torch.sort(flat_e, stable=True).indices
        sorted_e = flat_e[order]
        counts = torch.bincount(sorted_e, minlength=n_experts)
        starts = torch.cumsum(counts, 0) - counts
        pos = torch.arange(g * k, device=xg.device) - starts[sorted_e]
        keep = pos < cap
        dest = torch.where(keep, sorted_e * cap + pos, n_experts * cap)
        buf = xg.new_zeros((n_experts * cap + 1, xg.shape[-1]))
        buf[dest] = xg[order // k]
        return buf[:-1], (dest, order, w.reshape(-1)[order], keep)
    return dispatch


def busy_ms(torch, fn) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import api
    from repro_torch.models import layers as L

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    variants = {"port (searchsorted)": L._group_dispatch,
                "bincount": bincount_dispatch(torch)}
    for arch in ARCHS:
        cfg = get_config(arch)
        params, _ = api.init(cfg, device=dev)
        state, _ = api.init_decode_state(cfg, SLOTS, MAX_LEN, device=dev)
        serve = make_serve_step(cfg)
        gen = torch.Generator(device=dev).manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (SLOTS,), generator=gen,
                               device=dev)
        index = torch.arange(SLOTS, device=dev) + 8

        def steps(n):
            for _ in range(n):
                serve(params, state, tokens, index)

        results = {name: ([], []) for name in variants}
        order = list(variants) + list(variants)[::-1]
        for name in order * 2:
            L._group_dispatch = variants[name]
            steps(2)                                  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps(STEPS)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / STEPS
            busy = busy_ms(torch, lambda: steps(1))
            results[name][0].append(wall)
            results[name][1].append(busy)
            print(f"{arch} {name}: step {wall:.3f} ms wall, {busy:.3f} ms "
                  "busy", flush=True)
        L._group_dispatch = variants["port (searchsorted)"]
        for name, (walls, busys) in results.items():
            print(f"{arch} {name}: median step {statistics.median(walls):.3f}"
                  f" ms wall (min {min(walls):.3f}, max {max(walls):.3f}), "
                  f"{statistics.median(busys):.3f} ms busy")
        del params, state
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
