"""What the flash backward costs a full-width train step on the card:
hubert-xlarge (head_dim 80, bidirectional) and stablelm-1.6b (head_dim 64,
causal), B=2, S=2048, AdamW.

    python3 scripts/flash_bwd_step.py [--src DIR]   # with a CUDA card

``--src`` names the ``src`` directory whose `repro_torch` is measured
(default: this checkout's), so one call can measure two trees in turn
(parent, change, change, parent). Prints the card's name and power limit
first, then for each arch the step ms (`launch.steps.make_train_step`,
CUDA events, median of 5 after 2 warm-up steps; batches from
`data.pipeline.source_for_config`: frame features for hubert) and one
profiled step's device busy ms with the flash backward's device ms by
kernel (delta, dq, dk/dv). Prints only.
"""
from __future__ import annotations

import argparse
import pathlib
import statistics
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("hubert-xlarge", "stablelm-1.6b")
BATCH, SEQ = 2, 2048


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
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.data.pipeline import ShardedLoader, source_for_config
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as st
    from repro_torch.models import api as model_api

    print(cs.card_line(), flush=True)
    print(f"measuring {ops.__file__}", flush=True)
    dev = torch.device("cuda", 0)
    for arch in ARCHS:
        cfg = get_config(arch, smoke=False)
        params, _ = model_api.init(cfg, device=dev)
        train_step, opt = st.make_train_step(cfg, RunConfig())
        state = st.TrainState(params, opt.init(params),
                              torch.zeros((), dtype=torch.int32))
        loader = ShardedLoader(source_for_config(cfg, SEQ, seed=1), BATCH)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in loader.next_global(1).items()}
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
        busy, ranked = cs.device_profile(
            torch, lambda: train_step(state, batch), 1, host=False)
        stages = [cs.kernel_ms(ranked, f"flash_bwd_{s}_")
                  for s in ("delta", "dq", "dkv")]
        print(f"{arch} B={BATCH} S={SEQ}: step {statistics.median(times):.1f}"
              f" ms (CUDA events, median of 5: "
              f"{', '.join(f'{t:.1f}' for t in times)}); profiled step "
              f"{busy:.2f} ms busy, flash backward {sum(stages):.3f} ms "
              f"(delta {stages[0]:.3f}, dq {stages[1]:.3f}, dk/dv "
              f"{stages[2]:.3f}; {100 * sum(stages) / busy:.1f}% of busy)",
              flush=True)
        del params, state, batch, train_step, opt
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
