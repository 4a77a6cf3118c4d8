"""Host time a call of each kernel wrapper of the port, as the card's
main path calls them: one tree's, or two trees' in turns in one process.

    python3 scripts/wrapper_host_time.py [--src DIR] [--against DIR]

(with a CUDA card). The calls and their timing are `chip_smoke.py`'s
(`wrapper_calls`, `host_ms`: the least, over 10 batches, of the mean of
20 back-to-back calls that never wait for the card, so the clock sees the
host's own cost), which phase 3 prints for this tree. Prints the card's
name and power limit, then each call's host time.

``--src DIR`` times the kernel wrappers (``kernels/{flash_attention,
rmsnorm,ssd_scan,event_select,ref,ops}.py``) of another tree's ``src``,
loaded beside this tree's library, built from this tree's sources, in
place of this tree's. ``--against DIR`` loads that tree's wrappers the
same way and times both in turns (a, b, b, a) for ``--rounds`` rounds,
printing each side's median and range and their ratio: in one process,
where the host places the process cannot favour a side.

Prints only.
"""
from __future__ import annotations

import argparse
import importlib.util
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
WRAPPERS = ("ref", "flash_attention", "rmsnorm", "ssd_scan", "event_select",
            "ops")


def load_wrappers(src: pathlib.Path) -> dict:
    """Another tree's kernel wrappers as fresh modules (this tree's
    `_build` and its library stay shared); sys.modules is restored."""
    import repro_torch.kernels as pkg
    names = [f"repro_torch.kernels.{w}" for w in WRAPPERS]
    saved = {n: sys.modules[n] for n in names}
    mods = {}
    try:
        for w, name in zip(WRAPPERS, names):
            spec = importlib.util.spec_from_file_location(
                name, src / "repro_torch" / "kernels" / f"{w}.py")
            mods[w] = importlib.util.module_from_spec(spec)
            # `from repro_torch.kernels import x` reads the package's
            # attribute first, then sys.modules
            sys.modules[name] = mods[w]
            setattr(pkg, w, mods[w])
            spec.loader.exec_module(mods[w])
    finally:
        sys.modules.update(saved)
        for w, name in zip(WRAPPERS, names):
            setattr(pkg, w, saved[name])
    return mods


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default="")
    ap.add_argument("--against", default="")
    ap.add_argument("--rounds", type=int, default=8)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rn

    def side(src: str) -> dict:
        if not src:
            return {"fa": fa, "ops": ops, "rn": rn}
        mods = load_wrappers(pathlib.Path(src).resolve())
        return {"fa": mods["flash_attention"], "ops": mods["ops"],
                "rn": mods["rmsnorm"]}

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"{card}; wrappers from {args.src or ROOT / 'src'}")
    dev = torch.device("cuda", 0)
    this = smoke.wrapper_calls(torch, dev=dev, **side(args.src))

    with torch.no_grad():
        if not args.against:
            for name, fn in this:
                print(f"  {name}: {smoke.host_ms(torch, fn) * 1e3:.2f} us "
                      "of host time a call")
            return 0
        other = smoke.wrapper_calls(torch, dev=dev, **side(args.against))
        for (name, fn_a), (_, fn_b) in zip(this, other):
            got = {"this": [], "other": []}
            for r in range(args.rounds):
                order = (("this", fn_a), ("other", fn_b))
                for who, fn in (order if r % 2 == 0 else order[::-1]):
                    got[who].append(smoke.host_ms(torch, fn) * 1e3)
            med = {k: statistics.median(v) for k, v in got.items()}
            print(f"  {name}: this {med['this']:.2f} us "
                  f"[{min(got['this']):.2f}-{max(got['this']):.2f}], "
                  f"other {med['other']:.2f} us "
                  f"[{min(got['other']):.2f}-{max(got['other']):.2f}]; "
                  f"this / other {med['this'] / med['other']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
