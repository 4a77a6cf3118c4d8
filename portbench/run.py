"""Run one cell of the port's benchmark once, from the root of a checkout:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell, its configuration, traffic, limits and metrics are found by name
from `BENCHMARK.json`. The last line of standard output is the result (JSON):
the end-to-end metrics with ``--trace 0``, the per-layer ones with
``--trace 1``; the numbers that decided ``correct`` end it, and end standard
error, each beside its limit. Without a CUDA device, or with fewer than the
cell asks for, it exits 2 and prints no result; if JAX or the JAX package
was loaded, it exits 3 and prints no result.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: top-level modules that may not be loaded in a run
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # build and kernel caches at fixed paths inside the checkout (the
    # port's nvcc build goes to src/repro_torch/kernels/build/)
    cache = ROOT / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import harness

    cell = harness.find_cell(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = cell.kind().run(cell, seed=args.seed, seconds=args.seconds,
                             trace=bool(args.trace), device="cuda",
                             started=STARTED)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; the port runs without "
              "JAX and without the JAX package", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
