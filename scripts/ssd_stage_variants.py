#!/usr/bin/env python3
"""Time variants of the bf16 SSD stage kernels against each other on one
card, in one process.

    python3 scripts/ssd_stage_variants.py '{"base": {},
        "ht4": {"constexpr kOutBlocks": "256"},
        "nostore": {"if (q.t0 + l < q.s) {": "if (false) {"}}'

Each variant is `src/repro_torch/kernels/csrc/ssd_scan.cu` with some text
replaced: a key ``"constexpr NAME"`` sets that integer constant, any other
key is replaced verbatim (a diagnostic that drops work gives wrong
results, which the script reports and times all the same). Every variant
is built with nvcc for sm_90a into ``kernels/build/variants/`` (one
process each, all started together), held against the plain version at
five shapes (the mamba2-1.3b prefill and train shapes, zamba2-1.2b's, a
grouped n=16 one and a ragged one), then timed by stage under
`torch.profiler` at the first three shapes on views of one conv output,
variants alternating (a, b, ..., b, a) so that both passes are compared
within the call. Prints the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

SHAPES = [(1, 2048, 64, 64, 1, 128, 256), (2, 2048, 64, 64, 1, 128, 256),
          (1, 2048, 64, 64, 1, 64, 256), (2, 640, 8, 32, 4, 16, 128),
          (1, 2000, 8, 64, 1, 128, 250)]


def build(variants: dict, csrc: pathlib.Path, out: pathlib.Path,
          nvcc_flags: list) -> dict:
    src = (csrc / "ssd_scan.cu").read_text()
    procs = {}
    for name, edits in variants.items():
        text = src
        for key, value in edits.items():
            if key.startswith("constexpr "):
                text, n = re.subn(rf"constexpr int {key[10:]} = \d+;",
                                  f"constexpr int {key[10:]} = {value};", text)
            else:
                n = text.count(key)
                text = text.replace(key, value)
            if n == 0:
                sys.exit(f"{name}: {key!r} is not in ssd_scan.cu")
        path = out / f"ssd_{name}.cu"
        path.write_text(text)
        so = out / f"libssd_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [*nvcc_flags, "-shared", f"-I{csrc}", "-o", str(so), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"{name}: nvcc failed\n{log[-4000:]}")
        spills = [ln for ln in log.splitlines() if "spill stores" in ln
                  and " 0 bytes spill stores" not in ln]
        print(f"{name}: built; spills: {spills or 'none'}", flush=True)
        lib = ctypes.CDLL(str(so))
        lib.repro_ssd_scan_fwd.argtypes = (
            [ptr] * 7 + [i64] + [i32] * 7 + [i64] * 12 + [ptr])
        lib.repro_ssd_scan_fwd.restype = i32
        lib.repro_ssd_scan_workspace_bytes.argtypes = [i32] * 6
        lib.repro_ssd_scan_workspace_bytes.restype = i64
        libs[name] = lib
    return libs


def main() -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import _build, ref

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(cs.card_line(), flush=True)
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    libs = build(json.loads(sys.argv[1]), _build.CSRC, out,
                 [_build.nvcc_path(), *_build.COMPILE_FLAGS])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)

    def inputs(b, s, h, p, g, n):
        """x, B, C as views of one conv output, as the Mamba2 block cuts
        them; dt, A as tests/test_kernels.py draws them."""
        gen.manual_seed(6)

        def normal(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        xbc = normal(b, s, h * p + 2 * g * n).to(torch.bfloat16)
        x = xbc[..., :h * p].reshape(b, s, h, p)
        B = xbc[..., h * p:h * p + g * n].reshape(b, s, g, n)
        C = xbc[..., h * p + g * n:].reshape(b, s, g, n)
        return x, F.softplus(normal(b, s, h)), -torch.exp(normal(h) * 0.5), \
            B, C

    def call(lib, x, dt, A, B, C):
        b, s, h, p = x.shape
        g, n = B.shape[2], B.shape[3]
        strides = [t.stride(i) if t.shape[i] > 1 else 0
                   for t in (x, dt, B, C) for i in range(3)]
        y = torch.empty((b, s, h, p), dtype=x.dtype, device=dev)
        nbytes = lib.repro_ssd_scan_workspace_bytes(1, b, s, h, p, n)
        work = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        err = lib.repro_ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), work.data_ptr(), nbytes, 1, b, s, h,
            p, g, n, *strides, torch.cuda.current_stream().cuda_stream)
        if err:
            sys.exit(f"launch failed: CUDA error {err}")
        return y

    for shape in SHAPES:
        ins = inputs(*shape[:6])
        want = ref.ssd_scan_ref(*ins, shape[6]).float()
        for name, lib in libs.items():
            err = call(lib, *ins).float() - want
            mx = float(err.abs().max() / want.abs().max())
            norm = float(err.norm() / want.norm())
            ok = mx <= 2e-2 and norm <= 1e-2
            print(f"{name} {shape}: max {mx:.3e} norm {norm:.3e} "
                  f"{'ok' if ok else 'OUT OF TOLERANCE'}", flush=True)
    names = list(libs)
    for shape in SHAPES[:3]:
        ins = inputs(*shape[:6])
        runs = {name: [] for name in names}
        for name in names + names[::-1]:
            _, ranked = cs.device_profile(
                torch, lambda: call(libs[name], *ins), 20)
            stages = [(re.search(r"\w+_kernel", nm).group(0), t)
                      for nm, t in ranked if "ssd_" in nm]
            runs[name].append(stages)
        for name in names:
            print(f"{shape[:6]} {name}: " + " | ".join(
                f"{sum(t for _, t in st):.4f} ms ["
                + ", ".join(f"{k} {t:.4f}" for k, t in st) + "]"
                for st in runs[name]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
