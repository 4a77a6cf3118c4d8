#!/usr/bin/env python3
"""Time variants of the RMSNorm kernels against each other on one card,
in one process, beside torch's `F.rms_norm`.

    python3 scripts/rmsnorm_variants.py '{"base": {},
        "cols32": {"constexpr kCols": "32"},
        "sm8": {"constexpr kMaxBlocksPerSM": "8"}}'

Each variant is `src/repro_torch/kernels/csrc/rmsnorm.cu` with some text
replaced: a key ``"constexpr NAME"`` sets that integer constant, any other
key is replaced verbatim. Every variant is built with nvcc for sm_90a into
``kernels/build/variants/`` (one process each, all started together; its
ptxas spill lines are printed), held against the plain forward and
backward (`kernels.ref`) at every shape below, then timed at each shape,
variants alternating (a, b, ..., b, a) so that both passes are compared
within the call: the device time of the forward and of the backward
(`torch.profiler`, the kernels' own events), with the 50 MB L2 warm
(the same call repeated) and cold (a 128 MB read before each call, as a
train step reaches a norm's inputs after other work; a read, so that the
lines it leaves in L2 are clean and cost no write-back), beside the same
for `F.rms_norm` (bf16 weight) and its backward. Prints the card's name
and power limit first.
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

# (what, rows, d): the four training shapes of the norms (qwen3-1.7b at
# B=2, S=2048; mamba2-1.3b's gated norm), qwen3's prefill residual norm
# and a decode step's four rows
SHAPES = (("qwen3 residual", 4096, 2048), ("qwen3 q-norm", 65536, 128),
          ("qwen3 k-norm", 32768, 128), ("mamba2 gated", 4096, 4096),
          ("qwen3 prefill", 2048, 2048), ("decode", 4, 2048))
NAMES = ("repro_rmsnorm_fwd", "repro_rmsnorm_bwd",
         "repro_rmsnorm_bwd_workspace_bytes")
EPS = 1e-6


def build(variants: dict, csrc: pathlib.Path, out: pathlib.Path,
          flags: list) -> dict:
    src = (csrc / "rmsnorm.cu").read_text()
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
                sys.exit(f"{name}: {key!r} is not in rmsnorm.cu")
        path = out / f"rmsnorm_{name}.cu"
        path.write_text(text)
        so = out / f"librmsnorm_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [*flags, "-shared", "-o", str(so), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"{name}: nvcc failed\n{log}")
        spills = [line.strip() for line in log.splitlines()
                  if "spill" in line and " 0 bytes spill stores" not in line]
        print(f"{name}: built; {len(spills)} kernel(s) spill"
              + "".join(f"\n    {line}" for line in spills), flush=True)
        libs[name] = so
    return libs


def main() -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("needs a CUDA card")
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import rmsnorm as rn

    variants = json.loads(sys.argv[1]) if len(sys.argv) > 1 else {"base": {}}
    print(cs.card_line(), flush=True)
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    flags = [_build.nvcc_path(), *_build.COMPILE_FLAGS]
    libs = {name: _build.bind(ctypes.CDLL(str(so)), NAMES)
            for name, so in build(variants, _build.CSRC, out, flags).items()}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device=dev)
    library = _build.library

    def ms(fn, cold: bool, fragment: str) -> float:
        return cs.device_ms(torch, fn, 20, fragment, flush if cold else None)

    try:
        for what, rows, d in SHAPES:
            x = torch.randn((rows, d), generator=gen, device=dev).to(
                torch.bfloat16)
            dy = torch.randn((rows, d), generator=gen, device=dev).to(
                torch.bfloat16)
            scale = torch.linspace(0.5, 1.5, d, device=dev)
            want_y = ref.rmsnorm_ref(x, scale, EPS)
            want_dx, want_ds = ref.rmsnorm_bwd_ref(x, scale, dy, EPS)
            nbytes_f = 4 * rows * d + 4 * d
            nbytes_b = 6 * rows * d + 8 * d
            print(f"{what} ({rows}, {d}) bf16: bounds forward "
                  f"{nbytes_f / cs.HBM_BYTES_PER_S * 1e3:.4f} ms, backward "
                  f"{nbytes_b / cs.HBM_BYTES_PER_S * 1e3:.4f} ms", flush=True)
            for name, lib in libs.items():
                _build.library = lambda lib=lib: lib
                y = rn.rmsnorm_fwd(x, scale, EPS)
                dx, ds = rn.rmsnorm_bwd(x, scale, dy, EPS)
                errs = (float((y.float() - want_y.float()).abs().max()),
                        float((dx.float() - want_dx.float()).abs().max())
                        / float(want_dx.float().abs().max()),
                        float((ds - want_ds).abs().max())
                        / float(want_ds.abs().max()))
                ok = errs[0] <= 2e-2 * (1 + float(want_y.float().abs().max())
                                        ) and errs[1] <= 2e-2 \
                    and errs[2] <= 1e-3
                print(f"  {name}: max err y {errs[0]:.3e}, dx {errs[1]:.3e} "
                      f"and dscale {errs[2]:.3e} of max "
                      f"{'ok' if ok else 'OUT OF TOLERANCE'}", flush=True)
            order = list(libs) + list(libs)[::-1]
            times = {name: [] for name in libs}
            for name in order:
                _build.library = lambda lib=libs[name]: lib
                times[name].append([
                    ms(lambda: rn.rmsnorm_fwd(x, scale, EPS), cold,
                       "rmsnorm_") for cold in (False, True)] + [
                    ms(lambda: rn.rmsnorm_bwd(x, scale, dy, EPS), cold,
                       "rmsnorm_") for cold in (False, True)])
            for name, runs in times.items():
                print(f"  {name}: forward warm / cold "
                      + " / ".join(f"{r[0]:.4f}, {r[1]:.4f}" for r in runs)
                      + " ms; backward warm / cold "
                      + " / ".join(f"{r[2]:.4f}, {r[3]:.4f}" for r in runs)
                      + " ms (two passes)", flush=True)
            _build.library = library
            w = scale.to(torch.bfloat16)
            xl, wl = x.detach().requires_grad_(), w.detach().requires_grad_()
            yl = F.rms_norm(xl, (d,), wl, EPS)

            def lib_fwd():
                F.rms_norm(x, (d,), w, EPS)

            def lib_bwd():
                torch.autograd.grad(yl, (xl, wl), dy, retain_graph=True)
            print(f"  F.rms_norm: forward warm / cold "
                  f"{ms(lib_fwd, False, ''):.4f}, {ms(lib_fwd, True, ''):.4f}"
                  f" ms; backward warm / cold {ms(lib_bwd, False, ''):.4f}, "
                  f"{ms(lib_bwd, True, ''):.4f} ms", flush=True)
            del x, dy, want_y, want_dx, want_ds, xl, wl, yl
    finally:
        _build.library = library
    return 0


if __name__ == "__main__":
    sys.exit(main())
