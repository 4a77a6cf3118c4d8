#!/usr/bin/env python3
"""Time variants of the bf16 flash-attention backward against each other
on one card, in one process.

    python3 scripts/flash_bwd_variants.py '{"base": {},
        "noexp": {"float p = fast_exp2(sc[4 * j + e] * scale_log2 - lse2[col]);":
                  "float p = sc[4 * j + e];"},
        "parent": {"source": "scratch_checkout/src/repro_torch/kernels/csrc/flash_attention_bwd.cu"}}'

Each variant is `src/repro_torch/kernels/csrc/flash_attention_bwd.cu` (or
the file that its ``"source"`` key names, relative to the repository's
root, such as a parent tree's copy) with some text replaced: a key
``"constexpr NAME"`` sets that integer constant, any other key is
replaced verbatim (a diagnostic that drops work gives wrong results,
which the script reports and times all the same). Every variant is built
with nvcc for sm_90a into ``kernels/build/variants/`` (one process each,
all started together; the ptxas registers and spills and the SASS HGMMA
count of each dk/dv kernel are printed), held against
`ref.flash_attention_bwd_ref` at the timed shapes and three small edge
shapes, compared bit for bit with the first variant, then timed by stage
(delta, dq, dk/dv) under `torch.profiler` at hubert-xlarge's training
shape (2/2048/16/16/80, bidirectional), stablelm-1.6b's (2/2048/32/32/64,
causal) and qwen3-1.7b's (2/2048/16/8/128, causal), variants alternating
(a, b, ..., b, a) so that both passes are compared within the call.
Prints the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import json
import math
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# (B, Sq, Sk, H, KV, hd, causal); the first three are timed
SHAPES = [(2, 2048, 2048, 16, 16, 80, False),
          (2, 2048, 2048, 32, 32, 64, True),
          (2, 2048, 2048, 16, 8, 128, True), (2, 200, 200, 4, 2, 80, True),
          (2, 192, 320, 4, 2, 64, False), (1, 64, 64, 4, 4, 80, False)]
TIMED = 3
TOL, NORM_TOL = 2e-2, 1e-2  # chip_smoke.py's bf16 backward tolerances


def build(variants: dict, csrc: pathlib.Path, out: pathlib.Path,
          nvcc_flags: list) -> dict:
    from repro_torch.kernels import _build
    from chip_smoke import kernel_name
    procs = {}
    for name, edits in variants.items():
        edits = dict(edits)
        src = ROOT / edits.pop("source") if "source" in edits else \
            csrc / "flash_attention_bwd.cu"
        text = src.read_text()
        for key, value in edits.items():
            if key.startswith("constexpr "):
                text, n = re.subn(rf"constexpr int {key[10:]} = \d+;",
                                  f"constexpr int {key[10:]} = {value};", text)
            else:
                n = text.count(key)
                text = text.replace(key, value)
            if n == 0:
                sys.exit(f"{name}: {key!r} is not in {src.name}")
        path = out / f"flash_bwd_{name}.cu"
        path.write_text(text)
        so = out / f"libflash_bwd_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [*nvcc_flags, "-shared", f"-I{csrc}", "-o", str(so), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    cuobjdump = pathlib.Path(nvcc_flags[0]).parent / "cuobjdump"
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"{name}: nvcc failed\n{log[-4000:]}")
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = kernel_name(line.split("'")[1])
            elif "ptxas" in line and "arning" in line:  # e.g. C7514
                print(f"{name}: {line.strip()}")
            elif "dkv_" in entry and "bf16" in entry and (
                    "registers" in line or "spill" in line):
                print(f"{name}: {entry}: "
                      f"{line.replace('ptxas info    : ', '').strip()}")
        if cuobjdump.exists():
            sass = subprocess.run([str(cuobjdump), "-sass", str(so)],
                                  capture_output=True, text=True, timeout=300)
            func, hgmma = "", {}
            for line in sass.stdout.splitlines():
                if "Function :" in line:
                    func = kernel_name(line.split("Function :")[1].strip())
                elif "dkv_" in func and "bf16" in func:
                    hgmma[func] = hgmma.get(func, 0) + ("HGMMA" in line)
            print(f"{name}: HGMMA " + ", ".join(
                f"{f} {n}" for f, n in sorted(hgmma.items())))
        libs[name] = _build.bind(
            ctypes.CDLL(str(so)), ["repro_flash_attention_bwd"])
        print(f"{name}: built", flush=True)
    return libs


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(cs.card_line(), flush=True)
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    libs = build(json.loads(sys.argv[1]), _build.CSRC, out,
                 [_build.nvcc_path(), *_build.COMPILE_FLAGS])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)

    def inputs(B, Sq, Sk, H, KV, hd, causal):
        """q, k, v, dO as chip_smoke.py draws them, and the port's
        forward's out and lse."""
        def randn(shape, seed):
            gen.manual_seed(seed)
            return torch.randn(shape, generator=gen,
                               device=dev).to(torch.bfloat16)
        q, k, v = (randn((B, Sq, H, hd), 1), randn((B, Sk, KV, hd), 2),
                   randn((B, Sk, KV, hd), 3))
        do = randn((B, Sq, H, hd), 5)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        return q, k, v, o, lse, do

    def call(lib, q, k, v, o, lse, do, causal):
        B, Sq, H, hd = q.shape
        Sk, KV = k.shape[1], k.shape[2]
        strides = fa._check_launch("variant", q, k, v, do, o)
        delta = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
        dq = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=dev)
        dk = torch.empty((B, Sk, KV, hd), dtype=k.dtype, device=dev)
        dv = torch.empty_like(dk)
        err = fa._launch(
            lib.repro_flash_attention_bwd, dev, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), o.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), 1,
            B, Sq, Sk, H, KV, hd, *strides, 1.0 / math.sqrt(hd), int(causal))
        if err:
            sys.exit(f"launch failed: CUDA error {err}")
        return dq, dk, dv

    names = list(libs)
    for shape in SHAPES:
        ins = inputs(*shape)
        want = ref.flash_attention_bwd_ref(*ins, shape[6])
        first = None
        for name in names:
            got = call(libs[name], *ins, shape[6])
            errs = []
            for g, w in zip(got, want):
                d = g.float() - w.float()
                errs.append((float(d.abs().max() / w.float().abs().max()),
                             float(d.norm() / w.float().norm())))
            ok = all(m <= TOL and n <= NORM_TOL for m, n in errs)
            same = "" if first is None else (
                f"; bit for bit {names[0]}'s" if all(
                    torch.equal(a, b) for a, b in zip(got, first))
                else f"; differs from {names[0]}'s")
            first = got if first is None else first
            print(f"{name} {shape}: max " + " ".join(
                f"{m:.3e}" for m, _ in errs) + " norm " + " ".join(
                f"{n:.3e}" for _, n in errs)
                + f" (dq dk dv) {'ok' if ok else 'OUT OF TOLERANCE'}{same}",
                flush=True)
        del ins, want, first
    for shape in SHAPES[:TIMED]:
        B, Sq, Sk, H, KV, hd, causal = shape
        ins = inputs(*shape)
        pairs = Sq * (Sq + 1) // 2 if causal else Sq * Sk
        gflop_dq, gflop_dkv = (c * hd * pairs * H * B / 1e9 for c in (6, 8))
        runs = {name: [] for name in names}
        for name in names + names[::-1]:
            _, ranked = cs.device_profile(
                torch, lambda: call(libs[name], *ins, causal), 20)
            runs[name].append([cs.kernel_ms(ranked, f"flash_bwd_{s}_")
                               for s in ("delta", "dq", "dkv")])
        for name in names:
            print(f"{shape} {name}: " + " | ".join(
                f"{sum(st):.4f} ms [delta {st[0]:.4f}, dq {st[1]:.4f} "
                f"({gflop_dq / st[1]:.0f} TFLOP/s), dk/dv {st[2]:.4f} "
                f"({gflop_dkv / st[2]:.0f} TFLOP/s)]"
                for st in runs[name]), flush=True)
        del ins
    return 0


if __name__ == "__main__":
    sys.exit(main())
