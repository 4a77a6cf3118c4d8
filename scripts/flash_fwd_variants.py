#!/usr/bin/env python3
"""Time variants of the bf16 flash-attention forward against each other
and against SDPA on one card, in one process.

    python3 scripts/flash_fwd_variants.py [--dump DIR] '{"base": {},
        "noexp": {"fast_exp2(sc[": "(sc["},
        "stages3": {"constexpr kFwdStages": "3"},
        "parent": {"source": "scratch_checkout/src/repro_torch/kernels/csrc/flash_attention_fwd.cu"}}'

Each variant is `src/repro_torch/kernels/csrc/flash_attention_fwd.cu` (or
the file that its ``"source"`` key names, relative to the repository's
root, such as a parent tree's copy) with some text replaced: a key
``"constexpr NAME"`` sets that integer constant, any other key is
replaced verbatim (a diagnostic that drops work gives wrong results,
which the script reports and times all the same). Every variant is built
with nvcc for sm_90a into ``kernels/build/variants/`` (one process each,
all started together; the ptxas registers, spills and warnings (C7514
among them) and the SASS HGMMA count of each bf16 forward kernel are
printed), held against `ref.flash_attention_ref` at the timed shapes and
at small edge shapes, compared bit for bit with the first variant, then
timed on the device under `torch.profiler` at hubert-xlarge's encode
(1/2048/16/16/80, bidirectional) and training shape (B=2),
stablelm-1.6b's training shape (2/2048/32/32/64, causal), zamba2-1.2b's
(1/2048/32/32/64, causal), granite-moe-3b-a800m's (1/2048/24/8/64,
causal) and qwen3-1.7b's (1/2048/16/8/128, causal, the control),
variants alternating (a, b, ..., b, a) with SDPA's device time on the
same inputs between the two passes. A variant whose launch the card
refuses (too much shared memory for a ring that deep at hd 128) is
reported and left out at that shape. Prints the card's name and power
limit first. With ``--dump DIR`` (relative to the repository's root)
each variant's nvcc log and SASS are written there.
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

# (B, Sq, Sk, H, KV, hd, causal, who); the first six are timed
SHAPES = [(1, 2048, 2048, 16, 16, 80, False, "hubert encode"),
          (2, 2048, 2048, 16, 16, 80, False, "hubert train"),
          (2, 2048, 2048, 32, 32, 64, True, "stablelm train"),
          (1, 2048, 2048, 32, 32, 64, True, "zamba2 prefill"),
          (1, 2048, 2048, 24, 8, 64, True, "granite prefill"),
          (1, 2048, 2048, 16, 8, 128, True, "qwen3 prefill"),
          (2, 200, 200, 4, 2, 80, True, "ragged GQA"),
          (2, 192, 320, 4, 2, 64, False, "Sq 192, Sk 320"),
          (1, 64, 64, 4, 4, 80, False, "one half tile"),
          (2, 127, 127, 6, 2, 64, True, "a group of 3, ragged"),
          (2, 255, 255, 4, 4, 80, False, "two tiles less one"),
          (1, 129, 129, 4, 2, 32, True, "hd 32, a tile + 1")]
TIMED = 6
TOL = 2e-2  # chip_smoke.py's bf16 forward tolerance, elementwise


def build(variants: dict, csrc: pathlib.Path, out: pathlib.Path,
          nvcc_flags: list, dump: pathlib.Path = None) -> dict:
    from repro_torch.kernels import _build
    from chip_smoke import kernel_name
    procs = {}
    for name, edits in variants.items():
        edits = dict(edits)
        src = ROOT / edits.pop("source") if "source" in edits else \
            csrc / "flash_attention_fwd.cu"
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
        path = out / f"flash_fwd_{name}.cu"
        path.write_text(text)
        so = out / f"libflash_fwd_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [*nvcc_flags, "-shared", f"-I{csrc}", "-o", str(so), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    cuobjdump = pathlib.Path(nvcc_flags[0]).parent / "cuobjdump"
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log[-4000:]}", flush=True)
            continue
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = kernel_name(line.split("'")[1])
            elif "arning" in line or "Performance" in line:  # e.g. C7514
                print(f"{name}: {entry}: {line.strip()}")
            elif "bf16" in entry and ("registers" in line or "spill" in line):
                print(f"{name}: {entry}: "
                      f"{line.replace('ptxas info    : ', '').strip()}")
        if cuobjdump.exists():
            sass = subprocess.run([str(cuobjdump), "-sass", str(so)],
                                  capture_output=True, text=True, timeout=300)
            if dump is not None:
                (dump / f"{name}.log").write_text(log)
                (dump / f"{name}.sass").write_text(sass.stdout)
            func, hgmma = "", {}
            for line in sass.stdout.splitlines():
                if "Function :" in line:
                    func = kernel_name(line.split("Function :")[1].strip())
                elif "bf16" in func:
                    hgmma[func] = hgmma.get(func, 0) + ("HGMMA" in line)
            print(f"{name}: HGMMA " + ", ".join(
                f"{f} {n}" for f, n in sorted(hgmma.items())))
        libs[name] = _build.bind(
            ctypes.CDLL(str(so)), ["repro_flash_attention_fwd"])
        print(f"{name}: built", flush=True)
    return libs


def main() -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(cs.card_line(), flush=True)
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    args = sys.argv[1:]
    dump = None
    if args[0] == "--dump":  # the ptxas log and SASS of each variant
        dump = ROOT / args[1]
        dump.mkdir(parents=True, exist_ok=True)
        args = args[2:]
    libs = build(json.loads(args[0]), _build.CSRC, out,
                 [_build.nvcc_path(), *_build.COMPILE_FLAGS], dump)
    if not libs:
        sys.exit("no variant built")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)

    def inputs(B, Sq, Sk, H, KV, hd):
        """q, k, v as chip_smoke.py draws them."""
        def randn(shape, seed):
            gen.manual_seed(seed)
            return torch.randn(shape, generator=gen,
                               device=dev).to(torch.bfloat16)
        return (randn((B, Sq, H, hd), 1), randn((B, Sk, KV, hd), 2),
                randn((B, Sk, KV, hd), 3))

    def call(lib, q, k, v, causal):
        """(out, lse), or None when the card refuses the launch."""
        B, Sq, H, hd = q.shape
        Sk, KV = k.shape[1], k.shape[2]
        strides = fa._check_launch("variant", q, k, v)
        o = torch.empty_like(q)
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
        err = fa._launch(
            lib.repro_flash_attention_fwd, dev, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), lse.data_ptr(), 1, B, Sq, Sk, H, KV,
            hd, *strides, 1.0 / math.sqrt(hd), int(causal))
        return None if err else (o, lse)

    names = list(libs)
    refused = set()
    for B, Sq, Sk, H, KV, hd, causal, who in SHAPES:
        q, k, v = inputs(B, Sq, Sk, H, KV, hd)
        want = ref.flash_attention_ref(q, k, v, causal)
        first = None
        for name in names:
            got = call(libs[name], q, k, v, causal)
            torch.cuda.synchronize()
            if got is None:
                refused.add((name, hd))
                print(f"{name} {who} {(B, Sq, Sk, H, KV, hd, causal)}: "
                      "launch refused", flush=True)
                continue
            errs = [float((g.float() - w.float()).abs().max())
                    for g, w in zip(got, want)]
            ok = all(bool(((g.float() - w.float()).abs()
                           <= TOL + TOL * w.float().abs()).all())
                     for g, w in zip(got, want))
            same = "" if first is None else (
                f"; bit for bit {first[0]}'s" if all(
                    torch.equal(a, b) for a, b in zip(got, first[1]))
                else f"; differs from {first[0]}'s")
            first = (name, got) if first is None else first
            print(f"{name} {who} {(B, Sq, Sk, H, KV, hd, causal)}: max "
                  f"|err| out {errs[0]:.3e} lse {errs[1]:.3e} "
                  f"{'ok' if ok else 'OUT OF TOLERANCE'}{same}", flush=True)
        del q, k, v, want, first
    for B, Sq, Sk, H, KV, hd, causal, who in SHAPES[:TIMED]:
        q, k, v = inputs(B, Sq, Sk, H, KV, hd)
        pairs = Sq * (Sq + 1) // 2 if causal else Sq * Sk
        gflop = 4.0 * B * H * hd * pairs / 1e9
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        kw = {"enable_gqa": True} if H != KV else {}

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal, **kw)
        def kernel_dev_ms(name, n=20, tries=3):
            """Device ms a call, from a trace that saw every launch (a
            trace that dropped some of them is taken again)."""
            for _ in range(tries):
                count = {}
                _, ranked = cs.device_profile(
                    torch, lambda: call(libs[name], q, k, v, causal), n,
                    count=count)
                seen = sum(c for kname, c in count["by_name"].items()
                           if "flash_fwd_" in kname)
                if abs(seen - 1.0) < 1e-6:
                    return cs.kernel_ms(ranked, "flash_fwd_")
            sys.exit(f"{name}: the profiler saw {seen:.2f} launches a call")
        live = [n for n in names if (n, hd) not in refused]
        runs = {name: [] for name in live}
        for i, name in enumerate(live + live[::-1]):
            if i == len(live):
                sdpa_ms, _ = cs.device_profile(torch, sdpa, 20)
            runs[name].append(kernel_dev_ms(name))
        print(f"{who} {(B, Sq, Sk, H, KV, hd, causal)}: {gflop:.2f} GFLOP, "
              f"sdpa {sdpa_ms:.4f} ms on the device "
              f"({gflop / sdpa_ms:.0f} TFLOP/s)", flush=True)
        for name in live:
            ms = runs[name]
            print(f"  {name}: " + ", ".join(f"{t:.4f}" for t in ms)
                  + f" ms; mean {sum(ms) / len(ms):.4f} "
                  f"({gflop / (sum(ms) / len(ms)):.0f} TFLOP/s, "
                  f"{sum(ms) / len(ms) / sdpa_ms:.3f}x sdpa)", flush=True)
        del q, k, v, qt, kt, vt
    return 0


if __name__ == "__main__":
    sys.exit(main())
