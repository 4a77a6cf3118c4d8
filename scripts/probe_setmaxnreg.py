"""Does ptxas honour `setmaxnreg` in the port's warp-specialized kernels?

    python3 scripts/probe_setmaxnreg.py        # on a machine with nvcc

Builds for sm_90a, with `ptxas -v`:

1. a probe kernel of 384 threads whose producer warpgroup drops to 24
   registers and whose two consumer warpgroups rise to 240 and hold 200
   live floats a thread, with and without the `setmaxnreg` calls;
2. the flash-attention sources of `src/repro_torch/kernels/csrc` as they
   are, and with the calls taken out.

For each bf16 kernel it prints the spill bytes ptxas reports and the
highest register the SASS uses (`cuobjdump -sass`). A 384-thread launch
gives every thread 168 registers, so a register past R167 with no spill
shows the call honoured. Prints only; exits 1 if a build fails.
"""
from __future__ import annotations

import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xptxas", "-v", "-cubin"]

PROBE = r"""
#ifndef NOSET
#define SETMAXNREG(op, n) \
  asm volatile("setmaxnreg." op ".sync.aligned.u32 " #n ";\n")
#else
#define SETMAXNREG(op, n)
#endif
constexpr int kLive = 200;
__global__ void __launch_bounds__(384, 1)
probe_kernel(const float* __restrict__ in, float* __restrict__ out, int n) {
  if (threadIdx.x / 128 == 2) {
    SETMAXNREG("dec", 24);
    return;
  }
  SETMAXNREG("inc", 240);
  float acc[kLive];
#pragma unroll
  for (int i = 0; i < kLive; ++i) acc[i] = in[threadIdx.x + i * 384];
  for (int it = 0; it < n; ++it) {
    const float x = in[it];
#pragma unroll
    for (int i = 0; i < kLive; ++i)
      acc[i] = fmaf(acc[i], x, acc[(i + 1) % kLive]);
  }
#pragma unroll
  for (int i = 0; i < kLive; ++i) out[threadIdx.x + i * 384] = acc[i];
}
"""


def tool(name: str) -> str:
    found = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not pathlib.Path(found).exists():
        sys.exit(f"{name} not found: run this on a machine with the CUDA "
                 "toolkit")
    return found


def kernel_name(mangled: str) -> str:
    m = re.search(r"\d+((?:probe|flash_\w+?)_kernel)(?:I(?:Li)?(\w+?)E)?",
                  mangled)
    if not m:
        return mangled[:60]
    return f"{m.group(1)}<{m.group(2)}>" if m.group(2) else m.group(1)


def report(label: str, src: pathlib.Path, extra) -> bool:
    cubin = src.with_suffix(".cubin")
    build = subprocess.run([tool("nvcc"), *FLAGS, *extra, str(src), "-o",
                            str(cubin)], capture_output=True, text=True)
    if build.returncode != 0:
        print(f"{label}: build failed\n{build.stderr[-2000:]}")
        return False
    spills, entry = {}, ""
    for line in build.stderr.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        elif "spill stores" in line:
            spills[entry] = line.split(",")[1].strip()
    sass = subprocess.run([tool("cuobjdump"), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    top, func = {}, ""
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            func = m.group(1)
            top[func] = [0, 0]
        elif func:
            regs = [int(r) for r in re.findall(r"\bR(\d+)\b", line)]
            top[func][0] = max([top[func][0], *regs])
            top[func][1] += "USETMAXREG" in line
    for func, (reg, n_set) in sorted(top.items()):
        if "fp32" in func or "delta" in func:
            continue
        print(f"{label:<34} {kernel_name(func):<30} up to R{reg:<4} "
              f"{n_set} USETMAXREG  {spills.get(func, '?')}")
    return True


def main() -> int:
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        probe = tmp / "probe.cu"
        probe.write_text(PROBE)
        ok &= report("probe, setmaxnreg 24 / 240", probe, [])
        ok &= report("probe, no setmaxnreg", probe, ["-DNOSET"])
        for mode in ("as built", "no setmaxnreg"):
            d = tmp / mode.replace(" ", "_")
            shutil.copytree(CSRC, d)
            if mode == "no setmaxnreg":
                h = d / "hopper.cuh"
                h.write_text(re.sub(r'asm volatile\("setmaxnreg[^\n]*',
                                    "", h.read_text()))
            for name in ("flash_attention_fwd.cu", "flash_attention_bwd.cu"):
                ok &= report(f"{name[:-3]}, {mode}", d / name, [])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
