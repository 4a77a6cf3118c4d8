"""Build and load the port's CUDA kernels: ``nvcc`` -> one shared library
with a plain C interface -> ``ctypes``.

The library is built at first use from the sources in ``csrc/``, one
``nvcc`` process per source, all started together, then linked. It lands
in ``kernels/build/`` (listed in ``.gitignore``) under a name that carries
the hash of the sources and flags, so an edited source is rebuilt and a
stale library is never loaded. Nothing here runs at import time: the CPU
tests import every module on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from typing import List, Optional

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
SOURCES = ("flash_attention_fwd.cu", "flash_attention_bwd.cu", "rmsnorm.cu",
           "ssd_scan.cu", "ssd_scan_bwd.cu", "event_select.cu")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v"]

_lib: Optional[ctypes.CDLL] = None
#: seconds the last `library()` call spent building (0.0 when it loaded a
#: library already on disk) and the compilers' output of that build
last_build_seconds = 0.0
last_build_log = ""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built on a machine with the CUDA toolkit")


def source_digest() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu*")):  # the sources and their headers
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(COMPILE_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_DIR / f"librepro_torch_kernels_{source_digest()}.so"


def build() -> pathlib.Path:
    """Compile every source in parallel and link the library; returns its
    path. A library already built from the same sources is reused."""
    global last_build_seconds, last_build_log
    target = library_path()
    if target.exists():
        last_build_seconds, last_build_log = 0.0, ""
        return target
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs: List[str] = []
        procs = []
        for name in SOURCES:
            obj = os.path.join(tmp, name.replace(".cu", ".o"))
            objs.append(obj)
            procs.append((name, subprocess.Popen(
                [nvcc, *COMPILE_FLAGS, "-c", str(CSRC / name), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for name, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {name}\n{out}")
            if p.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        so_tmp = os.path.join(tmp, target.name)
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", so_tmp,
                               *objs], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}"
                               f"{link.stderr}")
        os.replace(so_tmp, target)  # atomic: a concurrent builder loses
    last_build_seconds = time.monotonic() - t0
    last_build_log = "\n".join(logs)
    return target


_P, _I32, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_float)
#: each C entry point's argument types and result type
SIGNATURES = {
    "repro_flash_attention_fwd": (
        [_P] * 5 + [_I32] * 7 + [_I64] * 9 + [_F32, _I32, _P], _I32),
    "repro_flash_attention_bwd": (
        [_P] * 10 + [_I32] * 7 + [_I64] * 15 + [_F32, _I32, _P], _I32),
    "repro_rmsnorm_fwd": ([_P] * 3 + [_I64, _I32, _F32, _I32, _P], _I32),
    "repro_rmsnorm_bwd": ([_P] * 6 + [_I64, _I32, _F32, _I32, _P], _I32),
    "repro_rmsnorm_bwd_workspace_bytes": ([_I64, _I32, _I32], _I64),
    "repro_ssd_scan_fwd": (
        [_P] * 7 + [_I64] + [_I32] * 7 + [_I64] * 12 + [_P], _I32),
    "repro_ssd_scan_workspace_bytes": ([_I32] * 6, _I64),
    "repro_ssd_scan_bwd": (
        [_P] * 12 + [_I64] + [_I32] * 6 + [_I64] * 12 + [_P], _I32),
    "repro_ssd_scan_bwd_workspace_bytes": ([_I32] * 6, _I64),
    "repro_event_select_fwd": ([_P] * 3 + [_I64, _I32, _I32, _P], _I32),
}


def bind(lib: ctypes.CDLL, names=tuple(SIGNATURES)) -> ctypes.CDLL:
    """Declare the argument and result types of the entry points `names`
    on a loaded library: this one, or a variant built from an edited
    source, which holds only that source's entry points."""
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = SIGNATURES[name]
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(str(build())))
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
