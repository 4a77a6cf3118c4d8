"""The port stands alone: importing every `repro_torch` module pulls in
neither `jax` nor anything of the JAX package, and its entry points refuse
to run on the CPU unless asked to."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_the_port_loads_no_jax_and_no_repro():
    mods = list(_modules())
    assert "repro_torch.kernels.ops" in mods and len(mods) > 20
    assert {"repro_torch.calibration.traces",
            "repro_torch.chaos.trace_injector", "repro_torch.serving.queue",
            "repro_torch.serving.requests", "repro_torch.serving.replica",
            "repro_torch.serving.degradation",
            "repro_torch.serving.simulator",
            "repro_torch.serving.planner"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", [*sorted(PKG.rglob("*.py")),
                                  ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_names_jax_or_repro(path):
    """Static check, covering chip_smoke.py, which a test cannot run."""
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                (path, n)


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    from repro_torch.api import Session
    from repro_torch.device import NoCudaDevice
    from repro_torch.models import api
    from repro_torch.serving.engine import GatewayEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDevice, match="device='cpu'"):
        Session.from_arch("qwen3-1.7b")
    cfg = Session.from_arch("qwen3-1.7b", device="cpu").cfg
    with pytest.raises(NoCudaDevice):
        api.init(cfg)
    with pytest.raises(NoCudaDevice):
        GatewayEngine(cfg)


def test_unported_archs_raise_clearly():
    """Every arch id the reference serves resolves in the port, full and
    SMOKE, in the reference's order; an unknown id raises `KeyError`."""
    from repro.configs.registry import ARCH_IDS as REF_IDS
    from repro_torch.configs import ARCH_IDS, get_config
    assert ARCH_IDS == REF_IDS
    for arch in REF_IDS:
        assert get_config(arch).name == arch
        assert get_config(arch, smoke=True).name == arch
    with pytest.raises(KeyError):
        get_config("no-such-arch")
