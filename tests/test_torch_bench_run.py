"""The port's bench driver (`repro_torch.bench.run`, `python -m
repro_torch bench`) and its examples (`repro_torch.examples`) on the CPU.

* The module list is the reference's `benchmarks/run.py` list less
  `mc_speed`, in its order; the exit codes are the reference's: 0 when
  every selected module runs, 1 when one raises, 2 for an unknown name
  (`mc_speed` among them). A selection that needs the card, with no card
  and no ``--device``, exits nonzero naming `NoCudaDevice`.
* ``bench --device cpu`` prints the reference CLI's CSV rows for host
  modules.
* `bottleneck_detect` and `heterogeneous_predict` print exactly what the
  reference scripts print; `quickstart` and `transient_train` run with
  ``--device cpu`` at a few steps (transient_train's own assert that the
  loss falls holds). They train on one torch thread: parallel test
  processes otherwise thrash.
"""
import contextlib
import io
import os
import pathlib
import runpy
import subprocess
import sys

import pytest
import torch

from repro_torch import __main__ as cli_main
from repro_torch.bench import run as bench_run

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()


def test_list_is_the_references_less_mc_speed():
    from benchmarks import run as ref
    rc, out = _stdout(bench_run.main, ["--list"])
    assert rc == 0
    assert out.split() == [m for m in ref.MODULES if m != "mc_speed"]
    assert bench_run.MODULES == out.split()
    assert len(bench_run.MODULES) == len(ref.MODULES) - 1 == 22
    rc, out = _stdout(cli_main.main, ["bench", "--list"])
    assert rc == 0 and out.split() == bench_run.MODULES


@pytest.mark.parametrize("only", ["definitely_not_a_module", "mc_speed",
                                  "table1_speed,mc_speed"])
def test_unknown_names_exit_2(only, capsys):
    assert bench_run.main(["--only", only]) == 2
    assert "unknown benchmark module(s)" in capsys.readouterr().err


def test_a_module_that_raises_exits_1(monkeypatch, capsys):
    from repro_torch.bench import table1_speed

    def boom():
        raise RuntimeError("table1 broke")
    monkeypatch.setattr(table1_speed, "run", boom)
    assert bench_run.main(["--only", "table1_speed,fig11_recomputation"]) == 1
    out = capsys.readouterr()
    assert "# table1_speed FAILED" in out.out
    assert "# fig11_recomputation done" in out.out
    assert "table1 broke" in out.err


def test_a_device_module_without_a_card_names_no_cuda_device():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-m", "repro_torch", "bench",
                          "--only", "fig2_stability"], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=120)
    assert out.returncode != 0
    assert "NoCudaDevice" in out.stderr
    assert "fig2" not in out.stdout


def test_cli_rows_equal_the_reference_clis():
    pytest.importorskip("jax")
    from repro import __main__ as ref_main
    only = "table1_speed,fig6_startup,fig11_recomputation"
    rc, want = _stdout(ref_main.main, ["bench", "--only", only])
    assert rc == 0
    rc, got = _stdout(cli_main.main, ["bench", "--device", "cpu",
                                      "--only", only])
    assert rc == 0

    def rows(text):
        return [ln for ln in text.splitlines() if not ln.startswith("#")]
    assert rows(got) == rows(want) and len(rows(got)) > 20


@pytest.mark.parametrize("name", ["bottleneck_detect",
                                  "heterogeneous_predict"])
def test_host_examples_print_the_references_output(name):
    pytest.importorskip("jax")
    import importlib
    _, want = _stdout(runpy.run_path, str(ROOT / "examples" / f"{name}.py"),
                      None, "__main__")
    port = importlib.import_module(f"repro_torch.examples.{name}")
    _, got = _stdout(port.main)
    assert got == want and got.count("\n") > 3


@pytest.fixture
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_quickstart_runs_on_the_cpu(one_thread):
    from repro_torch.examples import quickstart
    _, out = _stdout(quickstart.main, ["--device", "cpu", "--steps", "6"])
    assert "restore: latest checkpoint at step 5" in out
    assert "Eq(4) predicted wall-clock for 60 steps" in out


def test_transient_train_runs_on_the_cpu(one_thread):
    from repro_torch.examples import transient_train
    _, out = _stdout(transient_train.main,
                     ["--device", "cpu", "--steps", "20", "--global-batch",
                      "4", "--seq", "32"])
    assert "model lm-14m" in out and "— OK" in out
