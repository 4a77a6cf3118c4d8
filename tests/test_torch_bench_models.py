"""The port's host-only bench modules (`repro_torch.bench`) held against
the reference's `benchmarks/` on the CPU.

* Tables I-V, Figs 3, 4, 6, 11 and 12, Eq (4), the cost, scheduler and
  cross-provider studies: every row equal, name, value and ``derived``
  string, exactly. Table IV fits Fig 5's save times, which a wall clock
  measures: both packages' Fig 5 modules are given a clock that advances
  one second a reading, and both checkpointers a creation time of 0, so
  the rows depend only on the checkpoint sizes. Those are equal but for
  the index's CRC digits (the weights differ), a few bytes below the
  rows' rounding.
* The CNN zoo's parameter-tree leaf count (`bench._common.cnn_leaves`, on
  the meta device) equals the reference's `jax.eval_shape` count for all
  20 specs.
* `roofline.fmt_row` and `markdown_table` give the reference's output on
  one SMOKE dry-run record and on a skipped and a failed one; only the
  advice text differs, by design (it names the card's levers).

JAX is imported inside the fixture that needs it.
"""
import importlib
import itertools
import time
import types

import pytest

from repro_torch.bench import roofline
from repro_torch.bench._common import cnn_leaves
from repro_torch.models import cnn

HOST = ["table1_speed", "table2_speed_models", "table3_worker_speed",
        "table4_ckpt_models", "table5_revocations", "fig3_correlation",
        "fig4_cluster_scaling", "fig6_startup", "fig11_recomputation",
        "fig12_bottleneck", "eq4_endtoend", "cost_savings",
        "scheduler_gains", "cross_provider"]


@pytest.fixture(scope="module")
def J():
    """The JAX package's CNN zoo, on the CPU."""
    pytest.importorskip("jax")
    import jax
    from repro.models import cnn as jcnn
    return types.SimpleNamespace(jax=jax, cnn=jcnn)


def _clock(**kw):
    """A stand-in for the `time` module: ``kw`` over the real one's
    monotonic()."""
    return types.SimpleNamespace(**{"monotonic": time.monotonic, **kw})


@pytest.mark.parametrize("name", HOST)
def test_host_module_rows_equal_the_references(J, name, monkeypatch):
    ref = importlib.import_module(f"benchmarks.{name}")
    port = importlib.import_module(f"repro_torch.bench.{name}")
    if name == "table4_ckpt_models":
        for pkg in ("benchmarks", "repro_torch.bench"):
            monkeypatch.setattr(
                importlib.import_module(f"{pkg}.fig5_checkpoint"), "time",
                _clock(monotonic=itertools.count().__next__))
        for pkg in ("repro", "repro_torch"):
            monkeypatch.setattr(
                importlib.import_module(f"{pkg}.checkpoint.checkpointer"),
                "time", _clock(time=lambda: 0.0))
    want = ref.run()
    assert want
    assert port.run() == want


@pytest.mark.parametrize("name", list(cnn.ZOO))
def test_cnn_leaf_count_equals_the_references(J, name):
    want = len(J.jax.tree.leaves(J.jax.eval_shape(
        lambda: J.cnn.init_params(J.jax.random.PRNGKey(0),
                                  J.cnn.ZOO[name]))))
    assert cnn_leaves(cnn.ZOO[name]) == want
    if name == "resnet_32":
        assert want == 97


def test_roofline_rows_and_table_equal_the_references(monkeypatch):
    from benchmarks import roofline as ref
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch, smoke=False: get_config(arch,
                                                             smoke=True))
    done = dryrun.run_cell("qwen3-1.7b", "train_4k", False)
    assert done["ok"] and done["mesh"] == "16x16"
    records = [done,
               {"arch": "qwen3-1.7b", "shape": "long_500k", "skipped": True,
                "reason": "full attention at 500k tokens"},
               {"arch": "qwen3-1.7b", "shape": "decode_32k",
                "mesh": "2x16x16", "ok": False}]
    for r in records:
        got, want = roofline.fmt_row(r), ref.fmt_row(r)
        assert set(got) == set(want)
        assert {k: v for k, v in got.items() if k != "advice"} == \
            {k: v for k, v in want.items() if k != "advice"}
        if "advice" in got:
            assert got["advice"] == roofline._ADVICE[got["bottleneck"]]
    rows = [roofline.fmt_row(r) for r in records]
    assert roofline.markdown_table(rows) == ref.markdown_table(rows)
    assert "| qwen3-1.7b | train_4k | 16x16 |" in roofline.markdown_table(rows)
