"""`repro_torch.bench.fig5_checkpoint`, `fig2_stability` and
`fig10_replacement` held against the reference's `benchmarks/` on the
CPU (``device="cpu"``).

* Fig 5: the data size S_d of all 20 zoo trees equals the reference's,
  exactly. The save times are wall clocks; the index and metadata files
  (S_i, S_m) carry each leaf's CRC and a creation time, so they differ by
  the digits of those (at most 16 bytes) where the weights and the clock
  do.
* Fig 2: five SGD steps (lr 0.05) of ``bench_tiny`` through
  `fig2_stability.sgd_step`, from the reference's weights (crossed with
  `repro_torch.bridge`) on the same `CIFARLikeSource` batches, give the
  reference's losses to 1e-5 relative in fp32 (sums in another order);
  the reference's step is its module's jitted ``train_step``, written out
  here. The row is named for the device it ran on, as the reference's is
  for the CPU.
* Fig 10: the same row names, the model rows equal, and the measured row
  carries ``cold>warm``.

JAX is imported inside the fixture that needs it.
"""
import math
import types

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.bench import fig2_stability, fig5_checkpoint
from repro_torch.bench import fig10_replacement
from repro_torch.data.pipeline import CIFARLikeSource

FIG2_STEPS = 5
FIG2_RTOL = 1e-5


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from benchmarks import fig5_checkpoint as jfig5
    from benchmarks import fig10_replacement as jfig10
    from repro.models import cnn as jcnn
    return types.SimpleNamespace(jax=jax, jnp=jnp, cnn=jcnn, fig5=jfig5,
                                 fig10=jfig10)


def test_fig5_checkpoint_sizes_equal_the_references(J):
    want = J.fig5.measure(repeats=1, remote=False)
    got = fig5_checkpoint.measure(repeats=1, remote=False, device="cpu")
    assert [r.model for r in got] == [r.model for r in want]
    assert len(got) == 20
    for g, w in zip(got, want):
        assert g.s_d == w.s_d, g.model
        assert abs(g.s_i - w.s_i) <= 16 and abs(g.s_m - w.s_m) <= 16
        assert g.t_c > 0


def test_fig2_sgd_steps_equal_the_references(J):
    spec = fig2_stability.SPEC
    js = J.cnn.CNNSpec(spec.name, spec.kind, spec.blocks_per_stage,
                       spec.base_width)
    jparams = J.cnn.init_params(J.jax.random.PRNGKey(0), js)
    params = bridge.from_numpy(J.jax.tree.map(np.asarray, jparams), "cpu")
    for leaf in bridge_leaves(params):
        leaf.requires_grad_()

    @J.jax.jit
    def train_step(p, images, labels):
        loss, g = J.jax.value_and_grad(
            lambda pp: J.cnn.loss_fn(pp, js, images, labels))(p)
        return J.jax.tree.map(lambda a, b: a - 0.05 * b, p, g), loss

    src = CIFARLikeSource()
    for s in range(FIG2_STEPS):
        b = src.batch(s, 0, 1, 16)
        jparams, want = train_step(jparams, J.jnp.asarray(b["images"]),
                                   J.jnp.asarray(b["labels"]))
        got = fig2_stability.sgd_step(params, spec,
                                      torch.from_numpy(b["images"]),
                                      torch.from_numpy(b["labels"]))
        assert abs(float(got) - float(want)) <= FIG2_RTOL * abs(float(want)), s


def bridge_leaves(tree):
    from repro_torch.tree import flatten
    return [t for _, t in flatten(tree)]


def test_fig2_row_is_named_for_its_device():
    (row,) = fig2_stability.run(steps=8, batch=4, device="cpu")
    assert row["name"] == "fig2/real_cpu_speed_steps_per_s"
    assert math.isfinite(row["value"]) and "cov=" in row["derived"]


def test_fig10_rows_equal_the_references_in_form(J):
    want = J.fig10.run()
    got = fig10_replacement.run(device="cpu")
    assert [r["name"] for r in got] == [r["name"] for r in want]
    assert got[:-1] == want[:-1]
    assert "cold>warm=" in got[-1]["derived"]
    assert got[-1]["value"] > 0
