"""The references against the port's plain CPU path, on the same weights and
batch handed to both (which proves the weight map): the loss, every leaf's
gradient and one AdamW step, in fp32 at the SMOKE sizes. And the control, the
reference computed in fp8, fails the comparison the cells' limits make."""
from __future__ import annotations

import pytest
import torch

from portbench.tests.smoke import smoke_root  # noqa: F401
from portbench import check, harness, weights
from portbench.reference import train as plain

CELLS = ["stablelm-smoke.train", "mamba2-smoke.train",
         "hubert-smoke.train"]


def _port(cell):
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.launch import steps as st
    from repro_torch.models import api

    prog = cell.config["program"]
    cfg = get_config(prog["arch"], smoke=True).with_(dtype="float32")
    opt = cell.traffic["optimizer"]
    run = RunConfig(lr=opt["lr"], weight_decay=opt["weight_decay"],
                    warmup_steps=opt["warmup_steps"],
                    total_steps=opt["total_steps"],
                    grad_clip=opt["grad_clip"])
    return cfg, run, st, api


def _batch(cell, dims, seed):
    """Two rows of the feed that the cell's reference names, every key."""
    from portbench.kinds.train import feed_for
    b = feed_for(cell, dims, seed).batch(0, 0, 1, 2)
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("workload", CELLS)
def test_loss_and_gradients_equal_the_ports(smoke_root, workload):
    from repro_torch.tree import flatten
    cell = harness.find_cell(workload, smoke_root)
    ref = cell.reference()
    dims = ref.dims(cell.config)
    specs = ref.param_specs(dims)
    cfg, _, _, api = _port(cell)
    batch = _batch(cell, dims, 7)

    params = weights.nest(weights.make_all(specs, 7, "cpu"))
    live = {n: p.requires_grad_(True) for n, p in flatten(params)}
    loss = api.loss_fn(params, cfg, batch)
    loss.backward()

    w = weights.make_all(specs, 7, "cpu")
    leaves = plain._leaves(w)
    ref_loss = ref.loss_sum(leaves, dims, cast=plain.identity,
                            **batch) / batch["labels"].numel()
    ref_loss.backward()
    assert float(loss.detach()) == pytest.approx(float(ref_loss.detach()),
                                                 rel=1e-5)
    for name, leaf in leaves.items():
        g = plain._take_grad(leaf)
        scale = float(g.abs().max()) + 1e-12
        err = float((live[name].grad - g).abs().max()) / scale
        assert err < 1e-4, (name, err)


@pytest.mark.parametrize("workload", CELLS)
def test_adamw_step_equals_the_ports(smoke_root, workload):
    from repro_torch.tree import flatten
    cell = harness.find_cell(workload, smoke_root)
    ref = cell.reference()
    dims = ref.dims(cell.config)
    specs = ref.param_specs(dims)
    cfg, run, st, _ = _port(cell)
    batch = _batch(cell, dims, 3)

    step, opt = st.make_train_step(cfg, run)
    params = weights.nest(weights.make_all(specs, 3, "cpu"))
    state = st.TrainState(params, opt.init(params),
                          torch.zeros((), dtype=torch.int32))
    state, metrics = step(state, batch)

    theirs = plain.follow(
        ref, dims, weights.make_all(specs, 3, "cpu"),
        [batch], cell.traffic["optimizer"],
        initial=lambda n: weights.make_leaf(specs, n, 3, "cpu"), rows=2)
    assert float(metrics["loss"]) == pytest.approx(theirs["losses"][0],
                                                   rel=1e-5)
    for name, p in flatten(state.params):
        change = float(torch.linalg.vector_norm(
            p - weights.make_leaf(specs, name, 3, "cpu")))
        assert change == pytest.approx(theirs["change_norms"][name],
                                       rel=1e-3, abs=1e-9), name


@pytest.mark.parametrize("workload", CELLS)
def test_fp8_control_fails_the_cells_limits(smoke_root, workload):
    """The reference in fp8 (e4m3 operands, e5m2 gradients) against the
    reference: at least one number over its limit on every seed."""
    from portbench.kinds import train
    cell = harness.find_cell(workload, smoke_root)
    for seed in (1, 2, 3):
        control = train.reference_readings(cell, seed, "cpu", cast=plain.fp8,
                                           keep_grads=True)
        ref = train.reference_readings(
            cell, seed, "cpu", against={"control": control["first_grads"]})
        control["grad_diffs"] = ref["grad_diffs"]["control"]
        verdict = check.judge(check.numbers(control, ref), cell.limits)
        assert not verdict["correct"], (seed, verdict)


def test_reference_imports_nothing_of_the_program():
    import ast
    import pathlib
    for path in pathlib.Path(harness.ROOT, "portbench",
                             "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names}
        names |= {n.module for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module}
        tops = {n.split(".")[0] for n in names}
        assert not tops & {"repro_torch", "repro", "jax"}, (path, tops)


def test_fp8_rounds_operands_to_e4m3_and_gradients_to_e5m2():
    """The largest magnitude lands on the format's largest; relative
    rounding within half a unit of the last place: 3 mantissa bits forward
    (e4m3), 2 back (e5m2), for values in the formats' normal range."""
    x = torch.linspace(-3.0, 3.0, 1001, requires_grad=True)
    q = plain.fp8(x)
    assert float(q.detach().abs().max()) == pytest.approx(3.0, rel=1e-6)
    normal = x.detach().abs() > 3.0 / 448 * 2 ** -6 * 2
    rel = ((q - x).detach().abs() / x.detach().abs())[normal]
    assert 2 ** -5 < float(rel.max()) <= 2 ** -4 + 1e-6
    g = torch.linspace(-1.0, 1.0, 1001)
    q.backward(g)
    keep = g.abs() > 1e-3
    rel = ((x.grad - g).abs() / g.abs())[keep]
    assert 2 ** -4 < float(rel.max()) <= 2 ** -3 + 1e-6
