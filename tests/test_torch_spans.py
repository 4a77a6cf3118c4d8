"""The port's spans (`repro_torch.spans`) on the CPU: under a profiler each
trainer step opens the batch's span and then the step's, and the step its
forward, backward, clip and optimizer once each, in that order; the same
steps without a profiler give the same numbers bit for bit, and open no
`RecordFunction`; on the meta device, as the dry run runs a step, the SSD
backward opens one span an SSD layer."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import RunConfig, ShapeConfig, get_config
from repro_torch.core.trainer import TransientTrainer
from repro_torch.data.pipeline import ShardedLoader, SyntheticTokenSource
from repro_torch.launch import steps as st
from repro_torch.models import api
from repro_torch.tree import flatten

ARCHS = ["stablelm-1.6b", "mamba2-1.3b"]
STEP_PARTS = ["forward", "backward", "clip", "optimizer"]


def _trainer(arch, tmp_path):
    cfg = get_config(arch, smoke=True)
    run = RunConfig(lr=1e-3, warmup_steps=1, total_steps=8,
                    checkpoint_interval=0, checkpoint_dir=str(tmp_path))
    loader = ShardedLoader(SyntheticTokenSource(cfg.vocab_size, 32), 4)
    trainer = TransientTrainer(cfg, run, loader, device="cpu")
    return trainer, trainer.init_state()


def _ranges(prof):
    """The profiled ``repro_torch.*`` ranges: (start ns, end ns, name
    without the prefix), in the order they opened."""
    return sorted(
        (e.start_ns(), e.start_ns() + e.duration_ns(),
         e.name()[len(spans.PREFIX):])
        for e in prof.profiler.kineto_results.events()
        if e.name().startswith(spans.PREFIX))


def _traced_steps(arch, tmp_path, n=2):
    trainer, state = _trainer(arch, tmp_path)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, report = trainer.run_steps(state, n)
    return state, report, _ranges(prof)


@pytest.mark.parametrize("arch", ARCHS)
def test_each_step_opens_batch_then_step_and_its_parts_in_order(
        arch, tmp_path):
    _, report, ranges = _traced_steps(arch, tmp_path)
    assert report.steps_run == 2
    names = [name for _, _, name in ranges]
    one = ["trainer.batch", "step"] + [f"step.{p}" for p in STEP_PARTS]
    assert names == one * 2
    for k in range(2):
        batch, step, *parts = ranges[6 * k: 6 * k + 6]
        assert batch[1] <= step[0]
        for (s, e, _), (s2, _, _) in zip(parts, parts[1:]):
            assert e <= s2
        assert all(step[0] <= s and e <= step[1] for s, e, _ in parts)


@pytest.mark.parametrize("arch", ARCHS)
def test_spans_change_no_number(arch, tmp_path):
    traced, traced_report, _ = _traced_steps(arch, tmp_path / "a")
    trainer, state = _trainer(arch, tmp_path / "b")
    plain, plain_report = trainer.run_steps(state, 2)
    assert traced_report.losses == plain_report.losses
    assert traced_report.grad_norms == plain_report.grad_norms
    for (name, a), (_, b) in zip(flatten(traced.params),
                                 flatten(plain.params)):
        assert torch.equal(a, b), name


def test_without_a_profiler_a_span_is_the_shared_no_op(tmp_path,
                                                       monkeypatch):
    def refuse(name):
        raise AssertionError(f"a RecordFunction was entered: {name}")

    assert not torch.autograd._profiler_enabled()
    assert spans.span("step") is spans.OFF
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    trainer, state = _trainer("mamba2-1.3b", tmp_path)
    _, report = trainer.run_steps(state, 1)
    assert report.steps_run == 1
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="repro_torch.step"):
            spans.span("step")


@pytest.mark.parametrize("microbatch", [0, 2])
def test_ssd_backward_opens_one_span_an_ssd_layer_on_meta(microbatch):
    cfg = get_config("mamba2-1.3b", smoke=True)
    run = RunConfig(microbatch=microbatch)
    step, _ = st.make_train_step(cfg, run)
    state = st.train_state_specs(cfg, run)
    batch, _ = api.batch_specs(cfg, ShapeConfig("t", 64, 4, "train"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    names = [name for _, _, name in _ranges(prof)]
    n = max(microbatch, 1)
    assert names.count("ssd_bwd") == cfg.n_layers * n
    assert names.count("step.forward") == names.count("step.backward") == n
    assert names.count("step") == names.count("step.clip") == 1
