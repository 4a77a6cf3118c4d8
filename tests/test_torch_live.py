"""The §VI-B live loop of the port held against the JAX package on the
CPU: the profiler's windowed measurements, `Controller.check` on seeded
profiler histories (with and without a PS model), the deterministic
mitigation ladder none -> int8 -> topk -> add a PS, the trainer's mid-run
step rebuild, the `ps_crash` live chaos run (scorecards, event sequences,
losses), and `python -m repro_torch chaos`."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.__main__ import main
from repro_torch.configs import RunConfig
from repro_torch.configs import get_config as tget_config
from repro_torch.core import controller as tcontroller
from repro_torch.core import profiler as tprofiler
from repro_torch.core.perf_model import cluster_model as tcluster
from repro_torch.core.trainer import TransientTrainer
from repro_torch.data.pipeline import ShardedLoader, SyntheticTokenSource
from repro_torch.dist.compression import compression_ratio
from repro_torch.kernels import ops
from torch_live_harness import (assert_same_run, one_torch_thread,
                                run_live_pair)


@pytest.fixture(scope="module")
def J():
    """The JAX package's live-loop modules (no JAX arrays involved)."""
    pytest.importorskip("jax")
    from repro.core import controller
    from repro.core import profiler
    from repro.core.perf_model import cluster_model
    return controller, profiler, cluster_model


def _records(seed, n=40):
    """(step, t) pairs with seeded step times, a stall (two records at one
    time) and a gap in the step numbers."""
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    for step in range(n):
        if step == n // 2:
            step += 3
        dt = 0.0 if step == n // 3 else float(rng.uniform(0.01, 0.2))
        t += dt
        out.append((step, t, float(rng.normal(5.0, 1.0))))
    return out


def _profilers(jprofiler, seed, **kw):
    jp, tp = jprofiler.PerformanceProfiler(**kw), \
        tprofiler.PerformanceProfiler(**kw)
    for step, t, loss in _records(seed):
        jp.record(step, t=t, loss=loss)
        tp.record(step, t=t, loss=loss)
    return jp, tp


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kw", [
    dict(window=10, warmup_steps=5, warmup_seconds=0.0),
    dict(window=3, warmup_steps=0, warmup_seconds=1.0),
    dict(),
], ids=["trainer", "short", "defaults"])
def test_profiler_matches_the_reference(J, seed, kw):
    jp, tp = _profilers(J[1], seed, **kw)
    assert tp.window_speeds == jp.window_speeds
    assert [(r.t, r.step) for r in tp._win] == [(r.t, r.step)
                                               for r in jp._win]
    for name in ("speed", "cov", "step_time", "history"):
        assert getattr(tp, name)() == getattr(jp, name)(), name
    for last in (1, 2, 7, 100):
        assert tp.recent_speed(last) == jp.recent_speed(last)


def test_profiler_step_time_of_a_stall_is_infinite():
    p = tprofiler.PerformanceProfiler(warmup_steps=0, warmup_seconds=0.0)
    assert p.step_time() is None
    p.record(3, t=1.0)
    p.record(3, t=2.0)
    assert p.speed() == 0.0 and p.step_time() == float("inf")


def _ps_pair(J, **kw):
    return (J[2].PSBottleneckModel(**kw),
            tcluster.PSBottleneckModel(**kw))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("ps", [
    None,
    dict(model_bytes=1e8, ps_bw=1e9),                       # saturated
    dict(model_bytes=1e8, ps_bw=1e9, compression="int8"),
    dict(model_bytes=1e8, ps_bw=1e9, compression="topk"),
    dict(model_bytes=1e6, ps_bw=1e9, n_tensors=10),         # headroom
], ids=["no-ps", "none", "int8", "topk", "headroom"])
@pytest.mark.parametrize("predicted", [0.0, 4.0, 12.0, 40.0])
def test_controller_check_matches_the_reference(J, seed, ps, predicted):
    jp, tp = _profilers(J[1], seed, window=10, warmup_steps=5,
                        warmup_seconds=0.0)
    jc, tc = J[0].Controller(), tcontroller.Controller()
    jc.model_version = tc.model_version = seed
    jw = [J[2].WorkerSpec("v100", 5.0 + i) for i in range(3)]
    tw = [tcluster.WorkerSpec("v100", 5.0 + i) for i in range(3)]
    jps, tps = _ps_pair(J, **ps) if ps is not None else (None, None)
    jd = jc.check(jp, predicted, ps_model=jps, workers=jw)
    td = tc.check(tp, predicted, ps_model=tps, workers=tw)
    assert (td.bottleneck, td.measured, td.predicted, td.deviation,
            td.action.value, td.note, td.model_version) == (
        jd.bottleneck, jd.measured, jd.predicted, jd.deviation,
        jd.action.value, jd.note, jd.model_version)
    assert len(tc.log) == len(jc.log) == 1


def test_controller_walks_the_ladder_as_the_reference(J):
    """A PS-bound cluster that stays slow: compress (int8), escalate to
    top-k, then add a PS, in both packages, with the same PS models."""
    ladder = []
    for ctrl_mod, prof_mod, cm in ((J[0], J[1], J[2]),
                                   (tcontroller, tprofiler, tcluster)):
        prof = prof_mod.PerformanceProfiler(warmup_steps=0,
                                            warmup_seconds=0.0)
        for step in range(10):
            prof.record(step, t=step * 0.5)          # 2 steps/s measured
        ctrl = ctrl_mod.Controller()
        workers = [cm.WorkerSpec("v100", 25.0) for _ in range(4)]
        ps = cm.PSBottleneckModel(4e8, ps_bw=1e9, n_tensors=40)
        steps = []
        for scheme in ("int8", "topk", None):
            det = ctrl.check(prof, 10.0, ps_model=ps, workers=workers)
            steps.append((det.action.value, det.deviation, det.note))
            ps = (ctrl.mitigate_compression(ps, scheme) if scheme
                  else ctrl.mitigate_ps(ps))
            steps.append(dataclasses.astuple(ps))
        ladder.append(steps)
    assert ladder[1] == ladder[0]
    assert [s[0] for s in ladder[1][::2]] == [
        "enable_compression", "enable_compression", "add_parameter_server"]
    assert ladder[1][-1][1:] == (2, 1e9, 40, tcluster.PS_RPC_PER_TENSOR_S,
                                 "topk")


def _counting(monkeypatch, name):
    calls = []
    orig = getattr(ops, name)

    def counted(*args, **kwargs):
        calls.append(name)
        return orig(*args, **kwargs)
    monkeypatch.setattr(ops, name, counted)
    return calls


def test_mitigation_rebuilds_the_step_and_keeps_the_optimizer(
        monkeypatch, tmp_path):
    """none -> int8 attaches a zero residual on the trainer's device and
    keeps AdamW's moments; int8 -> topk keeps the residual; the rebuilt
    step still runs `ops.flash_attention` and `ops.rmsnorm`."""
    cfg = tget_config("qwen3-1.7b", smoke=True).with_(dtype="float32")
    run = RunConfig(checkpoint_dir=str(tmp_path), warmup_steps=1,
                    total_steps=8)
    loader = ShardedLoader(SyntheticTokenSource(cfg.vocab_size, 16), 2)
    workers = [tcluster.WorkerSpec("v100", 25.0) for _ in range(4)]
    trainer = TransientTrainer(
        cfg, run, loader, device="cpu", predicted_speed=1.0,
        ps_model=tcluster.PSBottleneckModel(4e8, ps_bw=1e9),
        workers=workers)
    with one_torch_thread():
        state, _ = trainer.run_steps(trainer.init_state(), 1)
    moments = state.opt
    m_before = moments["m"]["embed"].clone()
    state = trainer.apply_mitigation(tcontroller.Action.ENABLE_COMPRESSION,
                                     state, step=1)
    assert trainer.run.grad_compression == "int8"
    residual = state.residual
    assert residual["embed"].device == trainer.device
    assert residual["embed"].dtype == torch.float32
    assert all(float(r.abs().max()) == 0.0 for r in (
        residual["embed"], residual["final_norm"]["scale"]))
    assert state.opt is moments and torch.equal(moments["m"]["embed"],
                                                m_before)
    flash = _counting(monkeypatch, "flash_attention")
    norms = _counting(monkeypatch, "rmsnorm")
    with one_torch_thread():
        state, _ = trainer.run_steps(state, 1)
    assert len(flash) == cfg.n_layers and len(norms) > 0
    assert not torch.equal(moments["m"]["embed"], m_before)
    residual = state.residual
    assert float(residual["embed"].abs().max()) > 0.0
    state = trainer.apply_mitigation(tcontroller.Action.ENABLE_COMPRESSION,
                                     state, step=2)
    assert trainer.run.grad_compression == "topk"
    assert state.residual is residual
    assert [m["grad_compression"] for m in trainer.mitigations] == [
        "int8", "topk"]
    assert trainer.predicted_speed == tcluster.cluster_speed(
        workers, trainer.ps_model)


def test_live_ps_crash_matches_the_reference(monkeypatch):
    """The §VI-B loop under a silent PS throttle: the same detections,
    mitigations, virtual seconds and scorecard as the JAX package, the
    same events in the same order, losses within 1e-4; the payload drops
    by the compression ratio at each switch."""
    pair = run_live_pair(monkeypatch, "ps_crash")
    history = assert_same_run(pair)
    live = pair.port
    assert live["actions_applied"] == ["enable_compression"] * 2
    assert live["final_compression"] == "topk"
    assert live["detection_latency_steps"] <= 10
    steps = [p for k, p in history if k == "step"]
    by_scheme = {}
    for p in steps:
        by_scheme.setdefault(p.get("grad_compression", "none"),
                             p.get("payload_bytes"))
    assert list(by_scheme) == ["none", "int8", "topk"]
    full = 4.0 * sum(t.numel() for t in _leaves(pair.tchild))
    assert by_scheme["int8"] == full * compression_ratio("int8")
    assert by_scheme["topk"] == by_scheme["int8"] * (
        compression_ratio("topk") / compression_ratio("int8"))


def _leaves(session):
    from repro_torch.tree import flatten
    return [t for _, t in flatten(session.trainer.state.params)]


@pytest.mark.parametrize("name", ["ckpt_outage", "dead_ps", "price_spike",
                                  "ps_crash", "regional_wave", "straggler",
                                  "wave_price_combo"])
def test_sim_scorecards_match_the_reference(name):
    """The fleet half of `run_scenario` (faulted and baseline ensembles,
    the ground-truth hash, the parity probe, the smoke gates) gives the
    JAX package's scorecard exactly."""
    from repro.api.session import Session as JSession
    from repro.chaos import runner as jrunner
    from repro_torch.api import Session
    from repro_torch.chaos import runner as trunner
    kw = dict(live=False, smoke=True, samples=16)
    want = jrunner.run_scenario(jrunner.get_scenario(name),
                                session=JSession.from_arch("qwen3-1.7b"),
                                **kw)
    got = trunner.run_scenario(
        trunner.get_scenario(name),
        session=Session.from_arch("qwen3-1.7b", device="cpu"), **kw)
    assert got == want


def test_serving_scenarios_are_refused():
    """A serving scenario is refused by the training fleet and by the
    device engine: it runs no training sim and no live loop, and
    `engine="jit"` runs the serving fleet on its batched host engine
    (tests/test_torch_serving_fleet.py holds its scorecards)."""
    from repro_torch.api import Session
    from repro_torch.chaos import runner as trunner
    from repro_torch.chaos.scenarios import get_scenario
    sc = get_scenario("serve_wave")
    short = dataclasses.replace(sc, serving=dataclasses.replace(
        sc.serving, workload=dataclasses.replace(sc.serving.workload,
                                                 n_requests=40)))
    card = trunner.run_scenario(
        short, session=Session.from_arch("qwen3-1.7b", device="cpu"),
        engine="jit", live=True, samples=2)
    assert card["sim"] is None and card["live"] is None
    assert card["serving"]["engine"] == "batched"
    assert card["serving"]["samples"] == 2


def test_cli_chaos_smoke(capsys):
    with one_torch_thread():
        assert main(["chaos", "--scenario", "ps_crash", "--smoke",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert '"passed": true' in out and '"final_compression": "topk"' in out


def test_cli_chaos_lists_the_scenarios(capsys):
    assert main(["chaos", "--list"]) == 0
    names = capsys.readouterr().out.split()
    assert {"ps_crash", "straggler", "ckpt_outage"} <= set(names)
