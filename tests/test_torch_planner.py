"""The port's §V-C launch planner and Eq (4) prediction held against the
JAX package's on the CPU: `core/scheduler.py` (`expected_revocations_mc`,
`plan_launch` under score="eq4" and under score="sim" with the batched
and event engines), `Session.plan` and `Session.predict` of the SMOKE
`qwen3-1.7b` for the three markets, and the `plan` and `predict`
subcommands.

The host engines are copies, so their plans equal the reference's
exactly. The port's device engine (`engine="jit"`, here on the CPU) is
held against the batched engine under the fleet contract of
tests/test_engine_parity.py: revocation means, `finished` and the chosen
cell exact, time and cost to rtol 1e-9, the revocation standard error
and the percentiles to 1e-6. A `cuda` test holds the card's plan the
same way; JAX and the reference are imported inside fixtures.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.__main__ import main
from repro_torch.api import PredictionReport, Session
from repro_torch.core import scheduler as tsched
from repro_torch.providers import get_provider

EXACT = ("region", "gpu", "launch_hour", "n_workers", "provider", "samples",
         "score", "expected_revocations", "finished")
RTOL_9 = ("expected_time_s", "expected_cost")
TOL_6 = ("revocation_stderr", "time_p50_s", "time_p90_s", "cost_p50",
         "cost_p90")
RUN = dict(total_steps=2000, checkpoint_interval=200)


@pytest.fixture(scope="module")
def J():
    """The reference's planner and Session (the Session imports JAX)."""
    pytest.importorskip("jax")
    import types

    from repro.api import Session as RefSession
    from repro.core import scheduler
    from repro.core.perf_model import cluster_model
    return types.SimpleNamespace(sched=scheduler, Session=RefSession,
                                 cluster=cluster_model)


@pytest.fixture(scope="module")
def ref_session(J):
    return J.Session.from_arch("qwen3-1.7b", zero1=False, **RUN)


@pytest.fixture(scope="module")
def session():
    return Session.from_arch("qwen3-1.7b", device="cpu", **RUN)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _same_plans(got, want, exact=True):
    """Plans cell for cell; `exact=False` is the fleet contract."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gd, wd = dataclasses.asdict(g), dataclasses.asdict(w)
        assert gd.keys() == wd.keys()
        if exact:
            assert gd == wd
            continue
        assert {k: gd[k] for k in EXACT} == {k: wd[k] for k in EXACT}
        np.testing.assert_allclose([gd[k] for k in RTOL_9],
                                   [wd[k] for k in RTOL_9], rtol=1e-9)
        np.testing.assert_allclose([gd[k] for k in TOL_6],
                                   [wd[k] for k in TOL_6], rtol=1e-6,
                                   atol=1e-6)


def _cell(p):
    return (p.region, p.launch_hour)


# ------------------------------------------------------------ scheduler
@pytest.mark.parametrize("provider,region,gpu", [
    ("gcp", "us-central1", "v100"), ("gcp", "us-west1", "k80"),
    ("aws", "us-east-1", "v100"), ("azure", "southeastasia", "v100")])
@pytest.mark.parametrize("start_hour", [0.0, 13.5])
def test_revocation_mc_equals_the_reference(J, provider, region, gpu,
                                            start_hour):
    args = (region, gpu, start_hour, 5.0, 4, 300, 2, provider)
    assert tsched.expected_revocations_mc_stats(*args) == \
        J.sched.expected_revocations_mc_stats(*args)
    assert tsched.expected_revocations_mc(*args) == \
        J.sched.expected_revocations_mc(*args)
    with pytest.raises(ValueError, match="at least one"):
        tsched.expected_revocations_mc(region, gpu, 0.0, 1.0, 2, samples=0)


def _plan_kw(**kw):
    base = dict(gpu="v100", n_workers=4, worker_speed=2.3, n_w=4000,
                i_c=500, t_c=12.0, hours=[0, 9, 18], seed=3,
                model_gflops=5.0, samples=64)
    return {**base, **kw}


@pytest.mark.parametrize("provider", ["gcp", "aws", "azure"])
@pytest.mark.parametrize("kw", [{}, {"i_c": 0}, {"region": "__first__"},
                                {"ps": (1.87e8, 1, 97, "int8")}],
                         ids=["grid", "no-ckpt", "one-region", "ps"])
def test_eq4_plans_equal_the_references(J, provider, kw):
    kw = dict(kw)
    if kw.get("region") == "__first__":
        kw["region"] = get_provider(provider).regions_offering("v100")[0]
    tkw, jkw = dict(kw), dict(kw)
    if "ps" in kw:
        mb, n_ps, n_t, comp = kw["ps"]
        from repro_torch.core.perf_model.cluster_model import (
            PSBottleneckModel)
        tkw["ps"] = PSBottleneckModel(mb, n_ps, n_tensors=n_t,
                                      compression=comp)
        jkw["ps"] = J.cluster.PSBottleneckModel(mb, n_ps, n_tensors=n_t,
                                                compression=comp)
    tbest, tplans = tsched.plan_launch(**_plan_kw(provider=provider, **tkw))
    jbest, jplans = J.sched.plan_launch(**_plan_kw(provider=provider, **jkw))
    _same_plans(tplans, jplans)
    assert dataclasses.asdict(tbest) == dataclasses.asdict(jbest)
    assert tbest.expected_cost == min(p.expected_cost for p in tplans)


@pytest.mark.parametrize("engine", ["batched", "event"])
@pytest.mark.parametrize("provider", ["gcp", "azure"])
def test_sim_plans_equal_the_references(J, engine, provider):
    kw = _plan_kw(provider=provider, score="sim", engine=engine, samples=12,
                  hours=[0, 12], n_w=20_000, max_sim_hours=48.0)
    tbest, tplans = tsched.plan_launch(**kw)
    jbest, jplans = J.sched.plan_launch(**kw)
    _same_plans(tplans, jplans)
    assert dataclasses.asdict(tbest) == dataclasses.asdict(jbest)
    assert all(p.score == "sim" for p in tplans)
    assert sum(p.expected_revocations for p in tplans) > 0


@pytest.mark.parametrize("provider", ["gcp", "aws"])
def test_jit_plans_follow_the_fleet_contract(provider):
    """The port's device engine, on the CPU, against its batched engine
    over the same cells and seed."""
    kw = _plan_kw(provider=provider, score="sim", samples=48,
                  hours=[0, 6, 12], n_w=20_000)
    jbest, jplans = tsched.plan_launch(engine="jit", device="cpu", **kw)
    bbest, bplans = tsched.plan_launch(engine="batched", **kw)
    _same_plans(jplans, bplans, exact=False)
    assert _cell(jbest) == _cell(bbest)


def test_planner_refuses_as_the_reference(J):
    for mod in (tsched, J.sched):
        with pytest.raises(ValueError, match="unknown score"):
            mod.plan_launch(**_plan_kw(score="exact"))
        with pytest.raises(ValueError, match="at least one"):
            mod.plan_launch(**_plan_kw(samples=0))
        with pytest.raises(ValueError):
            mod.plan_launch(**_plan_kw(region="us-east1"))  # no v100 there
        with pytest.raises(ValueError):
            mod.plan_launch(**_plan_kw(gpu="p100", provider="aws"))


def test_jit_plan_needs_the_card_unless_asked(monkeypatch):
    from repro_torch.device import NoCudaDevice
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDevice):
        tsched.plan_launch(**_plan_kw(score="sim", engine="jit",
                                      samples=4, hours=[0]))


# ---------------------------------------------------------- the Session
@pytest.mark.parametrize("provider", ["gcp", "aws", "azure"])
def test_session_plan_equals_the_references(session, ref_session,
                                            provider):
    """tests/test_providers.py's cross-provider plan, and the eq4 plan
    with the Fig 4 PS cap (`n_ps`)."""
    for kw in (dict(n_workers=2, steps=500, hours=[0]),
               dict(n_workers=4, hours=[0, 12], n_ps=2, samples=100)):
        tbest, tplans = session.plan(gpu="v100", provider=provider, **kw)
        jbest, jplans = ref_session.plan(gpu="v100", provider=provider, **kw)
        _same_plans(tplans, jplans)
        assert dataclasses.asdict(tbest) == dataclasses.asdict(jbest)
    assert {p.region for p in tplans} == set(
        get_provider(provider).regions_offering("v100"))
    assert all(p.provider == provider for p in tplans)


@pytest.mark.parametrize("engine", ["batched", "jit"])
def test_session_sim_plan_equals_the_reference(session, ref_session,
                                               engine):
    """The sim-scored plan (PS-capped, T_c from the §IV law): the host
    engine exactly, the device engine on the CPU under the contract."""
    kw = dict(gpu="v100", n_workers=4, steps=2000, checkpoint_interval=200,
              score="sim", samples=32, hours=[0, 12])
    tbest, tplans = session.plan(engine=engine, **kw)
    jbest, jplans = ref_session.plan(engine="batched", **kw)
    _same_plans(tplans, jplans, exact=engine == "batched")
    assert _cell(tbest) == _cell(jbest)


@pytest.mark.parametrize("provider", ["gcp", "aws", "azure"])
@pytest.mark.parametrize("kw", [
    dict(n_workers=2, steps=1000, checkpoint_interval=100),
    dict(n_workers=4, t_c=34.65), dict(n_workers=3, checkpoint_interval=0),
    dict(n_workers=8, n_ps=2, seed=5)], ids=["eq4", "t_c", "no-ckpt", "ps"])
def test_session_predict_equals_the_reference(session, ref_session,
                                              provider, kw):
    got = session.predict(gpu="v100", provider=provider, **kw)
    want = ref_session.predict(gpu="v100", provider=provider, **kw)
    assert isinstance(got, PredictionReport)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.region == get_provider(provider).default_region
    assert got.total_time_seconds >= 1000 / got.cluster_speed - 1e-6


def test_full_width_predict_equals_the_reference(J):
    """phase 15's call, with its T_c, on the full-width config."""
    got = Session.from_arch("qwen3-1.7b", smoke=False, device="cpu",
                            **RUN).predict(gpu="v100", n_workers=4,
                                           t_c=40.0)
    want = J.Session.from_arch("qwen3-1.7b", smoke=False, zero1=False,
                               **RUN).predict(gpu="v100", n_workers=4,
                                              t_c=40.0)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.ps_bottlenecked and got.checkpoint_seconds == 40.0


def test_session_plan_rejects_unsold_cells(session):
    with pytest.raises(ValueError):
        session.plan(gpu="v100", region="us-east1")
    with pytest.raises(ValueError, match="no calibrated speed model"):
        session.predict(gpu="h100")
    with pytest.raises(ValueError, match="no calibrated speed model"):
        session.plan_serving(gpu="h100")


# ---------------------------------------------------------------- CLI
def test_cli_plan_and_predict_run_on_the_cpu(capsys):
    assert main(["plan", "--device", "cpu", "--score", "sim", "--engine",
                 "jit", "--samples", "16"]) == 0
    out = capsys.readouterr().out
    assert "scored 32 (region, hour) cells x 16 simulated" in out
    assert "device=cpu" in out and "finished=" in out
    assert main(["plan", "--device", "cpu", "--provider", "aws",
                 "--samples", "20"]) == 0
    assert "[score=eq4" in capsys.readouterr().out
    assert main(["predict", "--device", "cpu", "--provider", "azure"]) == 0
    out = capsys.readouterr().out
    assert "on azure/" in out and "Eq(4):" in out


def test_cli_plan_and_predict_need_a_card_or_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in ("plan", "predict"):
        assert main([cmd]) == 2
        assert "device='cpu'" in capsys.readouterr().err
    # a cell the market never sold: a clean error, as the reference's CLI
    assert main(["plan", "--device", "cpu", "--region", "us-east1"]) == 2
    assert "error:" in capsys.readouterr().err


# ------------------------------------------------------------- the card
@pytest.mark.cuda
def test_card_plan_follows_the_fleet_contract(card):
    """`Session.plan(score="sim", engine="jit")` on the card (the event
    select launched once a round) against the CPU's batched plan."""
    from repro_torch.kernels import ops
    kw = dict(gpu="v100", n_workers=4, steps=2000, checkpoint_interval=200,
              score="sim", samples=256, hours=[0, 12])
    ops.reset_launches()
    gbest, gplans = Session.from_arch("qwen3-1.7b", device=card,
                                      **RUN).plan(engine="jit", **kw)
    assert ops.launches["event_select_fwd"] > 0
    bbest, bplans = Session.from_arch("qwen3-1.7b", device="cpu",
                                      **RUN).plan(engine="batched", **kw)
    _same_plans(gplans, bplans, exact=False)
    assert _cell(gbest) == _cell(bbest)
