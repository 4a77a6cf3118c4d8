"""The port's calibration layer held against the JAX package on the CPU:
`params_hash`, the Estimator protocol of `GPUStepTimeModel`,
`PSBottleneckModel` and `ClusterSpeedEstimator`, `CusumDetector`,
`ModelStore` versioning and its static seeding, `Recalibrator` observe /
notify sequences, `Session.models`, the `straggler` live chaos run
with recalibration armed (drift, refit, post-refit deviation), the
Estimator protocol of the §V lifetime laws (`LifetimeModel` and each
provider's `LifetimeLaw`), and the transfer path (`transfer_*`,
`fit_p24_effects`, `holdout_p24_report`)."""
import dataclasses

import numpy as np
import pytest

from repro_torch import calibration as tcal
from repro_torch import providers as tproviders
from repro_torch.api import Session
from repro_torch.core import profiler as tprofiler
from repro_torch.core.perf_model import cluster_model as tcluster
from repro_torch.core.perf_model import speed_model as tspeed
from repro_torch.core.transient import revocation as trevocation
from torch_live_harness import assert_same_run, run_live_pair


@pytest.fixture(scope="module")
def J():
    """The JAX package's calibration modules (NumPy only)."""
    pytest.importorskip("jax")
    import types

    from repro import calibration, providers
    from repro.core import profiler
    from repro.core.perf_model import cluster_model, speed_model
    from repro.core.transient import revocation
    return types.SimpleNamespace(cal=calibration, profiler=profiler,
                                 cluster=cluster_model, speed=speed_model,
                                 revocation=revocation, providers=providers)


@pytest.mark.parametrize("parts", [
    (), (None,), ("step_time",), (3,), (np.int64(-7),), (0.1,), (1e300,),
    (np.arange(5.0),), (np.array([[1.5, 2.5]]),), ([1, 2, 3],),
    ("ps_capacity", 1e8, 1, 1.25e9, 0, 2.52e-4, "none"),
], ids=lambda p: repr(p)[:30])
def test_params_hash_equals_the_references(J, parts):
    assert tcal.params_hash(*parts) == J.cal.params_hash(*parts)


def test_params_hash_tells_parameters_apart():
    assert tcal.params_hash(1.0) != tcal.params_hash(1.0 + 2 ** -52)
    assert tcal.params_hash("a", None) != tcal.params_hash("a")
    assert tcal.params_hash(1) != tcal.params_hash(1.0)


def _rows(seed, gpu="v100", n=12):
    rng = np.random.default_rng(seed)
    c = rng.choice([0.59, 1.54, 2.41, 21.3], size=n)
    return [{"gpu": gpu, "c_m": float(ci),
             "step_time": float(0.05 * ci * rng.uniform(0.9, 1.3))}
            for ci in c]


@pytest.mark.parametrize("gpu", ["k80", "p100", "v100"])
def test_step_time_models_match_the_references(J, gpu):
    tgen = tspeed.calibrate_generators()[gpu]
    jgen = J.speed.calibrate_generators()[gpu]
    assert tgen.params_hash() == jgen.params_hash()
    rows = _rows(len(gpu), gpu)
    for c in (0.1, 1.0, 5.0, 30.0):
        assert tgen.predict(c) == jgen.predict(c)
    assert tgen.update(rows).params_hash() == jgen.update(rows).params_hash()
    assert tgen.score(rows) == jgen.score(rows)
    fit_t = tspeed.GPUStepTimeModel.fit(rows, gpu)
    fit_j = J.speed.GPUStepTimeModel.fit(rows, gpu)
    assert fit_t.params_hash() == fit_j.params_hash()


@pytest.mark.parametrize("bad", [[], [{"gpu": "v100", "c_m": 1.0,
                                       "step_time": 0.1}]],
                         ids=["no-rows", "one-anchor"])
def test_step_time_fit_guards(J, bad):
    for mod in (tspeed, J.speed):
        with pytest.raises(ValueError):
            mod.GPUStepTimeModel.fit(bad, "v100")


@pytest.mark.parametrize("kw", [
    dict(model_bytes=6.9e9),
    dict(model_bytes=1e8, n_ps=3, ps_bw=2e9, n_tensors=97),
    dict(model_bytes=4e8, compression="int8"),
    dict(model_bytes=4e8, compression="topk", n_tensors=40),
])
def test_ps_models_match_the_references(J, kw):
    tps, jps = tcluster.PSBottleneckModel(**kw), \
        J.cluster.PSBottleneckModel(**kw)
    assert tps.params_hash() == jps.params_hash()
    rows = [{"capacity_steps_per_s": c} for c in (3.0, 0.0, 5.5, 4.25)]
    assert tps.update(rows).params_hash() == jps.update(rows).params_hash()
    assert tps.score(rows) == jps.score(rows)
    tw = [tcluster.WorkerSpec("v100", 2.0 + i) for i in range(4)]
    jw = [J.cluster.WorkerSpec("v100", 2.0 + i) for i in range(4)]
    assert tps.predict(tw) == jps.predict(jw)
    assert tps.is_bottlenecked(tw) == jps.is_bottlenecked(jw)
    for mod in (tcluster, J.cluster):
        with pytest.raises(ValueError):
            mod.PSBottleneckModel.fit([{"capacity_steps_per_s": 0.0}], 1e8)


def _history(seed, n=10):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(0.01, 0.1, n))
    return [{"t": float(ti), "step": i, "loss": None}
            for i, ti in enumerate(t)]


@pytest.mark.parametrize("seed", range(3))
def test_cluster_speed_estimator_matches_the_reference(J, seed):
    h = _history(seed)
    t = tcal.ClusterSpeedEstimator.fit(h, source="refit")
    j = J.cal.ClusterSpeedEstimator.fit(h, source="refit")
    assert (t.speed, t.n_obs, t.source, t.params_hash()) == (
        j.speed, j.n_obs, j.source, j.params_hash())
    assert t.score(h) == j.score(h) and t.predict() == j.predict()
    assert t.update(h[3:]).params_hash() == j.update(h[3:]).params_hash()


@pytest.mark.parametrize("bad", [[], [{"t": 0.0, "step": 0}],
                                 [{"t": 1.0, "step": 0},
                                  {"t": 1.0, "step": 4}]],
                         ids=["empty", "one", "zero-span"])
def test_cluster_speed_estimator_guards(J, bad):
    for mod in (tcal, J.cal):
        with pytest.raises(ValueError):
            mod.ClusterSpeedEstimator.fit(bad)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("two_sided", [False, True])
def test_cusum_matches_the_reference(J, seed, two_sided):
    rng = np.random.default_rng(seed)
    devs = [None if u < 0.1 else float(d)
            for u, d in zip(rng.random(60), rng.normal(0.03, 0.12, 60))]
    t = tcal.CusumDetector(two_sided=two_sided)
    j = J.cal.CusumDetector(two_sided=two_sided)
    assert [t.observe(d) for d in devs] == [j.observe(d) for d in devs]
    assert t.alarms == j.alarms and t.statistic == j.statistic
    assert (t.s_pos, t.s_neg) == (j.s_pos, j.s_neg)


def _store_trail(store, cal, est_cls):
    store.register("cluster_speed", est_cls(speed=10.0))
    out = [store.update("cluster_speed", est_cls(speed=8.0, n_obs=6,
                                                 source="refit")),
           store.rollback("cluster_speed"),
           store.rollback("cluster_speed", 2),
           store.version("cluster_speed")]
    store.register("opaque", object())
    with pytest.raises(ValueError):
        store.register("opaque", object())
    with pytest.raises(ValueError):
        store.rollback("cluster_speed", 99)
    with pytest.raises(KeyError):
        store.current("missing")
    return out, store.snapshots("cluster_speed"), \
        store.at_version("cluster_speed", 2).speed, store.names(), \
        store.snapshots("opaque")


def test_model_store_matches_the_reference(J):
    t = _store_trail(tcal.ModelStore(), tcal, tcal.ClusterSpeedEstimator)
    j = _store_trail(J.cal.ModelStore(), J.cal,
                     J.cal.ClusterSpeedEstimator)
    assert t == j
    assert t[0] == [2, 3, 4, 4]


def test_static_store_snapshots_equal_the_references(J):
    t = tcal.ModelStore.with_static_calibrations()
    j = J.cal.ModelStore.with_static_calibrations()
    assert t.names() == j.names() == ["step_time/k80", "step_time/p100",
                                      "step_time/v100"]
    for name in t.names():
        assert t.snapshots(name) == j.snapshots(name)
        # the memoized instances themselves, as the reference seeds it
        assert t.current(name) is tspeed.calibrate_generators()[
            name.split("/")[1]]


def test_session_resolves_generators_through_its_store():
    s = Session.from_arch("qwen3-1.7b", device="cpu")
    gens = s._generators()
    assert sorted(gens) == ["k80", "p100", "v100"]
    assert all(gens[g] is s.models.current(f"step_time/{g}") for g in gens)
    assert s.predict_worker_speed("v100") > 0


def _feed(profiler_mod, recal, seed):
    """Controller-check cadence over seeded records: deviations that
    drift upward, a mitigation notice mid-way; returns what observe gave
    and the events the recalibrator emitted."""
    rng = np.random.default_rng(seed)
    prof = profiler_mod.PerformanceProfiler(window=10, warmup_steps=0,
                                            warmup_seconds=0.0)
    events, got, t = [], [], 0.0
    recal.bind(lambda kind, payload: events.append((kind, dict(payload))))
    recal.seed(20.0)
    for step in range(80):
        t += float(rng.uniform(0.04, 0.06)) * (1.5 if step > 30 else 1.0)
        prof.record(step, t=t)
        if step and step % 5 == 0:
            if step == 45:
                recal.notify_mitigation(step)
                continue
            dev = None if step == 10 else float(
                (0.2 if step > 30 else 0.0) + rng.normal(0.0, 0.03))
            got.append(recal.observe(step, dev, prof))
    return got, events


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("cfg", [
    {}, {"cooldown_checks": 0, "refit_window": 4, "min_history": 3},
    {"refit_window": 3, "min_history": 5},      # drift, but never a refit
], ids=["defaults", "short", "too-short"])
def test_recalibrator_sequences_match_the_reference(J, seed, cfg):
    t = tcal.Recalibrator(config=tcal.RecalibrationConfig(**cfg))
    j = J.cal.Recalibrator(config=J.cal.RecalibrationConfig(**cfg))
    assert _feed(tprofiler, t, seed) == _feed(J.profiler, j, seed)
    assert t.drift_events == j.drift_events and t.refits == j.refits
    assert t.version == j.version
    assert t.store.snapshots("cluster_speed") == j.store.snapshots(
        "cluster_speed")


def test_recorded_traces_are_refused(tmp_path):
    """A malformed or missing trace is refused as the reference refuses
    it; no trace ingests nothing (tests/test_torch_traces.py holds the
    ingestion itself against the reference)."""
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"kind": "meteor", "t_h": 1.0}\n')
    rec = tcal.Recalibrator(config=tcal.RecalibrationConfig(
        trace_path=str(bad)))
    with pytest.raises(ValueError, match="kind"):
        rec.ingest_trace()
    with pytest.raises(FileNotFoundError):
        tcal.Recalibrator().ingest_trace(str(tmp_path / "missing.jsonl"))
    assert tcal.Recalibrator().ingest_trace() == []


def test_live_straggler_with_recalibration_matches_the_reference(
        monkeypatch):
    """A silent straggler: no PS lever is pulled, CUSUM confirms the
    drift, the refit relearns the degraded speed, and the next check is
    back inside 6.7 %, as in the JAX package, event for event."""
    pair = run_live_pair(monkeypatch, "straggler", armed="recalibration")
    history = assert_same_run(pair)
    live, recal = pair.port, pair.port["recalibration"]
    assert live["actions_applied"] == [] and live["wrong_actions"] == 0
    assert len(recal["drift_events"]) >= 1 and len(recal["refits"]) >= 1
    assert abs(recal["post_refit_deviation"]) < 0.067
    kinds = [k for k, _ in history]
    assert "model_drift" in kinds and "model_refit" in kinds
    assert pair.tchild.models.version("cluster_speed") == \
        recal["model_version"]


# ------------------------------------------- §V lifetime laws (protocol)
def _lifetimes(seed, n=40, survive=0.3):
    rng = np.random.default_rng(seed)
    lt = rng.weibull(1.3, n) * 9.0
    lt[rng.uniform(size=n) < survive] = np.inf
    return lt


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("cell", [("us-central1", "v100"),
                                  ("us-west1", "k80"),
                                  ("europe-west1", "p100"),
                                  ("mars-east1", "v100")])
def test_lifetime_model_protocol_equals_the_reference(J, seed, cell):
    """`LifetimeModel.fit/predict/update/score/params_hash`; a cell with
    no Fig 8 hint takes the default shape, as the reference's does."""
    lt = _lifetimes(seed)
    got = trevocation.LifetimeModel.fit(*cell, lt)
    want = J.revocation.LifetimeModel.fit(*cell, lt)
    assert got.params_hash() == want.params_hash()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for t_h in (0.5, 6.0, 24.0):
        assert got.predict(t_h) == want.predict(t_h)
    assert got.score(lt) == want.score(lt)
    lt2 = _lifetimes(seed + 10, survive=0.6)
    assert got.update(lt2).params_hash() == want.update(lt2).params_hash()
    assert got.fit(*cell, lt, k=2.0).k == 2.0
    assert isinstance(got, tcal.Estimator)
    for mod in (trevocation, J.revocation):
        with pytest.raises(ValueError, match="no observed"):
            mod.LifetimeModel.fit(*cell, [])
        with pytest.raises(ValueError, match="no observed"):
            got.score([])


@pytest.mark.parametrize("provider", ["gcp", "aws", "azure"])
def test_every_laws_protocol_equals_the_reference(J, provider):
    """Each offered (region, gpu) law of each market: `params_hash` and
    `score` equal the reference's, and `residuals` for the
    `LifetimeLaw`s (AWS, Azure; GCP's laws are `LifetimeModel`s)."""
    tp, jp = tproviders.get_provider(provider), J.providers.get_provider(
        provider)
    seen = set()
    for off in tp.offerings():
        tl = tp.lifetime_model(off.region, off.gpu)
        jl = jp.lifetime_model(off.region, off.gpu)
        h = tl.params_hash()
        assert h == jl.params_hash(), (provider, off)
        seen.add(h)
        lt = _lifetimes(len(seen))
        assert tl.score(lt) == jl.score(lt)
        if not isinstance(tl, trevocation.LifetimeModel):
            np.testing.assert_array_equal(tl.residuals(lt),
                                          jl.residuals(lt))
            assert tl.residuals(lt).shape == (int(np.isfinite(lt).sum()),)
            with pytest.raises(ValueError, match="no finite"):
                tl.score(np.array([np.inf]))
    # distinct cells calibrate to distinct parameters
    assert len(seen) == len(tp.offerings())


# ------------------------------------------------------------ transfer
@pytest.mark.parametrize("target", ["k80", "p100", "v100"])
def test_step_time_transfer_equals_the_reference(J, target):
    got = tcal.transfer_step_time_model(target)
    want = J.cal.transfer_step_time_model(target)
    assert got.params_hash() == want.params_hash()
    # a card the spec sheet lacks, given its peak
    got = tcal.transfer_step_time_model("h100", target_teraflops=989.0)
    want = J.cal.transfer_step_time_model("h100", target_teraflops=989.0)
    assert got.params_hash() == want.params_hash()
    assert got.gpu == "h100" and np.all(got.t_anchors > 0)
    srcs = {g: m for g, m in tspeed.calibrate_generators().items()
            if g != target}
    jsrcs = {g: m for g, m in J.speed.calibrate_generators().items()
             if g != target}
    assert (tcal.transfer_step_time_model(target, srcs).params_hash()
            == J.cal.transfer_step_time_model(target, jsrcs).params_hash())


def test_transfer_refuses_as_the_reference(J):
    for mod in (tcal, J.cal):
        with pytest.raises(KeyError, match="unknown gpu"):
            mod.transfer_step_time_model("h100")
        with pytest.raises(ValueError, match="no source"):
            mod.transfer_step_time_model("v100", sources={})
        with pytest.raises(ValueError, match="positive"):
            mod.transfer_step_time_model("h100", target_teraflops=0.0)
        with pytest.raises(KeyError, match="never observed"):
            mod.transfer_p24("mars-east1", "v100")
        with pytest.raises(ValueError, match=">= 3"):
            mod.fit_p24_effects({("a", "k80"): 0.5, ("b", "k80"): 0.4})


def test_lifetime_transfer_equals_the_reference(J):
    assert tcal.fit_p24_effects() == J.cal.fit_p24_effects()
    eff = tcal.fit_p24_effects()
    for (region, gpu) in trevocation.TABLE5_RATES:
        assert tcal.transfer_p24(region, gpu, eff) == J.cal.transfer_p24(
            region, gpu)
        got = tcal.transfer_lifetime_model(region, gpu)
        want = J.cal.transfer_lifetime_model(region, gpu)
        assert got.params_hash() == want.params_hash()
    assert list(tcal.holdout_p24_report()) == list(
        J.cal.holdout_p24_report())
    rates = dict(trevocation.TABLE5_RATES)
    rates[("us-east1", "k80")] = 0.2
    assert tcal.fit_p24_effects(rates) == J.cal.fit_p24_effects(rates)
    assert list(tcal.holdout_p24_report(rates)) == list(
        J.cal.holdout_p24_report(rates))
