"""The port's recorded-trace layer held against the JAX package on the CPU:
the trace parser, `lifetimes_from_trace` and the hazard windows
(`calibration/traces.py`), the bundled sample trace (a byte-for-byte
copy), `TraceInjector.faults()`, `Recalibrator.ingest_trace` (store names,
versions and the refit laws' `params_hash`es), the `--recalib-trace` flag
through `Session.train`, and the `recorded_trace` chaos scenario: its
faults and its scorecards on the `batched` and `event` engines equal the
reference's, and the port's device engine (`engine="jit"`, here on the
CPU) is held against `batched` under the fleet contract of
tests/test_engine_parity.py (revocations, replacements and `finished`
exact, times and costs to rtol 1e-9).

Everything here is host NumPy in both packages, so the parser, the
windows, the faults, the stores and the host-engine scorecards are held
exactly. The reference is imported inside fixtures; a `cuda` test holds
the card's device engine the same way.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch import calibration as tcal
from repro_torch.api import Session
from repro_torch.chaos import trace_injector as tinj
from repro_torch.chaos.runner import run_scenario, scenario_fleet
from repro_torch.chaos.scenarios import get_scenario
from repro_torch.launch import cli

ROOT = pathlib.Path(__file__).resolve().parent.parent
SAMPLE = ROOT / "src" / "repro_torch" / "chaos" / "data" / "sample_trace.jsonl"

# tests/test_calibration.py's trace: three evictions in one hour, a
# censored survivor, and a price excursion over a $0.10 bid
TRACE = """\
# comment line
{"kind": "eviction", "t_h": 0.2, "lifetime_h": 0.2, "region": "r", "gpu": "v100"}
{"kind": "eviction", "t_h": 0.8, "lifetime_h": 0.8, "region": "r", "gpu": "v100"}
{"kind": "eviction", "t_h": 0.9, "lifetime_h": 0.9, "region": "r", "gpu": "v100"}
{"kind": "eviction", "t_h": 9.0, "lifetime_h": 9.0, "region": "r", "gpu": "v100", "censored": true}
{"kind": "price", "t_h": 0.0, "price": 0.08}
{"kind": "price", "t_h": 1.0, "price": 0.15}
{"kind": "price", "t_h": 2.0, "price": 0.12}
{"kind": "price", "t_h": 3.0, "price": 0.09}
"""


@pytest.fixture(scope="module")
def J():
    """The JAX package's trace layer and chaos modules (NumPy only)."""
    pytest.importorskip("jax")
    import types

    from repro import calibration
    from repro.chaos import runner, scenarios, trace_injector
    return types.SimpleNamespace(cal=calibration, runner=runner,
                                 scenarios=scenarios, inj=trace_injector)


def _events(events):
    return [dataclasses.asdict(e) for e in events]


def _windows(mod, events):
    return (mod.lifetimes_from_trace(events).tolist(),
            mod.lifetimes_from_trace(events, region="r", gpu="v100").tolist(),
            mod.lifetimes_from_trace(events, region="other").tolist(),
            mod.eviction_hazard_windows(events, n_workers=2, bucket_h=1.0),
            mod.eviction_hazard_windows(events, n_workers=4, bucket_h=0.5),
            mod.price_hazard_windows(events, bid=0.10),
            mod.price_hazard_windows(events, bid=0.13,
                                     hazard_per_excess=3.0))


@pytest.mark.parametrize("text", [TRACE, SAMPLE.read_text(),
                                  json.dumps([json.loads(line) for line in
                                              TRACE.splitlines()[1:]])],
                         ids=["test_trace", "sample_trace", "json_array"])
def test_parser_and_windows_equal_the_references(J, text):
    got, want = tcal.parse_trace(text), J.cal.parse_trace(text)
    assert _events(got) == _events(want)
    assert _windows(tcal, got) == _windows(J.cal, want)


def test_parser_guards_equal_the_references(J):
    for bad, match in (('{"kind": "meteor", "t_h": 1.0}', "kind"),
                       ('{"kind": "price"}', "t_h"), ("{nope}", "not JSON")):
        for mod in (tcal, J.cal):
            with pytest.raises(ValueError, match=match):
                mod.parse_trace(bad)
    events = tcal.parse_trace(TRACE)
    for mod in (tcal, J.cal):
        with pytest.raises(ValueError, match="bucket_h"):
            mod.eviction_hazard_windows(events, 2, bucket_h=0.0)
        with pytest.raises(ValueError, match="bid"):
            mod.price_hazard_windows(events, bid=0.0)


_record = st.one_of(
    st.builds(lambda t, lt, r, g, c: {"kind": "eviction", "t_h": t,
                                      "lifetime_h": lt, "region": r,
                                      "gpu": g, "censored": c},
              st.floats(0, 48, allow_nan=False),
              st.one_of(st.none(), st.floats(0, 48, allow_nan=False)),
              st.sampled_from([None, "a", "b"]),
              st.sampled_from([None, "v100", "k80"]), st.booleans()),
    st.builds(lambda t, p: {"kind": "price", "t_h": t, "price": p},
              st.floats(0, 48, allow_nan=False),
              st.one_of(st.none(), st.floats(0.01, 0.5, allow_nan=False))))


@given(records=st.lists(_record, max_size=30),
       bucket=st.sampled_from([0.25, 0.5, 1.0, 3.0]),
       bid=st.sampled_from([0.05, 0.1, 0.2]))
@settings(max_examples=40, deadline=None)
def test_random_traces_equal_the_references(records, bucket, bid):
    """Any trace: the same events, lifetimes (inf where censored) and
    windows, value for value."""
    pytest.importorskip("jax")
    from repro import calibration as jcal
    text = "\n".join(json.dumps(r) for r in records)
    got, want = tcal.parse_trace(text), jcal.parse_trace(text)
    assert _events(got) == _events(want)
    for region, gpu in ((None, None), ("a", "v100"), ("b", None)):
        np.testing.assert_array_equal(
            tcal.lifetimes_from_trace(got, region, gpu),
            jcal.lifetimes_from_trace(want, region, gpu))
    for n in (1, 4):
        assert tcal.eviction_hazard_windows(got, n, bucket) == \
            jcal.eviction_hazard_windows(want, n, bucket)
    assert tcal.price_hazard_windows(got, bid) == \
        jcal.price_hazard_windows(want, bid)


def test_sample_trace_is_the_references_byte_for_byte():
    ref = ROOT / "src" / "repro" / "chaos" / "data" / "sample_trace.jsonl"
    assert SAMPLE.read_bytes() == ref.read_bytes()
    assert len(SAMPLE.read_text().splitlines()) == 27


@pytest.mark.parametrize("kw", [dict(), dict(n_workers=4, bid=0.10),
                                dict(n_workers=8, bid=0.12, bucket_h=1.0,
                                     hazard_per_excess=3.0)],
                         ids=["no_bid", "scenario", "wide"])
def test_trace_injector_faults_equal_the_references(J, kw):
    got = tinj.TraceInjector.from_file(str(SAMPLE), **kw)
    want = J.inj.TraceInjector.from_file(str(SAMPLE), **kw)
    assert [(type(f).__name__, dataclasses.asdict(f))
            for f in got.faults()] == \
        [(type(f).__name__, dataclasses.asdict(f)) for f in want.faults()]
    roster = [(i, "v100", "us-central1", 1.0) for i in range(4)]
    assert got.timeline(roster, seed=3).truth_spans() == \
        want.timeline(roster, seed=3).truth_spans()


def test_the_scenario_reads_the_ports_own_trace(monkeypatch):
    """`recorded_trace` opens the copy beside the port's module, never a
    path under the JAX package."""
    opened = []
    real = tinj.load_trace
    monkeypatch.setattr(tinj, "load_trace",
                        lambda path: opened.append(path) or real(path))
    from repro_torch.chaos import scenarios
    scenarios.recorded_trace()
    assert [pathlib.Path(p).resolve() for p in opened] == [SAMPLE.resolve()]


def _ingest(mod, path, twice=True):
    rec = mod.Recalibrator(mod.RecalibrationConfig(trace_path=str(path)),
                           store=mod.ModelStore())
    written = [rec.ingest_trace()]
    if twice:
        written.append(rec.ingest_trace())
    return written, {n: rec.store.snapshots(n) for n in rec.store.names()}


@pytest.mark.parametrize("which", ["test_trace", "sample_trace"])
def test_ingest_trace_writes_the_references_store(J, tmp_path, which):
    """tests/test_calibration.py's cases: the written names, the second
    ingest a new version of the same name, and each refit law's
    `params_hash` equal to the reference's."""
    path = tmp_path / "trace.jsonl"
    path.write_text(TRACE if which == "test_trace" else SAMPLE.read_text())
    got, want = _ingest(tcal, path), _ingest(J.cal, path)
    assert got == want
    written, snaps = got
    if which == "test_trace":
        assert written == [["lifetime/trace/r/v100"]] * 2
        assert [v for v, _ in snaps["lifetime/trace/r/v100"]] == [1, 2]
    rec = tcal.Recalibrator(
        tcal.RecalibrationConfig(trace_path=str(path)))
    rec.ingest_trace()
    jrec = J.cal.Recalibrator(
        J.cal.RecalibrationConfig(trace_path=str(path)))
    jrec.ingest_trace()
    for name in rec.store.names():
        lm, jlm = rec.store.current(name), jrec.store.current(name)
        assert lm.p24 == jlm.p24 and lm.params_hash() == jlm.params_hash()
    assert tcal.Recalibrator().ingest_trace() == []


def test_recalib_trace_flag_ingests_through_session_train(tmp_path):
    """`train --recalibrate --recalib-trace PATH` arms a config whose
    trace `Session.train` ingests into the session's store at start."""
    path = tmp_path / "trace.jsonl"
    path.write_text(TRACE)
    from repro_torch.__main__ import build_parser
    args = build_parser().parse_args(
        ["train", "--device", "cpu", "--recalibrate", "--recalib-trace",
         str(path), "--steps", "2"])
    cfg = cli.recalib_from_args(args)
    assert cfg == tcal.RecalibrationConfig(trace_path=str(path))
    s = Session.from_arch("qwen3-1.7b", device="cpu")
    s.train(2, global_batch=2, seq_len=16, checkpoint_dir=str(tmp_path / "c"),
            recalibration=cfg)
    assert "lifetime/trace/r/v100" in s.models
    assert s.models.current("lifetime/trace/r/v100").p24 == \
        pytest.approx(0.75)


# ------------------------------------------------ the chaos scenario
def test_recorded_trace_scenario_equals_the_references(J):
    sc, rsc = get_scenario("recorded_trace"), J.scenarios.get_scenario(
        "recorded_trace")
    assert [(type(f).__name__, dataclasses.asdict(f)) for f in sc.faults] \
        == [(type(f).__name__, dataclasses.asdict(f)) for f in rsc.faults]
    assert (sc.description, sc.provider, sc.region, sc.expect,
            sc.total_steps, sc.max_hours, sc.n_workers) == \
        (rsc.description, rsc.provider, rsc.region, rsc.expect,
         rsc.total_steps, rsc.max_hours, rsc.n_workers)


@pytest.fixture(scope="module")
def ref_session():
    pytest.importorskip("jax")
    from repro.api import Session as RefSession
    return RefSession.from_arch("qwen3-1.7b", smoke=True)


@pytest.fixture(scope="module")
def session():
    return Session.from_arch("qwen3-1.7b", smoke=True, device="cpu")


@pytest.mark.parametrize("engine", ["batched", "event"])
def test_recorded_trace_scorecard_equals_the_references(J, ref_session,
                                                        session, engine):
    """The SMOKE scorecard, gates included, field for field."""
    kw = dict(engine=engine, live=False, samples=8, smoke=True)
    got = run_scenario(get_scenario("recorded_trace"), session=session, **kw)
    want = J.runner.run_scenario(J.scenarios.get_scenario("recorded_trace"),
                                 session=ref_session, **kw)
    assert got == want
    assert got["smoke"]["passed"]


def _per_trajectory(session, engine, samples, device=None):
    sc = get_scenario("recorded_trace")
    sim, n_steps = scenario_fleet(session, sc, seed=0)
    return sim.run_many(n_steps, samples, max_hours=sc.max_hours,
                        engine=engine, device=device).results


def _assert_fleet_contract(got, want):
    for key in ("revocations", "replacements"):
        assert [getattr(r, key) for r in got] == \
            [getattr(r, key) for r in want], key
    assert [r.steps_done for r in got] == pytest.approx(
        [r.steps_done for r in want], abs=1)
    for key in ("total_time_s", "monetary_cost"):
        np.testing.assert_allclose([getattr(r, key) for r in got],
                                   [getattr(r, key) for r in want],
                                   rtol=1e-9, atol=1e-9, err_msg=key)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_recorded_trace_jit_holds_the_fleet_contract(smoke):
    """The device engine (on the CPU) against the batched engine, trajectory
    by trajectory, and the scorecards' counts at the runner's 32
    trajectories; at full width the run is the censored one of ROADMAP.md's
    reference caveat 5 (extra_time_s -96,040 s), and its `min_extra_time_s`
    gate fails on both engines alike."""
    s = Session.from_arch("qwen3-1.7b", smoke=smoke, device="cpu")
    got = _per_trajectory(s, "jit", 24, device="cpu")
    want = _per_trajectory(s, "batched", 24)
    _assert_fleet_contract(got, want)
    kw = dict(live=False, samples=32, smoke=True)
    jc = run_scenario(get_scenario("recorded_trace"), session=s,
                      engine="jit", **kw)
    bc = run_scenario(get_scenario("recorded_trace"), session=s,
                      engine="batched", **kw)
    assert jc["sim"]["parity"]["counts_equal"]
    for part in ("faulted", "baseline"):
        for key in ("revocations_mean", "replacements_mean", "finished"):
            assert jc["sim"][part][key] == bc["sim"][part][key]
        assert jc["sim"][part]["time_mean_s"] == pytest.approx(
            bc["sim"][part]["time_mean_s"], rel=1e-9)
    assert jc["smoke"] == bc["smoke"]
    assert jc["sim"]["impact"] == bc["sim"]["impact"]
    assert bc["smoke"]["passed"] == smoke
    if not smoke:
        assert bc["sim"]["impact"]["extra_time_s"] == -96040.001686


@pytest.mark.cuda
def test_recorded_trace_on_the_card_holds_the_fleet_contract():
    """The card's device engine (the event-select kernel, one launch a
    round) against the batched engine on the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import ops
    s = Session.from_arch("qwen3-1.7b", smoke=True)
    before = ops.launches["event_select_fwd"]
    got = _per_trajectory(s, "jit", 256, device=s.device)
    assert ops.launches["event_select_fwd"] > before
    _assert_fleet_contract(got, _per_trajectory(s, "batched", 256))
    card = s.chaos("recorded_trace", engine="jit", live=False, smoke=True)
    assert card["passed"]
