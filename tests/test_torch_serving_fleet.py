"""The port's serving fleet held against the JAX package on the CPU:
`ServingFleetSim` on both engines (every count exact, `latencies_s`,
`total_time_s` and `cost` bit for bit, and each trajectory's degraded
tier records equal) over several seeds of tests/test_serving_fleet.py's
serve_wave-shaped `_wave_sim`, the port's own event-vs-batched parity, the
admission queue and the degradation tiers, `plan_serving` (the golden
ranking of tests/test_serving_fleet.py, field for field) and
`Session.plan_serving` at SMOKE and full width, the `serve_wave` scorecard
on both engines, `python -m repro_torch serve --fleet` against
`python -m repro serve --fleet`, and the scenario registry.

The serving fleet is host NumPy in both packages, so everything is held
exactly: the port's files are copies of the reference's. The reference is
imported inside fixtures.
"""
import dataclasses
import math

import pytest
from hypothesis import given, settings, strategies as st

from repro_torch import chaos as tchaos
from repro_torch import resilience as tresilience
from repro_torch import serving as tsv
from repro_torch.api import Session
from repro_torch.chaos.runner import run_scenario
from repro_torch.chaos.scenarios import get_scenario, list_scenarios

COUNTS = ("completed", "shed_queue_full", "shed_budget", "shed_degraded",
          "shed_horizon", "dropped_inflight", "dropped_warned", "handovers",
          "requeues", "hedges", "revocations", "warned_revocations",
          "replacements", "recovery_cycles", "tokens_served", "shed")


@pytest.fixture(scope="module")
def J():
    """The JAX package's serving fleet and chaos modules (NumPy only)."""
    pytest.importorskip("jax")
    import types

    from repro import chaos, resilience, serving
    from repro.chaos import runner, scenarios
    return types.SimpleNamespace(serving=serving, chaos=chaos,
                                 resilience=resilience, runner=runner,
                                 scenarios=scenarios)


def _wave_sim(sv, chaos, resilience, seed, *, armed=True, provider="aws",
              n_requests=120):
    """tests/test_serving_fleet.py's `_wave_sim`, on either package."""
    rset = sv.ReplicaSet(4, provider, gpu="v100", seed=seed)
    rset.chaos = chaos.FaultTimeline([chaos.PreemptionWave(0.01, 0.05, 60.0)],
                                     rset.roster(), seed=seed)
    wl = sv.ServingWorkload(n_requests=n_requests, arrival_rate_per_s=2.0,
                            max_tokens=16, queue_budget_s=15.0,
                            hedge_timeout_s=20.0)
    policy = sv.ServingDegradationPolicy(reduce_tokens_below=1.0,
                                         shrink_batch_below=0.75,
                                         shed_below=0.5)
    return sv.ServingFleetSim(
        rset, wl, policy=policy,
        resilience=resilience.ResilienceConfig() if armed else None,
        token_time_s=0.05, batch_ceiling=8, horizon_s=1800.0, seed=seed)


def _port_sim(seed, **kw):
    return _wave_sim(tsv, tchaos, tresilience, seed, **kw)


def _assert_same(got, want):
    """Result for result: counts exact, floats bit for bit."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.traj == w.traj
        assert {k: getattr(g, k) for k in COUNTS} == \
            {k: getattr(w, k) for k in COUNTS}, g.traj
        assert g.latencies_s.tobytes() == w.latencies_s.tobytes()
        assert (g.total_time_s, g.cost) == (w.total_time_s, w.cost)
        assert g.degraded_events == w.degraded_events


@pytest.mark.parametrize("engine", ["batched", "event"])
@pytest.mark.parametrize("seed,armed,provider", [
    (0, True, "aws"), (3, True, "aws"), (7, True, "gcp"), (1, False, "aws"),
    (5, False, "gcp")])
def test_fleet_sim_equals_the_references(J, engine, seed, armed, provider):
    got = _port_sim(seed, armed=armed, provider=provider).run_many(
        4, engine=engine)
    want = _wave_sim(J.serving, J.chaos, J.resilience, seed, armed=armed,
                     provider=provider).run_many(4, engine=engine)
    _assert_same(got, want)
    if armed and provider == "aws":
        assert sum(r.revocations for r in got) > 0
        assert sum(r.dropped_warned for r in got) == 0


@pytest.mark.parametrize("seed", range(4))
def test_event_and_batched_engines_agree(seed):
    """The port's own two-engine parity, the chaos runner's probe: every
    count and every latency equal."""
    a = _port_sim(seed).run_many(3, engine="batched")
    b = _port_sim(seed).run_many(3, engine="event")
    _assert_same(a, b)
    one = _port_sim(seed).run(traj=2, engine="event", samples=3)
    _assert_same([one], [b[2]])


def test_serving_refuses_an_unknown_engine():
    with pytest.raises(ValueError, match="unknown serving engine"):
        _port_sim(0).run_many(2, engine="jit")


@given(ops=st.lists(st.tuples(st.sampled_from(["offer", "front", "pop",
                                                "expire"]),
                              st.integers(0, 2),
                              st.floats(0, 2.0, allow_nan=False)),
                    max_size=40),
       cap=st.integers(1, 6), budget=st.sampled_from([0.5, 1.0, math.inf]))
@settings(max_examples=40, deadline=None)
def test_admission_queue_equals_the_references(ops, cap, budget):
    """Any sequence of offers, handovers, pops and expiry sweeps: the same
    admissions, pops, sheds (with reasons and times) and deadlines."""
    pytest.importorskip("jax")
    from repro.serving import AdmissionQueue as JQueue
    from repro.serving import Request as JRequest

    def drive(Queue, Request):
        q, now, log = Queue(cap, budget), 0.0, []
        for i, (op, prio, dt) in enumerate(ops):
            now += dt
            if op in ("offer", "front"):
                req = Request(rid=i, arrival_s=now, prompt_tokens=8,
                              max_tokens=4, priority=prio)
                if op == "offer":
                    log.append(("offer", q.offer(req, now)))
                else:
                    q.requeue_front(req, now)
            elif op == "pop":
                got = q.pop(now)
                log.append(("pop", None if got is None else got.rid))
            else:
                log.append(("expire", q.shed_expired(now)))
            log.append((len(q), q.next_deadline()))
        log.append([(r.rid, why, t) for r, why, t in q.shed])
        log.append([r.rid for r in q.drain()])
        return log
    assert drive(tsv.AdmissionQueue, tsv.Request) == \
        drive(JQueue, JRequest)


def test_degradation_tiers_equal_the_references(J):
    kw = dict(reduce_tokens_below=1.0, shrink_batch_below=0.75,
              shed_below=0.5)
    t, j = tsv.ServingDegradationPolicy(**kw), \
        J.serving.ServingDegradationPolicy(**kw)
    assert tsv.TIERS == J.serving.TIERS
    for alive in range(5):
        tier = t.tier(alive, 4)
        assert tier == j.tier(alive, 4)
        assert (t.token_cap(tier, 32), t.batch_ceiling(tier, 8),
                t.sheds_low_priority(tier)) == \
            (j.token_cap(tier, 32), j.batch_ceiling(tier, 8),
             j.sheds_low_priority(tier))


def test_replica_lifetimes_equal_the_references(J):
    """The keyed lifetime streams, chaos-thinned, and the replacement
    delay of the StartupModel's stage means."""
    for prov in ("gcp", "aws", "azure"):
        t = tsv.ReplicaSet(3, prov, seed=9)
        j = J.serving.ReplicaSet(3, prov, seed=9)
        assert (t.region, t.startup_s, t.warning_s, t.price_per_h) == \
            (j.region, j.startup_s, j.warning_s, j.price_per_h)
        for rs, chaos in ((t, tchaos), (j, J.chaos)):
            rs.chaos = chaos.FaultTimeline(
                [chaos.PreemptionWave(0.0, 1.0, 5.0)], rs.roster(), seed=9)
        assert t.initial_lifetimes_h(5).tobytes() == \
            j.initial_lifetimes_h(5).tobytes()
        assert [t.replacement_lifetime_h(2, 1, g, 0.3 * g) for g in
                range(1, 4)] == [j.replacement_lifetime_h(2, 1, g, 0.3 * g)
                                 for g in range(1, 4)]


# ---------------------------------------------------------------- planner
def test_plan_serving_golden_ranking_equals_the_references(J):
    """tests/test_serving_fleet.py's pinned grid, field for field."""
    kw = dict(replica_counts=(2, 4), providers=("gcp", "aws"),
              token_time_s=0.05, samples=4, seed=3)
    best, plans = tsv.plan_serving(
        tsv.ServingWorkload(n_requests=120, arrival_rate_per_s=2.0,
                            max_tokens=16),
        tsv.ServingSLO(p99_latency_s=5.0), **kw)
    jbest, jplans = J.serving.plan_serving(
        J.serving.ServingWorkload(n_requests=120, arrival_rate_per_s=2.0,
                                  max_tokens=16),
        J.serving.ServingSLO(p99_latency_s=5.0), **kw)
    assert [dataclasses.asdict(p) for p in plans] == \
        [dataclasses.asdict(p) for p in jplans]
    assert best is plans[0]
    assert [(p.provider, p.region, p.replicas) for p in plans] == [
        ("gcp", "us-central1", 2), ("aws", "us-east-1", 2),
        ("gcp", "us-central1", 4), ("aws", "us-east-1", 4)]
    assert best.cost_per_1k == pytest.approx(0.207017, abs=1e-4)


@pytest.fixture(scope="module")
def ref_sessions():
    pytest.importorskip("jax")
    from repro.api import Session as RefSession
    return {smoke: RefSession.from_arch("qwen3-1.7b", smoke=smoke)
            for smoke in (True, False)}


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_session_plan_serving_equals_the_references(ref_sessions, smoke):
    """The decode round priced by the §III rule (ROADMAP.md's reference
    caveat 6: 32.32 s on the v100 at full width, where every cell misses
    the SLO), and every plan, field for field."""
    s = Session.from_arch("qwen3-1.7b", smoke=smoke, device="cpu")
    kw = dict(replica_counts=(2, 4), samples=3, seed=1)
    best, plans = s.plan_serving(**kw)
    jbest, jplans = ref_sessions[smoke].plan_serving(**kw)
    assert [dataclasses.asdict(p) for p in plans] == \
        [dataclasses.asdict(p) for p in jplans]
    assert plans.index(best) == jplans.index(jbest) == 0
    assert s.bus.of_kind("plan_serving")[-1].payload == \
        ref_sessions[smoke].bus.of_kind("plan_serving")[-1].payload
    if smoke:
        assert best.meets_slo and best.token_time_s == pytest.approx(
            0.0306, abs=1e-4)
    else:
        assert not any(p.meets_slo for p in plans)
        assert best.token_time_s == pytest.approx(32.32, abs=0.01)


def test_cli_serve_fleet_prints_the_references_lines(J, capsys):
    from repro.__main__ import main as jmain
    from repro_torch.__main__ import main
    argv = ["serve", "--fleet", "--replica-counts", "2,4", "--requests",
            "60", "--plan-samples", "2", "--retry-attempts", "3"]
    assert jmain(argv) == 0
    want = capsys.readouterr().out
    assert main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert got.startswith("# serving plan: arch=qwen3-1.7b gpu=v100")
    assert len(got.splitlines()) == 5


# ----------------------------------------------------------- the scenario
def test_scenario_registry_equals_the_references(J):
    assert list_scenarios() == J.scenarios.list_scenarios()
    sc, rsc = get_scenario("serve_wave"), J.scenarios.get_scenario(
        "serve_wave")
    assert dataclasses.asdict(sc.serving) == dataclasses.asdict(rsc.serving)
    assert [dataclasses.asdict(f) for f in sc.faults] == \
        [dataclasses.asdict(f) for f in rsc.faults]
    assert (sc.expect, sc.provider, sc.region) == \
        (rsc.expect, rsc.provider, rsc.region)


@pytest.fixture(scope="module")
def sessions(ref_sessions):
    return (Session.from_arch("qwen3-1.7b", device="cpu"),
            ref_sessions[True])


@pytest.mark.parametrize("engine", ["batched", "event"])
def test_serve_wave_scorecard_equals_the_references(J, sessions, engine):
    """The serve_wave scorecard (armed, stock and fault-free ensembles,
    the impact block the four gates read, the parity probe), field for
    field, at 4 trajectories and a 120-request stream."""
    session, ref_session = sessions
    short = dataclasses.replace(
        get_scenario("serve_wave").serving,
        workload=dataclasses.replace(get_scenario("serve_wave")
                                     .serving.workload, n_requests=120))
    jshort = dataclasses.replace(
        J.scenarios.get_scenario("serve_wave").serving,
        workload=dataclasses.replace(J.scenarios.get_scenario("serve_wave")
                                     .serving.workload, n_requests=120))
    kw = dict(engine=engine, live=False, samples=4, smoke=True)
    got = run_scenario(dataclasses.replace(get_scenario("serve_wave"),
                                           serving=short),
                       session=session, **kw)
    want = J.runner.run_scenario(
        dataclasses.replace(J.scenarios.get_scenario("serve_wave"),
                            serving=jshort),
        session=ref_session, **kw)
    assert got == want
    assert got["sim"] is None
    serving = got["serving"]
    assert serving["parity"]["counts_equal"]
    assert serving["parity"]["time_max_rel_err"] == 0.0
    assert serving["impact"]["armed_dropped_warned"] == 0

