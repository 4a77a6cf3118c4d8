"""The port's fleet simulator held against the JAX package's.

The reference's device engine (`repro.core.transient.fleet_jit`) does not
import here (ROADMAP.md, reference caveat 1), so the port's device engine
(`repro_torch.core.transient.fleet_jit`, run on the CPU) is held against
the reference's two engines that do run, `engine="batched"` and
`engine="event"`, under the contract of tests/test_engine_parity.py:
revocation and replacement counts and `finished` exactly equal,
`steps_done` within 1, times and costs within rtol 1e-9, checkpoint, lost,
paused and restore times within 1e-6. The port's `FleetDraws` equals the
reference's bit for bit, and its `event_select` plain version equals the
Pallas kernel (interpret mode) bit for bit.

JAX and the reference are imported inside fixtures.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import resilience as presil
from repro_torch.api import Session as TorchSession
from repro_torch.chaos.injectors import keyed_uniforms
from repro_torch.chaos.scenarios import get_scenario, list_scenarios
from repro_torch.core.transient import fleet as pfleet
from repro_torch.core.transient import fleet_jit
from repro_torch.core.transient.fleet_batched import FleetDraws
from repro_torch.device import NoCudaDevice
from repro_torch.kernels import ref
from repro_torch.providers import get_provider
from repro_torch.resilience import DegradationPolicy, ResilienceConfig


@pytest.fixture
def rp():
    """The reference's fleet modules (no JAX import among them)."""
    pytest.importorskip("jax")
    from repro.chaos import injectors, scenarios
    from repro.core.transient import fleet, fleet_batched
    from repro import resilience
    return dataclasses.make_dataclass("R", ["fleet", "batched", "scenarios",
                                            "injectors", "resilience"])(
        fleet, fleet_batched, scenarios, injectors, resilience)


def _mk(fleet_mod, seed=0, provider="gcp", region="us-central1", gpu="v100",
        sp=4.56, n_workers=4, handover=True, replace=True, i_c=4000,
        t_c=3.84, grad_compression="none", model_bytes=1.87e6):
    """tests/test_engine_parity.py's `_mk_sim`, on either package."""
    workers = [fleet_mod.SimWorker(i, gpu, region, sp)
               for i in range(n_workers)]
    return fleet_mod.FleetSim(
        workers, model_gflops=1.54, model_bytes=model_bytes,
        step_speed_of=lambda g: sp, checkpoint_interval_steps=i_c,
        checkpoint_time_s=t_c, n_ps=1, seed=seed, handover=handover,
        replace=replace, price_of={gpu: 0.74}, provider=provider,
        grad_compression=grad_compression)


def _assert_same_results(j, o, what=""):
    """tests/test_engine_parity.py's `_assert_parity` contract."""
    assert [r.revocations for r in j] == [r.revocations for r in o], what
    assert [r.replacements for r in j] == [r.replacements for r in o], what
    assert [r.steps_done for r in j] == \
        pytest.approx([r.steps_done for r in o], abs=1)
    for field, tol in (("total_time_s", dict(rtol=1e-9)),
                       ("monetary_cost", dict(rtol=1e-9, atol=1e-9)),
                       ("checkpoint_time_s", dict(rtol=1e-6, atol=1e-6)),
                       ("lost_steps", dict(rtol=1e-6, atol=1e-6)),
                       ("paused_s", dict(rtol=1e-6, atol=1e-6)),
                       ("restore_delay_s", dict(rtol=1e-6, atol=1e-6))):
        np.testing.assert_allclose([getattr(r, field) for r in j],
                                   [getattr(r, field) for r in o],
                                   err_msg=f"{what} {field}", **tol)


def _assert_parity(mk_port, mk_ref, run_args, engines=("batched", "event")):
    """The port's jit engine (on the CPU) against each reference engine,
    from identical fresh sims."""
    j = mk_port().run_many(*run_args, engine="jit", device="cpu")
    for other in engines:
        o = mk_ref().run_many(*run_args, engine=other)
        _assert_same_results(j.results, o.results, f"vs {other}")
        assert j.stats.finished == o.stats.finished
    return j


# ------------------------------------------------------------- draws
def test_keyed_uniforms_equal_numpy_per_key():
    """The vectorized SeedSequence + PCG64 draw is NumPy's own, for keys
    with zeros, the widest words and every tag the engines use."""
    rng = np.random.default_rng(1)
    keys = np.stack([rng.integers(0, 2 ** 32, 400), np.full(400, 0xC4A15),
                     rng.integers(0, 6, 400), rng.integers(0, 70_000, 400),
                     rng.integers(0, 8, 400), rng.integers(0, 40, 400)], 1)
    keys[:3] = 0
    keys[3] = 2 ** 32 - 1
    want = [np.random.default_rng(np.random.SeedSequence(
        tuple(int(v) for v in k))).random() for k in keys]
    assert keyed_uniforms(keys).tobytes() == np.asarray(want).tobytes()
    with pytest.raises(ValueError):
        keyed_uniforms(np.array([[2 ** 32, 0]]))


@pytest.mark.parametrize("prov,region,gpu,chaos", [
    ("gcp", "us-central1", "v100", "regional_wave"),
    ("gcp", "europe-west1", "k80", None),
    ("aws", "us-east-1", "v100", "price_spike"),
    ("azure", "southeastasia", "v100", None),
])
def test_fleet_draws_equal_the_reference_bit_for_bit(rp, prov, region, gpu,
                                                     chaos):
    sims = [_mk(mod, seed=3, provider=prov, region=region, gpu=gpu)
            for mod in (rp.fleet, pfleet)]
    if chaos:
        sims[0].chaos = rp.scenarios.get_scenario(chaos).timeline(
            sims[0]._roster, seed=5)
        sims[1].chaos = get_scenario(chaos).timeline(sims[1]._roster, seed=5)
    want = rp.batched.FleetDraws(sims[0], 37, 7.0)
    got = FleetDraws(sims[1], 37, 7.0)
    assert got.initial.tobytes() == want.initial.tobytes()
    assert got._K == want._K
    res_r = rp.resilience.ResilienceConfig(restore_fail_p=0.5, seed=2)
    res_p = ResilienceConfig(restore_fail_p=0.5, seed=2)
    for g in (1, 2, 5):
        for a, b in zip(got._level(g), want._level(g)):
            assert a.tobytes() == b.tobytes()
        assert got.restore_stall_level(res_p, g).tobytes() == \
            want.restore_stall_level(res_r, g).tobytes()
        if chaos:
            assert got.chaos.join_uniform_matrix(37, g).tobytes() == \
                want.chaos.join_uniform_matrix(37, g).tobytes()


# ------------------------------------------------------ event select
@pytest.fixture(params=["float64", "float32"])
def pallas_es(request):
    """The Pallas kernel in interpret mode, in float64 (JAX's x64 mode on
    for the test) and float32."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.event_select import event_select_fwd
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", request.param == "float64")
    try:
        yield jnp, event_select_fwd, request.param
    finally:
        jax.config.update("jax_enable_x64", prev)


def _es_cases():
    rng = np.random.default_rng(0)
    cases = []
    for n, m, mask_p in ((1, 2, 0.0), (7, 8, 0.3), (64, 17, 0.9),
                         (300, 8, 1.0), (255, 6, 0.2), (257, 6, 0.5)):
        ev = rng.uniform(0.0, 1e6, (n, m))
        ev[rng.random((n, m)) < mask_p] = np.inf
        cases.append(ev)
    cases.append(np.full((5, 4), np.inf))                     # all masked
    cases.append(np.array([[3.0, 1.0, 1.0, 5.0], [2.0, 2.0, 2.0, 2.0],
                           [np.inf, 4.0, np.inf, 4.0]]))       # ties
    cases.append(np.array([[-np.inf, 0.0, np.inf],
                           [np.inf, -np.inf, -np.inf],
                           [0.5, np.inf, -np.inf]]))           # -inf
    cases.append(np.array([[1.0, np.nan, 0.5, 2.0],
                           [np.inf, 3.0, 2.0, 2.0]]))          # a NaN row
    return cases


@pytest.mark.parametrize("case", range(len(_es_cases())))
def test_event_select_ref_matches_pallas(pallas_es, case):
    jnp, event_select_fwd, dtype = pallas_es
    ev = _es_cases()[case].astype(dtype)
    for br in (4, 256):          # n off and on the block boundary
        want_t, want_i = event_select_fwd(jnp.asarray(ev), interpret=True,
                                          block_rows=br)
        assert np.asarray(want_t).dtype == ev.dtype
        t, i = ref.event_select_ref(torch.from_numpy(ev))
        assert t.dtype == getattr(torch, dtype) and i.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), np.asarray(want_t))
        np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))


# ------------------------------------------------ engine parity, CPU
CORPUS = [
    ("gcp", "us-central1", "v100", 4, True, True, "none",
     4000, 48.0, 0.0, 0),         # the paper's baseline cell
    ("gcp", "europe-west1", "k80", 8, False, True, "none",
     1000, 32.0, 0.0, 3),         # revocation-heavy + stock-chief loss
    ("gcp", "us-west1", "k80", 2, True, False, "none",
     4000, 100.0, 7.0, 5),        # replace=False frozen dead fleets
    ("aws", "us-east-1", "v100", 6, False, True, "none",
     1000, 80.0, 9.0, 2),         # 2-min warning: graceful checkpoint
    ("azure", "southeastasia", "v100", 4, False, True, "int8",
     4000, 60.0, 13.5, 1),        # compressed PS cap in the sim
    ("azure", "southcentralus", "v100", 1, True, True, "none",
     4000, 12.0, 23.75, 7),       # single slot, censoring, hour wrap
]


@pytest.mark.parametrize("prov,region,gpu,nw,ho,rep,comp,i_c,mh,sh,seed",
                         CORPUS)
def test_corpus_jit_matches_reference_engines(rp, prov, region, gpu, nw, ho,
                                              rep, comp, i_c, mh, sh, seed):
    kw = dict(seed=seed, provider=prov, region=region, gpu=gpu,
              n_workers=nw, handover=ho, replace=rep, grad_compression=comp,
              i_c=i_c)
    _assert_parity(lambda: _mk(pfleet, **kw), lambda: _mk(rp.fleet, **kw),
                   (250_000, 12, mh, sh))


def test_ported_scenarios_are_the_reference_fleet_scenarios(rp):
    names = list_scenarios()
    assert len(names) == 9
    assert names == rp.scenarios.list_scenarios()
    for name in names:
        assert get_scenario(name).name == name


@pytest.mark.parametrize("name", ["ckpt_outage", "dead_ps", "price_spike",
                                  "ps_crash", "recorded_trace",
                                  "regional_wave", "straggler",
                                  "wave_price_combo"])
def test_jit_parity_every_ported_chaos_scenario(rp, name):
    sc, rsc = get_scenario(name), rp.scenarios.get_scenario(name)
    assert [dataclasses.asdict(f) for f in sc.faults] == \
        [dataclasses.asdict(f) for f in rsc.faults]
    region = sc.region or get_provider(sc.provider).default_region
    kw = dict(seed=11, provider=sc.provider, region=region, gpu=sc.gpu,
              n_workers=sc.n_workers, handover=sc.handover)

    def mk_port():
        sim = _mk(pfleet, **kw)
        sim.chaos = sc.timeline(sim._roster, seed=11)
        return sim

    def mk_ref():
        sim = _mk(rp.fleet, **kw)
        sim.chaos = rsc.timeline(sim._roster, seed=11)
        return sim
    _assert_parity(mk_port, mk_ref, (sc.total_steps, 8, sc.max_hours))


def test_jit_parity_under_resilience(rp):
    """Restore-retry stalls and quorum pauses accrue identically."""
    def res_of(mod):
        return mod.ResilienceConfig(
            retry=mod.RetryPolicy(max_attempts=3, base_delay_s=60.0,
                                  multiplier=2.0, max_delay_s=600.0,
                                  jitter=0.5, deadline_s=1800.0),
            degradation=mod.DegradationPolicy(quorum=0.9, shrink_below=0.95,
                                              shrink_factor=0.7),
            restore_fail_p=0.7, seed=5)
    kw = dict(seed=5, region="europe-west1", gpu="k80", n_workers=8,
              handover=False, i_c=1000)

    def mk(mod, res):
        sim = _mk(mod, **kw)
        sim.resilience = res
        return sim
    j = _assert_parity(lambda: mk(pfleet, res_of(presil)),
                       lambda: mk(rp.fleet, res_of(rp.resilience)),
                       (250_000, 12, 32.0, 0.0))
    assert sum(r.restore_delay_s for r in j.results) > 0.0
    assert sum(r.paused_s for r in j.results) > 0.0


def test_deep_replacement_chain_pages_the_pools(rp):
    """Two slots revoked again and again outgrow the first 4 levels: the
    pools double twice and the frozen rows replay, with the batched
    engine's results."""
    kw = dict(seed=3, region="europe-west1", gpu="k80", n_workers=2)
    sim = _mk(pfleet, **kw)
    stats = {}
    got = fleet_jit.run_jit(sim, 2_000_000, 16, 96.0,
                            draws=FleetDraws(sim, 16, 0.0), device="cpu",
                            stats=stats)
    assert stats["doublings"] >= 1 and stats["levels"] > \
        fleet_jit.INITIAL_LEVELS
    ref_sim = _mk(rp.fleet, **kw)
    want = rp.batched.run_batched(ref_sim, 2_000_000, 16, 96.0,
                                  draws=rp.batched.FleetDraws(ref_sim, 16,
                                                              0.0))
    assert max(r.replacements for r in want) > 2 * fleet_jit.INITIAL_LEVELS
    _assert_same_results(got, want)


def test_results_independent_of_compaction_schedule(monkeypatch):
    """Paging finished rows out (COMPACT_MIN=8 on a 96-wide ensemble, many
    re-entries at shrinking widths) reproduces the single-entry result
    byte for byte."""
    sim = _mk(pfleet, seed=6, region="europe-west1", gpu="k80")
    draws = FleetDraws(sim, 96, 0.0)
    base_stats, comp_stats = {}, {}
    base = fleet_jit.run_jit(sim, 150_000, 96, 48.0, draws=draws, raw=True,
                             device="cpu", stats=base_stats)
    monkeypatch.setattr(fleet_jit, "COMPACT_MIN", 8)
    comp = fleet_jit.run_jit(sim, 150_000, 96, 48.0, draws=draws, raw=True,
                             device="cpu", stats=comp_stats)
    # without compaction a width of 96 re-enters only to grow the pools
    assert base_stats["entries"] == 1 + base_stats["doublings"]
    assert comp_stats["entries"] > base_stats["entries"]
    assert set(base) == set(comp)
    for key in base:
        assert np.asarray(base[key]).tobytes() == \
            np.asarray(comp[key]).tobytes(), key


def test_custom_law_points_at_batched():
    class _OddLaw:
        pass

    class _OddProvider:
        name = "odd"
        warning_seconds = 0.0
        graceful_checkpoint_on_warning = False

        def lifetime_model(self, region, gpu):
            return _OddLaw()

    sim = _mk(pfleet)
    sim.provider = _OddProvider()
    with pytest.raises(ValueError, match="no jittable port"):
        fleet_jit.run_jit(sim, 1000, 4, device="cpu")
    with pytest.raises(ValueError, match="at least one trajectory"):
        fleet_jit.run_jit(_mk(pfleet), 1000, 0, device="cpu")


def test_every_state_and_table_tensor_is_float64_or_int(monkeypatch):
    """One float32 scalar anywhere would break the 1e-9 time contract:
    walk the state and the table dict at every round, chaos and
    resilience on."""
    seen = []
    real_round = fleet_jit._round

    def spy(st, ar, **kw):
        out = real_round(st, ar, **kw)
        seen.append((dict(st), dict(ar), dict(out)))
        return out
    monkeypatch.setattr(fleet_jit, "_round", spy)
    sim = _mk(pfleet, seed=2, n_workers=4, handover=False)
    sim.chaos = get_scenario("wave_price_combo").timeline(sim._roster, 2)
    sim.resilience = ResilienceConfig(
        degradation=DegradationPolicy(quorum=0.6, shrink_below=0.9),
        restore_fail_p=0.5)
    sim.run_many(200_000, 6, 48.0, engine="jit", device="cpu")
    ints = {"revocations": torch.int32, "replacements": torch.int32,
            "gen": torch.int32, "orig": torch.int64,
            "slot_ids": torch.int64, "law_code": torch.int64}
    assert seen
    for st, ar, out in seen:
        for tree in (st, ar, out):
            for key, v in tree.items():
                if v.dtype == torch.bool:
                    assert key in ("alive", "chief", "done", "stalled",
                                   "blk_table", "hz_cols"), key
                else:
                    assert v.dtype == ints.get(key, torch.float64), \
                        (key, v.dtype)


def test_run_many_jit_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDevice):
        _mk(pfleet).run_many(1000, 2, engine="jit")
    with pytest.raises(NoCudaDevice):
        TorchSession.from_arch("qwen3-1.7b").simulate(samples=2,
                                                      engine="jit")
    # the host engines need no card, but a Session is built on one
    assert len(_mk(pfleet).run_many(1000, 2, engine="batched")) == 2


# -------------------------------------------------------- the Session
@pytest.fixture
def ref_session():
    pytest.importorskip("jax")
    from repro.api import Session
    return Session.from_arch("qwen3-1.7b", smoke=True)


@pytest.mark.parametrize("engine", ["batched", "event", "jit"])
def test_session_simulate_matches_reference(ref_session, engine):
    """`Session.simulate(samples>1)` on each engine against the
    reference's (its batched engine for "jit"); the sims are built from
    the same model metadata, so PS capacity and T_c agree."""
    port = TorchSession.from_arch("qwen3-1.7b", smoke=True, device="cpu")
    assert port.n_tensors() == ref_session.n_tensors()
    assert port.model_bytes() == ref_session.model_bytes()
    assert port.model_gflops() == ref_session.model_gflops()
    assert port.checkpoint_seconds() == ref_session.checkpoint_seconds()
    kw = dict(n_workers=4, gpu="k80", region="europe-west1",
              steps=1_000_000, samples=6, seed=1, checkpoint_interval=20_000)
    got = port.simulate(engine=engine, **kw)
    want = ref_session.simulate(
        engine="batched" if engine == "jit" else engine, **kw)
    assert got.provider == want.provider and got.region == want.region
    _assert_same_results(got.results, want.results, engine)
    assert got.stats.finished == want.stats.finished
    assert sum(r.revocations for r in got.results) > 0


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-1.3b",
                                  "zamba2-1.2b", "granite-moe-3b-a800m",
                                  "deepseek-v2-lite-16b"])
def test_n_tensors_counts_the_reference_leaves(arch):
    pytest.importorskip("jax")
    from repro.api import Session
    for smoke in (True, False):
        port = TorchSession.from_arch(arch, smoke=smoke, device="cpu")
        assert port.n_tensors() == Session.from_arch(
            arch, smoke=smoke).n_tensors(), (arch, smoke)


def test_cli_simulate_runs_the_device_engine_on_the_cpu(capsys):
    from repro_torch.__main__ import main
    assert main(["simulate", "--device", "cpu", "--samples", "4",
                 "--engine", "jit", "--steps", "20000"]) == 0
    out = capsys.readouterr().out
    assert "4 trajectories" in out and "revocations p50=" in out
    assert main(["simulate", "--device", "cpu", "--steps", "2000"]) == 0
    assert "steps in" in capsys.readouterr().out


@pytest.mark.cuda
@pytest.mark.parametrize("prov,region,gpu,nw,ho,rep,comp,i_c,mh,sh,seed",
                         CORPUS)
def test_corpus_on_the_card_matches_the_batched_engine(prov, region, gpu,
                                                       nw, ho, rep, comp,
                                                       i_c, mh, sh, seed):
    """The device engine on the card (the event-select kernel, CUDA's f64
    math) against the port's batched engine on the same draws."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.transient.fleet_batched import run_batched
    from repro_torch.kernels import ops
    sim = _mk(pfleet, seed=seed, provider=prov, region=region, gpu=gpu,
              n_workers=nw, handover=ho, replace=rep, grad_compression=comp,
              i_c=i_c)
    draws = FleetDraws(sim, 64, sh)
    want = run_batched(sim, 250_000, 64, mh, sh, draws=draws)
    before = ops.launches["event_select_fwd"]
    stats = {}
    got = fleet_jit.run_jit(sim, 250_000, 64, mh, sh, draws=draws,
                            stats=stats)
    assert ops.launches["event_select_fwd"] - before == stats["rounds"]
    _assert_same_results(got, want)
