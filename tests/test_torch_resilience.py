"""The port's live resilience layer held against the JAX package on the
CPU: `RetryPolicy.backoff` and the live jitter streams, `call_with_retries`
on seeded failure patterns (attempts, backoffs, ``retry`` events,
exhaustion, non-transient errors), the trainer's quorum tiers under a
revocation schedule, and the `ckpt_outage` live chaos run with resilience
armed (retried saves, recovered saves, the fallback drill)."""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as hst

from repro_torch.api import Session
from repro_torch.configs import RunConfig
from repro_torch.core.trainer import MembershipEvent
from repro_torch.resilience import (DegradationPolicy, ResilienceConfig,
                                    RetryExhausted, RetryPolicy,
                                    call_with_retries, live_jitter_uniforms)
from repro_torch.resilience import policy as tpolicy
from torch_live_harness import (assert_same_run, one_torch_thread,
                                run_live_pair, same_weights)


@pytest.fixture(scope="module")
def J():
    """The JAX package's resilience modules (NumPy only)."""
    pytest.importorskip("jax")
    from repro import resilience
    return resilience


POLICIES = [RetryPolicy(),
            RetryPolicy(max_attempts=6, base_delay_s=0.1, multiplier=3.0,
                        max_delay_s=2.0, jitter=0.5, deadline_s=4.0),
            RetryPolicy(max_attempts=2, jitter=0.0, deadline_s=0.25)]


def _twin(J, policy):
    return J.RetryPolicy(**dataclasses.asdict(policy))


@settings(deadline=None, max_examples=50)
@given(attempt=hst.integers(1, 12), u=hst.floats(0.0, 1.0),
       which=hst.integers(0, len(POLICIES) - 1))
def test_backoff_equals_the_references(J, attempt, u, which):
    p = POLICIES[which]
    assert p.backoff(attempt, u) == _twin(J, p).backoff(attempt, u)


@pytest.mark.parametrize("key", [-1, 0, 7, 2 ** 40])
@pytest.mark.parametrize("seed", [0, 3, 2 ** 33])
def test_live_jitter_streams_equal_the_references(J, seed, key):
    from repro.resilience import policy as jpolicy
    assert tpolicy._TAG_LIVE == jpolicy._TAG_LIVE
    for p in POLICIES:
        np.testing.assert_array_equal(
            live_jitter_uniforms(p, seed, key),
            jpolicy.live_jitter_uniforms(_twin(J, p), seed, key))


def _retry_run(mod, policy, pattern, seed, key, retry_on=(Exception,),
               error=OSError):
    """Run `call_with_retries` over a function that fails on the attempts
    `pattern` marks; returns the outcome, the sleeps and the events."""
    sleeps, events, calls = [], [], []

    def fn():
        calls.append(1)
        if pattern[len(calls) - 1]:
            raise error(f"attempt {len(calls)}")
        return "saved"

    try:
        out = mod.call_with_retries(
            fn, policy, op="checkpoint_save", seed=seed, key=key,
            sleep=sleeps.append, emit=lambda k, p: events.append((k, p)),
            retry_on=retry_on)
    except mod.RetryExhausted as exc:
        out = ("exhausted", exc.op, exc.attempts, type(exc.last).__name__)
    return out, sleeps, events, len(calls)


def _assert_same(t, j):
    (t_out, t_sleeps, t_events, t_calls), (j_out, j_sleeps, j_events,
                                           j_calls) = t, j
    assert t_out == j_out and t_calls == j_calls
    assert len(t_sleeps) == len(j_sleeps)
    for a, b in zip(t_sleeps, j_sleeps):
        assert abs(a - b) <= 1e-12
    assert [k for k, _ in t_events] == [k for k, _ in j_events]
    for (_, a), (_, b) in zip(t_events, j_events):
        assert {k: v for k, v in a.items() if k != "backoff_s"} == {
            k: v for k, v in b.items() if k != "backoff_s"}
        assert abs(a["backoff_s"] - b["backoff_s"]) <= 1e-12


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("which", range(len(POLICIES)))
def test_call_with_retries_matches_the_reference(J, seed, which):
    """Seeded failure patterns (each attempt fails with probability 0.6):
    the same outcome, attempts, backoffs and ``retry`` events."""
    policy = POLICIES[which]
    pattern = list(np.random.default_rng(seed).random(
        policy.max_attempts) < 0.6)
    import repro_torch.resilience as tres
    t = _retry_run(tres, policy, pattern, seed, key=10 * seed - 1)
    j = _retry_run(J, _twin(J, policy), pattern, seed, key=10 * seed - 1)
    _assert_same(t, j)


@pytest.mark.parametrize("which", range(len(POLICIES)))
def test_retries_exhaust_as_the_reference(J, which):
    import repro_torch.resilience as tres
    policy = POLICIES[which]
    fails = [True] * policy.max_attempts
    t = _retry_run(tres, policy, fails, 0, key=5)
    _assert_same(t, _retry_run(J, _twin(J, policy), fails, 0, key=5))
    assert t[0][0] == "exhausted"
    assert t[2][-1][1]["outcome"] == "gave_up"
    assert sum(t[1]) <= policy.deadline_s


def test_non_transient_errors_propagate_unretried(J):
    import repro_torch.resilience as tres
    for mod, policy in ((tres, RetryPolicy()),
                        (J, J.RetryPolicy())):
        with pytest.raises(ValueError, match="attempt 1"):
            _retry_run(mod, policy, [True] * 4, 0, 0, retry_on=(OSError,),
                       error=ValueError)
    sleeps, events = [], []
    with pytest.raises(RetryExhausted):
        call_with_retries(lambda: 1 / 0, RetryPolicy(max_attempts=1),
                          sleep=sleeps.append,
                          emit=lambda k, p: events.append(p))
    assert sleeps == [] and events[0]["outcome"] == "gave_up"


SCHEDULE = [(1, "revoke", 3), (2, "revoke", 2), (3, "revoke", 1),
            (5, "join", 6), (6, "join", 7)]


def test_quorum_tiers_match_the_reference(monkeypatch, tmp_path):
    """Four members lose three, then two replacements join: the same
    shrink_batch / pause / continue records, paused step slots, epochs
    and losses as the JAX package's trainer."""
    from repro.api.session import Session as JSession
    from repro.configs import RunConfig as JRunConfig
    from repro.core.trainer import MembershipEvent as JEvent
    from repro.resilience import DegradationPolicy as JDeg
    from repro.resilience import ResilienceConfig as JRes
    jcfg, tcfg = same_weights(monkeypatch)
    kw = dict(warmup_steps=1, total_steps=10, checkpoint_interval=0)
    deg = dict(quorum=0.5, shrink_below=0.75, shrink_factor=0.5)
    reps = []
    for sess, events in (
            (JSession(jcfg, JRunConfig(**kw), arch="qwen3-1.7b"),
             [JEvent(*e) for e in SCHEDULE]),
            (Session(tcfg, RunConfig(**kw), arch="qwen3-1.7b",
                     device="cpu"),
             [MembershipEvent(*e) for e in SCHEDULE])):
        res = (JRes(degradation=JDeg(**deg)) if isinstance(sess, JSession)
               else ResilienceConfig(degradation=DegradationPolicy(**deg)))
        with one_torch_thread():
            rep = sess.train(8, global_batch=4, seq_len=16, members=4,
                             events=events, resume=False,
                             checkpoint_dir=str(tmp_path / str(len(reps))),
                             resilience=res)
        reps.append((rep, sess))
    (jrep, jsess), (trep, tsess) = reps
    assert trep.degradations == jrep.degradations
    assert [d["tier"] for d in trep.degradations] == [
        "shrink_batch", "pause", "shrink_batch", "continue"]
    assert (trep.paused_steps, trep.steps_run, trep.epochs) == (
        jrep.paused_steps, jrep.steps_run, jrep.epochs)
    assert trep.paused_steps == 2
    for a, b in zip(trep.losses, jrep.losses):
        assert abs(a - b) <= 1e-4 * abs(b)
    assert [e.payload for e in tsess.bus.of_kind("degradation")] == [
        e.payload for e in jsess.bus.of_kind("degradation")]


def test_live_ckpt_outage_with_resilience_matches_the_reference(
        monkeypatch):
    """Saves inside the outage are retried and given up on, the first
    save after it recovers, and the post-run drill restores the previous
    generation after the newest is corrupted, as in the JAX package."""
    pair = run_live_pair(monkeypatch, "ckpt_outage", armed="resilience")
    history = assert_same_run(pair)
    rec = pair.port["recovery"]
    assert rec["save_failures"] >= 3 and rec["recovered_saves"] >= 1
    assert rec["retries"] >= 5 and rec["gave_up"] == rec["save_failures"]
    assert rec["fallback_drill"]["ok"] is True
    assert rec["fallback_drill"]["restored_step"] == \
        rec["fallback_drill"]["corrupted_step"] - 5
    assert sum(1 for k, _ in history if k == "retry") == \
        rec["retry_attempts"]
