"""Chaos scenario runner: sim ensembles + live trainer drive + scorecard.

`run_scenarios` is what `Session.chaos` and `python -m repro chaos` call.
Per scenario it produces one JSON-serializable scorecard:

* **sim** — a faulted vs baseline fleet-simulation ensemble on the
  requested engine (recovery cost in wall-clock, $ and lost steps), a
  batched-vs-event *parity probe* (same `FleetDraws`-keyed fault
  transforms must give identical per-trajectory revocation/replacement
  counts and matching times on both engines), and the ground-truth
  timeline plus a hash of the hazard-transformed lifetime matrix — the
  bit-identical-across-engines contract, pinned.
* **live** (scenarios with a `LivePlan`, unless `live=False`) — the real
  `TransientTrainer` run under a *virtual clock*: a bus subscriber prices
  every step at the truly degraded cluster speed (belief model with the
  PS bandwidth secretly scaled, straggler-scaled workers) while the
  trainer's own capacity model stays healthy — so detection, attribution
  and mitigation happen from measurement alone, deterministically on any
  machine. The bus history is then scored against the plan's ground
  truth (`evaluator.score_history`).

Nothing in the scorecard depends on wall-clock time or temp paths, so a
fixed (scenario, seed, samples) triple reproduces it bit-for-bit.

The port's copy of the JAX package's `chaos/runner.py`. The live run
trains on the session's device (the card unless the session was built
with ``device="cpu"``), and its checkpoint directory is removed when the
scenario ends. The serving branch (`_run_serving`) runs the serving-fleet
simulator, host NumPy on every device as in the reference.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import tempfile
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.chaos.evaluator import score_history
from repro_torch.chaos.scenarios import (Scenario, get_scenario,
                                         list_scenarios)
from repro_torch.checkpoint.checkpointer import _rebuild
from repro_torch.core.perf_model.cluster_model import (PSBottleneckModel,
                                                       WorkerSpec,
                                                       cluster_speed)

#: trajectories used for the per-scenario two-engine parity probe
PARITY_SAMPLES = 8


class VirtualClock:
    """Deterministic stand-in for `time.monotonic` in live chaos runs.
    The chaos driver advances it by the modeled duration of each step, so
    profiler speeds — and therefore detection latencies — are a function
    of the scenario alone, not of the machine the test runs on."""

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _ens_summary(ens) -> Dict[str, float]:
    lost = float(np.mean([r.lost_steps for r in ens.results]))
    return {"time_mean_s": round(ens.stats.time_mean_s, 6),
            "cost_mean": round(ens.stats.cost_mean, 6),
            "revocations_mean": ens.stats.revocations_mean,
            "replacements_mean": ens.stats.replacements_mean,
            "lost_steps_mean": round(lost, 6),
            "finished": ens.stats.finished,
            # recovery cost (zeros unless resilience is armed)
            "paused_s_mean": round(float(np.mean(
                [r.paused_s for r in ens.results])), 6),
            "restore_delay_s_mean": round(float(np.mean(
                [r.restore_delay_s for r in ens.results])), 6)}


def scenario_fleet(session, sc: Scenario, seed: int, chaos: bool = True):
    """The session's fleet for scenario `sc`, its faults armed unless
    ``chaos=False``: (sim, step budget), as every ensemble of `_run_sim`
    runs it."""
    sim, n_steps = session._fleet_sim(
        n_workers=sc.n_workers, gpu=sc.gpu, region=sc.region,
        steps=sc.total_steps, seed=seed, handover=sc.handover,
        provider=sc.provider)
    if chaos:
        sim.chaos = sc.timeline(sim._roster, seed=seed)
    return sim, n_steps


def _run_sim(session, sc: Scenario, engine: str, samples: int,
             seed: int) -> Dict[str, object]:
    from repro_torch.core.transient.fleet_batched import FleetDraws

    def build(chaos: bool):
        return scenario_fleet(session, sc, seed, chaos)

    sim_f, n_steps = build(chaos=True)
    truth = sim_f.chaos.truth_spans()
    # the shared-draws contract, pinned: the hazard-transformed initial
    # lifetime matrix is a pure function of (scenario, seed) — both
    # engines consume these exact values
    draws = FleetDraws(sim_f, PARITY_SAMPLES, 0.0)
    h = hashlib.sha1(json.dumps(truth, sort_keys=True).encode())
    h.update(np.ascontiguousarray(draws.initial).tobytes())
    truth_hash = h.hexdigest()

    faulted = sim_f.run_many(n_steps, samples, max_hours=sc.max_hours,
                             engine=engine, device=session.device)
    baseline = build(chaos=False)[0].run_many(
        n_steps, samples, max_hours=sc.max_hours, engine=engine,
        device=session.device)

    # two-engine parity probe on a small slice of the ensemble: the
    # requested engine (falling back to "batched" when the requested one
    # *is* the oracle) vs. the per-trajectory event loop
    probe = engine if engine != "event" else "batched"
    pa = build(chaos=True)[0].run_many(n_steps, PARITY_SAMPLES,
                                       max_hours=sc.max_hours,
                                       engine=probe, device=session.device)
    pb = build(chaos=True)[0].run_many(n_steps, PARITY_SAMPLES,
                                       max_hours=sc.max_hours,
                                       engine="event")
    counts_equal = all(
        a.revocations == b.revocations and a.replacements == b.replacements
        and a.steps_done == b.steps_done
        for a, b in zip(pa.results, pb.results))
    time_err = max(
        abs(a.total_time_s - b.total_time_s) / max(b.total_time_s, 1e-9)
        for a, b in zip(pa.results, pb.results))

    fs, bs = _ens_summary(faulted), _ens_summary(baseline)
    return {
        "engine": engine, "samples": samples,
        "truth": truth, "truth_hash": truth_hash,
        "faulted": fs, "baseline": bs,
        "impact": {
            "extra_time_s": round(fs["time_mean_s"] - bs["time_mean_s"], 6),
            "extra_cost": round(fs["cost_mean"] - bs["cost_mean"], 6),
            "extra_revocations": round(fs["revocations_mean"]
                                       - bs["revocations_mean"], 6),
            "extra_lost_steps": round(fs["lost_steps_mean"]
                                      - bs["lost_steps_mean"], 6),
        },
        "parity": {"trajectories": PARITY_SAMPLES, "engine": probe,
                   "counts_equal": counts_equal,
                   "time_max_rel_err": time_err},
    }


def _serving_summary(results) -> Dict[str, object]:
    from repro_torch.serving import summarize_serving
    return summarize_serving(results)


def _run_serving(session, sc: Scenario, engine: str, samples: int,
                 seed: int) -> Dict[str, object]:
    """Serving-fleet scorecard for scenarios carrying a `ServingScript`.

    Always runs the armed-vs-stock pair on the faulted fleet plus an
    armed fault-free baseline, so the drop-delta and p99-inflation gates
    hold in any CI invocation — arming here means the session's
    ResilienceConfig when one is set, else the defaults."""
    from repro_torch.chaos.evaluator import score_serving
    from repro_torch.resilience import ResilienceConfig
    from repro_torch.serving import ReplicaSet, ServingFleetSim

    spec = sc.serving
    armed_cfg = session.run.resilience or ResilienceConfig()

    def build(chaos: bool, resilience) -> ServingFleetSim:
        rset = ReplicaSet(spec.replicas, sc.provider, region=sc.region,
                          gpu=sc.gpu, seed=seed)
        if chaos:
            rset.chaos = sc.timeline(rset.roster(), seed=seed)
        return ServingFleetSim(
            rset, spec.workload, policy=spec.policy,
            resilience=resilience, token_time_s=spec.token_time_s,
            batch_ceiling=spec.batch_ceiling, horizon_s=spec.horizon_s,
            seed=seed)

    run_engine = engine if engine in ("batched", "event") else "batched"
    armed = build(True, armed_cfg).run_many(samples, engine=run_engine)
    stock = build(True, None).run_many(samples, engine=run_engine)
    baseline = build(False, armed_cfg).run_many(samples, engine=run_engine)

    # two-engine parity probe, same contract as the training sims: the
    # batched candidate-array engine and the per-trajectory event heap
    # must agree on every count and every latency
    probe = "batched" if run_engine == "event" else run_engine
    pa = build(True, armed_cfg).run_many(PARITY_SAMPLES, engine=probe)
    pb = build(True, armed_cfg).run_many(PARITY_SAMPLES, engine="event")
    counts_equal = all(
        (a.completed, a.shed, a.dropped_inflight, a.dropped_warned,
         a.handovers, a.requeues, a.hedges, a.revocations, a.replacements,
         a.recovery_cycles)
        == (b.completed, b.shed, b.dropped_inflight, b.dropped_warned,
            b.handovers, b.requeues, b.hedges, b.revocations,
            b.replacements, b.recovery_cycles)
        for a, b in zip(pa, pb))
    time_err = 0.0
    for a, b in zip(pa, pb):
        if a.latencies_s.shape != b.latencies_s.shape:
            counts_equal = False
            continue
        if a.latencies_s.size:
            time_err = max(time_err, float(np.max(
                np.abs(a.latencies_s - b.latencies_s)
                / np.maximum(b.latencies_s, 1e-9))))
        time_err = max(time_err,
                       abs(a.total_time_s - b.total_time_s)
                       / max(b.total_time_s, 1e-9))

    return {
        "engine": run_engine, "samples": samples,
        "replicas": spec.replicas,
        "armed": _serving_summary(armed),
        "stock": _serving_summary(stock),
        "baseline": _serving_summary(baseline),
        "impact": score_serving(armed, stock, baseline),
        "parity": {"trajectories": PARITY_SAMPLES, "engine": probe,
                   "counts_equal": counts_equal,
                   "time_max_rel_err": time_err},
    }


def _run_live(session, sc: Scenario, seed: int) -> Dict[str, object]:
    """Drive the real trainer through the scenario's `LivePlan`."""
    from repro_torch.api.session import Session

    plan = sc.live
    demand = plan.n_workers * plan.worker_speed
    healthy_cap = plan.ps_capacity_over_demand * demand
    model_bytes = session.model_bytes()
    # n_tensors=0: a pure network-bound PS whose capacity is exactly
    # ps_bw / (2 * bytes), so the sizing below is closed-form
    ps = PSBottleneckModel(model_bytes, 1, ps_bw=2.0 * model_bytes
                           * healthy_cap)
    workers = [WorkerSpec(sc.gpu, plan.worker_speed)
               for _ in range(plan.n_workers)]
    predicted = cluster_speed(workers, ps)

    child = Session(
        session.cfg,
        dataclasses.replace(session.run, total_steps=plan.n_steps,
                            warmup_steps=1, seed=seed,
                            checkpoint_interval=plan.checkpoint_interval,
                            grad_compression="none"),
        arch=session.arch, device=session.device)
    clock = VirtualClock()
    ps_factor = [1.0]
    slot_factor: Dict[int, float] = {}
    fired: set = set()

    def on_step(kind: str, payload: dict) -> None:
        tr = child.trainer
        step = payload["step"]
        for i, f in enumerate(plan.faults):
            if f.step == step and i not in fired:
                fired.add(i)
                if f.kind == "ps_crash":
                    ps_factor[0] = float(f.payload.get("capacity_factor",
                                                       0.5))
                elif f.kind == "ps_recover":
                    ps_factor[0] = 1.0
                elif f.kind == "straggler":
                    slot_factor[int(f.payload["slot"])] = float(
                        f.payload["speed_factor"])
                elif f.kind == "straggler_end":
                    slot_factor.pop(int(f.payload.get("slot", -1)), None)
                tr.inject_fault(f.kind, step=step, **dict(f.payload))
        # reality = the trainer's (healthy, possibly mitigated) belief
        # with the PS bandwidth secretly scaled and stragglers slowed —
        # mitigations the trainer applies (compression, extra PS) are
        # real and genuinely shorten recovery
        real_ps = dataclasses.replace(
            tr.ps_model, ps_bw=tr.ps_model.ps_bw * ps_factor[0])
        specs = [WorkerSpec(w.gpu, w.speed * slot_factor.get(i, 1.0))
                 for i, w in enumerate(workers)]
        sp = cluster_speed(specs, real_ps)
        clock.advance(1.0 / max(sp, 1e-9))

    child.bus.subscribe("step", on_step)
    with tempfile.TemporaryDirectory() as ckdir:
        rep = child.train(plan.n_steps, global_batch=4, seq_len=32,
                          checkpoint_dir=ckdir, resume=False,
                          predicted_speed=predicted,
                          check_every=plan.check_every,
                          ps_model=ps, workers=workers, clock=clock)
        drill = (_fallback_drill(child.trainer)
                 if child.run.resilience is not None else None)
    history = [(e.kind, e.payload) for e in child.bus.history]
    score = score_history(history, plan.truth(),
                          grace=2 * plan.check_every)
    out = {
        "n_steps": rep.steps_run,
        "virtual_seconds": round(clock.t, 6),
        "predicted_speed": predicted,
        "final_compression": child.trainer.run.grad_compression,
        "final_n_ps": child.trainer.ps_model.n_ps,
        "faults": rep.faults,
        **score,
    }
    if child.run.resilience is not None:
        # recovery scorecard (docs/resilience.md): the trainer's own
        # counters plus a post-run fallback drill — corrupt the newest
        # committed checkpoint and require the validated restore to land
        # on the previous good generation, never on torn state
        out["recovery"] = {**score["recovery"],
                           "retries": rep.retries,
                           "recovered_saves": rep.recovered_saves,
                           "save_failures": rep.checkpoint_failures,
                           "fallback_depth": rep.fallback_depth,
                           "paused_steps": rep.paused_steps,
                           "fallback_drill": drill}
    if child.run.recalibration is not None:
        # drift scorecard (docs/calibration.md): the refit ledger plus the
        # first check *after* the last refit — if the refit worked, that
        # deviation is back inside the controller threshold while the
        # fault is still active
        post_dev = None
        if rep.refits:
            last = rep.refits[-1]["step"]
            after = [p["deviation"] for k, p in history
                     if k == "detection" and p["step"] > last
                     and p.get("deviation") is not None]
            if after:
                post_dev = round(float(after[0]), 6)
        out["recalibration"] = {
            "drift_events": rep.drift_events,
            "refits": rep.refits,
            "model_version": child.trainer.controller.model_version,
            "post_refit_deviation": post_dev,
        }
    return out


def _fallback_drill(trainer) -> Dict[str, object]:
    """Corrupt the newest checkpoint on disk and prove
    `restore_latest_valid` falls back to the previous valid generation
    (the zero-torn-state-loads guarantee, exercised end-to-end). The
    restore template is the trainer's last state moved to the meta device:
    its shapes and dtypes, and no second allocation of the weights."""
    steps = trainer.ckpt.all_steps()
    if len(steps) < 2:
        return {"ok": None, "reason": f"{len(steps)} checkpoint(s) on "
                                      "disk; drill needs 2"}
    trainer.ckpt.corrupt(steps[-1])
    template = _rebuild(trainer.state, lambda _key, t: t.to("meta"))
    try:
        _tree, got, depth = trainer.ckpt.restore_latest_valid(template)
    except Exception as exc:  # noqa: BLE001 — scored, not raised
        return {"ok": False, "corrupted_step": steps[-1],
                "error": f"{type(exc).__name__}: {exc}"}
    return {"ok": bool(got == steps[-2] and depth >= 1),
            "corrupted_step": steps[-1], "restored_step": got,
            "fallback_depth": depth}


def _check_expectations(sc: Scenario, card: Dict[str, object]) -> List[str]:
    """Evaluate the scenario's smoke gates; returns failure strings."""
    fails: List[str] = []
    exp = sc.expect

    def gate(key, ok, detail):
        if key in exp and not ok(exp[key]):
            fails.append(f"{key}={exp[key]}: {detail}")

    serving = card.get("serving")
    if serving is not None:
        if not serving["parity"]["counts_equal"]:
            fails.append("serving parity: per-trajectory counts differ")
        if serving["parity"]["time_max_rel_err"] > 1e-6:
            fails.append("serving parity: latencies diverge "
                         f"({serving['parity']['time_max_rel_err']:.2e})")
        simp = serving["impact"]
        gate("serving_zero_dropped_warned",
             lambda v: (not v) or simp["armed_dropped_warned"] == 0,
             f"got {simp['armed_dropped_warned']} armed warned drops")
        gate("serving_min_armed_drop_delta",
             lambda v: simp["drop_delta"] >= v,
             f"got {simp['drop_delta']}")
        gate("serving_max_p99_inflation",
             lambda v: simp["p99_inflation"] <= v,
             f"got {simp['p99_inflation']}")
        gate("serving_min_degraded_cycles",
             lambda v: simp["recovery_cycles_total"] >= v,
             f"got {simp['recovery_cycles_total']}")

    sim = card["sim"]
    if sim is None:                 # serving-only scenario: no fleet sim
        return fails
    imp = sim["impact"]
    if not sim["parity"]["counts_equal"]:
        fails.append("engine parity: per-trajectory counts differ")
    if sim["parity"]["time_max_rel_err"] > 1e-6:
        fails.append("engine parity: times diverge "
                     f"({sim['parity']['time_max_rel_err']:.2e})")

    gate("min_extra_revocations", lambda v: imp["extra_revocations"] >= v,
         f"got {imp['extra_revocations']}")
    gate("max_extra_revocations", lambda v: imp["extra_revocations"] <= v,
         f"got {imp['extra_revocations']}")
    gate("min_extra_time_s", lambda v: imp["extra_time_s"] >= v,
         f"got {imp['extra_time_s']}")
    gate("min_extra_lost_steps", lambda v: imp["extra_lost_steps"] >= v,
         f"got {imp['extra_lost_steps']}")

    if card.get("resilience_armed"):
        # resilient_* gates fire only when the run was armed with a
        # ResilienceConfig (the plain CI chaos sweep skips them)
        fs = sim["faulted"]
        gate("resilient_min_paused_s",
             lambda v: fs["paused_s_mean"] >= v,
             f"got {fs['paused_s_mean']}")
        gate("resilient_min_restore_delay_s",
             lambda v: fs["restore_delay_s_mean"] >= v,
             f"got {fs['restore_delay_s_mean']}")

    live = card.get("live")
    if live is None:        # live gates only apply when the live run ran
        return fails
    gate("live_detected_all", lambda v: (not v)
         or live["missed_detections"] == 0,
         f"missed {live['missed_detections']}")
    gate("live_max_latency_steps",
         lambda v: live["detection_latency_steps"] is not None
         and live["detection_latency_steps"] <= v,
         f"got {live['detection_latency_steps']}")
    gate("live_actions", lambda v: live["actions_applied"] == list(v),
         f"got {live['actions_applied']}")
    gate("live_final_compression", lambda v: live["final_compression"] == v,
         f"got {live['final_compression']}")
    gate("live_max_false_alarms", lambda v: live["false_alarms"] <= v,
         f"got {live['false_alarms']}")
    gate("live_max_wrong_actions", lambda v: live["wrong_actions"] <= v,
         f"got {live['wrong_actions']}")
    gate("live_min_ckpt_failures",
         lambda v: live["checkpoint_failures"] >= v,
         f"got {live['checkpoint_failures']}")
    rec = live.get("recovery")
    if card.get("resilience_armed") and rec is not None:
        gate("resilient_live_min_retries",
             lambda v: rec["retries"] >= v, f"got {rec['retries']}")
        gate("resilient_live_min_recovered_saves",
             lambda v: rec["recovered_saves"] >= v,
             f"got {rec['recovered_saves']}")
        gate("resilient_drill_ok",
             lambda v: (not v) or rec["fallback_drill"]["ok"] is True,
             f"got {rec['fallback_drill']}")
        # a silent save failure would show as checkpoint_failed events
        # without matching gave_up retry records — require the ledger to
        # balance whenever any save failed
        if rec["save_failures"] > rec["gave_up"]:
            fails.append("recovery ledger: "
                         f"{rec['save_failures']} save failure(s) but only "
                         f"{rec['gave_up']} exhausted-retry record(s)")
    recal = live.get("recalibration")
    if card.get("recalibration_armed") and recal is not None:
        # recalib_* gates fire only when the run was armed with a
        # RecalibrationConfig (the plain CI chaos sweep skips them)
        gate("recalib_min_drift_events",
             lambda v: len(recal["drift_events"]) >= v,
             f"got {len(recal['drift_events'])}")
        gate("recalib_min_refits", lambda v: len(recal["refits"]) >= v,
             f"got {len(recal['refits'])}")
        gate("recalib_max_post_refit_deviation",
             lambda v: recal["post_refit_deviation"] is not None
             and abs(recal["post_refit_deviation"]) <= v,
             f"got {recal['post_refit_deviation']}")
    return fails


def run_scenario(sc: Scenario, *, session=None, engine: str = "batched",
                 live: bool = True, samples: int = 32, seed: int = 0,
                 smoke: bool = False) -> Dict[str, object]:
    """One scenario -> one scorecard dict (see the module docstring)."""
    if session is None:
        from repro_torch.api.session import Session
        session = Session.from_arch("qwen3-1.7b", smoke=True)
    card: Dict[str, object] = {
        "scenario": sc.name, "description": sc.description, "seed": seed,
        "resilience_armed": session.run.resilience is not None,
        "recalibration_armed": session.run.recalibration is not None,
        # serving scenarios script faults over a ReplicaSet, not a
        # training fleet — the per-worker training sim would be noise
        "sim": (None if sc.serving is not None
                else _run_sim(session, sc, engine, samples, seed)),
        "serving": (_run_serving(session, sc, engine, samples, seed)
                    if sc.serving is not None else None),
        "live": (_run_live(session, sc, seed)
                 if live and sc.live is not None else None),
    }
    if smoke:
        fails = _check_expectations(sc, card)
        card["smoke"] = {"passed": not fails, "failures": fails}
    return card


def run_scenarios(scenario: str = "all", *, session=None,
                  engine: str = "batched", live: bool = True,
                  samples: int = 32, seed: int = 0, smoke: bool = False,
                  progress: Optional[Callable[[str], None]] = None
                  ) -> Dict[str, object]:
    """Run one registered scenario (or all of them) -> full scorecard."""
    names = list_scenarios() if scenario == "all" else [scenario]
    cards = {}
    for name in names:
        if progress:
            progress(f"chaos: running scenario {name}")
        cards[name] = run_scenario(get_scenario(name), session=session,
                                   engine=engine, live=live,
                                   samples=samples, seed=seed, smoke=smoke)
    out = {"engine": engine, "samples": samples, "seed": seed,
           "scenarios": cards}
    if smoke:
        out["passed"] = all(c["smoke"]["passed"] for c in cards.values())
    return out
