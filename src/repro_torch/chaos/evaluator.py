"""Ground-truth scoring of the detection/mitigation loop (docs/chaos.md).

`score_history` replays an `EventBus` history (the `(kind, payload)`
tuples a live chaos run recorded) against the scenario's ground-truth
fault spans and scores what the Controller actually did:

* **detection latency** — steps from a fault's start to the first
  bottleneck=True `detection` event inside the span;
* **missed detections** — spans that expect a detection but never got one
  inside `[start, end + grace]` (`grace` forgives the measurement decay
  right after a fault ends: the profiler averages over history, so the
  deviation needs a few checks to wash out);
* **false alarms** — bottleneck detections outside every span+grace;
* **wrong actions** — detections whose recommended action is not in the
  covering span's expected set (a PS lever pulled on a straggler, say);
* **mitigation/checkpoint accounting** — actions applied, checkpoint
  saves failed during outage spans;
* **recovery accounting** — the resilience layer's `retry`,
  `restore_fallback`, `degradation` and `lease_handover` events
  (docs/resilience.md) summarized into the `recovery` block: attempts,
  backoff seconds slept, exhausted retries, fallback restores and
  degradation-tier transitions (all zero when resilience is off).

Spans whose kind has an empty expected-action set (checkpoint outages:
nothing speed-visible to detect) do not count toward detection scoring.

The port's copy of the JAX package's `chaos/evaluator.py`.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

#: Controller actions that are a correct response to each fault kind.
#: `ps_crash` walks the §VI-B ladder; a straggler should be flagged as an
#: under-performing worker (replacement — not a PS lever); a checkpoint
#: outage is invisible to the speed controller (detections not expected).
EXPECTED_ACTIONS: Dict[str, Tuple[str, ...]] = {
    "ps_crash": ("enable_compression", "add_parameter_server"),
    "straggler": ("replace_worker", "request_replacement"),
    "ckpt_outage": (),
}

#: Fault kinds the speed controller is expected to *detect* at all.
DETECTABLE = ("ps_crash", "straggler")


def score_serving(armed: List, stock: List, baseline: List
                  ) -> Dict[str, object]:
    """Score a serving-fleet chaos run (docs/serving.md).

    `armed`/`stock` are `ServingSimResult` lists from the *faulted*
    ensemble with resilience on/off; `baseline` is the armed fleet with
    no faults (the p99 reference). Returns the `serving.impact` block the
    serve_wave smoke gates read:

    * **armed_dropped_warned** — in-flight requests lost to *warned*
      revocations with resilience armed; the drain+handover contract says
      this is exactly zero.
    * **drop_delta** — stock minus armed mean in-flight drops: what
      arming the gateway saved.
    * **p99_inflation** — armed faulted p99 over armed fault-free p99;
      admission control bounds this (a queued request sheds at its budget
      instead of waiting unboundedly).
    * **recovery_cycles_total** — degraded→full tier transitions summed
      over the armed ensemble (each is one full degrade/recover arc).
    """
    import numpy as np

    def pool_p99(results):
        lat = np.concatenate([r.latencies_s for r in results])
        return float(np.percentile(lat, 99)) if lat.size else float("inf")

    def drop_mean(results):
        return float(np.mean([r.dropped_inflight for r in results]))

    p99_f, p99_b = pool_p99(armed), pool_p99(baseline)
    return {
        "armed_dropped_warned": int(sum(r.dropped_warned for r in armed)),
        "stock_dropped_warned": int(sum(r.dropped_warned for r in stock)),
        "drop_delta": round(drop_mean(stock) - drop_mean(armed), 6),
        "p99_faulted_s": round(p99_f, 6),
        "p99_baseline_s": round(p99_b, 6),
        "p99_inflation": round(p99_f / max(p99_b, 1e-9), 6),
        "recovery_cycles_total": int(sum(r.recovery_cycles
                                         for r in armed)),
        "degraded_events_total": int(sum(len(r.degraded_events)
                                         for r in armed)),
    }


def score_history(history: Iterable[Tuple[str, dict]],
                  truth: List[dict], grace: float = 0.0) -> Dict[str, object]:
    """Score one live run. `history` is `[(kind, payload), ...]` in emit
    order; `truth` is `LivePlan.truth()` output (`start_step`/`end_step`
    spans). Returns a JSON-serializable scorecard fragment."""
    history = list(history)
    detections = [p for k, p in history
                  if k == "detection" and p.get("bottleneck")]
    mitigations = [p for k, p in history if k == "mitigation"]
    ckpt_failed = [p for k, p in history if k == "checkpoint_failed"]
    faults_seen = [p for k, p in history if k == "fault"]
    retry_ev = [p for k, p in history if k == "retry"]
    fallbacks = [p for k, p in history if k == "restore_fallback"]
    degradations = [p for k, p in history if k == "degradation"]
    handovers = [p for k, p in history if k == "lease_handover"]

    def covering(step: float) -> Optional[dict]:
        for span in truth:
            if span["start_step"] <= step <= span["end_step"] + grace:
                return span
        return None

    spans_out: List[dict] = []
    missed = 0
    latencies: List[float] = []
    for span in truth:
        entry = dict(span)
        if span["kind"] in DETECTABLE:
            hits = [d["step"] for d in detections
                    if span["start_step"] <= d["step"]
                    <= span["end_step"] + grace]
            entry["detected"] = bool(hits)
            if hits:
                entry["detection_latency_steps"] = hits[0] - span["start_step"]
                latencies.append(entry["detection_latency_steps"])
            else:
                missed += 1
        if span["kind"] == "ckpt_outage":
            entry["checkpoint_failures"] = sum(
                1 for p in ckpt_failed
                if span["start_step"] <= p["step"] <= span["end_step"])
        spans_out.append(entry)

    false_alarms = sum(1 for d in detections if covering(d["step"]) is None)
    wrong = 0
    judged = 0
    for d in detections:
        span = covering(d["step"])
        expected = EXPECTED_ACTIONS.get(span["kind"]) if span else None
        if not expected:          # uncovered or action-less span kind
            continue
        judged += 1
        if d.get("action") not in expected + ("none",):
            wrong += 1

    return {
        "spans": spans_out,
        "detections": len(detections),
        "missed_detections": missed,
        "false_alarms": false_alarms,
        "detection_latency_steps": (min(latencies) if latencies else None),
        "wrong_actions": wrong,
        "wrong_action_rate": (wrong / judged) if judged else 0.0,
        "actions_applied": [m["action"] for m in mitigations],
        "checkpoint_failures": len(ckpt_failed),
        "faults_injected": len(faults_seen),
        "recovery": {
            "retry_attempts": len(retry_ev),
            "retried": sum(1 for p in retry_ev
                           if p.get("outcome") == "fail"),
            "gave_up": sum(1 for p in retry_ev
                           if p.get("outcome") == "gave_up"),
            "backoff_seconds": round(sum(p.get("backoff_s", 0.0)
                                         for p in retry_ev), 6),
            "restore_fallbacks": len(fallbacks),
            "degradation_tiers": [p.get("tier") for p in degradations],
            "lease_handovers": len(handovers),
        },
    }
