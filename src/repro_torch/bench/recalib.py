"""Online-recalibration benchmark (docs/calibration.md): the straggler
live scenario unarmed vs armed.

Unarmed, the controller keeps comparing measurement against the stale
static prediction for the whole fault window — every post-detection check
re-flags the same deviation. Armed, CUSUM confirms the drift, the
cluster-speed estimator refits from profiler history, and the very next
check lands back inside the 6.7 % threshold while the straggler is still
active; rows report the refit ledger and the post-refit deviation, plus
both runs' detection/mitigation quality (which recalibration must not
degrade: no false alarms, no wrong PS levers for a straggler).

The port's twin of `benchmarks/recalib.py`: both live runs train on the
device (the card unless ``device="cpu"``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.api.session import Session
from repro_torch.calibration import RecalibrationConfig
from repro_torch.chaos import get_scenario
from repro_torch.chaos.runner import _run_live
from repro_torch.device import DeviceLike

SEED = 0


def _live(armed: bool, device: DeviceLike = None) -> dict:
    session = Session.from_arch("qwen3-1.7b", smoke=True, device=device)
    if armed:
        session.run = dataclasses.replace(
            session.run, recalibration=RecalibrationConfig())
    return _run_live(session, get_scenario("straggler"), seed=SEED)


def run(device: DeviceLike = None):
    out = []
    unarmed = _live(armed=False, device=device)
    armed = _live(armed=True, device=device)
    for label, live in (("unarmed", unarmed), ("armed", armed)):
        out.append({
            "name": f"recalib/straggler_{label}/detections",
            "value": live["detections"],
            "derived": (f"latency={live['detection_latency_steps']} "
                        f"missed={live['missed_detections']} "
                        f"false={live['false_alarms']} "
                        f"wrong={live['wrong_actions']} "
                        f"actions={live['actions_applied']}")})
    assert "recalibration" not in unarmed, \
        "unarmed run must not carry a recalibration scorecard"
    recal = armed["recalibration"]
    out.append({"name": "recalib/straggler_armed/refits",
                "value": len(recal["refits"]),
                "derived": (f"drift_events={len(recal['drift_events'])} "
                            f"model_version={recal['model_version']} "
                            + " ".join(
                                f"v{r['model_version']}:"
                                f"{r['old_speed']:.1f}->{r['new_speed']:.1f}"
                                for r in recal["refits"]))})
    out.append({"name": "recalib/straggler_armed/post_refit_deviation",
                "value": (round(abs(recal["post_refit_deviation"]), 4)
                          if recal["post_refit_deviation"] is not None
                          else float("nan")),
                "derived": "abs deviation at the first check after the "
                           "last refit (controller threshold 0.067)"})
    return out
