"""Chaos scenario scorecard as benchmark rows: per-scenario recovery cost
(extra wall-clock / $ / revocations vs an unfaulted baseline on the same
draws) plus the live detection/mitigation quality numbers (docs/chaos.md).

The port's twin of `benchmarks/chaos.py`: the live runs train on the
device (the card unless ``device="cpu"``).
"""
from __future__ import annotations

from repro_torch.api.session import Session
from repro_torch.chaos import get_scenario, list_scenarios, run_scenario
from repro_torch.device import DeviceLike

SAMPLES = 8
SEED = 0


def run(device: DeviceLike = None):
    session = Session.from_arch("qwen3-1.7b", smoke=True, device=device)
    out = []
    for name in list_scenarios():
        card = run_scenario(get_scenario(name), session=session,
                            samples=SAMPLES, seed=SEED, smoke=True)
        if card["sim"] is None:
            # serving scenario: scored by bench/serving.py
            continue
        imp = card["sim"]["impact"]
        par = card["sim"]["parity"]
        derived = (f"+${imp['extra_cost']:.2f} "
                   f"+{imp['extra_revocations']:.2f} revocations "
                   f"parity_err={par['time_max_rel_err']:.1e} "
                   f"smoke={'pass' if card['smoke']['passed'] else 'FAIL'}")
        live = card["live"]
        if live is not None:
            derived += (f" live[latency={live['detection_latency_steps']} "
                        f"missed={live['missed_detections']} "
                        f"false={live['false_alarms']} "
                        f"wrong={live['wrong_actions']} "
                        f"compression={live['final_compression']}]")
        out.append({"name": f"chaos/{name}",
                    "value": round(imp["extra_time_s"], 1),
                    "derived": derived + " (extra seconds vs baseline)"})
    return out
