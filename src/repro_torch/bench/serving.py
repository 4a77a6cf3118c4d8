"""Serving-gateway scorecard as benchmark rows (docs/serving.md).

Three blocks:

* ``serving/gateway_*`` — the real-model continuous-batching gateway on
  the smoke config: decode throughput plus per-token p50/p95/p99 wall
  latency from `ServeReport`.
* ``serving/serve_wave`` — the chaos serving scenario's armed-vs-stock
  delta: in-flight drops saved, warned drops (must be 0 armed), p99
  inflation over the fault-free baseline, recovery cycles, engine-parity
  error.
* ``serving/plan`` — the SLO-aware fleet planner's best cell for a small
  workload ($/1k completed requests).

The port's twin of `benchmarks/serving.py`: the gateway decodes on the
device (the card unless ``device="cpu"``); `serve_wave` and the plan are
host NumPy on every device.
"""
from __future__ import annotations

from repro_torch.api.session import Session
from repro_torch.chaos import get_scenario, run_scenario
from repro_torch.device import DeviceLike
from repro_torch.serving import ServingWorkload

SAMPLES = 8
SEED = 0


def run(device: DeviceLike = None):
    session = Session.from_arch("qwen3-1.7b", smoke=True, device=device)
    out = []

    rep = session.serve(tokens=16, batch=4, prompt_len=8)
    out.append({"name": "serving/gateway_tokens_per_s",
                "value": round(rep.tokens_per_second, 1),
                "derived": f"decode p50={rep.decode_ms_p50:.2f}ms "
                           f"p95={rep.decode_ms_p95:.2f}ms "
                           f"p99={rep.decode_ms_p99:.2f}ms "
                           f"(batch={rep.batch})"})

    card = run_scenario(get_scenario("serve_wave"), session=session,
                        samples=SAMPLES, seed=SEED, smoke=True, live=False)
    srv = card["serving"]
    imp = srv["impact"]
    out.append({"name": "serving/serve_wave",
                "value": imp["drop_delta"],
                "derived": f"armed_warned_drops={imp['armed_dropped_warned']} "
                           f"p99_inflation={imp['p99_inflation']:.2f}x "
                           f"recovery_cycles={imp['recovery_cycles_total']} "
                           f"parity_err="
                           f"{srv['parity']['time_max_rel_err']:.1e} "
                           f"smoke="
                           f"{'pass' if card['smoke']['passed'] else 'FAIL'}"
                           " (in-flight drops saved vs stock)"})

    best, plans = session.plan_serving(
        replica_counts=(2, 4), providers=("gcp", "aws"),
        workload=ServingWorkload(n_requests=120, arrival_rate_per_s=2.0,
                                 max_tokens=16),
        samples=4, seed=SEED)
    out.append({"name": "serving/plan",
                "value": round(best.cost_per_1k, 4),
                "derived": f"best={best.provider}/{best.region} "
                           f"x{best.replicas} "
                           f"slo={'ok' if best.meets_slo else 'miss'} "
                           f"p99={best.latency_p99_s:.3f}s of "
                           f"{len(plans)} cells ($/1k requests)"})
    return out
