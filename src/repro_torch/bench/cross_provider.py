"""Beyond-paper: the same workload priced across three transient markets.

The paper's cost/overhead analysis (§V-§VI) is single-cloud; with the
`FleetProvider` layer the identical Eq (4) + fleet-simulation machinery
runs over GCP preemptible, AWS spot and Azure low-priority offerings, so
this benchmark answers the planning question the ROADMAP's provider item
poses: for a fixed training job, which market finishes it cheapest, and
what does the revocation/replacement overhead difference cost in time?

Per (provider, gpu): the §V-C planner's best (region, launch-hour) cell
(expected cost/time via Eq 4) and a fleet-simulation *ensemble*
(`FleetSim.run_many`, pre-drawn batched lifetimes) of that best cell —
mean plus p90 of realized cost/time/revocations.

The port's twin of `benchmarks/cross_provider.py`.
"""
from __future__ import annotations

from repro_torch.bench.fleet_common import (I_C, N_W, N_WORKERS, T_C,
                                     best_cell_ensemble)
from repro_torch.core.perf_model.speed_model import TABLE1_MODELS, calibrate_generators
from repro_torch.core.scheduler import plan_launch
from repro_torch.providers import available_providers, get_provider


def run():
    gens = calibrate_generators()
    c_m = TABLE1_MODELS["resnet_32"]
    out = []
    for name in available_providers():
        prov = get_provider(name)
        for gpu in prov.gpus():
            if gpu not in gens:
                continue
            sp = 1.0 / gens[gpu].step_time(c_m)
            best, plans = plan_launch(gpu, N_WORKERS, sp, n_w=N_W, i_c=I_C,
                                      t_c=T_C, hours=[0, 6, 12, 18],
                                      provider=prov)
            st = best_cell_ensemble(prov, gpu, best.region, sp,
                                    float(best.launch_hour))
            out.append({
                "name": f"cross_provider/{name}/{gpu}x{N_WORKERS}",
                "value": round(best.expected_cost, 2),
                "derived": (
                    f"best={best.region}@{best.launch_hour:02d}h "
                    f"E[time]={best.expected_time_s / 3600:.2f}h "
                    f"E[rev]={best.expected_revocations:.2f}"
                    f"±{best.revocation_stderr:.2f}; simulated (n={st.n}) "
                    f"${st.cost_mean:.2f}/{st.time_mean_s / 3600:.2f}h "
                    f"p90 ${st.cost_p90:.2f}/{st.time_p90_s / 3600:.2f}h "
                    f"rev={st.revocations_mean:.1f} @ ${prov.price(gpu)}/h "
                    f"(best-cell expected cost $)"),
            })
    return out


if __name__ == "__main__":
    for r in run():
        print(r)
