"""Beyond-paper (§V-C future work, built): revocation-aware launch planning —
how much expected time/cost does choosing the right (region, launch hour)
save vs the worst naive choice? The best cell is then validated with a
`FleetSim.run_many` ensemble (pre-drawn batched lifetimes): the planner's
Eq (4) expectation should sit inside the simulated distribution.

The port's twin of `benchmarks/scheduler_gains.py`.
"""
from __future__ import annotations

from repro_torch.bench.fleet_common import I_C, N_W, T_C, best_cell_ensemble
from repro_torch.core.perf_model.speed_model import TABLE1_MODELS, calibrate_generators
from repro_torch.core.scheduler import plan_launch


def run():
    gens = calibrate_generators()
    c_m = TABLE1_MODELS["resnet_32"]
    out = []
    for gpu, n in (("k80", 4), ("v100", 4)):
        sp = 1.0 / gens[gpu].step_time(c_m)
        best, plans = plan_launch(gpu, n, sp, n_w=N_W, i_c=I_C, t_c=T_C)
        worst = max(plans, key=lambda p: p.expected_cost)
        time_save = (worst.expected_time_s - best.expected_time_s) \
            / worst.expected_time_s * 100
        cost_save = (worst.expected_cost - best.expected_cost) \
            / worst.expected_cost * 100
        st = best_cell_ensemble("gcp", gpu, best.region, sp,
                                float(best.launch_hour), n_workers=n)
        out.append({
            "name": f"scheduler/{gpu}x{n}",
            "value": round(cost_save, 1),
            "derived": (f"best={best.region}@{best.launch_hour:02d}h "
                        f"E[rev]={best.expected_revocations:.2f}"
                        f"±{best.revocation_stderr:.2f} "
                        f"vs worst={worst.region}@{worst.launch_hour:02d}h "
                        f"E[rev]={worst.expected_revocations:.2f}; "
                        f"time saved {time_save:.1f}%; best-cell ensemble "
                        f"(n={st.n}) time p50={st.time_p50_s / 3600:.2f}h "
                        f"p90={st.time_p90_s / 3600:.2f}h (cost saved %)"),
        })
    return out


if __name__ == "__main__":
    for r in run():
        print(r)
