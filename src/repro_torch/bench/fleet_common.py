"""Shared fleet-simulation workload for the planner benchmarks.

`scheduler_gains.py` and `cross_provider.py` both validate a planner's
best (region, launch-hour) cell with the same ensemble recipe — one
ResNet-32 x 4-worker job, simulated `ENSEMBLE_N` times via
`FleetSim.run_many` (pre-drawn batched lifetimes). Keeping the recipe
here means the two benchmarks can never silently diverge on the
workload they report.

The port's twin of `benchmarks/fleet_common.py`.
"""
from __future__ import annotations

from repro_torch.core.perf_model.speed_model import TABLE1_MODELS
from repro_torch.core.transient.fleet import FleetSim, SimStats, SimWorker
from repro_torch.models import cnn
from repro_torch.providers import get_provider

# ResNet-32 at 4 workers, sized so the ~4-8 h wall-clock actually exposes
# each market's revocation behavior (same workload for every provider).
N_W = 256_000
I_C = 4_000
T_C = 3.84
N_WORKERS = 4
ENSEMBLE_N = 16


def best_cell_ensemble(provider, gpu: str, region: str, sp: float,
                       launch_hour: float, n_workers: int = N_WORKERS,
                       n: int = ENSEMBLE_N) -> SimStats:
    """Simulated distribution of the shared workload in one launch cell."""
    prov = get_provider(provider)
    workers = [SimWorker(i, gpu, region, sp) for i in range(n_workers)]
    sim = FleetSim(workers, model_gflops=TABLE1_MODELS["resnet_32"],
                   model_bytes=4.0 * cnn.param_count(cnn.RESNET_32),
                   step_speed_of=lambda g: sp,
                   checkpoint_interval_steps=I_C, checkpoint_time_s=T_C,
                   seed=0, price_of={gpu: prov.price(gpu)}, provider=prov)
    return sim.run_many(N_W, n, max_hours=100.0,
                        start_hour=launch_hour).stats
