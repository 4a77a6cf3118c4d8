"""Table V + Figs 8-9 — revocation characterization from the calibrated
fleet sampler: 12 non-consecutive days of batch requests per (region, GPU);
revocation rates, mean-time-to-revocation, and the diurnal histogram.

The port's twin of `benchmarks/table5_revocations.py`.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core.transient.revocation import (REGION_GPU_PARAMS, TABLE5_RATES,
                                             RevocationSampler)


def run():
    out = []
    samp = RevocationSampler(seed=7)
    rates_err = []
    for (region, gpu), paper_rate in sorted(TABLE5_RATES.items()):
        if paper_rate is None:
            continue
        n = 30 * 12  # 30 servers per batch x 12 days
        lts = [samp.lifetime(region, gpu, start_hour=(d * 7) % 24)
               for d in range(n)]
        revoked = [t for t in lts if math.isfinite(t)]
        rate = len(revoked) / n
        mttr = float(np.mean(revoked)) if revoked else float("nan")
        rates_err.append(abs(rate - paper_rate))
        out.append({"name": f"table5/{region}/{gpu}",
                    "value": round(rate, 4),
                    "derived": f"paper={paper_rate:.4f} mttr={mttr:.1f}h "
                               f"model_mttr="
                               f"{REGION_GPU_PARAMS[(region,gpu)].mean_time_to_revocation():.1f}h"})
    out.append({"name": "table5/mean_abs_rate_error",
                "value": round(float(np.mean(rates_err)), 4),
                "derived": "vs paper Table V"})
    # fig 9: no V100 revocations between 4PM and 8PM local
    v100 = REGION_GPU_PARAMS[("us-central1", "v100")]
    rng = np.random.default_rng(3)
    hours = []
    for _ in range(400):
        start = rng.uniform(0, 24)
        t = v100.sample(rng, 1, start_hour=start)[0]
        if math.isfinite(t):
            hours.append((start + t) % 24)  # absolute local hour of revocation
    quiet = sum(1 for h in hours if 16 <= h < 20)
    out.append({"name": "fig9/v100_quiet_window_revocations",
                "value": quiet, "derived": "expected ~0 in 4PM-8PM"})
    return out


if __name__ == "__main__":
    for r in run():
        print(r)
