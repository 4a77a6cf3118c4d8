"""Figs 6-7 — transient startup time: stage breakdown (provisioning/staging/
running) per GPU, transient vs on-demand, and post-revocation variance.

The port's twin of `benchmarks/fig6_startup.py`.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.transient.startup import StartupModel


def run():
    m = StartupModel(seed=0)
    out = []
    for gpu in ("k80", "p100", "v100"):
        for transient in (True, False):
            s = [m.sample(gpu, transient)["total"] for _ in range(50)]
            kind = "transient" if transient else "ondemand"
            out.append({"name": f"fig6/{gpu}/{kind}",
                        "value": round(float(np.mean(s)), 2),
                        "derived": f"std={np.std(s):.2f} "
                                   f"under100s={int(np.mean(s) < 100)}"})
    # fig 7: immediate vs delayed request CoV after a revocation
    for gpu in ("k80", "p100", "v100"):
        imm = [m.sample(gpu, True, after_revocation=True)["total"]
               for _ in range(100)]
        dl = [m.sample(gpu, True, after_revocation=False)["total"]
              for _ in range(100)]
        cov_i = float(np.std(imm) / np.mean(imm))
        cov_d = float(np.std(dl) / np.mean(dl))
        out.append({"name": f"fig7/{gpu}/immediate_vs_delayed",
                    "value": round(cov_i / max(cov_d, 1e-9), 2),
                    "derived": f"cov_imm={cov_i:.3f} cov_delay={cov_d:.3f} "
                               f"mean_diff={abs(np.mean(imm)-np.mean(dl)):.1f}s"})
    return out


if __name__ == "__main__":
    for r in run():
        print(r)
