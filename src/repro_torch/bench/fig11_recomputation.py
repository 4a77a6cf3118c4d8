"""Fig 11 — TensorFlow-specific recomputation overhead: revoke the chief 1K
steps after a checkpoint; vary replacement timing; compare stock (reuse chief
identity -> recompute from last checkpoint) vs CM-DARE handover (bounded by
the checkpoint interval, overhead ~ 0 here).

The port's twin of `benchmarks/fig11_recomputation.py`.
"""
from __future__ import annotations

from repro_torch.core.perf_model.speed_model import TABLE1_MODELS, calibrate_generators
from repro_torch.core.transient.replacement import recomputation_overhead_s


def run():
    gens = calibrate_generators()
    sp2 = 2.0 / gens["k80"].step_time(TABLE1_MODELS["resnet_15"])  # 2x K80
    sp1 = sp2 / 2.0
    out = []
    for replace_after_s in (0, 60, 120, 240):
        # stock: replacement inherits chief IP -> cluster redoes 1k steps
        stock = recomputation_overhead_s(1000, sp1, reuse_chief_identity=True)
        dare = recomputation_overhead_s(1000, sp1, reuse_chief_identity=False)
        out.append({"name": f"fig11/replace_after_{replace_after_s}s",
                    "value": round(stock, 1),
                    "derived": f"handover={dare:.1f}s "
                               f"savings={stock - dare:.1f}s"})
    # bound: recompute can never exceed I_c / speed
    i_c = 4000
    bound = i_c / sp1
    out.append({"name": "fig11/bound_checkpoint_interval_s",
                "value": round(bound, 1),
                "derived": f"I_c={i_c} steps at {sp1:.2f} steps/s; paper ~224s "
                           "at its cluster speed"})
    return out


if __name__ == "__main__":
    for r in run():
        print(r)
