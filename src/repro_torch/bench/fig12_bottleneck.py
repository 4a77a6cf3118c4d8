"""Fig 12 / §VI-B — detect the PS bottleneck (predicted-vs-measured deviation
over the 6.7% threshold) and mitigate: add a second parameter server (the
paper reports up to 70.6% speed improvement) or compress the update
payload (docs/DESIGN.md §6) — the int8 rows show the compression lever
helps network-bound models and leaves RPC-bound ones (ResNet-32's 97
tensors) flat.

The port's twin of `benchmarks/fig12_bottleneck.py`.
"""
from __future__ import annotations

from repro_torch.bench._common import cnn_leaves
from repro_torch.core.controller import Action, Controller
from repro_torch.core.perf_model.cluster_model import PSBottleneckModel, WorkerSpec, cluster_speed
from repro_torch.core.perf_model.speed_model import TABLE1_MODELS, calibrate_generators
from repro_torch.core.profiler import PerformanceProfiler
from repro_torch.models import cnn


def run():
    gens = calibrate_generators()
    out = []
    for model in ("resnet_15", "resnet_32"):
        c_m = TABLE1_MODELS[model]
        spec = cnn.RESNET_15 if model == "resnet_15" else cnn.RESNET_32
        mb = 4.0 * cnn.param_count(spec)
        nt = cnn_leaves(spec)
        solo = 1.0 / gens["p100"].step_time(c_m)
        for n in (4, 6, 8):
            workers = [WorkerSpec("p100", solo)] * n
            ps1 = PSBottleneckModel(mb, 1, n_tensors=nt)
            measured = cluster_speed(workers, ps1)          # what profiler sees
            predicted = sum(w.speed for w in workers)       # sp = Σ sp_i
            # feed the profiler a synthetic measurement trace
            prof = PerformanceProfiler(window=2, warmup_steps=0,
                                       warmup_seconds=0.0)
            t = 0.0
            for s in range(8):
                prof.record(s, t=t)
                t += 1.0 / measured
            ctrl = Controller()
            det = ctrl.check(prof, predicted, ps1, workers)
            improved = cluster_speed(workers, ctrl.mitigate_ps(ps1))
            gain = (improved - measured) / measured * 100
            out.append({
                "name": f"fig12/{model}/p100x{n}",
                "value": round(gain, 1),
                "derived": (f"detected={det.bottleneck} action={det.action.value} "
                            f"speed {measured:.2f}->{improved:.2f} steps/s "
                            f"(gain %)"),
            })
            # the other §VI-B lever: int8 payload, no extra server
            ps8 = ctrl.mitigate_compression(ps1, "int8")
            comp = cluster_speed(workers, ps8)
            out.append({
                "name": f"fig12/{model}/p100x{n}/int8",
                "value": round((comp - measured) / measured * 100, 1),
                "derived": (f"ENABLE_COMPRESSION: capacity "
                            f"{ps1.capacity_steps_per_s():.2f}->"
                            f"{ps8.capacity_steps_per_s():.2f}, speed "
                            f"{measured:.2f}->{comp:.2f} steps/s (gain %)"),
            })
    return out


if __name__ == "__main__":
    for r in run():
        print(r)
