"""§VI-B use case: online PS-bottleneck detection and mitigation.

Streams measured speeds (async-PS queue sim) into the profiler, lets the
controller compare against the composed prediction (6.7% threshold after a
30s warmup), and follows the controller's escalation (docs/DESIGN.md §6):
compress the update payload first (free — no new server), then provision
a second parameter server if the cluster is still saturated. ResNet-32 is
RPC-bound (97 tensors), so compression alone does not move it and the
controller escalates to the PS lever.

PYTHONPATH=src python -m repro_torch.examples.bottleneck_detect

The port's twin of `examples/bottleneck_detect.py`: host only.
"""
from __future__ import annotations

from repro_torch.bench._common import cnn_leaves
from repro_torch.core.controller import Action, Controller
from repro_torch.core.perf_model.cluster_model import PSBottleneckModel, WorkerSpec
from repro_torch.core.perf_model.speed_model import TABLE1_MODELS, calibrate_generators
from repro_torch.core.profiler import PerformanceProfiler
from repro_torch.core.ps_async import ps_queue_sim
from repro_torch.models import cnn


def main():
    gens = calibrate_generators()
    c_m = TABLE1_MODELS["resnet_32"]
    step_p100 = gens["p100"].step_time(c_m)
    mb = 4.0 * cnn.param_count(cnn.RESNET_32)
    nt = cnn_leaves(cnn.RESNET_32)

    for n_workers in (2, 6):
        print(f"\n=== {n_workers} x P100 training ResNet-32, 1 PS ===")
        res = ps_queue_sim([step_p100] * n_workers, mb, n_ps=1, steps=200,
                           n_tensors=nt)
        measured = res.cluster_speed
        predicted = n_workers / step_p100          # sp = sum sp_i
        prof = PerformanceProfiler(window=5, warmup_steps=0,
                                   warmup_seconds=0.0)
        t = 0.0
        for s in range(12):
            prof.record(s, t=t)
            t += 1.0 / measured
        ctrl = Controller(threshold=0.067)
        workers = [WorkerSpec("p100", 1.0 / step_p100)] * n_workers
        ps = PSBottleneckModel(mb, 1, n_tensors=nt)
        det = ctrl.check(prof, predicted, ps, workers)
        print(f"measured {measured:.2f} vs predicted {predicted:.2f} steps/s "
              f"(deviation {det.deviation*100:.1f}%)")
        if det.bottleneck:
            print(f"BOTTLENECK -> {det.action.value}: {det.note}")
            if det.action is Action.ENABLE_COMPRESSION:
                ps = ctrl.mitigate_compression(ps, "int8")
                res2 = ps_queue_sim([step_p100] * n_workers, mb, n_ps=1,
                                    steps=200, n_tensors=nt,
                                    grad_compression=ps.compression)
                gain = (res2.cluster_speed - measured) / measured * 100
                print(f"after int8 compression: {res2.cluster_speed:.2f} "
                      f"steps/s (+{gain:.1f}%)")
                det = ctrl.check(prof, predicted, ps, workers)
            if det.action is Action.ADD_PARAMETER_SERVER:
                ps = ctrl.mitigate_ps(ps)
                res3 = ps_queue_sim([step_p100] * n_workers, mb,
                                    n_ps=ps.n_ps, steps=200, n_tensors=nt,
                                    grad_compression=ps.compression)
                gain = (res3.cluster_speed - measured) / measured * 100
                print(f"after adding PS: {res3.cluster_speed:.2f} steps/s "
                      f"(+{gain:.1f}%; paper reports up to 70.6%)")
        else:
            print("no bottleneck: measurement matches the model")


if __name__ == "__main__":
    main()
