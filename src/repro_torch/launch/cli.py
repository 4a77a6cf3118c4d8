"""Shared argparse wiring for the port's entry points (the twin of the
JAX package's `launch/cli.py`, for the flags of the ported verbs:
train, serve (and `serve --fleet`), plan, simulate, predict, chaos and
bench, and for the examples under `repro_torch.examples`)."""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import ARCH_IDS, RunConfig


def make_parser(prog: str, description: str) -> argparse.ArgumentParser:
    """A parser for a standalone entry point (an example, the bench
    driver), with the port's ``--device`` flag."""
    p = argparse.ArgumentParser(prog=prog, description=description)
    add_device_arg(p)
    return p


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card (pass 'cpu' "
                        "for the plain PyTorch path)")


def add_arch_arg(p: argparse.ArgumentParser,
                 default: str = "qwen3-1.7b") -> None:
    p.add_argument("--arch", choices=ARCH_IDS, default=default,
                   help="architecture id (see repro_torch.configs.registry)")


def add_scale_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--full", action="store_true",
                   help="the full-width config; default is the reduced "
                        "smoke config")
    p.add_argument("--seed", type=int, default=0)
    add_device_arg(p)


def add_batch_args(p: argparse.ArgumentParser, batch_default: int = 8,
                   seq_default: int = 64) -> None:
    p.add_argument("--global-batch", type=int, default=batch_default)
    p.add_argument("--seq", type=int, default=seq_default)


def add_train_args(p: argparse.ArgumentParser,
                   steps_default: int = 50) -> None:
    p.add_argument("--steps", type=int, default=steps_default)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--optimizer", default="adamw")
    # None = let Session pick the arch-namespaced default; an explicit
    # value (even the default path) is honored verbatim
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-interval", type=int, default=20)
    p.add_argument("--members", type=int, default=2)
    p.add_argument("--revoke-at", type=int, default=0,
                   help="inject a revocation at this step (0 = none)")
    p.add_argument("--master-weights", action="store_true")
    p.add_argument("--mode", default="sync", choices=("sync", "async_ps"),
                   help="sync elastic runtime (default) or the §II "
                        "asynchronous-PS emulation with staleness "
                        "telemetry")
    p.add_argument("--grad-compression", default="none",
                   choices=("none", "bf16", "int8", "topk"),
                   help="§VI-B wire compression with error feedback")


def add_serve_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--tokens", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.0)


def add_serve_fleet_args(p: argparse.ArgumentParser) -> None:
    """`serve --fleet` planning flags (docs/serving.md)."""
    g = p.add_argument_group("fleet planning (--fleet)")
    g.add_argument("--fleet", action="store_true",
                   help="plan an SLO-aware serving fleet across transient "
                        "markets instead of decoding locally")
    g.add_argument("--gpu", default="v100", choices=("k80", "p100", "v100"))
    g.add_argument("--providers", default="gcp,aws",
                   help="comma-separated transient markets to score")
    g.add_argument("--replica-counts", default="2,4,8",
                   help="comma-separated fleet sizes to score")
    g.add_argument("--requests", type=int, default=200,
                   help="workload size (open-loop Poisson stream)")
    g.add_argument("--rate", type=float, default=2.0,
                   help="mean arrivals per second")
    g.add_argument("--slo-p99", type=float, default=10.0,
                   help="p99 end-to-end latency SLO, seconds")
    g.add_argument("--plan-samples", type=int, default=8,
                   help="simulation trajectories per fleet cell")


def add_fleet_args(p: argparse.ArgumentParser,
                   workers_default: int = 4) -> None:
    from repro_torch.providers import available_providers

    # only the paper's measured GPUs have calibrated speed/revocation
    # models
    p.add_argument("--gpu", default="v100", choices=("k80", "p100", "v100"))
    p.add_argument("--provider", default="gcp",
                   choices=available_providers(),
                   help="transient market to plan/simulate/predict on")
    p.add_argument("--region", default=None,
                   help="constrain to one region (default: the provider's "
                        "default region; `plan` scores all regions)")
    p.add_argument("--workers", type=int, default=workers_default)
    p.add_argument("--n-ps", type=int, default=1)


def add_resilience_args(p: argparse.ArgumentParser) -> None:
    """Recovery-policy flags (the live trainer's and the simulated
    fleet's). All default to unset; `resilience_from_args` returns None
    (fail-fast saves, strict restores) unless at least one is given."""
    g = p.add_argument_group("resilience")
    g.add_argument("--retry-attempts", type=int, default=None,
                   help="max attempts per fallible op (save/restore/join)")
    g.add_argument("--retry-base", type=float, default=None,
                   help="first backoff delay, seconds")
    g.add_argument("--retry-max-delay", type=float, default=None,
                   help="backoff ceiling, seconds")
    g.add_argument("--retry-deadline", type=float, default=None,
                   help="total backoff budget per op, seconds")
    g.add_argument("--quorum", type=float, default=None,
                   help="pause training below this alive fraction")
    g.add_argument("--shrink-below", type=float, default=None,
                   help="shrink the global batch below this alive "
                        "fraction (but above --quorum)")
    g.add_argument("--shrink-factor", type=float, default=None,
                   help="global-batch factor while shrunk (default 0.5)")
    g.add_argument("--restore-fail-p", type=float, default=None,
                   help="simulated per-attempt restore failure "
                        "probability (fleet sim stall model)")


def resilience_from_args(args: argparse.Namespace):
    """`ResilienceConfig` from the add_resilience_args namespace, or None
    when no resilience flag was passed."""
    names = ("retry_attempts", "retry_base", "retry_max_delay",
             "retry_deadline", "quorum", "shrink_below", "shrink_factor",
             "restore_fail_p")
    vals = {n: getattr(args, n, None) for n in names}
    if all(v is None for v in vals.values()):
        return None
    from repro_torch.resilience import (DegradationPolicy, ResilienceConfig,
                                        RetryPolicy)
    retry = RetryPolicy()
    for field, name in (("max_attempts", "retry_attempts"),
                        ("base_delay_s", "retry_base"),
                        ("max_delay_s", "retry_max_delay"),
                        ("deadline_s", "retry_deadline")):
        if vals[name] is not None:
            retry = dataclasses.replace(retry, **{field: vals[name]})
    degr = DegradationPolicy(
        quorum=vals["quorum"] or 0.0,
        shrink_below=vals["shrink_below"] or 0.0,
        shrink_factor=(0.5 if vals["shrink_factor"] is None
                       else vals["shrink_factor"]))
    return ResilienceConfig(retry=retry, degradation=degr,
                            restore_fail_p=vals["restore_fail_p"] or 0.0,
                            seed=getattr(args, "seed", 0) or 0)


def add_recalib_args(p: argparse.ArgumentParser) -> None:
    """Online-recalibration flags. Unarmed unless `--recalibrate` is
    passed; `recalib_from_args` then returns None and every static
    calibration stays as it is."""
    g = p.add_argument_group("recalibration")
    g.add_argument("--recalibrate", action="store_true",
                   help="arm CUSUM drift detection + online refit of the "
                        "cluster-speed model from profiler history")
    g.add_argument("--drift-threshold", type=float, default=None,
                   help="CUSUM alarm level on accumulated deviation "
                        "(default 0.15)")
    g.add_argument("--drift-allowance", type=float, default=None,
                   help="per-check deviation slack before the CUSUM "
                        "statistic accumulates (default 0.05)")
    g.add_argument("--refit-window", type=int, default=None,
                   help="trailing profiler records a refit consumes "
                        "(default 6)")
    g.add_argument("--recalib-trace", default=None,
                   help="recorded provider trace (JSONL) to refit "
                        "lifetime laws from at startup")


def recalib_from_args(args: argparse.Namespace):
    """`RecalibrationConfig` from the add_recalib_args namespace, or None
    when --recalibrate was not passed."""
    if not getattr(args, "recalibrate", False):
        return None
    from repro_torch.calibration import RecalibrationConfig
    picked = {field: getattr(args, attr)
              for field, attr in (("drift_threshold", "drift_threshold"),
                                  ("drift_allowance", "drift_allowance"),
                                  ("refit_window", "refit_window"),
                                  ("trace_path", "recalib_trace"))
              if getattr(args, attr, None) is not None}
    return dataclasses.replace(RecalibrationConfig(), **picked)


def run_config_from_args(args: argparse.Namespace) -> RunConfig:
    """RunConfig from the add_train_args/add_scale_args namespace; absent
    attributes fall back to RunConfig defaults. ``--checkpoint-dir`` is
    not mapped: the train handler passes it to `Session.train`, so unset
    and an explicit path stay distinct."""
    mapping = {"optimizer": "optimizer", "lr": "lr", "total_steps": "steps",
               "checkpoint_interval": "checkpoint_interval",
               "master_weights": "master_weights", "seed": "seed",
               "grad_compression": "grad_compression"}
    picked = {field: getattr(args, attr) for field, attr in mapping.items()
              if getattr(args, attr, None) is not None}
    if "total_steps" in picked:
        picked["warmup_steps"] = max(1, picked["total_steps"] // 10)
    picked["zero1"] = False
    res = resilience_from_args(args)
    if res is not None:
        picked["resilience"] = res
    recal = recalib_from_args(args)
    if recal is not None:
        picked["recalibration"] = recal
    return dataclasses.replace(RunConfig(), **picked)


def session_from_args(args: argparse.Namespace):
    """Build a `repro_torch.api.Session` from a parsed namespace."""
    from repro_torch.api import Session
    return Session.from_arch(args.arch, smoke=not args.full,
                             run=run_config_from_args(args),
                             device=args.device)
