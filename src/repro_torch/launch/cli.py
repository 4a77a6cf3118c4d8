"""Shared argparse wiring for the port's entry points (the twin of the
JAX package's `launch/cli.py`, for the flags of the ported verbs)."""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import ARCH_IDS, RunConfig


def add_arch_arg(p: argparse.ArgumentParser,
                 default: str = "qwen3-1.7b") -> None:
    p.add_argument("--arch", choices=ARCH_IDS, default=default,
                   help="architecture id (see repro_torch.configs.registry)")


def add_scale_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--full", action="store_true",
                   help="the full-width config; default is the reduced "
                        "smoke config")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card (pass 'cpu' "
                        "for the plain PyTorch path)")


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
    p.add_argument("--grad-compression", default="none",
                   choices=("none", "bf16", "int8", "topk"),
                   help="§VI-B wire compression with error feedback")


def add_serve_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--tokens", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.0)


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
    return dataclasses.replace(RunConfig(), **picked)


def session_from_args(args: argparse.Namespace):
    """Build a `repro_torch.api.Session` from a parsed namespace."""
    from repro_torch.api import Session
    return Session.from_arch(args.arch, smoke=not args.full,
                             run=run_config_from_args(args),
                             device=args.device)
