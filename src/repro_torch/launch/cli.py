"""Shared argparse wiring for the port's entry points (the twin of the
JAX package's `launch/cli.py`, for the flags the serving slice uses)."""
from __future__ import annotations

import argparse

from repro_torch.configs import ARCH_IDS


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


def add_serve_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--tokens", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.0)


def session_from_args(args: argparse.Namespace):
    """Build a `repro_torch.api.Session` from a parsed namespace."""
    from repro_torch.api import Session
    return Session.from_arch(args.arch, smoke=not args.full,
                             device=args.device)
