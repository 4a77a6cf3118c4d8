"""Meshes of the port — the twin of the JAX package's `launch/mesh.py`.

The production meshes are abstract (`dist.sharding.AbstractMesh`: axis
names and sizes, no devices): the dry run prices a layout on them
without the chips. `make_host_mesh` is clamped to the CUDA devices
present, one without a card, so on one H100 it is the 1x1 mesh.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.dist.sharding import AbstractMesh, abstract_mesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16x16 = 256 chips per pod; multi_pod adds a 2-pod outer axis (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return abstract_mesh(shape, axes)


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> AbstractMesh:
    return abstract_mesh(shape, axes)


def make_host_mesh(n_data: int = 1, n_model: int = 1) -> AbstractMesh:
    """Small mesh over however many devices exist: the CUDA devices, or
    one without a card."""
    n = max(1, torch.cuda.device_count())
    n_data = min(n_data, n)
    n_model = max(1, min(n_model, n // max(1, n_data)))
    return abstract_mesh((n_data, n_model), ("data", "model"))
