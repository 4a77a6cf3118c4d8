"""Weights across the two packages, as numpy arrays.

`from_numpy` takes the JAX package's parameter tree — `api.init`'s values
as nested dicts of numpy arrays, e.g.
``jax.tree.map(np.asarray, values)`` — and returns the port's parameters
under the same paths (``embed``, ``final_norm/scale``,
``layers/attn/wq``, ..., stacked on the leading ``layers`` axis);
`to_numpy` goes back. Both are bit-exact. numpy has no bf16 of its own:
`to_numpy` gives a bf16 tensor as an int16 array of its raw words, which
needs no `ml_dtypes` (``.view(ml_dtypes.bfloat16)`` gives JAX's type).
`torch` cannot reproduce `jax.random` streams, so this is how a test gives both
packages one set of weights.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import tree_map


def _to_tensor(a: Any, device: torch.device) -> torch.Tensor:
    a = np.array(a)  # a writable copy that the tensor may own
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: same bits as torch's
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _to_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().copy()


def from_numpy(values: Any, device: DeviceLike = None) -> Any:
    """Nested dicts of numpy arrays -> the same tree of tensors on
    ``device`` (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a, dev), values)


def to_numpy(params: Any) -> Any:
    """The port's parameter tree -> nested dicts of numpy arrays (bf16 as
    raw int16 words)."""
    return tree_map(_to_array, params)
