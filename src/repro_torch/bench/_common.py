"""What the port's bench modules share: the CNN zoo's parameter-tree leaf
count, which the PS model takes as its RPC count (`n_tensors`), and the
wait that closes a timed call on the device."""
from __future__ import annotations

import torch

from repro_torch.models import cnn
from repro_torch.tree import flatten


def cnn_leaves(spec: cnn.CNNSpec) -> int:
    """Leaves of ``spec``'s parameter tree (97 for ResNet-32). The
    reference counts `jax.eval_shape` leaves; the port counts the tree
    drawn on the meta device (no weights), as `cnn.param_count` does."""
    tree = cnn.init_params(torch.Generator(), spec, device="meta")
    return sum(1 for _ in flatten(tree))


def sync(device: torch.device) -> None:
    """Wait for the card's queued work, where the reference calls
    `block_until_ready`; the CPU runs eagerly and needs no wait."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
