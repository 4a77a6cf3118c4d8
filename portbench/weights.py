"""Weights made by the benchmark, by parameter name, from the seed: one
generator a leaf, seeded from (seed, name), one draw a leaf on the device in
fp32, the type the port trains. The same call makes the same leaf again,
for the reference and for the change a leaf made."""
from __future__ import annotations

import hashlib
from typing import Dict, Tuple

import torch

Spec = Tuple[tuple, object]   # shape, draw(generator, shape, device)


def leaf_seed(seed: int, name: str) -> int:
    digest = hashlib.sha256(f"{seed}:{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def make_leaf(specs: Dict[str, Spec], name: str, seed: int,
              device) -> torch.Tensor:
    shape, draw = specs[name]
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, name))
    return draw(gen, tuple(shape), device)


def make_all(specs: Dict[str, Spec], seed: int, device) -> Dict[str, torch.Tensor]:
    return {name: make_leaf(specs, name, seed, device) for name in specs}


def check_names(specs: Dict[str, Spec], program: Dict[str, tuple]) -> None:
    """The program's tree holds exactly these names and shapes."""
    ours = {n: tuple(s) for n, (s, _) in specs.items()}
    if ours != program:
        missing = sorted(set(program) - set(ours))
        extra = sorted(set(ours) - set(program))
        differ = sorted(n for n in set(ours) & set(program)
                        if ours[n] != program[n])
        raise ValueError(f"the program's parameters differ from the "
                         f"reference's: missing {missing}, extra {extra}, "
                         f"shapes differ {differ}")


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """``{"a/b": t}`` -> ``{"a": {"b": t}}``."""
    tree: dict = {}
    for name, t in flat.items():
        *path, last = name.split("/")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[last] = t
    return tree
