"""Minimal optimizer library of the port — the twin of the JAX package's
`optim/optimizers.py`: SGD / momentum / Adam / AdamW with gradient
clipping, over nested-dict trees of tensors. `torch.optim` is not used:
the reference's arithmetic is the contract (AdamW's ``b2=0.95``, the
decay ``wd * w`` added to the step before the lr multiply, the fp32
``w32`` master copy under ``master=True``, bias corrections in fp32).

Unlike the reference, `update` writes the new parameters and optimizer
state into the given tensors in place (and returns them), so one card
holds one copy of each; every value is computed as the reference computes
it before it is written.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.tree import flatten, tree_map

_F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], Tuple[Any, Any]]
    # update(grads, opt_state, params, step) -> (new_params, new_opt_state)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for _, x in flatten(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def _sched(lr) -> Callable[[Any], torch.Tensor]:
    return lr if callable(lr) else (lambda step: torch.tensor(lr, dtype=_F32))


def _lr(lr_fn, step) -> float:
    # the float32 value as a Python float: a tensor op with it rounds it
    # back to exactly that float32
    return float(lr_fn(step))


def _zip(*trees):
    """Leaf tuples of trees with one structure, in `flatten` order."""
    return zip(*([leaf for _, leaf in flatten(t)] for t in trees))


def sgd(lr) -> Optimizer:
    lr_fn = _sched(lr)

    def init(params):
        return ()

    @torch.no_grad()
    def update(grads, state, params, step):
        lr_t = _lr(lr_fn, step)
        for p, g in _zip(params, grads):
            p.copy_(p - lr_t * g.to(p.dtype))
        return params, state

    return Optimizer(init, update)


def momentum(lr, beta: float = 0.9) -> Optimizer:
    lr_fn = _sched(lr)

    def init(params):
        return {"m": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr_t = _lr(lr_fn, step)
        for p, g, m in _zip(params, grads, state["m"]):
            m.copy_(beta * m + g.to(m.dtype))
            p.copy_(p - lr_t * m)
        return params, state

    return Optimizer(init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, master: bool = False) -> Optimizer:
    """Adam/AdamW. With master=True the live params are bf16 and an fp32
    master copy ``w32`` lives in the optimizer state."""
    lr_fn = _sched(lr)

    def init(params):
        st = {"m": tree_map(lambda p: torch.zeros_like(p, dtype=_F32), params),
              "v": tree_map(lambda p: torch.zeros_like(p, dtype=_F32), params)}
        if master:
            st["w32"] = tree_map(lambda p: p.to(_F32, copy=True), params)
        return st

    @torch.no_grad()
    def update(grads, state, params, step):
        lr_t = _lr(lr_fn, step)
        t = torch.as_tensor(step, dtype=_F32) + 1.0
        c1 = float(1.0 - b1 ** t)
        c2 = float(1.0 - b2 ** t)
        leaves = list(_zip(params, grads, state["m"], state["v"]))
        w32s = ([w for _, w in flatten(state["w32"])] if master
                else [None] * len(leaves))
        for (p, g, m, v), w32 in zip(leaves, w32s):
            g32 = g.float()
            m.copy_(b1 * m + (1 - b1) * g32)
            v.copy_(b2 * v + (1 - b2) * g32 * g32)
            step_ = (m / c1) / (torch.sqrt(v / c2) + eps)
            src = w32 if w32 is not None else p.float()
            if weight_decay:
                step_ = step_ + weight_decay * src
            new32 = src - lr_t * step_
            p.copy_(new32)
            if w32 is not None:
                w32.copy_(new32)
        return params, state

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, master: bool = False) -> Optimizer:
    return adam(lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                master=master)


def make_optimizer(name: str, lr, weight_decay: float = 0.0,
                   master: bool = False) -> Optimizer:
    if name == "sgd":
        return sgd(lr)
    if name == "momentum":
        return momentum(lr)
    if name == "adam":
        return adam(lr, master=master)
    if name == "adamw":
        return adamw(lr, weight_decay=weight_decay, master=master)
    raise KeyError(name)
