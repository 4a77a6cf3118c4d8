"""The plain training loop that a family's reference runs: the mean
cross-entropy over a batch, taken in blocks of rows so that it fits beside
what else the card holds, the clip to a global norm, and AdamW with the
linear warm-up and cosine decay the traffic file states. fp32 throughout,
with TF32 off.

A family module gives `loss_sum(w, dims, **rows, cast)`, the summed
cross-entropy of a block of rows, whose keyword arguments are the keys its
feed's batches hold (``tokens`` and ``labels``, or ``features`` and
``labels``); ``w`` maps each parameter name to its leaf, or, for a name under
``layers/``, to the list of its layers' slices. ``cast`` is applied to both
operands of every product and to the residual stream: the identity for the
reference, `fp8` for the control that computes in the precision below the
configuration's bf16.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch

Batch = Dict[str, torch.Tensor]   # a feed's batch, key by key


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


#: rows of a batch a block of the loss takes (the reference's memory tactic)
ROWS = 1


def _fp8_round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to the fp8 format ``dtype`` under one scale a tensor
    (its largest magnitude onto the format's largest), back in fp32."""
    scale = x.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8(torch.autograd.Function):
    """fp8 training's rounding: a product's operand to e4m3, the gradient
    coming back through it to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return _fp8_round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8_round(g, torch.float8_e5m2)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


def as_run(cfg: dict) -> dict:
    """A configuration file's keys as the run has them: the source's
    values, with each departure of the port's model put in their place."""
    return {**cfg, **{k: d["run"]
                      for k, d in cfg.get("departures", {}).items()}}


def lr_at(opt: dict, step: int) -> float:
    """The learning rate of step ``step`` (0-based): linear warm-up over
    ``warmup_steps``, then a cosine down to ``min_lr_frac`` of the peak at
    ``total_steps``."""
    warm = min(1.0, (step + 1.0) / max(1, opt["warmup_steps"]))
    prog = min(max((step - opt["warmup_steps"])
                   / max(1, opt["total_steps"] - opt["warmup_steps"]), 0.0),
               1.0)
    lo = opt["min_lr_frac"]
    cos = lo + (1 - lo) * 0.5 * (1 + math.cos(math.pi * prog))
    return opt["lr"] * warm * cos


def _leaves(weights: Dict[str, torch.Tensor]):
    """Leaves that autograd fills: each stacked tensor as its layers'
    slices (views of it, so an update of the stack reaches them)."""
    out = {}
    for name, t in weights.items():
        if name.startswith("layers/"):
            out[name] = [t[i].detach().requires_grad_(True)
                         for i in range(t.shape[0])]
        else:
            out[name] = t.requires_grad_(True)
    return out


def _take_grad(leaf) -> torch.Tensor:
    if isinstance(leaf, list):
        g = torch.stack([x.grad for x in leaf])
        for x in leaf:
            x.grad = None
        return g
    g, leaf.grad = leaf.grad, None
    return g


def follow(family, dims: dict, weights: Dict[str, torch.Tensor],
           batches: Sequence[Batch], opt: dict, initial: Callable[[str],
                                                                  torch.Tensor],
           rows: int = ROWS, cast: Callable = identity,
           first_grad: Optional[Callable[[str, torch.Tensor], None]] = None
           ) -> dict:
    """Train ``weights`` (fp32, updated in place) on ``batches``, one
    AdamW step a batch. Returns the loss of each step, the norm of each
    leaf's first gradient as the optimizer gets it (clipped), the norm of
    each leaf's second moment after the last step, and the norm of each
    leaf's change after the last step against ``initial(name)``, the leaf
    as it was drawn. ``first_grad(name, g)`` sees each leaf's first clipped
    gradient."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    leaves = _leaves(weights)
    m = {n: torch.zeros_like(t) for n, t in weights.items()}
    v = {n: torch.zeros_like(t) for n, t in weights.items()}
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    for step, batch in enumerate(batches):
        n_tokens = batch["labels"].numel()
        total = 0.0
        for r in range(0, batch["labels"].shape[0], rows):
            block = {k: v[r:r + rows] for k, v in batch.items()}
            loss = family.loss_sum(leaves, dims, cast=cast,
                                   **block) / n_tokens
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        grads = {n: _take_grad(leaf) for n, leaf in leaves.items()}
        gnorm = math.sqrt(sum(float(g.double().pow(2).sum())
                              for g in grads.values()))
        scale = min(1.0, opt["grad_clip"] / (gnorm + 1e-9))
        lr = lr_at(opt, step)
        c1, c2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
        with torch.no_grad():
            for n, p in weights.items():
                g = grads.pop(n).mul_(scale)
                if step == 0:
                    grad_norms[n] = float(torch.linalg.vector_norm(g))
                    if first_grad is not None:
                        first_grad(n, g)
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                update = (m[n] / c1) / ((v[n] / c2).sqrt_() + eps)
                p.sub_(lr * (update + wd * p))
                del g, update
    moment_norms = {n: float(torch.linalg.vector_norm(t))
                    for n, t in v.items()}
    del m, v, leaves
    change_norms = {}
    with torch.no_grad():
        for n, p in weights.items():
            change_norms[n] = float(torch.linalg.vector_norm(p - initial(n)))
    return {"losses": losses, "grad_norms": grad_norms,
            "moment_norms": moment_norms, "change_norms": change_norms}


def cross_entropy_sum(logits: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale
