"""Step factories of the port — the twins of the JAX package's
`launch/steps.py`: `make_train_step` (with `TrainState`,
`init_residual`, `init_train_state`), `make_prefill_step` and
`make_serve_step`.

PyTorch runs eagerly, so a step is the plain function; there is nothing
to jit and no sharding to derive on one card. On the card the train
step's forward runs the flash-attention and RMSNorm kernels and its
backward the flash-attention backward kernel (`kernels.ops`).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.device import DeviceLike
from repro_torch.dist.compression import ErrorFeedback, payload_bytes
from repro_torch.models import api
from repro_torch.optim import (clip_by_global_norm, cosine_warmup,
                               make_optimizer)
from repro_torch.tree import tree_map


class TrainState(NamedTuple):
    params: Any
    opt: Any
    #: 0-d int32 tensor on the CPU (the host drives the schedule)
    step: torch.Tensor
    # error-feedback residual tree for grad compression (§VI-B); the empty
    # tuple holds no tensors, so uncompressed runs carry no extra state and
    # their checkpoints have no residual entries
    residual: Any = ()


def _value_and_grad(cfg: ModelConfig, params, batch):
    """(loss, grads) of `api.loss_fn` at ``params``; the grads have the
    params' dtypes."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = api.loss_fn(live, cfg, batch)
    loss.backward()
    return loss.detach(), tree_map(lambda p: p.grad, live)


def make_train_step(cfg: ModelConfig, run: RunConfig):
    """Returns (train_step, opt); train_step(state, batch) -> (state,
    metrics) with metrics ``loss``, ``grad_norm`` and ``step`` (plus
    ``payload_bytes`` under ``run.grad_compression``).

    As in the reference: ``run.microbatch`` > 1 averages the loss and the
    gradients of that many equal slices of the batch (a Python loop in
    place of `lax.scan`, the same ``/ n`` weighting); the gradients are
    clipped to ``run.grad_clip``; with ``run.grad_compression`` in
    {"bf16", "int8", "topk"} the clipped gradients take the error-feedback
    round trip before the optimizer sees them. The optimizer updates the
    state's params and moments in place (`optim.optimizers`).
    """
    lr = cosine_warmup(run.lr, run.warmup_steps, run.total_steps)
    opt = make_optimizer(run.optimizer, lr, run.weight_decay,
                         master=run.master_weights)
    ef = (ErrorFeedback(run.grad_compression)
          if run.grad_compression != "none" else None)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if run.microbatch and run.microbatch > 1:
            n = run.microbatch

            def micro(x, i):
                if x.dim() >= 1 and x.shape[0] % n == 0:
                    return x.reshape((n, x.shape[0] // n) + x.shape[1:])[i]
                return x

            loss = 0.0
            grads = tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32),
                state.params)
            for i in range(n):
                mb = {k: micro(x, i) for k, x in batch.items()}
                l, g = _value_and_grad(cfg, state.params, mb)
                loss = loss + l / n
                grads = tree_map(lambda a, b: a + b / n, grads, g)
        else:
            loss, grads = _value_and_grad(cfg, state.params, batch)

        grads, gnorm = clip_by_global_norm(grads, run.grad_clip)
        residual = state.residual
        metrics = {"loss": loss.float(), "grad_norm": gnorm,
                   "step": state.step}
        if ef is not None:
            grads, residual = ef.roundtrip(grads, residual)
            metrics["payload_bytes"] = payload_bytes(grads,
                                                     run.grad_compression)
        new_params, new_opt = opt.update(grads, state.opt, state.params,
                                         state.step)
        return TrainState(new_params, new_opt, state.step + 1,
                          residual), metrics

    return train_step, opt


def make_prefill_step(cfg: ModelConfig):
    """prefill_step(params, batch) -> logits (B,S,V). On the card every
    attention launches the flash-attention kernel and every norm the
    RMSNorm kernel."""
    @torch.no_grad()
    def prefill_step(params, batch):
        return api.prefill(params, cfg, batch)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One-token decode against the KV cache (updated in place)."""
    @torch.no_grad()
    def serve_step(params, state, tokens, index):
        logits, new_state = api.decode_step(params, cfg, state, tokens, index)
        return logits, new_state
    return serve_step


def init_residual(params, run: RunConfig):
    """Zero error-feedback residual when compression is on, else the empty
    tree."""
    if run.grad_compression == "none":
        return ()
    return ErrorFeedback(run.grad_compression).init(params)


def init_train_state(cfg: ModelConfig, run: RunConfig, *,
                     device: DeviceLike = None) -> TrainState:
    """Fresh weights (`api.init`), bf16 under ``run.master_weights``, the
    optimizer's zero state, step 0 and the zero residual."""
    params, _ = api.init(cfg, device=device)
    if run.master_weights:
        params = tree_map(lambda p: p.to(torch.bfloat16)
                          if p.dtype == torch.float32 else p, params)
    lr = cosine_warmup(run.lr, run.warmup_steps, run.total_steps)
    opt = make_optimizer(run.optimizer, lr, run.weight_decay,
                         master=run.master_weights)
    return TrainState(params, opt.init(params),
                      torch.zeros((), dtype=torch.int32),
                      init_residual(params, run))
