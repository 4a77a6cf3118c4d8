"""Step factories of the port — the twins of the JAX package's
`launch/steps.py`: `make_train_step` (with `TrainState`,
`init_residual`, `init_train_state`), `make_prefill_step` and
`make_serve_step`; and the shardings the dry run prices from the models'
logical axes (`param_shardings`, `opt_shardings` with ZeRO-1,
`batch_shardings`, `train_state_specs`, `train_state_shardings`).

PyTorch runs eagerly, so a step is the plain function; there is nothing
to jit, and one card partitions nothing by the shardings. On the card
the train step's forward runs the flash-attention and RMSNorm kernels
and its backward the flash-attention backward kernel (`kernels.ops`).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.device import DeviceLike
from repro_torch.dist import sharding as sh
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


# ---------------------------------------------------------------------------
# sharding derivation
# ---------------------------------------------------------------------------
def param_shardings(mesh, cfg: ModelConfig, rules=sh.MEGATRON_RULES):
    shapes, axes = api.param_specs(cfg)
    return sh.tree_shardings(mesh, axes, rules, shapes)


def _zero1(mesh, sharding: sh.NamedSharding, shape, rules):
    """Additionally shard the first unsharded divisible dim over 'data'
    (ZeRO-1: optimizer state partitioned across the data axis)."""
    if "data" not in mesh.axis_names:
        return sharding
    spec = list(sharding.spec) + [None] * (len(shape) - len(sharding.spec))
    used = {a for e in spec if e is not None
            for a in (e if isinstance(e, tuple) else (e,))}
    if "data" in used:
        return sharding
    sizes = dict(mesh.shape)
    dsize = sizes["data"]
    for i, e in enumerate(spec):
        if e is None and shape[i] % dsize == 0 and shape[i] >= dsize:
            spec[i] = "data"
            return sh.NamedSharding(mesh, sh.PartitionSpec(*spec))
        if e is not None:
            axes = e if isinstance(e, tuple) else (e,)
            cur = 1
            for a in axes:
                cur *= sizes[a]
            if shape[i] % (cur * dsize) == 0:
                spec[i] = tuple(axes) + ("data",)
                return sh.NamedSharding(mesh, sh.PartitionSpec(*spec))
    return sharding


def opt_shardings(mesh, cfg: ModelConfig, run: RunConfig, p_shardings,
                  rules=sh.MEGATRON_RULES):
    """Optimizer-state shardings: mirror params, optionally ZeRO-1 over data.

    Opt state is () (sgd) or {"m": params-like[, "v": params-like
    [, "w32": params-like]]}.
    """
    opt = make_optimizer(run.optimizer, run.lr, run.weight_decay,
                         master=run.master_weights)
    opt_shape = opt.init(_live_param_shapes(cfg, run))
    if not opt_shape:
        return opt_shape

    def map_like(subtree):
        return tree_map(
            lambda sdg, shp: (_zero1(mesh, sdg, tuple(shp.shape), rules)
                              if run.zero1 else sdg),
            p_shardings, subtree)

    return {k: map_like(v) for k, v in opt_shape.items()}


def batch_shardings(mesh, cfg: ModelConfig, shape: ShapeConfig,
                    rules=sh.MEGATRON_RULES):
    specs, axes = api.batch_specs(cfg, shape)
    return sh.tree_shardings(mesh, axes, rules, specs), specs


def _live_param_shapes(cfg: ModelConfig, run: RunConfig):
    """Meta tensors of the LIVE params (bf16 when master_weights)."""
    shapes = api.param_shapes(cfg)
    if run.master_weights:
        shapes = tree_map(
            lambda s: torch.empty(s.shape, device="meta",
                                  dtype=(torch.bfloat16
                                         if s.dtype == torch.float32
                                         else s.dtype)), shapes)
    return shapes


def train_state_specs(cfg: ModelConfig, run: RunConfig) -> TrainState:
    """The train state without allocation: params, optimizer state and
    residual as meta tensors; the step is the host's 0-d counter, as the
    train step keeps it."""
    pshapes = _live_param_shapes(cfg, run)
    opt = make_optimizer(run.optimizer, run.lr, run.weight_decay,
                         master=run.master_weights)
    res_shapes = ()
    if run.grad_compression != "none":
        res_shapes = tree_map(lambda s: torch.empty(
            s.shape, dtype=torch.float32, device="meta"), pshapes)
    return TrainState(pshapes, opt.init(pshapes),
                      torch.zeros((), dtype=torch.int32), res_shapes)


def train_state_shardings(mesh, cfg: ModelConfig, run: RunConfig,
                          rules=sh.MEGATRON_RULES) -> TrainState:
    ps = param_shardings(mesh, cfg, rules)
    os_ = opt_shardings(mesh, cfg, run, ps, rules)
    scalar = sh.NamedSharding(mesh, sh.PartitionSpec())
    # the residual is params-shaped (f32), so it shards exactly like params
    rs = ps if run.grad_compression != "none" else ()
    return TrainState(ps, os_, scalar, rs)


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------
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
