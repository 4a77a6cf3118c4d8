"""Unified model API of the port: init / loss / prefill / decode — the
twin of the JAX package's `models/api.py` for every family: the dense,
MoE and VLM transformers (GQA or MLA attention; the VLM's M-RoPE
positions from ``batch["positions"]``), the SSM (Mamba2), the hybrid
(Zamba2) and the audio encoder (HuBERT, ``batch["features"]``, no
decode).

Besides, the dry run's specs (`param_axes`, `param_shapes`,
`decode_state_specs`, `batch_specs`, `decode_batch_specs`): where the
reference returns `jax.ShapeDtypeStruct` stand-ins, the port returns
tensors on the meta device, which carry a shape and a dtype and hold no
memory.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import encoder, hybrid, ssm_lm, transformer
from repro_torch.models import layers as L
from repro_torch.tree import tree_map


def _module(cfg: ModelConfig):
    if cfg.family == "ssm":
        return ssm_lm
    if cfg.family == "hybrid":
        return hybrid
    if cfg.family == "audio":
        return encoder
    return transformer  # dense | moe | vlm


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
def init(cfg: ModelConfig, generator: Optional[torch.Generator] = None, *,
         device: DeviceLike = None):
    """Returns (param_values, param_axes) trees. Without a generator the
    weights are drawn from one seeded with 0 on ``device`` (the card
    unless ``device="cpu"``)."""
    mod = _module(cfg)
    if generator is None:
        generator = torch.Generator(device=resolve_device(device))
        generator.manual_seed(0)
    return L.split_params(mod.init_params(generator, cfg))


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def param_specs(cfg: ModelConfig):
    """(meta tensors, axes) of the parameter tree, from a draw under
    `FakeTensorMode`, which builds the shapes and allocates nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        values, axes = L.split_params(
            _module(cfg).init_params(torch.Generator(), cfg))
    return tree_map(lambda t: _meta(t.shape, t.dtype), values), axes


def param_axes(cfg: ModelConfig):
    """Axes tree without materializing params."""
    return param_specs(cfg)[1]


def param_shapes(cfg: ModelConfig):
    """The parameter tree as meta tensors (shapes and dtypes)."""
    return param_specs(cfg)[0]


# ---------------------------------------------------------------------------
# losses / steps
# ---------------------------------------------------------------------------
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)


def _logits_and_aux(params, cfg: ModelConfig,
                    batch: Dict[str, torch.Tensor]):
    """The forward on a batch: frame features for audio, tokens and
    their M-RoPE positions (when given) for the VLM, tokens otherwise."""
    mod = _module(cfg)
    if cfg.family == "audio":
        return mod.forward(params, cfg, batch["features"])
    if cfg.family == "vlm":
        return mod.forward(params, cfg, batch["tokens"],
                           positions=batch.get("positions"))
    return mod.forward(params, cfg, batch["tokens"])


def loss_fn(params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean cross-entropy against ``batch["labels"]`` plus the aux loss
    (the MoE layers' load-balancing loss; zero for the other families)."""
    logits, aux = _logits_and_aux(params, cfg, batch)
    return cross_entropy(logits, batch["labels"]) + aux


def forward(params, cfg: ModelConfig, *args, **kw):
    return _module(cfg).forward(params, cfg, *args, **kw)


def prefill(params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Forward returning logits only (inference prefill)."""
    return _logits_and_aux(params, cfg, batch)[0]


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device: DeviceLike = None):
    """Returns (state_values, state_axes) for the decode carrier (KV
    cache / SSM state / both). It is bf16 by default, whatever the
    model's dtype, as in the reference."""
    if cfg.family == "audio":
        raise ValueError("encoder-only arch has no decode state")
    mod = _module(cfg)
    builder = (mod.init_cache if mod is transformer else mod.init_state)
    return L.split_params(builder(cfg, batch, max_len, dtype,
                                  resolve_device(device)))


def decode_state_specs(cfg: ModelConfig, batch: int, max_len: int,
                       dtype=torch.bfloat16):
    """(meta tensors, axes) of the decode carrier, as the reference's
    (a family without a state of its own gets the KV cache)."""
    make_state = {"ssm": ssm_lm.init_state,
                  "hybrid": hybrid.init_state}.get(cfg.family,
                                                   transformer.init_cache)
    return L.split_params(make_state(cfg, batch, max_len, dtype,
                                     torch.device("meta")))


def decode_step(params, cfg: ModelConfig, state, tokens, index):
    if cfg.family == "audio":
        raise ValueError("encoder-only arch has no decode step")
    return _module(cfg).decode_step(params, cfg, state, tokens, index)


# ---------------------------------------------------------------------------
# input specs (meta tensors; no allocation) per shape cell
# ---------------------------------------------------------------------------
def batch_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, tuple]]:
    """Train/prefill batch: (specs, logical_axes). Token ids are int32,
    features bf16, as in the reference."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if cfg.family == "audio":
        specs = {"features": _meta((B, S, cfg.frontend_dim), torch.bfloat16),
                 "labels": _meta((B, S), i32)}
        axes = {"features": ("batch", "seq", None), "labels": ("batch", "seq")}
    elif cfg.family == "vlm":
        specs = {"tokens": _meta((B, S), i32),
                 "positions": _meta((3, B, S), i32),
                 "labels": _meta((B, S), i32)}
        axes = {"tokens": ("batch", "seq"), "positions": (None, "batch", "seq"),
                "labels": ("batch", "seq")}
    else:
        specs = {"tokens": _meta((B, S), i32), "labels": _meta((B, S), i32)}
        axes = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
    if shape.kind == "prefill":
        specs.pop("labels")
        axes.pop("labels")
    return specs, axes


def decode_batch_specs(cfg: ModelConfig, shape: ShapeConfig):
    """Decode step inputs: tokens (B,), index scalar."""
    specs = {"tokens": _meta((shape.global_batch,), torch.int32),
             "index": _meta((), torch.int32)}
    axes = {"tokens": ("batch",), "index": ()}
    return specs, axes


def make_batch(cfg: ModelConfig, shape: ShapeConfig,
               generator: Optional[torch.Generator] = None,
               batch_override: Optional[int] = None,
               seq_override: Optional[int] = None, *,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Materialize a synthetic batch (small shapes / tests only) on the
    generator's device: the reference's keys, shapes and ranges, `torch`
    draws in place of `jax.random`'s. Without a generator the batch is
    drawn from one seeded with 0 on ``device`` (the card unless
    ``device="cpu"``), as `init` draws its weights."""
    if generator is None:
        generator = torch.Generator(device=resolve_device(device))
        generator.manual_seed(0)
    dev = generator.device
    B = batch_override or shape.global_batch
    S = seq_override or shape.seq_len
    if cfg.family == "audio":
        return {"features": torch.randn((B, S, cfg.frontend_dim),
                                        generator=generator, device=dev
                                        ).to(torch.bfloat16),
                "labels": torch.randint(0, cfg.vocab_size, (B, S),
                                        generator=generator, device=dev)}
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=generator, device=dev),
             "labels": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=generator, device=dev)}
    if cfg.family == "vlm":
        batch["positions"] = torch.arange(S, device=dev)[None, None].expand(
            3, B, S)
    return batch
