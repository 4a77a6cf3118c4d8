"""Programmatic serving loop over the continuous-batching gateway — the
twin of the JAX package's `api/serving.py`.

`generate()` seats every request in a slot of one `GatewayEngine`, feeds
the prompts token by token (cache-consistent for every family), then
samples `tokens` new tokens per request through the engine's per-slot
temperature gate, the first token included.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike
from repro_torch.serving.engine import GatewayEngine


@dataclasses.dataclass
class ServeReport:
    arch: str
    batch: int
    prompt_len: int
    tokens_generated: int
    prefill_seconds: float
    decode_seconds: float
    tokens_per_second: float
    sample_tokens: List[int]
    generated: torch.Tensor  # (batch, tokens) int32, on the CPU
    #: per-iteration decode wall-time percentiles, milliseconds
    decode_ms_p50: float = 0.0
    decode_ms_p95: float = 0.0
    decode_ms_p99: float = 0.0
    #: the device the model ran on (`torch.cuda.get_device_name` or "cpu")
    device: str = ""


def generate(cfg: ModelConfig, params=None, *, batch: int = 4,
             prompt_len: int = 32, tokens: int = 16,
             temperature: float = 0.0, seed: int = 1, prompt=None,
             device: DeviceLike = None) -> ServeReport:
    """Prefill a (random or given) prompt via repeated decode, then
    sample `tokens` new tokens. Runs on the card unless
    ``device="cpu"``."""
    if cfg.family == "audio":
        raise ValueError("encoder-only arch has no decode path")
    max_len = prompt_len + tokens
    eng = GatewayEngine(cfg, params, slots=batch, max_len=max_len,
                        seed=seed, device=device)
    if prompt is None:
        gen = torch.Generator().manual_seed(seed)
        prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                               generator=gen)
    for slot in range(batch):
        eng.join(slot, rid=slot, prompt=[int(t) for t in prompt[slot]],
                 max_new=tokens, temperature=temperature)

    # all slots prefill in lockstep: the first prompt_len iterations feed
    # prompt tokens; the last of those emits each request's first token
    out: Dict[int, List[int]] = {}
    t0 = time.monotonic()
    for _ in range(prompt_len - 1):
        eng.step()
    prefill_s = time.monotonic() - t0

    t0 = time.monotonic()
    n_prefill_steps = len(eng.step_seconds)
    while eng.busy():
        for ev in eng.step():
            if ev["done"]:
                out[ev["rid"]] = ev["tokens"]
    decode_s = time.monotonic() - t0

    eng.step_seconds = eng.step_seconds[n_prefill_steps:]
    pct = eng.decode_percentiles_ms()
    gen_tokens = torch.tensor([out[slot] for slot in range(batch)],
                              dtype=torch.int32)
    dev = eng.device
    return ServeReport(
        arch=cfg.name, batch=batch, prompt_len=prompt_len,
        tokens_generated=tokens, prefill_seconds=prefill_s,
        decode_seconds=decode_s,
        tokens_per_second=tokens * batch / max(decode_s, 1e-9),
        sample_tokens=gen_tokens[0, :10].tolist(), generated=gen_tokens,
        decode_ms_p50=pct["p50"], decode_ms_p95=pct["p95"],
        decode_ms_p99=pct["p99"],
        device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else dev.type))
