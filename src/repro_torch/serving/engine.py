"""Continuous-batching gateway engine over the real model — the twin of
the JAX package's `serving/engine.py:GatewayEngine`.

One `GatewayEngine` owns a fixed pool of decode *slots* backed by a
single shared decode state (KV cache) of shape ``(slots, max_len)``.
Requests join and retire independently: each slot carries its own write
position, so a request can prefill its prompt while its neighbours are
mid-generation — the per-slot vector `cache_index` path of the layers.

A join zeroes the joining slot's rows along each state leaf's named
``batch`` axis before the next step, in place (the reference builds a
masked copy inside its jitted step; PyTorch runs eagerly and needs no
trace, so the reference's `jit_cache` memo has no counterpart here).

Sampling uses the reference's per-slot temperature gate: greedy `argmax`
(first index on ties) where a slot's temperature is 0, else a categorical
draw from the engine's own `torch.Generator`.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import api
from repro_torch.tree import flatten


def _reset_by_batch_axis(state, axes, slots: torch.Tensor) -> None:
    """Zero the rows ``slots`` of every state leaf along its named
    ``batch`` axis, in place."""
    ax_by_path = dict(flatten(axes))
    for path, leaf in flatten(state):
        ax = ax_by_path[path]
        if ax is not None and "batch" in ax:
            leaf.index_fill_(ax.index("batch"), slots, 0)


class GatewayEngine:
    """Slot-level continuous batching over one model's decode state."""

    def __init__(self, cfg: ModelConfig, params=None, *, slots: int = 4,
                 max_len: int = 64, seed: int = 1,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if params is None:
            params, _ = api.init(cfg, device=self.device)
        self.cfg = cfg
        self.params = params
        self.slots = int(slots)
        self.max_len = int(max_len)
        # bf16 whatever the model's dtype, as api.init_decode_state gives it
        self.state, self._axes = api.init_decode_state(
            cfg, slots, max_len, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        #: logits (slots, V) of the last step, for inspection
        self.last_logits: Optional[torch.Tensor] = None

        # per-slot host-side bookkeeping
        self.rid: List[Optional[int]] = [None] * slots
        self._pending: List[deque] = [deque() for _ in range(slots)]
        self._pos = np.zeros(slots, np.int64)       # next write position
        self._last = np.zeros(slots, np.int64)      # last sampled token
        self._temp = np.zeros(slots, np.float32)
        self._budget = np.zeros(slots, np.int64)    # tokens still owed
        self._emitted: List[List[int]] = [[] for _ in range(slots)]
        self._join_mask = np.zeros(slots, bool)     # reset on next step
        self.step_seconds: List[float] = []         # per-iteration wall time

    # ----------------------------------------------------------- admission
    def busy(self) -> bool:
        return any(r is not None for r in self.rid)

    def join(self, slot: int, rid: int, prompt: Sequence[int],
             max_new: int, temperature: float = 0.0) -> None:
        """Seat request `rid` in `slot`; its prompt prefills token-by-token
        on subsequent `step()` calls while other slots keep decoding."""
        if self.rid[slot] is not None:
            raise ValueError(f"slot {slot} is occupied by rid "
                             f"{self.rid[slot]}")
        prompt = list(int(t) for t in prompt)
        if not prompt:
            raise ValueError(f"rid {rid}: empty prompt")
        if max_new < 1:
            raise ValueError(f"rid {rid}: max_new must be >= 1")
        if len(prompt) + max_new > self.max_len:
            raise ValueError(
                f"rid {rid}: prompt_len {len(prompt)} + max_new {max_new} "
                f"exceeds max_len {self.max_len}")
        self.rid[slot] = rid
        self._pending[slot] = deque(prompt)
        self._pos[slot] = 0
        self._temp[slot] = temperature
        self._budget[slot] = max_new
        self._emitted[slot] = []
        self._join_mask[slot] = True

    def release(self, slot: int) -> List[int]:
        """Evict a slot (retire or external cancel); returns what it had
        emitted so far."""
        out = self._emitted[slot]
        self.rid[slot] = None
        self._pending[slot] = deque()
        self._emitted[slot] = []
        self._budget[slot] = 0
        return out

    # ------------------------------------------------------------- decode
    @torch.no_grad()
    def _decode(self, toks: np.ndarray, reset: np.ndarray) -> np.ndarray:
        dev = self.device
        if reset.any():
            _reset_by_batch_axis(self.state, self._axes,
                                 torch.from_numpy(np.flatnonzero(reset))
                                 .to(dev))
        logits, self.state = api.decode_step(
            self.params, self.cfg, self.state, torch.from_numpy(toks).to(dev),
            torch.from_numpy(self._pos).to(dev))
        self.last_logits = logits
        nxt = torch.argmax(logits, dim=-1)
        if (self._temp > 0).any():
            temps = torch.from_numpy(self._temp).to(dev)
            safe = torch.where(temps > 0, temps, torch.ones_like(temps))
            probs = torch.softmax(logits.float() / safe[:, None], dim=-1)
            sampled = torch.multinomial(probs, 1,
                                        generator=self.generator)[:, 0]
            nxt = torch.where(temps > 0, sampled, nxt)
        return nxt.cpu().numpy()      # waits for the step to finish

    def step(self) -> List[Dict]:
        """One decode iteration across all occupied slots. Returns one
        event per slot that emitted a token this step:
        ``{"slot", "rid", "token", "done", "tokens"?}`` — prefill steps
        emit nothing for their slot."""
        active = [i for i in range(self.slots) if self.rid[i] is not None]
        if not active:
            return []
        toks = np.zeros(self.slots, np.int64)
        for i in active:
            toks[i] = (self._pending[i].popleft() if self._pending[i]
                       else self._last[i])
        reset = self._join_mask.copy()
        self._join_mask[:] = False

        t0 = time.monotonic()
        nxt = self._decode(toks, reset)
        self.step_seconds.append(time.monotonic() - t0)

        events: List[Dict] = []
        for i in active:
            self._pos[i] += 1
            if self._pending[i]:
                continue                      # still prefilling
            tok = int(nxt[i])
            self._last[i] = tok
            self._emitted[i].append(tok)
            done = len(self._emitted[i]) >= self._budget[i]
            ev = {"slot": i, "rid": self.rid[i], "token": tok,
                  "done": done}
            if done:
                ev["tokens"] = self.release(i)
            events.append(ev)
        return events

    # ------------------------------------------------------------ metrics
    def decode_percentiles_ms(self) -> Dict[str, float]:
        """p50/p95/p99 of per-iteration wall time, milliseconds."""
        if not self.step_seconds:
            return {"p50": 0.0, "p95": 0.0, "p99": 0.0}
        arr = np.asarray(self.step_seconds) * 1e3
        return {"p50": float(np.percentile(arr, 50)),
                "p95": float(np.percentile(arr, 95)),
                "p99": float(np.percentile(arr, 99))}
