"""`repro_torch` — the PyTorch/CUDA port of the CM-DARE stack, for one
NVIDIA H100.

It mirrors `src/repro/` module for module (same module and function
names, so each file has a twin in the JAX package to be held against) and
imports nothing of it. Its entry points run on the card unless the caller
passes ``device="cpu"``; with no CUDA device and no explicit CPU request
they raise. On the card, every GQA attention (forward and, in training,
backward), every RMSNorm, every Mamba2 SSD scan and every next-event
select of the fleet engine goes through a hand-written kernel
(`repro_torch.kernels`); the plain PyTorch versions serve CPU tensors and
the tests.

Ported so far: inference — batched prefill
(`launch.steps.make_prefill_step`) and the continuous-batching gateway
(`api.Session.serve`, ``python -m repro_torch serve``) — and training —
`api.Session.train` over `core.trainer.TransientTrainer` and
`launch.steps.make_train_step` (``python -m repro_torch train``) — for
the dense family (``qwen3-1.7b``), the MoE family
(``granite-moe-3b-a800m``; ``deepseek-v2-lite-16b`` with MLA attention
and a dense first layer) and the SSM family (``mamba2-1.3b``); the
hybrid family (``zamba2-1.2b``) runs the same entry points — and the
§VI-A fleet simulator (`api.Session.simulate`, ``python -m repro_torch
simulate``) with its event, batched and device (``engine="jit"``)
engines, the providers, chaos scenarios and resilience policies it reads.
"""
