"""Architecture configs of the PyTorch port: a copy of the reference
package's `ModelConfig` and its sub-configs (the port imports nothing of
the JAX package).

Dropped from the reference: `use_pallas` and `unroll_layers`, which steer
XLA tracing. The port takes its hand-written kernels whenever a tensor
lies on the card (`repro_torch.kernels.ops`), and its layer loop is
plain Python. `RunConfig` is the reference's, field for field; its
default `checkpoint_dir` keeps the reference's name (``repro_ckpt``) but
lies in the temporary directory that ``TMPDIR`` names, as
`default_checkpoint_dir` gives it; its `compilation_cache_dir` is
accepted and ignored (nothing is jitted). `ShapeConfig`, the four
dry-run shapes and `valid_cells` are the reference's.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0            # routed experts
    top_k: int = 0
    n_shared_experts: int = 0     # always-on experts (DeepSeek style)
    expert_d_ff: int = 0          # per-expert hidden size
    capacity_factor: float = 1.25
    group_size: int = 4096        # tokens per routing group (local sort dispatch)
    router_jitter: float = 0.0
    aux_loss_coef: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0          # 0 => no query compression (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD mixer."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256
    a_init_range: Tuple[float, float] = (1.0, 16.0)


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | audio | vlm | cnn
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    # attention flavor
    qk_norm: bool = False
    rope_theta: float = 10000.0
    partial_rotary: float = 1.0     # fraction of head_dim that rotates
    mrope_sections: Tuple[int, ...] = ()  # M-RoPE (qwen2-vl): dims per (t,h,w)
    causal: bool = True             # False => encoder (hubert)
    # sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # deepseek: first k layers use a dense FFN instead of MoE
    first_k_dense: int = 0
    dense_d_ff: int = 0
    # hybrid (zamba2): one weight-shared attention block every `shared_attn_every`
    shared_attn_every: int = 0
    # misc
    mlp_variant: str = "swiglu"  # swiglu | gelu (2-matrix, starcoder2-style)
    kv_quant: bool = False       # int8 KV cache (per-token-per-head scales)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # frontend stub for audio/vlm: dim of precomputed frame/patch embeddings
    frontend_dim: int = 0
    remat: str = "none"  # none | full | dots  (activation checkpoint policy)

    # ---- derived quantities -------------------------------------------------
    @property
    def kv_groups(self) -> int:
        return max(1, self.n_heads // max(1, self.n_kv_heads))

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # parameter count (embedding + blocks + head), used for C_m features,
    # checkpoint-size prediction and MODEL_FLOPS=6ND roofline sanity.
    def param_count(self) -> int:
        d, L, V = self.d_model, self.n_layers, self.vocab_size
        total = V * d  # embed
        if not self.tie_embeddings and V:
            total += V * d  # lm head
        if self.family in ("ssm",):
            total += L * self._ssm_layer_params()
        elif self.family == "hybrid":
            n_shared = 1
            total += L * self._ssm_layer_params()
            total += n_shared * self._attn_params() + n_shared * self._mlp_params(self.d_ff)
        else:
            total += L * self._attn_params()
            if self.moe:
                moe_layers = L - self.first_k_dense
                total += self.first_k_dense * self._mlp_params(self.dense_d_ff or self.d_ff)
                per_expert = self._mlp_params(self.moe.expert_d_ff)
                total += moe_layers * (
                    (self.moe.n_experts + self.moe.n_shared_experts) * per_expert
                    + self.d_model * self.moe.n_experts  # router
                )
            else:
                total += L * self._mlp_params(self.d_ff)
        total += L * 2 * d + d  # norms
        return total

    def _attn_params(self) -> int:
        d = self.d_model
        if self.mla is not None:
            m = self.mla
            qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
            p = d * (self.n_heads * qk_head)                        # W_q
            p += d * (m.kv_lora_rank + m.qk_rope_head_dim)          # W_dkv (+rope k)
            p += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
            p += self.n_heads * m.v_head_dim * d                    # W_o
            return p
        hd = self.head_dim
        return d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d

    def _mlp_params(self, d_ff: int) -> int:
        mats = 2 if self.mlp_variant == "gelu" else 3  # SwiGLU has a gate
        return mats * self.d_model * d_ff

    def _ssm_layer_params(self) -> int:
        s = self.ssm
        d_inner = s.expand * self.d_model
        n_heads = d_inner // s.head_dim
        p = self.d_model * (2 * d_inner + 2 * s.n_groups * s.d_state + n_heads)  # in_proj
        p += s.d_conv * (d_inner + 2 * s.n_groups * s.d_state)  # conv
        p += n_heads * 2  # A_log, D
        p += d_inner * self.d_model  # out_proj
        return p

    def flops_per_token(self, seq_len: int) -> float:
        """Approx. training-forward FLOPs per token (the paper's C_m feature).

        6*N_active per fwd+bwd token is computed by callers; this returns the
        *active* parameter count (dense-equivalent matmul params touched per
        token) plus the attention quadratic term.
        """
        n_active = self.active_param_count()
        flops = 2.0 * n_active
        # attention score/value quadratic term
        if self.family not in ("ssm",):
            n_attn_layers = (1 if self.family == "hybrid" else self.n_layers)
            if self.family == "hybrid" and self.shared_attn_every:
                n_attn_layers = self.n_layers // self.shared_attn_every
            hd = self.head_dim or (self.mla.qk_nope_head_dim + self.mla.qk_rope_head_dim
                                   if self.mla else 0)
            flops += n_attn_layers * 4.0 * self.n_heads * hd * seq_len * (
                0.5 if self.causal else 1.0)
        return flops

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only top-k + shared experts)."""
        if not self.moe:
            return self.param_count()
        total = self.param_count()
        moe_layers = self.n_layers - self.first_k_dense
        per_expert = self._mlp_params(self.moe.expert_d_ff)
        inactive = moe_layers * (self.moe.n_experts - self.moe.top_k) * per_expert
        return total - inactive


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode | long_decode

    @property
    def is_decode(self) -> bool:
        return self.kind in ("decode", "long_decode")


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "long_decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


def valid_cells(cfg: ModelConfig):
    """The (arch x shape) cells that are runnable for this architecture.

    Skips (recorded, per docs/DESIGN.md §4): decode shapes for encoder-only archs;
    long_500k for pure full-attention archs (needs sub-quadratic attention).
    """
    out = []
    for s in ALL_SHAPES:
        if not cfg.causal and s.kind in ("decode", "long_decode"):
            continue  # encoder-only: no autoregressive step
        if s.kind == "long_decode" and cfg.family not in ("ssm", "hybrid"):
            continue  # full attention: sub-quadratic required at 500k
        out.append(s)
    return out


def default_checkpoint_dir() -> str:
    """The reference's default checkpoint directory, under TMPDIR."""
    return os.path.join(tempfile.gettempdir(), "repro_ckpt")


@dataclass(frozen=True)
class RunConfig:
    """Training-run hyperparameters (used by the launcher/examples)."""
    optimizer: str = "adamw"
    lr: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    grad_clip: float = 1.0
    checkpoint_interval: int = 500        # steps (paper: I_c)
    checkpoint_dir: str = field(default_factory=default_checkpoint_dir)
    zero1: bool = True                    # no-op on one card
    master_weights: bool = False          # bf16 live params + fp32 master in opt
    grad_compression: str = "none"        # none | bf16 | int8 | topk
    seed: int = 0
    microbatch: int = 0                   # 0 => no gradient accumulation
    compilation_cache_dir: str = ""       # accepted, ignored: nothing to jit
    resilience: Optional[object] = None   # resilience.ResilienceConfig
    recalibration: Optional[object] = None  # calibration.RecalibrationConfig
