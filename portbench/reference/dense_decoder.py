"""Plain fp32 reference of a pre-norm dense decoder as the configuration
file states it: token embedding, then per layer RMSNorm, multi-head
attention with partial rotary embeddings (the first ``partial_rotary_factor``
of each head turns, its halves rotated) and a causal softmax, the residual,
RMSNorm and a SwiGLU MLP, the residual; a final RMSNorm and an untied output
head. Each layer is recomputed in the backward pass, so a block of rows takes
one layer's activations at a time.

The parameter names and layouts are those of the port's tree (the stacked
``layers/`` leaves lead with the layer), which is how the benchmark hands one
set of weights to both sides; this module draws them too (`param_specs`).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench import yardstick
from portbench.feed import TokenFeed
from portbench.reference.train import as_run, cross_entropy_sum, rmsnorm

LAYER_KEYS = ("layers/ln1/scale", "layers/attn/wq", "layers/attn/wk",
              "layers/attn/wv", "layers/attn/wo", "layers/ln2/scale",
              "layers/mlp/wg", "layers/mlp/wi", "layers/mlp/wo")

#: the batches this model reads: token ids
FEED = TokenFeed


def dims(cfg: dict) -> dict:
    """The sizes the reference runs, from a configuration file as the run
    has it; a feature that this module does not compute is refused."""
    cfg = as_run(cfg)
    if cfg.get("norm") != "rmsnorm":
        raise ValueError("the dense reference's norms are RMSNorm")
    for key in ("use_qkv_bias", "qk_layernorm", "use_parallel_residual",
                "tie_word_embeddings"):
        if cfg.get(key):
            raise ValueError(f"the dense reference does not compute {key}")
    if cfg.get("hidden_act", "silu") != "silu":
        raise ValueError("the dense reference's MLP is SwiGLU (silu)")
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    return {"layers": cfg["num_hidden_layers"], "d": d, "heads": heads,
            "kv_heads": cfg["num_key_value_heads"], "head_dim": d // heads,
            "d_ff": cfg["intermediate_size"], "vocab": cfg["vocab_size"],
            "rotary": cfg["partial_rotary_factor"],
            "theta": float(cfg["rope_theta"]), "eps": cfg["layer_norm_eps"]}


def _normal(std: float):
    def draw(gen, shape, device):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).mul_(std)
    return draw


def _ones(gen, shape, device):
    return torch.ones(shape, dtype=torch.float32, device=device)


def param_specs(m: dict) -> dict:
    """name -> (shape, draw(generator, shape, device)): normal weights of
    std 1/sqrt(fan-in) (the embedding 0.02), norm scales of one."""
    L, d, H, KV = m["layers"], m["d"], m["heads"], m["kv_heads"]
    hd, f, V = m["head_dim"], m["d_ff"], m["vocab"]
    return {
        "embed": ((V, d), _normal(0.02)),
        "final_norm/scale": ((d,), _ones),
        "layers/ln1/scale": ((L, d), _ones),
        "layers/ln2/scale": ((L, d), _ones),
        "layers/attn/wq": ((L, d, H, hd), _normal(d ** -0.5)),
        "layers/attn/wk": ((L, d, KV, hd), _normal(d ** -0.5)),
        "layers/attn/wv": ((L, d, KV, hd), _normal(d ** -0.5)),
        "layers/attn/wo": ((L, H, hd, d), _normal((H * hd) ** -0.5)),
        "layers/mlp/wg": ((L, d, f), _normal(d ** -0.5)),
        "layers/mlp/wi": ((L, d, f), _normal(d ** -0.5)),
        "layers/mlp/wo": ((L, f, d), _normal(f ** -0.5)),
        "lm_head": ((d, V), _normal(d ** -0.5)),
    }


def _rotary(m: dict, seq: int, device):
    rot = int(m["head_dim"] * m["rotary"])
    rot -= rot % 2
    inv = 1.0 / m["theta"] ** (torch.arange(0, rot, 2, dtype=torch.float64,
                                            device=device) / rot)
    ang = torch.arange(seq, dtype=torch.float64, device=device)[:, None] * inv
    return rot, ang.cos().float()[:, None, :], ang.sin().float()[:, None, :]


def _rope(x, rot, cos, sin):
    half = rot // 2
    x1, x2, rest = x[..., :half], x[..., half:rot], x[..., rot:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, rest], -1)


def _layer(x, ln1, wq, wk, wv, wo, ln2, wg, wi, wo2, *, m, rope, cast):
    b, s, d = x.shape
    H, KV, hd = m["heads"], m["kv_heads"], m["head_dim"]
    h = cast(rmsnorm(x, ln1, m["eps"]))
    q = (h @ cast(wq).reshape(d, H * hd)).view(b, s, H, hd)
    k = (h @ cast(wk).reshape(d, KV * hd)).view(b, s, KV, hd)
    v = (h @ cast(wv).reshape(d, KV * hd)).view(b, s, KV, hd)
    q, k = _rope(q, *rope), _rope(k, *rope)
    rep = H // KV
    q = q.permute(0, 2, 1, 3)                                   # b H s hd
    k = k.permute(0, 2, 3, 1).repeat_interleave(rep, dim=1)     # b H hd s
    v = v.permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)     # b H s hd
    scores = (cast(q) @ cast(k)) / math.sqrt(hd)
    future = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
    p = torch.softmax(scores.masked_fill(future, float("-inf")), dim=-1)
    o = (cast(p) @ cast(v)).permute(0, 2, 1, 3).reshape(b, s, H * hd)
    x = x + cast(o) @ cast(wo).reshape(H * hd, d)
    h = cast(rmsnorm(x, ln2, m["eps"]))
    a = cast(F.silu(h @ cast(wg)) * (h @ cast(wi)))
    return x + a @ cast(wo2)


def loss_sum(w: dict, m: dict, tokens, labels, cast) -> torch.Tensor:
    """Summed cross-entropy of the next token over a block of rows."""
    x = cast(w["embed"][tokens.long()])
    rot, cos, sin = _rotary(m, tokens.shape[1], x.device)
    layer = functools.partial(_layer, m=m, rope=(rot, cos, sin), cast=cast)
    for i in range(m["layers"]):
        x = cast(checkpoint(layer, x, *(w[k][i] for k in LAYER_KEYS),
                            use_reentrant=False))
    h = rmsnorm(x, w["final_norm/scale"], m["eps"])
    return cross_entropy_sum(cast(h) @ cast(w["lm_head"]), labels)


def kernel_calls(m: dict, batch: int, seq: int) -> dict:
    """The kernels' calls a training step makes, by the yardstick's name:
    (calls, shape)."""
    return {"flash_attention": (m["layers"], {
        "batch": batch, "seq": seq, "heads": m["heads"],
        "kv_heads": m["kv_heads"], "head_dim": m["head_dim"],
        "causal": True})}


def matmul_params(m: dict) -> int:
    """Weights of every product a token meets, the output head included
    and the embedding's gather not."""
    d, H, KV, hd = m["d"], m["heads"], m["kv_heads"], m["head_dim"]
    per_layer = d * H * hd + 2 * d * KV * hd + H * hd * d + 3 * d * m["d_ff"]
    return m["layers"] * per_layer + d * m["vocab"]


def train_flops(m: dict, batch: int, seq: int) -> float:
    """Model FLOPs of a training step: 6 a weight and token, and 12·hd a
    kept (query, key) pair and head for attention's two products forward
    and four backward. Recomputation is not counted."""
    pairs = batch * yardstick.attention_pairs(seq, causal=True)
    return (6.0 * matmul_params(m) * batch * seq
            + 12.0 * m["head_dim"] * pairs * m["heads"] * m["layers"])
