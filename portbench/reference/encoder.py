"""Plain fp32 reference of a HuBERT-style encoder (arXiv:2106.07447) as the
configuration file states it, the port's departures in place: frames of the
stubbed convolutional front end in, their projection to the model's width,
a depthwise convolution over time as the positional embedding (``x +
gelu(conv(x))``), then per layer RMSNorm, bidirectional multi-head attention
with a full softmax (every pair of frames kept, no rotary), the residual,
RMSNorm and a two-matrix MLP with the tanh form of GELU, the residual; a
final RMSNorm and a head over the codebook's units, with the cross-entropy
of every frame. No product has a bias. Each layer is recomputed in the
backward pass, so a block of rows takes one layer's activations at a time.

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
from portbench.feed import FrameFeed
from portbench.reference.train import as_run, cross_entropy_sum, rmsnorm

#: the batches this model reads: frames of the front end and a unit a frame
FEED = FrameFeed

LAYER_KEYS = ("layers/ln1/scale", "layers/attn/wq", "layers/attn/wk",
              "layers/attn/wv", "layers/attn/wo", "layers/ln2/scale",
              "layers/mlp/wi", "layers/mlp/wo")

#: the run values of the source's features that this module computes, by
#: the configuration file's key
COMPUTES = {"conv_feature_extractor": "stub", "feat_proj_layer_norm": False,
            "num_conv_pos_embedding_groups": "depthwise", "norm": "rmsnorm",
            "bias": False, "hidden_act": "gelu_pytorch_tanh",
            "objective": "frame_cross_entropy", "do_stable_layer_norm": True}


def dims(cfg: dict) -> dict:
    """The sizes the reference runs, from a configuration file as the run
    has it; a feature that this module does not compute is refused."""
    cfg = as_run(cfg)
    for key, value in COMPUTES.items():
        if cfg.get(key) != value:
            raise ValueError(f"the encoder reference computes {key} = "
                             f"{value!r}, not {cfg.get(key)!r}")
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    return {"layers": cfg["num_hidden_layers"], "d": d, "heads": heads,
            "head_dim": d // heads, "d_ff": cfg["intermediate_size"],
            "vocab": cfg["num_codebook_units"],
            "frontend_dim": cfg["conv_dim"][-1],
            "pos_taps": cfg["num_conv_pos_embeddings"],
            "eps": cfg["layer_norm_eps"]}


def _normal(std: float):
    def draw(gen, shape, device):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).mul_(std)
    return draw


def _ones(gen, shape, device):
    return torch.ones(shape, dtype=torch.float32, device=device)


def param_specs(m: dict) -> dict:
    """name -> (shape, draw(generator, shape, device)): normal weights of
    std 1/sqrt(fan-in) (the positional convolution's over its taps), norm
    scales of one."""
    L, d, H, hd = m["layers"], m["d"], m["heads"], m["head_dim"]
    f, V, F_in, K = m["d_ff"], m["vocab"], m["frontend_dim"], m["pos_taps"]
    return {
        "frontend_proj": ((F_in, d), _normal(F_in ** -0.5)),
        "pos_conv": ((K, d), _normal(K ** -0.5)),
        "final_norm/scale": ((d,), _ones),
        "layers/ln1/scale": ((L, d), _ones),
        "layers/ln2/scale": ((L, d), _ones),
        "layers/attn/wq": ((L, d, H, hd), _normal(d ** -0.5)),
        "layers/attn/wk": ((L, d, H, hd), _normal(d ** -0.5)),
        "layers/attn/wv": ((L, d, H, hd), _normal(d ** -0.5)),
        "layers/attn/wo": ((L, H, hd, d), _normal((H * hd) ** -0.5)),
        "layers/mlp/wi": ((L, d, f), _normal(d ** -0.5)),
        "layers/mlp/wo": ((L, f, d), _normal(f ** -0.5)),
        "head": ((d, V), _normal(d ** -0.5)),
    }


def _layer(x, ln1, wq, wk, wv, wo, ln2, wi, wo2, *, m, cast):
    b, s, d = x.shape
    H, hd = m["heads"], m["head_dim"]
    h = cast(rmsnorm(x, ln1, m["eps"]))
    q = (h @ cast(wq).reshape(d, H * hd)).view(b, s, H, hd)
    k = (h @ cast(wk).reshape(d, H * hd)).view(b, s, H, hd)
    v = (h @ cast(wv).reshape(d, H * hd)).view(b, s, H, hd)
    q = q.permute(0, 2, 1, 3)                                   # b H s hd
    k = k.permute(0, 2, 3, 1)                                   # b H hd s
    v = v.permute(0, 2, 1, 3)                                   # b H s hd
    p = torch.softmax((cast(q) @ cast(k)) / math.sqrt(hd), dim=-1)
    o = (cast(p) @ cast(v)).permute(0, 2, 1, 3).reshape(b, s, H * hd)
    x = x + cast(o) @ cast(wo).reshape(H * hd, d)
    h = cast(rmsnorm(x, ln2, m["eps"]))
    a = cast(F.gelu(h @ cast(wi), approximate="tanh"))
    return x + a @ cast(wo2)


def loss_sum(w: dict, m: dict, features, labels, cast) -> torch.Tensor:
    """Summed cross-entropy of each frame's unit over a block of rows."""
    x = cast(features.float()) @ cast(w["frontend_proj"])
    # depthwise "same" convolution over time: one group a channel
    taps = m["pos_taps"]
    kernel = cast(w["pos_conv"]).t().unsqueeze(1)               # d 1 taps
    pos = F.conv1d(cast(x).transpose(1, 2), kernel, padding=taps // 2,
                   groups=m["d"]).transpose(1, 2)
    x = cast(x + F.gelu(pos, approximate="tanh"))
    layer = functools.partial(_layer, m=m, cast=cast)
    for i in range(m["layers"]):
        x = cast(checkpoint(layer, x, *(w[k][i] for k in LAYER_KEYS),
                            use_reentrant=False))
    h = rmsnorm(x, w["final_norm/scale"], m["eps"])
    return cross_entropy_sum(cast(h) @ cast(w["head"]), labels)


def kernel_calls(m: dict, batch: int, seq: int) -> dict:
    """The kernels' calls a training step makes, by the yardstick's name:
    (calls, shape)."""
    return {"flash_attention": (m["layers"], {
        "batch": batch, "seq": seq, "heads": m["heads"],
        "kv_heads": m["heads"], "head_dim": m["head_dim"],
        "causal": False})}


def matmul_params(m: dict) -> int:
    """Weights of every product a frame meets: the front end's projection,
    the layers' and the head's. The depthwise positional convolution (taps
    x d weights, 2 FLOPs each a frame) is not a product and is not
    counted."""
    d, H, hd = m["d"], m["heads"], m["head_dim"]
    per_layer = 4 * d * H * hd + 2 * d * m["d_ff"]
    return (m["frontend_dim"] * d + m["layers"] * per_layer
            + d * m["vocab"])


def train_flops(m: dict, batch: int, seq: int) -> float:
    """Model FLOPs of a training step: 6 a weight and frame, and 12·hd a
    kept (query, key) pair and head for attention's two products forward
    and four backward, over every pair (bidirectional). Recomputation is
    not counted, nor the positional convolution."""
    pairs = batch * yardstick.attention_pairs(seq, causal=False)
    return (6.0 * matmul_params(m) * batch * seq
            + 12.0 * m["head_dim"] * pairs * m["heads"] * m["layers"])
