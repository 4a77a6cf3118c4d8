"""Plain fp32 reference of a Mamba2 language model (arXiv:2405.21060) as the
configuration file states it: token embedding, then per layer RMSNorm and
the Mamba2 mixer, the residual; a final RMSNorm and an untied output head.

The mixer: one input projection to (z, x, B, C, dt); a depthwise causal
convolution of width ``d_conv`` with bias over (x, B, C), then SiLU;
dt = softplus(dt + dt_bias), A = -exp(A_log); the SSD recurrence
h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_tᵀ, y_t = C_t h_t + D x_t, computed
chunk by chunk (the paper's quadratic form inside a chunk of
``chunk_size`` tokens, the recurrence over chunk states between them);
y·SiLU(z) through an RMSNorm, then the output projection. Each layer is
recomputed in the backward pass.

Parameter names and layouts are those of the port's tree, as the benchmark
hands one set of weights to both sides; this module draws them
(`param_specs`).
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

LAYER_KEYS = ("layers/ln/scale", "layers/mixer/in_proj",
              "layers/mixer/conv_w", "layers/mixer/conv_b",
              "layers/mixer/dt_bias", "layers/mixer/A_log",
              "layers/mixer/D", "layers/mixer/norm",
              "layers/mixer/out_proj")

#: the batches this model reads: token ids
FEED = TokenFeed


def dims(cfg: dict) -> dict:
    """The sizes the reference runs, from a configuration file as the run
    has it."""
    cfg = as_run(cfg)
    if cfg.get("tie_embeddings"):
        raise ValueError("the Mamba2 reference has an untied output head")
    if not cfg.get("rms_norm", False) or cfg.get("d_intermediate", 0):
        raise ValueError("the Mamba2 reference has RMSNorm and no MLP")
    pad = cfg["pad_vocab_size_multiple"]
    d = cfg["d_model"]
    d_inner = cfg["expand"] * d
    return {"layers": cfg["n_layer"], "d": d, "d_inner": d_inner,
            "heads": d_inner // cfg["headdim"], "head_dim": cfg["headdim"],
            "groups": cfg["ngroups"], "d_state": cfg["d_state"],
            "d_conv": cfg["d_conv"], "chunk": cfg["chunk_size"],
            "vocab": -(-cfg["vocab_size"] // pad) * pad,
            "eps": cfg["norm_epsilon"],
            "a_range": tuple(cfg["A_init_range"]),
            "dt_range": (cfg["dt_min"], cfg["dt_max"])}


def _normal(std: float):
    def draw(gen, shape, device):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).mul_(std)
    return draw


def _const(value: float):
    def draw(gen, shape, device):
        return torch.full(shape, value, dtype=torch.float32, device=device)
    return draw


def _log_uniform(lo: float, hi: float):
    def draw(gen, shape, device):
        u = torch.rand(shape, generator=gen, device=device,
                       dtype=torch.float32)
        return torch.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    return draw


def _a_log(lo: float, hi: float):
    def draw(gen, shape, device):
        u = torch.rand(shape, generator=gen, device=device,
                       dtype=torch.float32)
        return torch.log(lo + u * (hi - lo))
    return draw


def _dt_bias(lo: float, hi: float):
    """softplus⁻¹ of dt drawn log-uniform in [lo, hi], as Mamba2 draws it."""
    def draw(gen, shape, device):
        dt = _log_uniform(lo, hi)(gen, shape, device)
        return dt + torch.log(-torch.expm1(-dt))
    return draw


def param_specs(m: dict) -> dict:
    """name -> (shape, draw(generator, shape, device))."""
    L, d, di, h = m["layers"], m["d"], m["d_inner"], m["heads"]
    gn, K, V = m["groups"] * m["d_state"], m["d_conv"], m["vocab"]
    conv_dim = di + 2 * gn
    return {
        "embed": ((V, d), _normal(0.02)),
        "final_norm/scale": ((d,), _const(1.0)),
        "layers/ln/scale": ((L, d), _const(1.0)),
        "layers/mixer/in_proj": ((L, d, 2 * di + 2 * gn + h),
                                 _normal(d ** -0.5)),
        "layers/mixer/conv_w": ((L, K, conv_dim), _normal(K ** -0.5)),
        "layers/mixer/conv_b": ((L, conv_dim), _const(0.0)),
        "layers/mixer/dt_bias": ((L, h), _dt_bias(*m["dt_range"])),
        "layers/mixer/A_log": ((L, h), _a_log(*m["a_range"])),
        "layers/mixer/D": ((L, h), _const(1.0)),
        "layers/mixer/norm": ((L, di), _const(1.0)),
        "layers/mixer/out_proj": ((L, di, d), _normal(di ** -0.5)),
        "lm_head": ((d, V), _normal(d ** -0.5)),
    }


def ssd(x, dt, A, B, C, chunk: int, cast):
    """x (b,s,h,p), dt (b,s,h), A (h,), B and C (b,s,g,n) -> y (b,s,h,p)
    without the D term."""
    b, s, h, p = x.shape
    g = B.shape[2]
    nc = s // chunk
    X = (x * dt[..., None]).reshape(b, nc, chunk, h, p)
    acs = (dt * A).reshape(b, nc, chunk, h).permute(0, 3, 1, 2).cumsum(-1)
    keep = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=x.device).tril()
    decay = torch.exp((acs[..., :, None] - acs[..., None, :])
                      .masked_fill(~keep, float("-inf")))     # b h c l m
    Bc = B.reshape(b, nc, chunk, g, -1).repeat_interleave(h // g, dim=3)
    Cc = C.reshape(b, nc, chunk, g, -1).repeat_interleave(h // g, dim=3)
    cb = torch.einsum("bclhn,bcmhn->bhclm", cast(Cc), cast(Bc))
    y = torch.einsum("bhclm,bcmhp->bclhp", cast(cb * decay), cast(X))
    to_end = torch.exp(acs[..., -1:] - acs).permute(0, 2, 3, 1)  # b c l h
    states = torch.einsum("bclhn,bclhp->bchpn", cast(Bc),
                          cast(X * to_end[..., None]))
    gamma = torch.exp(acs[..., -1])                               # b h c
    state = torch.zeros_like(states[:, 0])
    before = []
    for c in range(nc):
        before.append(state)
        state = state * gamma[:, :, c, None, None] + states[:, c]
    before = torch.stack(before, dim=1)                           # b c h p n
    from_start = torch.exp(acs).permute(0, 2, 3, 1)[..., None]    # b c l h 1
    y = y + torch.einsum("bclhn,bchpn->bclhp", cast(Cc),
                         cast(before)) * from_start
    return y.reshape(b, s, h, p)


def _layer(x, ln, in_proj, conv_w, conv_b, dt_bias, A_log, D, norm,
           out_proj, *, m, cast):
    b, s, d = x.shape
    di, h, p = m["d_inner"], m["heads"], m["head_dim"]
    gn, K = m["groups"] * m["d_state"], m["d_conv"]
    u = rmsnorm(x, ln, m["eps"])
    zxbcdt = cast(u) @ cast(in_proj)
    z, xbc, dt = zxbcdt.split([di, di + 2 * gn, h], dim=-1)
    padded = F.pad(xbc, (0, 0, K - 1, 0))
    conv = sum(padded[:, i:i + s] * conv_w[i] for i in range(K)) + conv_b
    xs, B, C = F.silu(conv).split([di, gn, gn], dim=-1)
    dt = F.softplus(dt + dt_bias)
    xh = xs.reshape(b, s, h, p)
    y = ssd(xh, dt, -torch.exp(A_log), B.reshape(b, s, m["groups"], -1),
            C.reshape(b, s, m["groups"], -1), m["chunk"], cast)
    y = (y + xh * D[:, None]).reshape(b, s, di) * F.silu(z)
    return x + cast(rmsnorm(y, norm, m["eps"])) @ cast(out_proj)


def loss_sum(w: dict, m: dict, tokens, labels, cast) -> torch.Tensor:
    """Summed cross-entropy of the next token over a block of rows."""
    x = cast(w["embed"][tokens.long()])
    layer = functools.partial(_layer, m=m, cast=cast)
    for i in range(m["layers"]):
        x = cast(checkpoint(layer, x, *(w[k][i] for k in LAYER_KEYS),
                            use_reentrant=False))
    h = rmsnorm(x, w["final_norm/scale"], m["eps"])
    return cross_entropy_sum(cast(h) @ cast(w["lm_head"]), labels)


def kernel_calls(m: dict, batch: int, seq: int) -> dict:
    """The kernels' calls a training step makes, by the yardstick's name:
    (calls, shape)."""
    return {"ssd_scan": (m["layers"], {
        "batch": batch, "seq": seq, "heads": m["heads"],
        "head_dim": m["head_dim"], "groups": m["groups"],
        "d_state": m["d_state"], "chunk": min(m["chunk"], seq)})}


def matmul_params(m: dict) -> int:
    """Weights of every product a token meets (the input and output
    projections, the output head); the depthwise convolution and the
    embedding's gather are not products."""
    d, di = m["d"], m["d_inner"]
    in_width = 2 * di + 2 * m["groups"] * m["d_state"] + m["heads"]
    return m["layers"] * (d * in_width + di * d) + d * m["vocab"]


def train_flops(m: dict, batch: int, seq: int) -> float:
    """Model FLOPs of a training step: 6 a weight and token, and three
    times the SSD forward's products a layer (forward and backward)."""
    (calls, shape), = kernel_calls(m, batch, seq).values()
    ssd_flops, _ = yardstick.ssd_fwd_cost(**shape)
    return 6.0 * matmul_params(m) * batch * seq + 3.0 * calls * ssd_flops
