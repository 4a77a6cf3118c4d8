"""The paper's measurement workload: 20 CNNs for CIFAR-10 (32x32x3) — the
twin of the JAX package's `models/cnn.py`.

Two ResNets + two Shake-Shakes (Tensor2Tensor's four) plus 16 custom variants
generated by varying depth and width — exactly the paper's §III-A methodology
for spreading model complexity C_m. `flops_per_image` provides the C_m feature
(analytic 2*MACs, fwd; training multiplier applied by the perf model).

The parameter tree is the reference's, path for path (``stem``,
``stages/<stage>/<block>/b1/c1``, ``fc_w``, ...), with HWIO conv weights,
so `bridge.from_numpy` carries weights across and a checkpoint has one
layout; a conv permutes its weight to OIHW at use. Images arrive NHWC, as
in the reference, and are copied once to contiguous NCHW. The convolutions
are `F.conv2d` (cuDNN on the card), as the reference left them to
`lax.conv_general_dilated`: no Pallas kernel runs here. TPU-style "SAME"
padding is not PyTorch's ``padding=1`` at stride 2 (JAX pads (0, 1) there,
PyTorch (1, 1)), so the padding is computed as XLA computes it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.tree import flatten

IMG = 32
N_CLASSES = 10


@dataclasses.dataclass(frozen=True)
class CNNSpec:
    name: str
    kind: str                 # resnet | shake_shake
    blocks_per_stage: int
    base_width: int

    @property
    def depth(self) -> int:
        per_block = 2
        return 3 * self.blocks_per_stage * per_block + 2


# The paper's four Tensor2Tensor models (approximate published GFLOPs):
RESNET_15 = CNNSpec("resnet_15", "resnet", 2, 16)
RESNET_32 = CNNSpec("resnet_32", "resnet", 5, 16)
SHAKE_SMALL = CNNSpec("shake_shake_small", "shake_shake", 4, 32)
SHAKE_BIG = CNNSpec("shake_shake_big", "shake_shake", 4, 96)


def custom_variants() -> List[CNNSpec]:
    """16 custom CNNs varying hidden-layer count and size (paper §III-A)."""
    out = []
    for nb in (1, 3, 4, 7):
        for w in (8, 24, 48, 64):
            out.append(CNNSpec(f"custom_r{nb}w{w}", "resnet", nb, w))
    return out


ZOO: Dict[str, CNNSpec] = {
    s.name: s
    for s in [RESNET_15, RESNET_32, SHAKE_SMALL, SHAKE_BIG] + custom_variants()
}


# ---------------------------------------------------------------------------
# params / forward
# ---------------------------------------------------------------------------
def _normal(gen: torch.Generator, shape, scale: float,
            device) -> torch.Tensor:
    if torch.device(device).type == "meta":   # shapes only (param_count)
        return torch.empty(shape, device="meta")
    return torch.randn(shape, generator=gen, device=device).mul_(scale)


def _conv_init(gen, k, cin, cout, device):
    return _normal(gen, (k, k, cin, cout), 1.0 / math.sqrt(k * k * cin),
                   device)


def _same_pads(n: int, k: int, stride: int):
    """XLA's "SAME" padding of one spatial dim: (before, after)."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x (B, C, H, W), w HWIO: `lax.conv_general_dilated` with "SAME"."""
    k = w.shape[0]
    (top, bottom), (left, right) = (_same_pads(x.shape[2], k, stride),
                                    _same_pads(x.shape[3], k, stride))
    if (top, left) != (bottom, right):
        x = F.pad(x, (left, right, top, bottom))
        top = left = 0
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride,
                    padding=(top, left))


def _norm(x, scale, bias, eps=1e-5):
    # batch-stat norm (no running stats — stateless; fine for speed
    # studies), the biased variance as `jnp.var`
    mean = torch.mean(x, dim=(0, 2, 3), keepdim=True)
    var = torch.var(x, dim=(0, 2, 3), keepdim=True, correction=0)
    return ((x - mean) * torch.rsqrt(var + eps) * scale[:, None, None]
            + bias[:, None, None])


def _init_branch(gen, cin, cout, device):
    return {
        "c1": _conv_init(gen, 3, cin, cout, device),
        "s1": torch.ones((cout,), device=device),
        "b1": torch.zeros((cout,), device=device),
        "c2": _conv_init(gen, 3, cout, cout, device),
        "s2": torch.ones((cout,), device=device),
        "b2": torch.zeros((cout,), device=device),
    }


def _branch(p, x, stride):
    h = _conv(x, p["c1"], stride)
    h = F.relu(_norm(h, p["s1"], p["b1"]))
    h = _conv(h, p["c2"])
    return _norm(h, p["s2"], p["b2"])


def init_params(gen: torch.Generator, spec: CNNSpec,
                device=None) -> Dict:
    """fp32 weights drawn from ``gen`` on ``device`` (the generator's by
    default; ``"meta"`` gives the shapes only)."""
    device = gen.device if device is None else device
    widths = [spec.base_width, spec.base_width * 2, spec.base_width * 4]
    p: Dict = {"stem": _conv_init(gen, 3, 3, widths[0], device),
               "stem_s": torch.ones((widths[0],), device=device),
               "stem_b": torch.zeros((widths[0],), device=device)}
    stages = []
    cin = widths[0]
    for w in widths:
        blocks = []
        for _ in range(spec.blocks_per_stage):
            blk = {"b1": _init_branch(gen, cin, w, device)}
            if spec.kind == "shake_shake":
                blk["b2"] = _init_branch(gen, cin, w, device)
            if cin != w:
                blk["proj"] = _conv_init(gen, 1, cin, w, device)
            blocks.append(blk)
            cin = w
        stages.append(blocks)
    p["stages"] = stages
    p["fc_w"] = _normal(gen, (cin, N_CLASSES), 0.01, device)
    p["fc_b"] = torch.zeros((N_CLASSES,), device=device)
    return p


def forward(params, spec: CNNSpec, images: torch.Tensor, *,
            train: bool = False,
            key: Optional[torch.Generator] = None) -> torch.Tensor:
    """images: (B,32,32,3) -> logits (B,10). A shake-shake block mixes
    its branches by 0.5, or in training with ``key`` (a generator on the
    images' device) by a per-image uniform draw."""
    # contiguous NCHW: torch 2.13's CPU backward of a convolution whose
    # input is a channels-last view (NHWC memory) corrupts the heap
    x = images.permute(0, 3, 1, 2).contiguous()
    x = F.relu(_norm(_conv(x, params["stem"]), params["stem_s"],
                     params["stem_b"]))
    for si, blocks in enumerate(params["stages"]):
        for bi, blk in enumerate(blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            shortcut = x
            if "proj" in blk:
                shortcut = _conv(x, blk["proj"], stride)
            elif stride != 1:
                shortcut = x[:, :, ::stride, ::stride]
            h1 = _branch(blk["b1"], x, stride)
            if spec.kind == "shake_shake":
                h2 = _branch(blk["b2"], x, stride)
                if train and key is not None:
                    alpha = torch.rand((x.shape[0], 1, 1, 1), generator=key,
                                       device=x.device)
                else:
                    alpha = 0.5
                h = alpha * h1 + (1 - alpha) * h2
            else:
                h = h1
            x = F.relu(shortcut + h)
    x = torch.mean(x, dim=(2, 3))
    return x @ params["fc_w"] + params["fc_b"]


def loss_fn(params, spec: CNNSpec, images, labels,
            key: Optional[torch.Generator] = None) -> torch.Tensor:
    logits = forward(params, spec, images, train=True, key=key)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    return torch.mean(logz - gold)


# ---------------------------------------------------------------------------
# model complexity C_m (the paper's FLOPs-per-image feature)
# ---------------------------------------------------------------------------
def flops_per_image(spec: CNNSpec) -> float:
    """Analytic forward FLOPs (2*MACs) per 32x32 image."""
    widths = [spec.base_width, spec.base_width * 2, spec.base_width * 4]
    hw = IMG
    total = 2 * hw * hw * 3 * widths[0] * 9  # stem
    cin = widths[0]
    n_branches = 2 if spec.kind == "shake_shake" else 1
    for si, w in enumerate(widths):
        for bi in range(spec.blocks_per_stage):
            stride = 2 if (si > 0 and bi == 0) else 1
            hw_out = hw // stride
            per_branch = (2 * hw_out * hw_out * cin * w * 9
                          + 2 * hw_out * hw_out * w * w * 9)
            total += n_branches * per_branch
            if cin != w:
                total += 2 * hw_out * hw_out * cin * w
            hw = hw_out
            cin = w
    total += 2 * cin * N_CLASSES
    return float(total)


def param_count(spec: CNNSpec) -> int:
    """Counted from the tree's shapes on the meta device (no weights)."""
    tree = init_params(torch.Generator(), spec, device="meta")
    return int(sum(t.numel() for _, t in flatten(tree)))
