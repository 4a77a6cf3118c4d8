"""The yardstick's counts held to closed forms and to independent counts,
from both sides (equality, so a count neither too high nor too low passes),
at two shapes each."""
from __future__ import annotations

import itertools

import pytest
import torch

from portbench.tests.smoke import smoke_root  # noqa: F401
from portbench import harness, yardstick


@pytest.mark.parametrize("seq", [7, 2048])
@pytest.mark.parametrize("causal", [True, False])
def test_pairs_equal_a_count_of_the_mask(seq, causal):
    mask = torch.ones(seq, seq, dtype=torch.bool)
    if causal:
        mask = mask.tril()
    assert yardstick.attention_pairs(seq, causal) == int(mask.sum())
    if causal:
        assert yardstick.attention_pairs(seq, causal) == seq * (seq + 1) // 2


@pytest.mark.parametrize("shape", [
    dict(batch=2, seq=128, heads=4, kv_heads=2, head_dim=32, causal=True),
    dict(batch=6, seq=2048, heads=32, kv_heads=32, head_dim=64,
         causal=True),
    dict(batch=14, seq=2048, heads=16, kv_heads=16, head_dim=80,
         causal=False)])
def test_flash_bytes_equal_the_tensors_bytes(shape):
    """Q, K, V, O in bf16 and the fp32 log-sum-exp, as the kernel's
    caller hands them over and gets them back; the backward adds dO read
    and dQ, dK, dV written. The products over every kept pair: S(S+1)/2 a
    head causal, S² bidirectional (hubert's training shape)."""
    B, S, H, KV, hd = (shape[k] for k in ("batch", "seq", "heads",
                                          "kv_heads", "head_dim"))
    meta = dict(device="meta", dtype=torch.bfloat16)
    q, o, do, dq = (torch.empty(B, S, H, hd, **meta) for _ in range(4))
    k, v, dk, dv = (torch.empty(B, S, KV, hd, **meta) for _ in range(4))
    lse = torch.empty(B, H, S, device="meta", dtype=torch.float32)
    size = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    fwd_flops, fwd_bytes = yardstick.flash_fwd_cost(**shape)
    bwd_flops, bwd_bytes = yardstick.flash_bwd_cost(**shape)
    assert fwd_bytes == size(q, k, v, o, lse)
    assert bwd_bytes == size(q, k, v, o, do, lse, dq, dk, dv)
    pairs = B * H * (S * (S + 1) // 2 if shape["causal"] else S * S)
    assert fwd_flops == 4 * hd * pairs and bwd_flops == 10 * hd * pairs


def _ssd_products_by_loop(b, s, h, p, g, n, chunk):
    """Multiply-adds of the chunked SSD forward, counted term by term."""
    macs = 0
    for _bi, c in itertools.product(range(b), range(s // chunk)):
        for l, m in itertools.product(range(chunk), repeat=2):
            if m <= l:
                macs += g * n          # C_l · B_m, one a group
                macs += h * p          # score(l, m) x_m, one a head
        macs += chunk * h * n * p      # B_m x_mᵀ into the chunk's state
        macs += chunk * h * n * p      # C_l · state into y_l
        macs += h * n * p              # the state carried to the next chunk
    return 2 * macs


@pytest.mark.parametrize("shape", [
    dict(batch=1, seq=8, heads=2, head_dim=3, groups=1, d_state=4, chunk=4),
    dict(batch=2, seq=12, heads=4, head_dim=2, groups=2, d_state=3,
         chunk=3)])
def test_ssd_flops_equal_a_loop_count(shape):
    flops, nbytes = yardstick.ssd_fwd_cost(**shape)
    b, s, h, p, g, n = (shape[k] for k in ("batch", "seq", "heads",
                                           "head_dim", "groups", "d_state"))
    assert flops == _ssd_products_by_loop(b, s, h, p, g, n, shape["chunk"])
    assert nbytes == 2 * b * s * h * p * 2 + 4 * b * s * h + 4 * h \
        + 2 * 2 * b * s * g * n


def test_least_seconds_takes_the_larger_bound():
    assert yardstick.least_seconds(989e12, 0.0) == pytest.approx(1.0)
    assert yardstick.least_seconds(0.0, 3.35e12) == pytest.approx(1.0)
    assert yardstick.least_seconds(989e12, 6.7e12) == pytest.approx(2.0)


@pytest.mark.parametrize("name,params,tflop", [
    ("stablelm-1.6b", 1_438_646_272, 113.5),
    ("mamba2-1.3b", 1_342_390_272, 69.7),
    ("hubert-xlarge", 945_018_880, 205.9)])
def test_model_flops_of_the_configurations(name, params, tflop, smoke_root):
    """The products' weights counted from the port's own tree (every
    matrix, none of the norms, the embedding, the convolutions or the SSD's
    per-head vectors), and a step's model FLOPs at the cells' batches
    (hubert's the queued cell's)."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.tree import flatten
    cell = {"stablelm-1.6b": "stablelm-1.6b.train-2k",
            "mamba2-1.3b": "mamba2-1.3b.train-2k",
            "hubert-xlarge": "hubert-xlarge.train-2k"}[name]
    cell = harness.find_cell(cell, smoke_root)
    ref = cell.reference()
    dims = ref.dims(cell.config)
    shapes = dict(flatten(api.param_shapes(get_config(name, smoke=False))))
    products = sum(t.numel() for n, t in shapes.items()
                   if t.dim() >= 2 + n.startswith("layers/")
                   and n != "embed" and "conv" not in n)
    assert ref.matmul_params(dims) == products == params
    t = cell.traffic
    got = ref.train_flops(dims, t["global_batch"], t["seq_len"]) / 1e12
    assert got == pytest.approx(tflop, rel=2e-3)


def test_encoder_flops_count_every_pair_of_frames(smoke_root):
    """hubert's step (the queued cell's): 6 a product weight (from the
    port's tree) and frame, and 12·hd a pair of frames and head over all S²
    pairs of a row, bidirectional, in each of its 48 layers."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.tree import flatten
    cell = harness.find_cell("hubert-xlarge.train-2k", smoke_root)
    ref = cell.reference()
    dims = ref.dims(cell.config)
    shapes = dict(flatten(api.param_shapes(get_config("hubert-xlarge",
                                                      smoke=False))))
    products = sum(t.numel() for n, t in shapes.items()
                   if n in ("frontend_proj", "head")
                   or n.startswith(("layers/attn/", "layers/mlp/")))
    B, S = cell.traffic["global_batch"], cell.traffic["seq_len"]
    assert (B, S) == (14, 2048)
    assert ref.train_flops(dims, B, S) == \
        6.0 * products * B * S + 12.0 * 80 * B * S * S * 16 * 48
    calls, shape = ref.kernel_calls(dims, B, S)["flash_attention"]
    assert calls == 48 and shape == dict(batch=14, seq=2048, heads=16,
                                         kv_heads=16, head_dim=80,
                                         causal=False)
