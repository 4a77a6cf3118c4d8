"""The port's kernels held against the JAX package's.

On the CPU the port's kernels are their plain PyTorch versions
(`repro_torch.kernels.ref`); these tests hold those against the Pallas
kernels run in interpret mode, with the tolerances of
tests/test_kernels.py (fwd 2e-5 in fp32, 2e-2 in bf16). The CUDA kernels
themselves are held against the plain versions on the card by the tests
marked ``cuda`` (skipped without a card) and by ``chip_smoke.py``.

JAX is imported inside the fixture that needs it, so the ``cuda`` tests
also run on a machine that has the card and no JAX:
``python -m pytest -m cuda tests/test_torch_kernels.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture
def pallas():
    """The JAX package's kernels (interpret mode on the CPU)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import flash_attention, ops as jops
    return jnp, flash_attention, jops


def _inputs(seed, shapes, dtype):
    """numpy normals, rounded to `dtype` by each package (exactly)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return arrs, [torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in arrs]


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().cpu().numpy()
    return np.asarray(t.astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal", [
    (1, 128, 128, 4, 4, 64, True),     # MHA causal
    (2, 128, 128, 4, 2, 32, True),     # GQA
    (1, 256, 256, 2, 1, 64, True),     # MQA longer
    (1, 128, 128, 4, 4, 64, False),    # bidirectional
    (1, 128, 128, 4, 4, 80, False),    # hubert-xlarge's head_dim 80
    (2, 192, 192, 4, 2, 80, True),     # hd 80, GQA, causal
])
def test_flash_attention_ref_matches_pallas(pallas, B, Sq, Sk, H, KV, hd,
                                            causal, dtype):
    jnp, jfa, _ = pallas
    tol = _TOL[dtype]
    shapes = [(B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)]
    arrs, (tq, tk, tv) = _inputs(0, shapes, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in arrs)
    want_out, want_lse = jfa.flash_attention_fwd(
        jq, jk, jv, causal=causal, block_q=64, block_k=64, interpret=True)
    out, lse = ref.flash_attention_ref(tq, tk, tv, causal)
    assert out.dtype == tq.dtype and lse.dtype == torch.float32
    assert lse.shape == (B, H, Sq)
    np.testing.assert_allclose(_np(out), _np(want_out), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(lse), _np(want_lse), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 8, 128), (5, 2048), (3, 4, 2, 32)])
def test_rmsnorm_ref_matches_pallas(pallas, shape, dtype):
    jnp, _, jops = pallas
    tol = _TOL[dtype]
    (x,), (tx,) = _inputs(1, [shape], dtype)
    jx = jnp.asarray(x).astype(dtype)
    scale = np.random.default_rng(2).uniform(0.5, 1.5, shape[-1]).astype(
        np.float32)
    want = jops.rmsnorm(jx, jnp.asarray(scale), 1e-5)
    got = ops.rmsnorm(tx, torch.from_numpy(scale), 1e-5)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_causal_needs_equal_lengths():
    q = torch.zeros(1, 8, 2, 32)
    kv = torch.zeros(1, 16, 2, 32)
    with pytest.raises(ValueError, match="Sq == Sk"):
        ops.flash_attention(q, kv, kv, causal=True)
    # bidirectional attention takes Sq != Sk
    assert ops.flash_attention(q, kv, kv, causal=False).shape == q.shape


def test_cpu_tensors_take_the_plain_version():
    """The dispatch rule on the CPU: plain version, no launch counted."""
    before = dict(ops.launches)
    x = torch.randn(4, 128, generator=torch.Generator().manual_seed(0))
    assert torch.equal(ops.rmsnorm(x, torch.ones(128)),
                       ref.rmsnorm_ref(x, torch.ones(128)))
    q = x.reshape(1, 4, 1, 128)
    assert torch.equal(ops.flash_attention(q, q, q),
                       ref.flash_attention_ref(q, q, q)[0])
    ssd_in = _ssd_inputs("cpu", 1, 64, 2, 32, 1, 16, torch.float32)
    assert torch.equal(ops.ssd_scan(*ssd_in, chunk=32),
                       ref.ssd_scan_ref(*ssd_in, chunk=32))
    assert ops.launches == before


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _qkv(q, k, v, fused):
    """q, k, v as they are, or as strided views of one fused
    (B, S, H + 2 KV, hd) tensor, as a fused QKV projection gives them."""
    if not fused:
        return q, k, v
    H, KV = q.shape[2], k.shape[2]
    qkv = torch.cat([q, k, v], dim=2)
    return qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,hd,causal,fused", [
    (1, 256, 16, 8, 128, True, False),
    (2, 200, 4, 2, 64, True, False),      # ragged: S % 64 != 0
    (1, 130, 4, 4, 32, False, False),
    (1, 1, 4, 2, 128, True, False),       # one token
    (1, 129, 4, 2, 128, True, False),     # one past a 128-query tile
    (2, 2048, 16, 8, 128, True, False),   # qwen3-1.7b's training shape
    (1, 2048, 32, 32, 64, True, False),   # zamba2-1.2b's attention
    (1, 300, 8, 1, 128, True, False),     # MQA
    (2, 160, 4, 2, 32, True, False),      # hd=32, causal
    (2, 192, 8, 2, 128, True, True),      # views of one fused QKV tensor
    (4, 32, 16, 8, 128, True, False),     # the live chaos plans' shape
    (1, 2048, 24, 8, 64, True, False),    # granite: a group of 3 heads
    (1, 100, 6, 2, 64, True, False),      # a group of 3, ragged
    (1, 2048, 16, 16, 80, False, False),  # hubert-xlarge's encode, hd 80
    (1, 2048, 16, 16, 80, True, False),   # hd 80, causal
    (1, 100, 4, 4, 80, True, False),      # hd 80, ragged
    (2, 192, 4, 2, 80, False, True),      # hd 80, views of a fused QKV
    (1, 256, 48, 4, 128, True, False),    # starcoder2-15b: a group of 12
    (1, 256, 12, 2, 128, True, False),    # qwen2-vl-2b: a group of 6
    (1, 256, 32, 32, 64, True, False),    # stablelm-1.6b: MHA
    # the training shapes at hd <= 80 (stablelm's, hubert's): persistent
    # blocks walking several tiles of both batches
    (2, 2048, 32, 32, 64, True, False),
    (2, 2048, 16, 16, 80, False, False),
    # the edges of the hd <= 80 schedule's 64-key units and 128-key
    # stages: one unit, a ragged last unit or stage, a tile + 1; Sq 192
    # with Sk 320; a group of 3 heads
    *[(2, s, 4, 2, hd, causal, False)
      for s in (64, 127, 129, 191, 255) for hd in (80, 64)
      for causal in (True, False)],
    (2, (192, 320), 4, 2, 80, False, False),
    (2, (192, 320), 4, 2, 64, False, False),
    (2, 255, 6, 2, 64, True, False),
])
def test_flash_kernel_matches_plain_on_card(cuda, B, S, H, KV, hd, causal,
                                            fused, dtype):
    """S is Sq = Sk, or a pair (Sq, Sk)."""
    from repro_torch.kernels import flash_attention as fa
    tol = _TOL[dtype]
    Sq, Sk = S if isinstance(S, tuple) else (S, S)
    _, (q, k, v) = _inputs(3, [(B, Sq, H, hd), (B, Sk, KV, hd),
                               (B, Sk, KV, hd)], dtype)
    q, k, v = _qkv(q.to(cuda), k.to(cuda), v.to(cuda), fused)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    want_out, want_lse = ref.flash_attention_ref(q, k, v, causal)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_np(out), _np(want_out), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(lse), _np(want_lse), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,hd", [
    pytest.param(False, 80, id="False"), pytest.param(True, 80, id="True"),
    pytest.param(True, 64, id="True-hd64")])
def test_flash_kernel_at_hd80_is_deterministic_on_card(cuda, causal, hd):
    """Two bf16 forward calls at hubert-xlarge's encode shape (hd 80)
    and at stablelm-1.6b's causal hd 64 give the same bits, and the output
    keeps its last 16 columns (at hd 80 a box that dropped columns 64-79
    would leave them unwritten)."""
    from repro_torch.kernels import flash_attention as fa
    H = 16 if hd == 80 else 32
    _, (q, k, v) = _inputs(4, [(1, 2048, H, hd)] * 3, "bfloat16")
    q, k, v = q.to(cuda), k.to(cuda), v.to(cuda)
    first = fa.flash_attention_fwd(q, k, v, causal=causal)
    again = fa.flash_attention_fwd(q, k, v, causal=causal)
    want, _ = ref.flash_attention_ref(q, k, v, causal)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    tail = first[0][..., hd - 16:].float() - want[..., hd - 16:].float()
    assert float(tail.abs().max()) <= 2e-2 * float(want.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", [(1, 2048), (37, 2048), (300, 128),
                                    (64, 4096), (5, 32), (37, 256),
                                    (2048, 1280), (64, 6144)])
def test_rmsnorm_kernel_matches_plain_on_card(cuda, rows, d, dtype):
    from repro_torch.kernels import rmsnorm as rn
    tol = _TOL[dtype]
    _, (x,) = _inputs(4, [(rows, d)], dtype)
    x = x.to(cuda)
    scale = torch.linspace(0.5, 1.5, d, device=cuda)
    got = rn.rmsnorm_fwd(x, scale)
    want = ref.rmsnorm_ref(x, scale)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", [(1, 2048), (37, 2048), (300, 128),
                                    (64, 4096), (4096, 2048), (2048, 1280),
                                    (64, 6144)])
def test_rmsnorm_bwd_kernel_matches_plain_on_card(cuda, rows, d, dtype):
    """dx and dscale against `ref.rmsnorm_bwd_ref`: fp32 3e-4 of max; bf16
    dx 2e-2 of max and 1e-2 in Frobenius norm (one rounding each, after
    sums in another order), dscale (fp32 in both) 1e-3 of max."""
    from repro_torch.kernels import rmsnorm as rn
    _, (x, dy) = _inputs(4, [(rows, d), (rows, d)], dtype)
    x, dy = x.to(cuda), dy.to(cuda)
    scale = torch.linspace(0.5, 1.5, d, device=cuda)
    dx, ds = rn.rmsnorm_bwd(x, scale, dy, 1e-6)
    want_dx, want_ds = ref.rmsnorm_bwd_ref(x, scale, dy, 1e-6)
    torch.cuda.synchronize()
    assert dx.dtype == x.dtype and dx.shape == x.shape
    assert ds.dtype == torch.float32 and ds.shape == (d,)
    assert bool(torch.isfinite(dx).all()) and bool(torch.isfinite(ds).all())
    tol_dx, tol_ds = (3e-4, 3e-4) if dtype == "float32" else (2e-2, 1e-3)
    err = dx.float() - want_dx.float()
    assert float(err.abs().max()) <= tol_dx * float(want_dx.abs().max())
    if dtype == "bfloat16":
        assert float(err.norm() / want_dx.float().norm()) <= 1e-2
    assert float((ds - want_ds).abs().max()) <= tol_ds * float(
        want_ds.abs().max())
    # without dscale, dx is the same
    only_dx, no_ds = rn.rmsnorm_bwd(x, scale, dy, 1e-6, need_dscale=False)
    assert no_ds is None and torch.equal(only_dx, dx)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(4096, 2048), (65536, 128)])
def test_rmsnorm_bwd_kernel_is_deterministic_on_card(cuda, rows, d):
    """No float atomics: dscale's partials are added in a fixed order,
    so two calls give the same bits."""
    from repro_torch.kernels import rmsnorm as rn
    _, (x, dy) = _inputs(5, [(rows, d), (rows, d)], "bfloat16")
    x, dy = x.to(cuda), dy.to(cuda)
    scale = torch.linspace(0.5, 1.5, d, device=cuda)
    first = rn.rmsnorm_bwd(x, scale, dy, 1e-6)
    again = rn.rmsnorm_bwd(x, scale, dy, 1e-6)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_cuda_tensors_launch_the_kernels(cuda):
    before = dict(ops.launches)
    x = torch.randn(8, 128, device=cuda)
    ops.rmsnorm(x, torch.ones(128, device=cuda))
    # one backward call counts one launch, whatever the CUDA launches
    xg = x.clone().requires_grad_()
    sg = torch.ones(128, device=cuda, requires_grad=True)
    torch.autograd.grad(ops.rmsnorm(xg, sg), (xg, sg), torch.ones_like(x))
    q = x.reshape(1, 8, 1, 128)
    ops.flash_attention(q, q, q)
    ops.ssd_scan(*_ssd_inputs(cuda, 1, 64, 2, 32, 1, 16, torch.float32),
                 chunk=64)
    # bf16 past one 128-token chunk: three CUDA kernels, one launch counted
    ops.ssd_scan(*_ssd_inputs(cuda, 1, 300, 2, 32, 1, 16, torch.bfloat16),
                 chunk=300)
    torch.cuda.synchronize()
    assert ops.launches == {**before,
                            "flash_attention_fwd":
                                before["flash_attention_fwd"] + 1,
                            "rmsnorm_fwd": before["rmsnorm_fwd"] + 2,
                            "rmsnorm_bwd": before["rmsnorm_bwd"] + 1,
                            "ssd_scan_fwd": before["ssd_scan_fwd"] + 2}


@pytest.mark.cuda
@pytest.mark.parametrize("S,H,KV,dtype,tol,norm_tol", [
    (256, 24, 8, "bfloat16", 2e-2, 1e-2),   # granite's heads
    (100, 6, 2, "float32", 3e-4, 3e-4),     # ragged
])
def test_flash_bwd_kernel_at_a_group_of_three_on_card(cuda, S, H, KV, dtype,
                                                      tol, norm_tol):
    """granite-moe-3b-a800m's 24 query heads over 8 KV heads at hd 64: the
    backward sums dk and dv over a group of 3, against the plain version
    with the tolerances of tests/test_torch_train.py's backward cases."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=cuda).manual_seed(5)
    dt = getattr(torch, dtype)
    q, do = (torch.randn((1, S, H, 64), generator=g, device=cuda).to(dt)
             for _ in range(2))
    k, v = (torch.randn((1, S, KV, 64), generator=g, device=cuda).to(dt)
            for _ in range(2))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, True)
    torch.cuda.synchronize()
    for gt, wt in zip(got, want):
        assert gt.dtype == wt.dtype and gt.shape == wt.shape
        err = gt.float() - wt.float()
        assert float(err.abs().max()) <= tol * float(wt.float().abs().max())
        assert float(err.norm() / wt.float().norm()) <= norm_tol


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "deepseek-v2-lite-16b"])
def test_moe_layer_is_deterministic_on_card(cuda, arch):
    """Two bf16 calls of one full-width MoE layer on 2048 tokens give the
    same bits: the combine sums each token's k pairs in a fixed order
    (no atomic scatter-add), so greedy replays can be identical."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    cfg = get_config(arch)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params, _ = L.split_params(L.init_moe(gen, cfg))
    x = torch.randn((1, 2048, cfg.d_model), generator=gen,
                    device=cuda).to(torch.bfloat16)
    with torch.no_grad():
        first, aux1 = L.moe(params, cfg, x)
        again, aux2 = L.moe(params, cfg, x)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(first).all())
    assert torch.equal(first, again) and torch.equal(aux1, aux2)


def _ssd_inputs(device, b, s, h, p, g, n, dtype, seed=6, views=False):
    """x, B, C in ``dtype``; dt = softplus(normal) and A = -exp(normal/2)
    in fp32, as tests/test_kernels.py draws them. With ``views``, x, B and
    C are views of one (b, s, h p + 2 g n) tensor, cut as
    `models.ssm.mamba2_block` cuts its conv output."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)
    if views:
        xbc = normal(b, s, h * p + 2 * g * n).to(dtype)
        x = xbc[..., :h * p].reshape(b, s, h, p)
        B = xbc[..., h * p:h * p + g * n].reshape(b, s, g, n)
        C = xbc[..., h * p + g * n:].reshape(b, s, g, n)
    else:
        x = normal(b, s, h, p).to(dtype)
    dt = torch.nn.functional.softplus(normal(b, s, h))
    A = -torch.exp(normal(h) * 0.5)
    if not views:
        B, C = normal(b, s, g, n).to(dtype), normal(b, s, g, n).to(dtype)
    return x, dt, A, B, C


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,g,n,chunk,dtype,views", [
    (1, 2048, 64, 64, 1, 128, 256, "bfloat16", False),  # mamba2 prefill
    (2, 2048, 64, 64, 1, 128, 256, "bfloat16", False),  # mamba2 train
    (1, 2048, 64, 64, 1, 64, 256, "bfloat16", False),   # zamba2-1.2b
    (1, 256, 8, 64, 2, 32, 128, "bfloat16", False),     # grouped B/C
    (1, 32, 4, 32, 1, 16, 32, "bfloat16", False),       # one ragged tile
    # many of the bf16 kernels' 128-token chunks, the last one ragged
    (1, 2000, 8, 64, 1, 128, 250, "bfloat16", False),
    (2, 100, 8, 64, 2, 64, 100, "bfloat16", False),     # under one chunk
    (2, 640, 8, 32, 4, 16, 128, "bfloat16", False),     # g > 1, n=16, p=32
    # views of one conv output, as the Mamba2 block hands them over
    (1, 2048, 64, 64, 1, 128, 256, "bfloat16", True),
    (2, 200, 8, 32, 2, 16, 200, "bfloat16", True),
    (2, 128, 4, 32, 2, 16, 64, "float32", False),
    (1, 200, 2, 64, 1, 128, 200, "float32", False),     # ragged last tile
])
def test_ssd_kernel_matches_plain_on_card(cuda, b, s, h, p, g, n, chunk,
                                          dtype, views):
    """fp32: 5e-4 of max |plain| (tests/test_kernels.py); bf16: 2e-2 of
    max |plain| and 1e-2 in Frobenius norm, as the flash backward is held
    (y is rounded to bf16 once, from fp32 sums)."""
    from repro_torch.kernels import ssd_scan as ss
    x, dt, A, B, C = _ssd_inputs(cuda, b, s, h, p, g, n,
                                 getattr(torch, dtype), views=views)
    if views:
        assert x.stride(1) == B.stride(1) == h * p + 2 * g * n
    got = ss.ssd_scan_fwd(x, dt, A, B, C, chunk)
    want = ref.ssd_scan_ref(x, dt, A, B, C, chunk)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == x.shape
    assert bool(torch.isfinite(got).all())
    err = (got.float() - want.float())
    assert float(err.abs().max()) <= (5e-4 if dtype == "float32" else 2e-2) \
        * float(want.float().abs().max())
    if dtype == "bfloat16":
        assert float(err.norm() / want.float().norm()) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ssd_kernel_is_deterministic_on_card(cuda, dtype):
    """No atomics: two calls give the same bits (bf16 at the mamba2-1.3b
    prefill shape, through all three stages)."""
    from repro_torch.kernels import ssd_scan as ss
    ins = _ssd_inputs(cuda, 1, 2048, 64, 64, 1, 128, getattr(torch, dtype),
                      views=True)
    first = ss.ssd_scan_fwd(*ins, 256)
    again = ss.ssd_scan_fwd(*ins, 256)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_backward_on_card_is_autograd_over_the_plain_version(cuda,
                                                                 dtype):
    """`ops.ssd_scan` launches the forward kernel once. In fp32 its
    backward is autograd over `ref.ssd_scan_ref` for every input; in bf16
    it launches the backward kernel once, which matches the plain twin
    `ref.ssd_scan_bwd_ref` at the forward's bf16 bounds."""
    ins = _ssd_inputs(cuda, 1, 256, 4, 32, 2, 16, getattr(torch, dtype))
    a = [t.detach().requires_grad_() for t in ins]
    w = [t.detach().requires_grad_() for t in ins]
    before = dict(ops.launches)
    y = ops.ssd_scan(*a, 64)
    assert ops.launches["ssd_scan_fwd"] == before["ssd_scan_fwd"] + 1
    dy = torch.randn_like(y)
    got = torch.autograd.grad(y, a, dy)
    if dtype == "float32":
        assert ops.launches["ssd_scan_bwd"] == before["ssd_scan_bwd"]
        want = torch.autograd.grad(ref.ssd_scan_ref(*w, 64), w, dy)
        for g_, w_ in zip(got, want):
            assert g_.shape == w_.shape
            np.testing.assert_allclose(_np(g_), _np(w_), rtol=1e-4,
                                       atol=1e-4 * float(w_.abs().max()))
        return
    assert ops.launches["ssd_scan_bwd"] == before["ssd_scan_bwd"] + 1
    want = ref.ssd_scan_bwd_ref(*ins, dy, 64)
    torch.cuda.synchronize()
    for g_, w_ in zip(got, want):
        assert g_.dtype == w_.dtype and g_.shape == w_.shape
        err = g_.float() - w_.float()
        assert float(err.abs().max()) <= 2e-2 * float(w_.float().abs().max())
        assert float(err.norm() / w_.float().norm()) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,g,n,chunk,views", [
    (4, 2048, 64, 64, 1, 128, 256, True),   # mamba2 train, as the cell runs
    (1, 2048, 64, 64, 1, 128, 256, False),  # mamba2 prefill's shape
    (2, 2048, 64, 64, 1, 128, 256, False),
    (1, 2048, 64, 64, 1, 64, 256, False),   # zamba2-1.2b
    (1, 256, 8, 64, 2, 32, 128, False),     # grouped B/C
    (1, 32, 4, 32, 1, 16, 32, False),       # one ragged chunk
    (1, 2000, 8, 64, 1, 128, 250, False),   # many chunks, the last ragged
    (2, 100, 8, 64, 2, 64, 100, False),     # under one chunk
    (2, 640, 8, 32, 4, 16, 128, False),     # g > 1, n=16, p=32 (SMOKE)
    (1, 2048, 64, 64, 1, 128, 256, True),   # views of one conv output
    (2, 200, 8, 32, 2, 16, 200, True),
])
def test_ssd_bwd_kernel_matches_plain_on_card(cuda, b, s, h, p, g, n, chunk,
                                              views):
    """The bf16 backward kernel against `ref.ssd_scan_bwd_ref` on the same
    bf16 inputs, every gradient at the forward's bf16 bounds: 2e-2 of max
    |plain| and 1e-2 in relative Frobenius norm. dx, dB and dC round to
    bf16 once, from fp32 sums of bf16 operands (the scores, the weighted
    x and dy, the state tiles rounded once, as the forward rounds them);
    ddt and dA stay in fp32 and read about 1e-3 of max |plain| and 3e-4 to
    9e-4 in norm on the H100, from the same rounded operands."""
    from repro_torch.kernels import ssd_scan as ss
    x, dt, A, B, C = _ssd_inputs(cuda, b, s, h, p, g, n, torch.bfloat16,
                                 views=views)
    if views:
        assert x.stride(1) == B.stride(1) == h * p + 2 * g * n
    dy = torch.randn(x.shape, device=cuda).to(torch.bfloat16)
    got = ss.ssd_scan_bwd(x, dt, A, B, C, dy, chunk)
    want = ref.ssd_scan_bwd_ref(x, dt, A, B, C, dy, chunk)
    torch.cuda.synchronize()
    for g_, w_ in zip(got, want):
        assert g_.dtype == w_.dtype and g_.shape == w_.shape
        assert bool(torch.isfinite(g_).all())
        err = g_.float() - w_.float()
        assert float(err.abs().max()) <= 2e-2 * float(w_.float().abs().max())
        assert float(err.norm() / w_.float().norm()) <= 1e-2


@pytest.mark.cuda
def test_ssd_bwd_kernel_is_deterministic_and_counted_once_on_card(cuda):
    """No atomics: two calls at mamba2-1.3b's training shape give the same
    bits, and `ops.ssd_scan`'s backward counts one launch a call, however
    many CUDA kernels it runs."""
    from repro_torch.kernels import ssd_scan as ss
    ins = _ssd_inputs(cuda, 4, 2048, 64, 64, 1, 128, torch.bfloat16,
                      views=True)
    dy = torch.randn(ins[0].shape, device=cuda).to(torch.bfloat16)
    first = ss.ssd_scan_bwd(*ins, dy, 256)
    again = ss.ssd_scan_bwd(*ins, dy, 256)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    leaves = [t.detach().requires_grad_() for t in ins]
    before = dict(ops.launches)
    y = ops.ssd_scan(*leaves, 256)
    torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert ops.launches == {**before,
                            "ssd_scan_fwd": before["ssd_scan_fwd"] + 1,
                            "ssd_scan_bwd": before["ssd_scan_bwd"] + 1}


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (2, 64, 4, 32, 1, 16, 16),      # several chunks, n=16, p=32
    (1, 96, 6, 32, 3, 16, 32),      # g > 1
    (1, 128, 4, 64, 2, 128, 32),    # n=128, p=64, two groups
    (2, 64, 2, 64, 1, 128, 64),     # a chunk equal to s
    (1, 48, 4, 32, 2, 32, 48),      # one chunk, not a power of two
])
def test_ssd_bwd_ref_is_autograd_over_the_plain_scan(b, s, h, p, g, n,
                                                      chunk):
    """The closed-form backward equals autograd over `ref.ssd_scan_ref`
    for all five gradients, both in fp32, to 1e-5 of max |want|."""
    x, dt, A, B, C = _ssd_inputs("cpu", b, s, h, p, g, n, torch.float32)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(1))
    leaves = [t.detach().requires_grad_() for t in (x, dt, A, B, C)]
    want = torch.autograd.grad(ref.ssd_scan_ref(*leaves, chunk), leaves, dy)
    got = ref.ssd_scan_bwd_ref(x, dt, A, B, C, dy, chunk)
    for g_, w_ in zip(got, want):
        assert g_.dtype == w_.dtype and g_.shape == w_.shape
        np.testing.assert_allclose(_np(g_), _np(w_), rtol=0,
                                   atol=1e-5 * float(w_.abs().max()))


def _ssd_meta(b, s, h, p, g, n, dtype=torch.bfloat16):
    def meta(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device="meta")
    return (meta(b, s, h, p), meta(b, s, h, dt=torch.float32),
            meta(h, dt=torch.float32), meta(b, s, g, n), meta(b, s, g, n))


@pytest.mark.parametrize("wrt", [(0, 1, 2, 3, 4), (0, 3), (1, 2)])
def test_ssd_bf16_backward_on_meta_tallies_the_kernel(wrt):
    """On the meta device a bf16 backward takes the kernel's path: it
    tallies one `ssd_scan_bwd` call at `bwd_cost`, launches nothing, and
    returns gradients of the inputs' shapes and dtypes for the inputs that
    need them."""
    from repro_torch.kernels import ssd_scan as ss
    ins = [t.requires_grad_(i in wrt)
           for i, t in enumerate(_ssd_meta(2, 256, 8, 64, 2, 128))]
    ops.reset_launches()
    ops.reset_tally()
    y = ops.ssd_scan(*ins, 128)
    got = torch.autograd.grad(y, [ins[i] for i in wrt], torch.empty_like(y))
    assert [(t.shape, t.dtype, t.device.type) for t in got] == \
        [(ins[i].shape, ins[i].dtype, "meta") for i in wrt]
    assert ops.tally["ssd_scan_bwd"] == [1, *ss.bwd_cost(2, 256, 8, 64, 2,
                                                         128, 2)]
    assert set(ops.launches.values()) == {0}


def test_ssd_fp32_backward_on_meta_stays_autograd():
    """fp32 keeps autograd over the plain scan: no kernel call tallied."""
    ins = [t.requires_grad_() for t in _ssd_meta(1, 64, 2, 32, 1, 16,
                                                 torch.float32)]
    ops.reset_tally()
    y = ops.ssd_scan(*ins, 32)
    got = torch.autograd.grad(y, ins, torch.empty_like(y))
    assert [t.shape for t in got] == [t.shape for t in ins]
    assert ops.tally["ssd_scan_bwd"] == [0, 0.0, 0.0]


def test_ssd_bwd_launcher_refuses_what_the_kernel_does_not_take():
    from repro_torch.kernels import ssd_scan as ss
    x, dt, A, B, C = _ssd_inputs("cpu", 1, 64, 2, 32, 1, 16, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        ss.ssd_scan_bwd(x, dt, A, B, C, torch.zeros_like(x), 64)
    meta = [t.to("meta") for t in (x, dt, A, B, C)]
    with pytest.raises(TypeError):               # fp32 takes autograd
        ss.ssd_scan_bwd(*[t.float() for t in meta], meta[0].float(), 64)
    with pytest.raises(ValueError, match="head_dim"):
        wide = _ssd_meta(1, 64, 2, 48, 1, 16)
        ss.ssd_scan_bwd(*wide, torch.empty_like(wide[0]), 64)
    with pytest.raises(ValueError, match="dy"):
        ss.ssd_scan_bwd(*meta, meta[0][:, :32], 64)
    # the bwd cost at the cell's call: 64.7 GFLOP, 213.9 MB
    flops, nbytes = ss.bwd_cost(4, 2048, 64, 64, 1, 128)
    assert (flops, nbytes) == (64693993472.0, 213910016.0)


def test_ssd_bwd_cost_counts_the_kernels_chunk():
    """`bwd_cost` counts 64-token chunks, as the kernel runs them, and a
    ragged last chunk at its own length: its products are additive over
    the chunks and its bytes over the tokens."""
    from repro_torch.kernels import ssd_scan as ss
    shape = dict(b=1, h=2, p=32, g=1, n=16)
    full = ss.bwd_cost(s=ss.BWD_CHUNK, **shape)
    part = ss.bwd_cost(s=36, **shape)
    both = ss.bwd_cost(s=ss.BWD_CHUNK + 36, **shape)
    assert both[0] == full[0] + part[0]
    assert both[1] == full[1] + part[1] - 8 * shape["h"]   # A, dA once
    assert ss.bwd_cost(s=4 * ss.BWD_CHUNK, **shape)[0] == 4 * full[0]


# ---------------------------------------------------------- event select
def _es_matrix(n, m, dtype, seed=0):
    """Random event times with 30% masked, and the edge rows where n
    allows: all masked, a full tie, -inf twice, a NaN."""
    rng = np.random.default_rng(seed)
    ev = rng.uniform(0.0, 1e6, (n, m))
    ev[rng.random((n, m)) < 0.3] = np.inf
    if n >= 4:
        ev[0] = np.inf
        ev[1] = 7.0
        ev[2, 1] = ev[2, m - 1] = -np.inf
        ev[3, 1] = np.nan
    return torch.from_numpy(ev.astype(dtype))


def test_event_select_cpu_tensors_never_reach_the_kernel():
    """On the CPU `ops.event_select` is the plain version and counts no
    launch; the launcher itself refuses a CPU tensor."""
    from repro_torch.kernels import event_select as es
    before = dict(ops.launches)
    ev = _es_matrix(257, 17, "float64")
    t, i = ops.event_select(ev)
    want_t, want_i = ref.event_select_ref(ev)
    assert torch.equal(i, want_i) and i.dtype == torch.int32
    assert torch.equal(t.view(torch.int64), want_t.view(torch.int64))
    assert ops.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        es.event_select_fwd(ev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n,m", [(65536, 8), (4096, 8), (1, 2), (257, 17)])
def test_event_select_kernel_matches_plain_on_card(cuda, n, m, dtype):
    """Bit for bit: the minimum (NaN rows: the row's first NaN) and the
    lowest column attaining it."""
    from repro_torch.kernels import event_select as es
    ev = _es_matrix(n, m, dtype).to(cuda)
    t, i = es.event_select_fwd(ev)
    want_t, want_i = ref.event_select_ref(ev)
    torch.cuda.synchronize()
    bits = torch.int64 if dtype == "float64" else torch.int32
    assert t.dtype == ev.dtype and i.dtype == torch.int32
    assert torch.equal(i, want_i)
    assert torch.equal(t.view(bits), want_t.view(bits))
    if n >= 4:
        assert i[:4].tolist() == [0, 0, 1, 0]
        assert t[:2].tolist() == [float("inf"), 7.0]
        assert t[2].item() == float("-inf") and bool(torch.isnan(t[3]))


@pytest.mark.cuda
def test_event_select_launcher_refuses_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels import event_select as es
    ev = _es_matrix(64, 8, "float64").to(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        es.event_select_fwd(ev.t())
    with pytest.raises(ValueError, match="contiguous"):
        es.event_select_fwd(ev[:0])
    with pytest.raises(TypeError):
        es.event_select_fwd(ev.to(torch.int64))
    before = ops.launches["event_select_fwd"]
    ops.event_select(ev)
    torch.cuda.synchronize()
    assert ops.launches["event_select_fwd"] == before + 1


# ------------------------------------------------------------- the build
def test_build_names_the_library_by_its_sources(tmp_path, monkeypatch):
    """An edited source gets a new library name, so a stale build is
    never loaded."""
    from repro_torch.kernels import _build
    for name in _build.SOURCES:
        (tmp_path / name).write_bytes((_build.CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path()
    assert before.parent == _build.BUILD_DIR
    (tmp_path / _build.SOURCES[0]).write_text("// edited\n")
    assert _build.library_path() != before


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)      # nothing built
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert list(tmp_path.iterdir()) == []


def test_kernel_launchers_refuse_cpu_tensors():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    x = torch.zeros(2, 128)
    with pytest.raises(ValueError, match="CUDA"):
        rn.rmsnorm_fwd(x, torch.ones(128))
    q = torch.zeros(1, 4, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_fwd(q, q, q)
    from repro_torch.kernels import ssd_scan as ss
    with pytest.raises(ValueError, match="CUDA"):
        ss.ssd_scan_fwd(*_ssd_inputs("cpu", 1, 64, 2, 32, 1, 16,
                                     torch.float32), chunk=64)
