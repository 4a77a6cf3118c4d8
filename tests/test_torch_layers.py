"""The port's layers (`repro_torch.models.layers`) held against the JAX
package's, on the same numpy inputs and weights, on the CPU.

Tolerances: 1e-5 for fp32 where both sides compute the same function in
the same precision (only the order of sums differs), 2e-2 in bf16 as in
tests/test_kernels.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import layers as JL
from repro_torch import bridge
from repro_torch.configs import get_config as torch_config
from repro_torch.models import layers as TL

CFG = get_config("qwen3-1.7b", smoke=True)           # JAX side
TCFG = torch_config("qwen3-1.7b", smoke=True)        # port side


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("jdt,tdt,tol", [(jnp.float32, torch.float32, 1e-5),
                                         (jnp.bfloat16, torch.bfloat16, 2e-2)])
def test_rmsnorm_and_head_rmsnorm(jdt, tdt, tol):
    x = _normal(0, (2, 6, CFG.d_model))
    scale = np.linspace(0.5, 1.5, CFG.d_model, dtype=np.float32)
    want = JL.rmsnorm({"scale": jnp.asarray(scale)},
                      jnp.asarray(x).astype(jdt), CFG.norm_eps)
    got = TL.rmsnorm({"scale": torch.from_numpy(scale)},
                     torch.from_numpy(x).to(tdt), CFG.norm_eps)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)

    q = _normal(1, (2, 6, CFG.n_heads, CFG.head_dim))
    hs = np.linspace(0.8, 1.2, CFG.head_dim, dtype=np.float32)
    want = JL.head_rmsnorm(jnp.asarray(hs), jnp.asarray(q).astype(jdt))
    got = TL.head_rmsnorm(torch.from_numpy(hs), torch.from_numpy(q).to(tdt))
    assert got.shape == q.shape and got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("rot_frac", [1.0, 0.25])   # full and partial rotary
def test_apply_rope(rot_frac):
    x = _normal(2, (2, 9, 4, 32))
    pos = np.stack([np.arange(9), np.arange(9) + 5]).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, rot_frac)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos).long(),
                        1e6, rot_frac)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    # the non-rotating tail passes through untouched
    rot = int(32 * rot_frac)
    np.testing.assert_array_equal(_np(got)[..., rot:], x[..., rot:])


def _attn_params():
    p = JL.init_attention(jax.random.PRNGKey(4), CFG)
    vals, _ = JL.split_params(p)
    return vals, bridge.from_numpy(jax.tree.map(np.asarray, vals), "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_attention(dtype):
    jcfg = CFG.with_(use_pallas=True, dtype=dtype)
    jvals, tvals = _attn_params()
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    x = _normal(5, (2, 16, CFG.d_model))
    pos = np.broadcast_to(np.arange(16), (2, 16)).astype(np.int32)
    want, _ = JL.attention(jvals, jcfg, jnp.asarray(x).astype(jdt),
                           jnp.asarray(pos))
    got, cache = TL.attention(tvals, TCFG, torch.from_numpy(x).to(tdt),
                              torch.from_numpy(pos).long())
    assert cache is None and got.dtype == tdt
    scale = np.abs(_np(want)).max()
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got) / scale, _np(want) / scale,
                               atol=tol)


@pytest.mark.parametrize("vector_index", [False, True])
def test_decode_attention(vector_index):
    """One decode step against a half-filled fp32 cache: the output and
    the written cache row, with a scalar index (lockstep) and a per-row
    vector index (continuous batching, rows at different depths)."""
    jvals, tvals = _attn_params()
    B, T = 2, 12
    shape = (B, T, CFG.n_kv_heads, CFG.head_dim)
    ck, cv = _normal(6, shape), _normal(7, shape)
    x = _normal(8, (B, 1, CFG.d_model))
    idx = np.array([5, 9], np.int32) if vector_index else np.int32(5)
    pos = (idx[:, None] if vector_index
           else np.full((B, 1), idx)).astype(np.int32)
    want, want_cache = JL.attention(
        jvals, CFG.with_(dtype="float32"), jnp.asarray(x), jnp.asarray(pos),
        cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
        cache_index=jnp.asarray(idx))
    t_idx = torch.from_numpy(idx).long() if vector_index else int(idx)
    t_cache = {"k": torch.from_numpy(ck.copy()),
               "v": torch.from_numpy(cv.copy())}
    got, got_cache = TL.attention(tvals, TCFG.with_(dtype="float32"),
                                  torch.from_numpy(x),
                                  torch.from_numpy(pos).long(),
                                  cache=t_cache, cache_index=t_idx)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    for name in ("k", "v"):
        assert got_cache[name] is t_cache[name]       # written in place
        np.testing.assert_allclose(_np(got_cache[name]),
                                   _np(want_cache[name]), atol=1e-5,
                                   rtol=1e-5)


def test_mlp_swiglu_and_gelu():
    x = _normal(9, (2, 5, 64))
    for variant in ("swiglu", "gelu"):
        p = JL.init_mlp(jax.random.PRNGKey(10), 64, 96, variant)
        vals, _ = JL.split_params(p)
        tvals = bridge.from_numpy(jax.tree.map(np.asarray, vals), "cpu")
        want = JL.mlp(vals, jnp.asarray(x))
        got = TL.mlp(tvals, torch.from_numpy(x))
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("hd", [80, 128])
def test_flash_attention_with_a_gradient_reaches_the_launcher(hd):
    """A forward that needs a gradient at head_dim 80 (hubert-xlarge's
    training) is no longer refused: `_FlashAttention` goes on to the
    launcher, whose first check is that the tensors lie on the card, as
    at any other head dim."""
    from repro_torch.kernels import ops
    q = torch.zeros(1, 4, 2, hd, requires_grad=True)
    with pytest.raises(ValueError, match="CUDA device"):
        ops._FlashAttention.apply(q, q, q, False)
