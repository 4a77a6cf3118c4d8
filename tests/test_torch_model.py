"""The port's model (`repro_torch.models`) held against the JAX package's
on the qwen3-1.7b SMOKE config, with the same weights (crossed via
`repro_torch.bridge`) and the same numpy tokens, on the CPU.

The JAX side runs with ``use_pallas=True``, so its prefill goes through
the Pallas flash-attention kernel in interpret mode. Tolerances are
scale-relative (as tests/test_models_smoke.py): 1e-4 in fp32, 2e-2 in
bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import api as japi
from repro_torch import bridge
from repro_torch.configs import get_config as torch_config
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import api as tapi
from repro_torch.tree import flatten

B, S = 2, 16


@pytest.fixture(scope="module")
def weights():
    """JAX values and the same weights as port tensors."""
    cfg = get_config("qwen3-1.7b", smoke=True)
    vals, _ = japi.init(cfg, jax.random.PRNGKey(0))
    return vals, bridge.from_numpy(jax.tree.map(np.asarray, vals), "cpu")


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-6))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_prefill_logits_match_jax(weights, dtype, tol):
    jvals, tvals = weights
    jcfg = get_config("qwen3-1.7b", smoke=True).with_(use_pallas=True,
                                                      dtype=dtype)
    tcfg = torch_config("qwen3-1.7b", smoke=True).with_(dtype=dtype)
    toks = _tokens(0, (B, S), jcfg.vocab_size)
    want = japi.prefill(jvals, jcfg, {"tokens": jnp.asarray(toks)})
    got = make_prefill_step(tcfg)(tvals, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (B, S, jcfg.vocab_size) and got.dtype == getattr(
        torch, dtype)
    assert _rel_err(got.float(), want.astype(jnp.float32)) < tol


@pytest.mark.parametrize("vector_index", [False, True])
def test_decode_steps_match_jax(weights, vector_index):
    """8 decode positions against an fp32 cache on both sides; the index
    is a scalar (lockstep) or a per-row vector (the gateway's path)."""
    jvals, tvals = weights
    jcfg = get_config("qwen3-1.7b", smoke=True).with_(dtype="float32")
    tcfg = torch_config("qwen3-1.7b", smoke=True).with_(dtype="float32")
    toks = _tokens(1, (B, 8), jcfg.vocab_size)
    jstate, _ = japi.init_decode_state(jcfg, B, 8, dtype=jnp.float32)
    tstate, _ = tapi.init_decode_state(tcfg, B, 8, dtype=torch.float32,
                                       device="cpu")
    serve = make_serve_step(tcfg)
    for i in range(8):
        jidx = jnp.full((B,), i, jnp.int32) if vector_index else jnp.int32(i)
        tidx = torch.full((B,), i) if vector_index else i
        want, jstate = japi.decode_step(jvals, jcfg, jstate,
                                        jnp.asarray(toks[:, i]), jidx)
        got, tstate = serve(tvals, tstate, torch.from_numpy(toks[:, i]),
                            tidx)
        assert got.shape == (B, jcfg.vocab_size)
        assert _rel_err(got, want) < 1e-4, i


def test_decode_matches_prefill(weights):
    """The port's own cache path agrees with its prefill path (fp32)."""
    _, tvals = weights
    tcfg = torch_config("qwen3-1.7b", smoke=True).with_(dtype="float32")
    toks = torch.from_numpy(_tokens(2, (B, 8), tcfg.vocab_size))
    full = tapi.prefill(tvals, tcfg, {"tokens": toks})
    state, _ = tapi.init_decode_state(tcfg, B, 8, dtype=torch.float32,
                                      device="cpu")
    for i in range(8):
        lg, state = tapi.decode_step(tvals, tcfg, state, toks[:, i], i)
        assert _rel_err(lg, full[:, i]) < 1e-4, i


def test_init_matches_reference_tree(weights):
    """Same paths, shapes, dtypes and logical axes as the reference's
    `api.init`; the weights themselves come from a torch.Generator."""
    jvals, _ = weights
    cfg = get_config("qwen3-1.7b", smoke=True)
    _, jaxes = japi.init(cfg, jax.random.PRNGKey(0))
    tvals, taxes = tapi.init(torch_config("qwen3-1.7b", smoke=True),
                             torch.Generator().manual_seed(3), device="cpu")
    jflat = dict(flatten(jax.tree.map(np.asarray, jvals)))
    tflat = dict(flatten(tvals))
    assert sorted(jflat) == sorted(tflat)
    for path, arr in jflat.items():
        assert tuple(tflat[path].shape) == arr.shape, path
        assert tflat[path].dtype == torch.float32
    assert dict(flatten(taxes)) == dict(flatten(jaxes))
    # the same scales: embed 0.02, projections 1/sqrt(fan_in)
    assert abs(float(tflat["embed"].std()) - 0.02) < 2e-3
    d = cfg.d_model
    assert abs(float(tflat["layers/attn/wq"].std()) - d ** -0.5) < 0.01


def test_bridge_round_trip_is_bit_exact(weights):
    jvals, tvals = weights
    back = bridge.to_numpy(tvals)
    for path, arr in flatten(jax.tree.map(np.asarray, jvals)):
        got = dict(flatten(back))[path]
        assert got.dtype == arr.dtype
        np.testing.assert_array_equal(got.view(np.uint8), arr.view(np.uint8))
    # bf16 crosses bit for bit too
    bf = np.asarray(jnp.asarray(_tokens(3, (4, 5), 1000) / 7.0,
                                jnp.bfloat16))
    t = bridge.from_numpy({"x": bf}, "cpu")["x"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(bridge.to_numpy({"x": t})["x"].view(
        np.uint16), bf.view(np.uint16))


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    want = float(japi.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(tapi.cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(labels)))
    assert abs(got - want) < 1e-5 * max(1.0, abs(want))


def test_bridge_gives_bf16_as_words():
    """bf16 leaves leave the port as raw int16 words, which need no
    `ml_dtypes`; viewed as JAX's bf16 type they come back bit for bit."""
    t = torch.linspace(-3, 3, 11).to(torch.bfloat16)
    words = bridge.to_numpy({"x": t})["x"]
    assert words.dtype == np.int16
    np.testing.assert_array_equal(words, t.view(torch.int16).numpy())
    typed = words.view(jnp.bfloat16)
    assert typed.dtype == jnp.bfloat16
    assert torch.equal(bridge.from_numpy({"x": typed}, "cpu")["x"], t)
