"""The int8 KV cache (`cfg.kv_quant`) of the port held against the JAX
package's, on the CPU.

* `_quant_int8`: the int8 values equal the reference's exactly and the
  scales to one float32 ulp (here they come out equal).
* Decode of the qwen3-1.7b and stablelm-1.6b SMOKE configs in fp32 with an
  int8 cache: each step's logits within 1e-5 of max |logit| of the
  reference's decode on the same weights (the fp32 decode's bound in
  tests/test_torch_ssm.py), and the last step within the reference test's
  own bounds against prefill (tests/test_kv_quant.py: relative distance
  under 0.05 of max |logit|, correlation above 0.999); greedy streams
  through the gateway equal the reference's.
* The cache's bytes equal the reference's `decode_state_specs` count at
  full qwen3 width (and stay under 0.52x the bf16 cache's); MLA's latent
  cache ignores `kv_quant`, as the reference's does; the hybrid's shared
  attention has no int8 cache, so zamba2 refuses it.

The test marked ``cuda`` runs on the card (skipped here): the int8
gateway's greedy replay at full qwen3 width is deterministic.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.api.serving import generate
from repro_torch.configs import get_config as torch_config
from repro_torch.models import api as tapi
from repro_torch.models import layers as TL
from repro_torch.tree import flatten

ARCHS = ["qwen3-1.7b", "stablelm-1.6b"]


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.api.serving import generate as jgenerate
    from repro.configs import get_config
    from repro.models import api as japi
    from repro.models import layers as JL
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=get_config,
                                 api=japi, layers=JL, generate=jgenerate)


def _configs(J, arch, **kw):
    return (J.get_config(arch, smoke=True).with_(dtype="float32", **kw),
            torch_config(arch, smoke=True).with_(dtype="float32", **kw))


def _weights(J, jcfg):
    vals, _ = J.api.init(jcfg, J.jax.random.PRNGKey(0))
    return vals, bridge.from_numpy(J.jax.tree.map(np.asarray, vals), "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,scale", [((4, 16, 2, 64), 1.0),
                                         ((2, 1, 8, 128), 30.0),
                                         ((3, 5, 4, 80), 1e-9)])
def test_quant_int8_equals_the_references(J, shape, scale, dtype):
    x = (np.random.default_rng(0).standard_normal(shape) * scale).astype(
        np.float32)
    x[0, 0, 0] = 0.0                    # an all-zero row: the scale floor
    jq, js = J.layers._quant_int8(J.jnp.asarray(x).astype(dtype))
    tq, ts = TL._quant_int8(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    js = np.asarray(js)
    assert np.all(np.abs(ts.numpy() - js) <= np.spacing(np.abs(js)))


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_decode_matches_the_references(J, arch):
    jcfg, tcfg = _configs(J, arch, kv_quant=True)
    jvals, tvals = _weights(J, jcfg)
    Bz, S = 2, 10
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                             (Bz, S)).astype(np.int32)
    jst, _ = J.api.init_decode_state(jcfg, batch=Bz, max_len=S,
                                     dtype=J.jnp.float32)
    tst, _ = tapi.init_decode_state(tcfg, Bz, S, dtype=torch.float32,
                                    device="cpu")
    assert tst["layers"]["k"].dtype == torch.int8
    with torch.no_grad():
        for i in range(S):
            want, jst = J.api.decode_step(jvals, jcfg, jst,
                                          J.jnp.asarray(toks[:, i]),
                                          J.jnp.int32(i))
            got, tst = tapi.decode_step(tvals, tcfg, tst,
                                        torch.from_numpy(toks[:, i]), i)
            want = np.asarray(want)
            assert np.abs(got.numpy() - want).max() <= \
                1e-5 * np.abs(want).max(), i
        full = tapi.prefill(tvals, tcfg.with_(kv_quant=False),
                            {"tokens": torch.from_numpy(toks)})[:, -1]
    rel = float((got - full).abs().max() / full.abs().max())
    corr = float(np.corrcoef(got.numpy().ravel(), full.numpy().ravel())[0, 1])
    assert rel < 0.05 and corr > 0.999, (rel, corr)


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_greedy_streams_match_the_references(J, arch):
    jcfg, tcfg = _configs(J, arch, kv_quant=True)
    jvals, tvals = _weights(J, jcfg)
    prompt = np.random.default_rng(2).integers(0, jcfg.vocab_size, (3, 6))
    want = J.generate(jcfg, jvals, batch=3, prompt_len=6, tokens=5,
                      prompt=prompt.astype(np.int32))
    got = generate(tcfg, tvals, batch=3, prompt_len=6, tokens=5,
                   prompt=prompt, device="cpu")
    np.testing.assert_array_equal(np.asarray(got.generated),
                                  np.asarray(want.generated))


def _cache_bytes(state):
    return sum(t.numel() * t.element_size() for _, t in flatten(state))


@pytest.mark.parametrize("kv_quant", [False, True])
def test_cache_bytes_equal_the_references(J, kv_quant):
    jcfg = J.get_config("qwen3-1.7b").with_(kv_quant=kv_quant)
    tcfg = torch_config("qwen3-1.7b").with_(kv_quant=kv_quant)
    vals, _ = J.api.decode_state_specs(jcfg, batch=1, max_len=32768)
    want = sum(int(np.dtype(v.dtype).itemsize) * int(np.prod(v.shape))
               for v in J.jax.tree.leaves(vals))
    state, axes = tapi.init_decode_state(tcfg, 1, 32768, device="meta")
    assert _cache_bytes(state) == want
    assert axes["layers"]["k"] == ("layers", "batch", "kv_seq", "kv_heads",
                                   None)
    if kv_quant:
        assert axes["layers"]["k_scale"] == ("layers", "batch", "kv_seq",
                                             "kv_heads")
        # 28 layers x (K, V) x 8 heads x (128 int8 + a 4-byte scale)
        assert want == 32768 * 28 * 2 * 8 * (128 + 4)
        bf16 = _cache_bytes(tapi.init_decode_state(
            tcfg.with_(kv_quant=False), 1, 32768, device="meta")[0])
        assert want < 0.52 * bf16


def test_mla_cache_ignores_kv_quant(J):
    jcfg, tcfg = _configs(J, "deepseek-v2-lite-16b")
    plain, plain_axes = tapi.init_decode_state(tcfg, 2, 8, device="cpu")
    quant, quant_axes = tapi.init_decode_state(tcfg.with_(kv_quant=True), 2,
                                               8, device="cpu")
    assert quant_axes == plain_axes
    assert [(p, t.shape, t.dtype) for p, t in flatten(quant)] == \
        [(p, t.shape, t.dtype) for p, t in flatten(plain)]
    jvals, tvals = _weights(J, jcfg)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (2, 8)))
    with torch.no_grad():
        for i in range(8):
            a, plain = tapi.decode_step(tvals, tcfg, plain, toks[:, i], i)
            b, quant = tapi.decode_step(tvals, tcfg.with_(kv_quant=True),
                                        quant, toks[:, i], i)
            assert torch.equal(a, b), i


def test_hybrid_refuses_the_int8_cache():
    cfg = torch_config("zamba2-1.2b", smoke=True).with_(kv_quant=True)
    with pytest.raises(ValueError, match="hybrid"):
        tapi.init_decode_state(cfg, 2, 8, device="cpu")


# --------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_int8_gateway_replay_on_card_is_deterministic(cuda):
    """qwen3-1.7b at full width (bf16) with the int8 cache: two greedy
    runs of the 4-slot gateway give the same tokens, and the cache holds
    int8 values."""
    cfg = torch_config("qwen3-1.7b", smoke=False).with_(kv_quant=True)
    params = tapi.init(cfg, torch.Generator(device=cuda).manual_seed(0),
                       device=cuda)[0]
    runs = [generate(cfg, params, batch=4, prompt_len=16, tokens=8, seed=1,
                     device=cuda) for _ in range(2)]
    assert runs[0].generated.shape == (4, 8)
    assert torch.equal(runs[0].generated, runs[1].generated)
    state, _ = tapi.init_decode_state(cfg, 1, 4, device=cuda)
    assert state["layers"]["k"].dtype == torch.int8
