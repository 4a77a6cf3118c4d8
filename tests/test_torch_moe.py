"""The port's MoE and MLA paths (`repro_torch.models.layers.moe`,
`mla_attention`, `_chunked_attn` and `transformer` with its
``dense_layers``) held against the JAX package's, on the CPU at the
granite-moe-3b-a800m and deepseek-v2-lite-16b SMOKE configs.

Both packages get the same weights (the reference's `init`, crossed with
`repro_torch.bridge`) and the same numpy inputs. Tolerances, each with
its reason:

* fp32 outputs (the MoE layer, MLA prefill and decode, logits): 2e-5 of
  max |want|; the sums run in another order (the combine sums a token's
  k pairs in one pass where the reference scatter-adds them);
* the aux loss: 1e-6 relative; routing (`top_e`) and the kept-pair mask
  are equal, and the dispatch is equal to the bit;
* bf16 logits: the port's distance from the reference's fp32 logits
  (Frobenius, relative) is at most 1.25x the reference's own bf16
  distance, as tests/test_torch_ssm.py holds the SSM models: a bf16
  router can swap an expert at a near tie, in either package;
* `loss_fn` gradients: 3e-4 of each leaf's max |value|.

JAX is imported inside the fixture that needs it.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.api import Session
from repro_torch.api.serving import generate
from repro_torch.configs import get_config as torch_config
from repro_torch.launch import steps as tsteps
from repro_torch.models import api as tapi
from repro_torch.models import layers as TL
from repro_torch.serving.engine import GatewayEngine
from repro_torch.tree import flatten, tree_map

ARCHS = ["granite-moe-3b-a800m", "deepseek-v2-lite-16b"]
IDS = ["granite", "deepseek"]


@pytest.fixture(scope="module")
def J():
    """The JAX package, on the CPU."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from jax import lax
    from repro.api.serving import generate
    from repro.configs import get_config
    from repro.models import api as japi
    from repro.models import layers as JL
    return types.SimpleNamespace(jax=jax, jnp=jnp, lax=lax,
                                 generate=generate, get_config=get_config,
                                 api=japi, L=JL)


def _configs(J, arch, dtype="float32", **kw):
    jcfg = J.get_config(arch, smoke=True).with_(dtype=dtype, **kw)
    tcfg = torch_config(arch, smoke=True).with_(dtype=dtype, **kw)
    return jcfg, tcfg


def _weights(J, jcfg, seed=0):
    vals, _ = J.api.init(jcfg.with_(dtype="float32"),
                         J.jax.random.PRNGKey(seed))
    return vals, _tensors(J, vals)


def _tensors(J, jtree):
    return bridge.from_numpy(J.jax.tree.map(np.asarray, jtree), "cpu")


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(np.asarray(t, dtype=np.float32))


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


def _frob(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _no_drop(cfg):
    """The config at capacity_factor = E / k: every group's capacity is
    its size, so no pair is dropped."""
    mo = cfg.moe
    return cfg.with_(moe=dataclasses.replace(
        mo, capacity_factor=mo.n_experts / mo.top_k))


def _jax_route(J, jcfg, router, xf):
    """The reference `moe`'s routing lines on (G, g, d) tokens: router
    logits in the activation dtype, softmax in fp32, `lax.top_k`."""
    jnp = J.jnp
    logits = jnp.einsum("Ggd,de->Gge", xf, router.astype(xf.dtype))
    probs = J.jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    top_w, top_e = J.lax.top_k(probs, jcfg.moe.top_k)
    return top_w / jnp.sum(top_w, axis=-1, keepdims=True), top_e


# ------------------------------------------------------------------- MoE
@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_moe_layer_matches_jax(J, arch):
    """One MoE layer in fp32 (two routing groups of 64 tokens): output,
    aux loss, routing and the kept-pair mask of every group."""
    jcfg, tcfg = _configs(J, arch)
    jp, _ = J.L.split_params(J.L.init_moe(J.jax.random.PRNGKey(1), jcfg))
    tp = _tensors(J, jp)
    x = _normal(2, (2, 64, jcfg.d_model))
    want, want_aux = J.L.moe(jp, jcfg, J.jnp.asarray(x))
    got, got_aux = TL.moe(tp, tcfg, torch.from_numpy(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    assert _rel(got, want) < 2e-5
    assert abs(float(got_aux) - float(want_aux)) <= 1e-6 * float(want_aux)

    G, g = 2, 64
    cap = TL.moe_capacity(tcfg, g)
    assert cap == 24   # ceil(64 * 2 / 8 * 1.5) rounded up to 8
    xf = x.reshape(G, g, -1)
    jw, je = _jax_route(J, jcfg, jp["router"], J.jnp.asarray(xf))
    _, tw, te = TL.moe_route(tp, tcfg, torch.from_numpy(xf))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)
    E = jcfg.moe.n_experts
    for i in range(G):
        _, jmeta = J.L._group_dispatch(J.jnp.asarray(xf[i]), je[i], jw[i],
                                       E, cap)
        _, tmeta = TL._group_dispatch(torch.from_numpy(xf[i]), te[i], tw[i],
                                      E, cap)
        np.testing.assert_array_equal(tmeta[3].numpy(), np.asarray(jmeta[3]))


@pytest.mark.parametrize("seed,g,k,E,cap", [
    (0, 32, 2, 4, 8),      # 64 pairs on 4 experts of 8 slots: drops
    (1, 64, 6, 8, 16),     # deepseek's k
    (2, 16, 8, 40, 8),     # granite's E and k, a decode-sized group
])
def test_group_dispatch_and_combine_match_jax(J, seed, g, k, E, cap):
    """Skewed routing (expert e drawn with weight 1/(e+1)) so the first
    experts overflow their ``cap`` slots: the dispatch buffer, the pairs'
    destinations, tokens, weights and kept mask are equal, and the
    combine agrees to fp32 rounding."""
    rng = np.random.default_rng(seed)
    d = 16
    x = rng.standard_normal((g, d)).astype(np.float32)
    p = 1.0 / np.arange(1, E + 1)
    eid = np.stack([rng.choice(E, size=k, replace=False, p=p / p.sum())
                    for _ in range(g)]).astype(np.int32)
    w = rng.uniform(0.1, 1.0, (g, k)).astype(np.float32)
    jbuf, (jdest, jtok, jw, jkeep) = J.L._group_dispatch(
        J.jnp.asarray(x), J.jnp.asarray(eid), J.jnp.asarray(w), E, cap)
    tbuf, meta = TL._group_dispatch(torch.from_numpy(x),
                                    torch.from_numpy(eid).long(),
                                    torch.from_numpy(w), E, cap)
    dest, order, w_sorted, keep = meta
    assert not bool(keep.all()) or seed == 2
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(dest.numpy(), np.asarray(jdest))
    np.testing.assert_array_equal((order // k).numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(w_sorted.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))

    out_buf = rng.standard_normal((E * cap, d)).astype(np.float32)
    want = J.L._group_combine(J.jnp.asarray(out_buf),
                              (jdest, jtok, jw, jkeep), g, k, d)
    got = TL._group_combine(torch.from_numpy(out_buf), meta, g, k, d)
    assert got.shape == (g, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_moe_refuses_a_batch_that_does_not_split_into_groups(J):
    _, tcfg = _configs(J, "granite-moe-3b-a800m")
    params, _ = TL.split_params(TL.init_moe(torch.Generator(), tcfg))
    with pytest.raises(ValueError, match="groups of 64"):
        TL.moe(params, tcfg, torch.zeros(1, 96, tcfg.d_model))


# ------------------------------------------------------------------- MLA
@pytest.mark.parametrize("causal,chunk,q_offset", [
    (True, 64, 0), (False, 64, 0), (True, 256, 0), (True, 32, 64)])
def test_chunked_attn_matches_jax(J, causal, chunk, q_offset):
    """GQA by broadcast, q/k head dim 24 and v's 16, several query
    chunks (or one), fp32."""
    Sq = 128
    Sk = Sq + q_offset
    q = _normal(3, (2, Sq, 4, 24))
    k = _normal(4, (2, Sk, 2, 24))
    v = _normal(5, (2, Sk, 2, 16))
    want = J.L._chunked_attn(*(J.jnp.asarray(a) for a in (q, k, v)), causal,
                             q_offset, chunk=chunk)
    got = TL._chunked_attn(*(torch.from_numpy(a) for a in (q, k, v)), causal,
                           q_offset, chunk=chunk)
    assert got.shape == (2, Sq, 4, 16)
    assert _rel(got, want) < 1e-5
    with pytest.raises(ValueError, match="multiple of chunk"):
        TL._chunked_attn(*(torch.from_numpy(a) for a in (q, k, v)), causal,
                         q_offset, chunk=48)


@pytest.mark.parametrize("vector_index", [False, True])
def test_mla_prefill_and_absorbed_decode_match_jax(J, vector_index):
    """deepseek SMOKE's MLA in fp32: prefill of 16 tokens, then 8 decode
    steps against an fp32 (c_kv, k_rope) cache, each within 2e-5; the
    port's decode also agrees with its own prefill."""
    jnp = J.jnp
    jcfg, tcfg = _configs(J, "deepseek-v2-lite-16b")
    jp, _ = J.L.split_params(J.L.init_mla(J.jax.random.PRNGKey(2), jcfg))
    tp = _tensors(J, jp)
    B, S = 2, 16
    x = _normal(6, (B, S, jcfg.d_model))
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    want, _ = J.L.mla_attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got, none = TL.mla_attention(tp, tcfg, torch.from_numpy(x),
                                 torch.from_numpy(pos).long())
    assert none is None and got.shape == x.shape
    assert _rel(got, want) < 2e-5

    m = jcfg.mla
    shapes = {"c_kv": (B, 8, m.kv_lora_rank),
              "k_rope": (B, 8, m.qk_rope_head_dim)}
    jcache = {n: jnp.zeros(s, jnp.float32) for n, s in shapes.items()}
    tcache = {n: torch.zeros(s) for n, s in shapes.items()}
    for i in range(8):
        xi = x[:, i:i + 1]
        jidx = jnp.full((B,), i, jnp.int32) if vector_index else jnp.int32(i)
        tidx = torch.full((B,), i) if vector_index else i
        p_i = np.full((B, 1), i, np.int32)
        want, jcache = J.L.mla_attention(jp, jcfg, jnp.asarray(xi),
                                         jnp.asarray(p_i), jcache, jidx)
        got, tcache = TL.mla_attention(tp, tcfg, torch.from_numpy(xi),
                                       torch.from_numpy(p_i).long(), tcache,
                                       tidx)
        assert _rel(got, want) < 2e-5, i
        # the absorbed decode computes the materialised prefill's rows
        assert _rel(got[:, 0], TL.mla_attention(
            tp, tcfg, torch.from_numpy(x[:, :i + 1]),
            torch.from_numpy(pos[:, :i + 1]).long())[0][:, -1]) < 2e-5, i
    for n in shapes:
        np.testing.assert_allclose(tcache[n].numpy(), np.asarray(jcache[n]),
                                   rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- models
@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_init_matches_reference_tree(J, arch):
    """SMOKE: paths, shapes, fp32 and axes of the params and of the
    decode state (deepseek's ``dense_layers`` and MLA cache)."""
    jcfg, tcfg = _configs(J, arch)
    jvals, jaxes = J.api.init(jcfg, J.jax.random.PRNGKey(0))
    tvals, taxes = tapi.init(tcfg, torch.Generator().manual_seed(3),
                             device="cpu")
    jflat = dict(flatten(J.jax.tree.map(np.asarray, jvals)))
    tflat = dict(flatten(tvals))
    assert sorted(jflat) == sorted(tflat)
    for path, arr in jflat.items():
        assert tuple(tflat[path].shape) == arr.shape, path
        assert tflat[path].dtype == torch.float32, path
    assert dict(flatten(taxes)) == dict(flatten(jaxes))
    jst, jst_axes = J.api.init_decode_state(jcfg, 3, 8)
    tst, tst_axes = tapi.init_decode_state(tcfg, 3, 8, device="cpu")
    assert dict(flatten(tst_axes)) == dict(flatten(jst_axes))
    tst_flat = dict(flatten(tst))
    for path, arr in flatten(J.jax.tree.map(np.asarray, jst)):
        t = tst_flat[path]
        assert tuple(t.shape) == arr.shape and t.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_full_config_param_shapes_match_reference(J, arch):
    """The published configs' parameter paths and shapes, without
    allocating: the reference's `param_shapes` against a draw under
    `FakeTensorMode`."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    jcfg = J.get_config(arch)
    want = {p: tuple(s.shape)
            for p, s in flatten(J.api.param_shapes(jcfg))}
    with FakeTensorMode():
        vals, _ = tapi.init(torch_config(arch), torch.Generator())
        got = {p: tuple(t.shape) for p, t in flatten(vals)}
    assert got == want


def test_bridge_carries_the_new_paths_bit_for_bit(J):
    """`dense_layers/...`, `layers/moe/{router,wi,wg,wo}`,
    `layers/moe/shared/*`, `layers/attn/{wdkv,wkrope,wuk,wuv,kv_norm}`
    and `lm_head` cross both ways unchanged."""
    jcfg, _ = _configs(J, "deepseek-v2-lite-16b")
    jvals, tvals = _weights(J, jcfg)
    jflat = dict(flatten(J.jax.tree.map(np.asarray, jvals)))
    for path in ("dense_layers/mlp/wi", "layers/moe/router", "layers/moe/wg",
                 "layers/moe/shared/wo", "layers/attn/wdkv",
                 "layers/attn/wkrope", "layers/attn/wuk", "layers/attn/wuv",
                 "layers/attn/kv_norm", "lm_head"):
        assert path in jflat, path
    back = dict(flatten(bridge.to_numpy(tvals)))
    assert sorted(back) == sorted(jflat)
    for path, arr in jflat.items():
        np.testing.assert_array_equal(back[path], arr)


def _prefill_pair(J, arch, dtype, seed=0):
    """(reference fp32, reference, port) logits of one batch of 2 x 64
    tokens (two routing groups) on one set of fp32 weights."""
    jcfg, tcfg = _configs(J, arch, dtype)
    jvals, tvals = _weights(J, jcfg, seed)
    toks = _tokens(seed, (2, 64), jcfg.vocab_size)
    jtoks = {"tokens": J.jnp.asarray(toks)}
    f32 = J.api.prefill(jvals, jcfg.with_(dtype="float32"), jtoks)
    want = J.api.prefill(jvals, jcfg, jtoks)
    got = tsteps.make_prefill_step(tcfg)(tvals,
                                         {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 64, jcfg.vocab_size)
    assert got.dtype == getattr(torch, dtype)
    return _np(f32), _np(want.astype(J.jnp.float32)), _np(got)


@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_prefill_logits_match_jax(J, arch):
    _, want, got = _prefill_pair(J, arch, "float32")
    assert _rel(got, want) < 2e-5


@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_bf16_prefill_is_as_close_to_fp32_as_the_references(J, arch):
    """bf16 logits, mean over four seeds of the weights and tokens: the
    port's distance from the fp32 logits (Frobenius, relative) is at most
    1.25x the reference's own. A token whose bf16 router input differs by
    a rounding can swap an expert at a near tie, and either package's
    flips move whole tokens, so one seed's distance is a lottery
    (measured at seeds 0-3: reference 0.061-0.116 for granite and
    0.155-0.266 for deepseek, the port 0.061-0.142 and 0.102-0.237); the
    means were 1.07x (granite) and 0.88x (deepseek) the reference's."""
    ref_d, port_d = [], []
    for seed in range(4):
        f32, want, got = _prefill_pair(J, arch, "bfloat16", seed)
        ref_d.append(_frob(want, f32))
        port_d.append(_frob(got, f32))
    assert np.mean(port_d) <= 1.25 * np.mean(ref_d), (port_d, ref_d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vector_index", [False, True])
@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_decode_steps_match_jax(J, arch, vector_index, dtype):
    """8 decode steps, the index a scalar (lockstep) or a per-row vector
    (the gateway's path). fp32 with an fp32 cache: within 2e-5 at every
    step. bf16 with the bf16 cache: the port's logits of the 8 steps are
    as close to the reference's fp32 decode as the reference's bf16
    decode's are (Frobenius over the 8 steps, within 1.25x)."""
    jnp = J.jnp
    jcfg, tcfg = _configs(J, arch, dtype)
    jvals, tvals = _weights(J, jcfg)
    toks = _tokens(1, (2, 8), jcfg.vocab_size)
    cache_dt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    j32 = jcfg.with_(dtype="float32")
    jst32, _ = J.api.init_decode_state(j32, 2, 8, dtype=jnp.float32)
    jst, _ = J.api.init_decode_state(jcfg, 2, 8, dtype=cache_dt[0])
    tst, _ = tapi.init_decode_state(tcfg, 2, 8, dtype=cache_dt[1],
                                    device="cpu")
    serve = tsteps.make_serve_step(tcfg)
    jstep32, jstep = (J.jax.jit(lambda p, st, t, i, c=c: J.api.decode_step(
        p, c, st, t, i)) for c in (j32, jcfg))
    steps = []
    for i in range(8):
        jidx = jnp.full((2,), i, jnp.int32) if vector_index else jnp.int32(i)
        tidx = torch.full((2,), i) if vector_index else i
        tok = jnp.asarray(toks[:, i])
        f32, jst32 = jstep32(jvals, jst32, tok, jidx)
        want, jst = jstep(jvals, jst, tok, jidx)
        got, tst = serve(tvals, tst, torch.from_numpy(toks[:, i]), tidx)
        assert got.shape == (2, jcfg.vocab_size)
        if dtype == "float32":
            assert _rel(got, want) < 2e-5, i
        steps.append((_np(f32), _np(want), _np(got)))
    if dtype == "bfloat16":
        f32, want, got = (np.stack(a) for a in zip(*steps))
        assert _frob(got, f32) <= 1.25 * _frob(want, f32)


@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_loss_fn_grads_match_jax(J, arch):
    """The loss (cross-entropy plus the aux loss) and every gradient leaf
    (router, experts, shared experts, MLA, the dense layer) in fp32."""
    jnp = J.jnp
    jcfg, tcfg = _configs(J, arch)
    jvals, tvals = _weights(J, jcfg)
    toks = _tokens(3, (2, 33), jcfg.vocab_size)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jloss, jgrads = J.jax.value_and_grad(
        lambda p: J.api.loss_fn(p, jcfg, {k: jnp.asarray(v)
                                          for k, v in batch.items()}))(jvals)
    _, jaux = J.api.forward(jvals, jcfg, jnp.asarray(batch["tokens"]))
    params = tree_map(lambda t: t.requires_grad_(), tvals)
    loss = tapi.loss_fn(params, tcfg, {k: torch.from_numpy(v).long()
                                       for k, v in batch.items()})
    loss.backward()
    assert float(jaux) > 0.0
    assert abs(float(loss.detach()) - float(jloss)) < 1e-5 * abs(float(jloss))
    want = dict(flatten(J.jax.tree.map(np.asarray, jgrads)))
    got = dict(flatten(tree_map(lambda p: p.grad, params)))
    assert sorted(got) == sorted(want)
    assert any("router" in p for p in got)
    for path in want:
        assert _rel(got[path], want[path]) < 3e-4, path


@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_greedy_streams_match_jax(J, arch):
    jcfg, tcfg = _configs(J, arch)
    jvals, tvals = _weights(J, jcfg)
    prompt = _tokens(2, (3, 6), jcfg.vocab_size)
    want = J.generate(jcfg, jvals, batch=3, prompt_len=6, tokens=5,
                      prompt=prompt)
    got = generate(tcfg, tvals, batch=3, prompt_len=6, tokens=5,
                   prompt=prompt, device="cpu")
    assert got.generated.shape == (3, 5)
    np.testing.assert_array_equal(np.asarray(got.generated),
                                  np.asarray(want.generated))


@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_gateway_matches_prefill_at_the_no_drop_capacity(J, arch):
    """As `chip_smoke.py` phase 17 holds it: 4 slots fed a 32-token prompt
    one token a step through `GatewayEngine` with an fp32 model and
    state, against a prefill of the 4 x 32 tokens, at capacity_factor =
    E / k (a group's capacity equals its size, so prefill drops no pair,
    as decode's groups of 4 never do). At the published capacity the
    prefill drops pairs and the two paths differ."""
    _, tcfg = _configs(J, arch)
    cfg = _no_drop(tcfg)
    assert TL.moe_capacity(cfg, 128) == 128
    params, _ = tapi.init(cfg, torch.Generator().manual_seed(5),
                          device="cpu")
    prompt = _tokens(7, (4, 32), cfg.vocab_size)
    pre = tsteps.make_prefill_step(cfg)(
        params, {"tokens": torch.from_numpy(prompt).long()})[:, -1]
    eng = GatewayEngine(cfg, params, slots=4, max_len=48, device="cpu")
    eng.state, eng._axes = tapi.init_decode_state(cfg, 4, 48,
                                                  dtype=torch.float32,
                                                  device="cpu")
    for slot in range(4):
        eng.join(slot, rid=slot, prompt=prompt[slot].tolist(), max_new=4)
    for _ in range(32):
        eng.step()
    assert _rel(eng.last_logits, pre) < 1e-4


@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_session_prefills_and_serves_through_the_entry_points(arch):
    """`Session.from_arch` on the CPU: `make_prefill_step` and two greedy
    `Session.serve` runs with one seed give identical streams."""
    s = Session.from_arch(arch, smoke=True, device="cpu")
    toks = torch.from_numpy(_tokens(4, (1, 64), s.cfg.vocab_size)).long()
    logits = tsteps.make_prefill_step(s.cfg)(s.params, {"tokens": toks})
    assert logits.shape == (1, 64, s.cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    runs = [s.serve(tokens=4, batch=2, prompt_len=8, seed=1)
            for _ in range(2)]
    assert runs[0].generated.shape == (2, 4)
    assert torch.equal(torch.as_tensor(runs[0].generated),
                       torch.as_tensor(runs[1].generated))


def test_bf16_decode_drift_at_full_depth_is_no_larger_than_the_references(J):
    """The deepseek SMOKE widths at deepseek-v2-lite-16b's 27 layers and
    the no-drop capacity, in bf16 with the engines' bf16 cache: the
    gateway's logits at the last of 32 prompt tokens (fed one a step to
    4 slots, as `chip_smoke.py` phase 17 feeds them) against prefill's,
    max |diff| / max |prefill|, in each package on one set of weights,
    mean over seeds 0 and 1. The port's is at most 1.25x the
    reference's: bf16 rounding flips an expert at a near tie, and a
    flipped token moves every later layer, so both packages drift far
    (measured: the reference 0.590 and 1.005, the port 0.607 and 1.215).
    At granite's SMOKE widths and 32 layers both stay small (the
    reference 0 and 0.009, the port 0 and 0.026)."""
    jnp = J.jnp
    jcfg, tcfg = (_no_drop(c.with_(n_layers=27)) for c in _configs(
        J, "deepseek-v2-lite-16b", "bfloat16"))
    slots, plen = 4, 32

    def drift(served, pre):
        return float(np.max(np.abs(served - pre)) / np.max(np.abs(pre)))

    ref_d, port_d = [], []
    for seed in (0, 1):
        jvals, tvals = _weights(J, jcfg, seed)
        prompt = _tokens(7 + seed, (slots, plen), jcfg.vocab_size)
        pre = J.api.prefill(jvals, jcfg, {"tokens": jnp.asarray(prompt)})
        state, _ = J.api.init_decode_state(jcfg, slots, plen + 16)
        step = J.jax.jit(lambda p, st, t, i: J.api.decode_step(p, jcfg, st,
                                                               t, i))
        for i in range(plen):
            logits, state = step(jvals, state, jnp.asarray(prompt[:, i]),
                                 jnp.full((slots,), i, jnp.int32))
        ref_d.append(drift(_np(logits.astype(jnp.float32)),
                           _np(pre[:, -1].astype(jnp.float32))))
        eng = GatewayEngine(tcfg, tvals, slots=slots, max_len=plen + 16,
                            device="cpu")
        for slot in range(slots):
            eng.join(slot, rid=slot, prompt=prompt[slot].tolist(),
                     max_new=16)
        for _ in range(plen):
            eng.step()
        got_pre = tsteps.make_prefill_step(tcfg)(
            tvals, {"tokens": torch.from_numpy(prompt).long()})[:, -1]
        port_d.append(drift(_np(eng.last_logits), _np(got_pre)))
    print(f"reference {ref_d}, port {port_d}")
    assert all(np.isfinite(port_d)) and np.mean(ref_d) > 0.0
    assert np.mean(port_d) <= 1.25 * np.mean(ref_d), (port_d, ref_d)
