"""The VLM path the port adds — `qwen2-vl-2b`'s M-RoPE (three t/h/w
position rows, each turning its own section of the rotary frequencies)
and the `positions=` / `input_embeds=` inputs of `transformer.forward` —
held against the JAX package on the CPU at the SMOKE config.

When the three rows are equal, M-RoPE computes exactly plain RoPE, and
the reference's `make_batch` builds its positions that way. So every
comparison here draws three *different* rows with numpy; one test pins
the degenerate case on its own.

Tolerances: fp32 1e-5 of max |want| (2e-5 for decode), bf16 2e-2, the
loss 1e-5 relative and each gradient leaf 3e-4 of its max |value|, as
tests/test_torch_dense_archs.py. JAX is imported inside the fixture that
needs it.
"""
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
from repro_torch.models import transformer
from repro_torch.serving.engine import GatewayEngine
from repro_torch.tree import flatten, tree_map

ARCH = "qwen2-vl-2b"
B, S = 2, 24


@pytest.fixture(scope="module")
def J():
    """The JAX package, on the CPU."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.api.serving import generate
    from repro.configs import get_config
    from repro.models import api as japi
    from repro.models import layers as JL
    from repro.models import transformer as JT
    return types.SimpleNamespace(jax=jax, jnp=jnp, generate=generate,
                                 get_config=get_config, api=japi, L=JL,
                                 T=JT)


def _configs(J, dtype="float32"):
    return (J.get_config(ARCH, smoke=True).with_(dtype=dtype),
            torch_config(ARCH, smoke=True).with_(dtype=dtype))


def _weights(J, seed=0):
    jcfg, _ = _configs(J)
    vals, _ = J.api.init(jcfg, J.jax.random.PRNGKey(seed))
    return vals, bridge.from_numpy(J.jax.tree.map(np.asarray, vals), "cpu")


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(np.asarray(t, dtype=np.float32))


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _positions(seed, b=B, s=S):
    """Three distinct (t, h, w) rows: t runs 0..S-1, h and w are drawn,
    as an image's patches sit on a grid."""
    rng = np.random.default_rng(seed)
    t = np.broadcast_to(np.arange(s), (b, s))
    h, w = rng.integers(0, 3 * s, (2, b, s))
    pos = np.stack([t, h, w]).astype(np.int32)
    assert not (pos[0] == pos[1]).all() and not (pos[1] == pos[2]).all()
    return pos


def test_the_vlm_arch_resolves():
    from repro_torch.configs import ARCH_IDS
    assert ARCH in ARCH_IDS
    cfg = torch_config(ARCH)
    assert cfg.family == "vlm" and cfg.mrope_sections == (16, 24, 24)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("rot_frac,sections", [(1.0, (4, 6, 6)),
                                               (1.0, (16, 24, 24)),
                                               (0.5, (2, 3, 3))])
def test_mrope_matches_jax(J, rot_frac, sections, dtype, tol):
    hd = 2 * sum(sections) / rot_frac
    x = np.random.default_rng(0).standard_normal(
        (B, S, 3, int(hd))).astype(np.float32)
    pos = _positions(1)
    want = J.L.apply_rope(J.jnp.asarray(x).astype(dtype), J.jnp.asarray(pos),
                          1e6, rot_frac, sections)
    got = TL.apply_rope(torch.from_numpy(x).to(getattr(torch, dtype)),
                        torch.from_numpy(pos), 1e6, rot_frac, sections)
    assert got.dtype == getattr(torch, dtype)
    assert _rel(got, want) < tol


def test_mrope_with_equal_rows_is_plain_rope():
    """The trap: with t = h = w, M-RoPE is plain RoPE, so a parity test
    on such positions cannot tell the two apart."""
    x = torch.randn(B, S, 2, 32, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(S).expand(B, S)
    plain = TL.apply_rope(x, pos, 1e6)
    mrope = TL.apply_rope(x, pos.expand(3, B, S), 1e6,
                          mrope_sections=(4, 6, 6))
    torch.testing.assert_close(mrope, plain, rtol=0, atol=0)
    distinct = TL.apply_rope(x, torch.from_numpy(_positions(2)).long(), 1e6,
                             mrope_sections=(4, 6, 6))
    assert not torch.allclose(distinct, plain)


def test_mrope_sections_must_cover_the_rotary_half():
    x = torch.zeros(1, 2, 1, 32)
    with pytest.raises(AssertionError):
        TL.apply_rope(x, torch.zeros(3, 1, 2), 1e6, mrope_sections=(4, 4, 4))
    with pytest.raises(AssertionError, match="3,B,S"):
        TL.apply_rope(x, torch.zeros(1, 2), 1e6, mrope_sections=(4, 6, 6))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_prefill_logits_match_jax_with_distinct_rows(J, dtype, tol):
    jcfg, tcfg = _configs(J, dtype)
    jvals, tvals = _weights(J)
    toks, pos = _tokens(0, (B, S), jcfg.vocab_size), _positions(3)
    want = J.api.prefill(jvals, jcfg, {"tokens": J.jnp.asarray(toks),
                                       "positions": J.jnp.asarray(pos)})
    got = tsteps.make_prefill_step(tcfg)(
        tvals, {"tokens": torch.from_numpy(toks),
                "positions": torch.from_numpy(pos)})
    assert got.shape == (B, S, jcfg.vocab_size)
    assert _rel(got, want.astype(J.jnp.float32)) < tol
    # and the rows matter: the default positions give other logits
    default = tsteps.make_prefill_step(tcfg)(
        tvals, {"tokens": torch.from_numpy(toks)})
    assert _rel(default, got) > 10 * tol


def test_default_positions_broadcast_to_three_rows(J):
    """Without positions the forward broadcasts 0..S-1 to (3,B,S), as the
    reference does (and `make_batch`'s positions equal that)."""
    jcfg, tcfg = _configs(J)
    jvals, tvals = _weights(J)
    toks = _tokens(4, (B, S), jcfg.vocab_size)
    want, _ = J.T.forward(jvals, jcfg, J.jnp.asarray(toks))
    got, _ = transformer.forward(tvals, tcfg, torch.from_numpy(toks))
    rows = torch.arange(S).expand(3, B, S)
    explicit, _ = transformer.forward(tvals, tcfg, torch.from_numpy(toks),
                                      positions=rows)
    assert _rel(got, want) < 1e-5
    torch.testing.assert_close(got, explicit, rtol=0, atol=0)


def test_input_embeds_match_jax(J):
    """The stubbed vision frontend: patch embeddings (B,S,d) in place of
    the token embedding, with distinct rows."""
    jcfg, tcfg = _configs(J)
    jvals, tvals = _weights(J)
    emb = np.random.default_rng(5).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    pos = _positions(6)
    want, _ = J.T.forward(jvals, jcfg, None, positions=J.jnp.asarray(pos),
                          input_embeds=J.jnp.asarray(emb))
    got, _ = transformer.forward(tvals, tcfg, None,
                                 positions=torch.from_numpy(pos),
                                 input_embeds=torch.from_numpy(emb))
    assert _rel(got, want) < 1e-5


def test_loss_fn_grads_match_jax_with_distinct_rows(J):
    jnp = J.jnp
    jcfg, tcfg = _configs(J)
    jvals, tvals = _weights(J)
    toks = _tokens(7, (B, S + 1), jcfg.vocab_size)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "positions": _positions(8)}
    jloss, jgrads = J.jax.value_and_grad(
        lambda p: J.api.loss_fn(p, jcfg, {k: jnp.asarray(v)
                                          for k, v in batch.items()}))(jvals)
    params = tree_map(lambda t: t.requires_grad_(), tvals)
    loss = tapi.loss_fn(params, tcfg, {k: torch.from_numpy(v).long()
                                       for k, v in batch.items()})
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) < 1e-5 * abs(float(jloss))
    want = dict(flatten(J.jax.tree.map(np.asarray, jgrads)))
    got = dict(flatten(tree_map(lambda p: p.grad, params)))
    assert sorted(got) == sorted(want)
    for path in want:
        assert _rel(got[path], want[path]) < 3e-4, path


def test_decode_steps_match_jax(J):
    """`decode_step` broadcasts its (B,1) positions to (3,B,1): 6 steps
    against an fp32 cache, a per-row index."""
    jnp = J.jnp
    jcfg, tcfg = _configs(J)
    jvals, tvals = _weights(J)
    toks = _tokens(9, (B, 6), jcfg.vocab_size)
    jst, _ = J.api.init_decode_state(jcfg, B, 6, dtype=jnp.float32)
    tst, _ = tapi.init_decode_state(tcfg, B, 6, dtype=torch.float32,
                                    device="cpu")
    serve = tsteps.make_serve_step(tcfg)
    for i in range(6):
        want, jst = J.api.decode_step(jvals, jcfg, jst,
                                      jnp.asarray(toks[:, i]),
                                      jnp.full((B,), i, jnp.int32))
        got, tst = serve(tvals, tst, torch.from_numpy(toks[:, i]),
                         torch.full((B,), i))
        assert _rel(got, want) < 2e-5, i


def test_gateway_serves_as_the_reference_and_as_prefill(J):
    """Through the gateway: greedy streams equal the reference's, and the
    last prompt position's logits equal a prefill of the same tokens
    (fp32 model and state)."""
    jcfg, tcfg = _configs(J)
    jvals, tvals = _weights(J)
    prompt = _tokens(10, (3, 6), jcfg.vocab_size)
    want = J.generate(jcfg, jvals, batch=3, prompt_len=6, tokens=5,
                      prompt=prompt)
    rep = generate(tcfg, tvals, batch=3, prompt_len=6, tokens=5,
                   prompt=prompt, device="cpu")
    np.testing.assert_array_equal(np.asarray(rep.generated),
                                  np.asarray(want.generated))
    eng = GatewayEngine(tcfg, tvals, slots=3, max_len=8, device="cpu")
    eng.state, eng._axes = tapi.init_decode_state(tcfg, 3, 8,
                                                  dtype=torch.float32,
                                                  device="cpu")
    for slot in range(3):
        eng.join(slot, rid=slot, prompt=prompt[slot].tolist(), max_new=2)
    for _ in range(6):
        eng.step()
    pre = tsteps.make_prefill_step(tcfg)(
        tvals, {"tokens": torch.from_numpy(prompt)})[:, -1]
    assert _rel(eng.last_logits, pre) < 1e-5


def test_session_trains_on_the_cpu(tmp_path):
    s = Session.from_arch(ARCH, smoke=True, device="cpu")
    rep = s.train(2, global_batch=2, seq_len=16, checkpoint_dir=str(tmp_path))
    assert len(rep.losses) == 2 and all(np.isfinite(rep.losses))
