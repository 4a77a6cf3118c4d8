"""The audio encoder the port adds (`hubert-xlarge`,
`repro_torch.models.encoder`) and its data source held against the JAX
package on the CPU at the SMOKE config: the frontend projection, the
31-tap depthwise positional conv, bidirectional layers, the final norm
and the 504-way head (64 at SMOKE).

Both packages get the same weights (crossed with `repro_torch.bridge`)
and the same numpy frame features; the reference runs its plain
attention, the port its plain versions. Tolerances, as the decoders'
tests: logits 1e-5 of max |want| in fp32 and 2e-2 in bf16; the loss 1e-5
relative, every gradient leaf 3e-4 of its max |value|.

JAX is imported inside the fixture that needs it.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.api import Session
from repro_torch.api.serving import generate
from repro_torch.configs import get_config as torch_config
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import steps as tsteps
from repro_torch.models import api as tapi
from repro_torch.models import encoder
from repro_torch.serving.engine import GatewayEngine
from repro_torch.tree import flatten, tree_map

ARCH = "hubert-xlarge"


@pytest.fixture(scope="module")
def J():
    """The JAX package, on the CPU."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.data import pipeline
    from repro.models import api as japi
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=get_config,
                                 api=japi, pipeline=pipeline)


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


def _features(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_init_matches_reference_tree(J):
    """Paths, shapes, fp32 and axes of the SMOKE params, and the full
    config's shapes without allocating."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    jcfg, tcfg = _configs(J)
    jvals, jaxes = J.api.init(jcfg, J.jax.random.PRNGKey(0))
    tvals, taxes = tapi.init(tcfg, torch.Generator().manual_seed(1),
                             device="cpu")
    jflat = dict(flatten(J.jax.tree.map(np.asarray, jvals)))
    tflat = dict(flatten(tvals))
    assert sorted(jflat) == sorted(tflat)
    assert {"frontend_proj", "pos_conv", "head"} <= set(tflat)
    for path, arr in jflat.items():
        assert tuple(tflat[path].shape) == arr.shape, path
        assert tflat[path].dtype == torch.float32, path
    assert dict(flatten(taxes)) == dict(flatten(jaxes))
    want = {p: tuple(s.shape) for p, s in
            flatten(J.api.param_shapes(J.get_config(ARCH)))}
    with FakeTensorMode():
        vals, _ = tapi.init(torch_config(ARCH), torch.Generator())
        got = {p: tuple(t.shape) for p, t in flatten(vals)}
    assert got == want


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_encode_logits_match_jax(J, dtype, tol):
    jcfg, tcfg = _configs(J, dtype)
    jvals, tvals = _weights(J)
    feats = _features(0, (2, 40, jcfg.frontend_dim))
    want = J.api.prefill(jvals, jcfg, {"features": J.jnp.asarray(feats)})
    got = tsteps.make_prefill_step(tcfg)(
        tvals, {"features": torch.from_numpy(feats)})
    assert got.shape == (2, 40, jcfg.vocab_size)
    assert got.dtype == getattr(torch, dtype)
    assert _rel(got, want.astype(J.jnp.float32)) < tol


def test_positional_conv_sees_both_sides(J):
    """A change to one frame moves the logits of frames up to 15 away on
    either side (the "same" conv and bidirectional attention), in both
    packages alike."""
    jcfg, tcfg = _configs(J)
    jvals, tvals = _weights(J)
    feats = _features(1, (1, 40, jcfg.frontend_dim))
    moved = feats.copy()
    moved[0, 20] += 1.0
    outs = []
    for f in (feats, moved):
        want = J.api.prefill(jvals, jcfg, {"features": J.jnp.asarray(f)})
        got, aux = encoder.forward(tvals, tcfg, torch.from_numpy(f))
        assert float(aux) == 0.0
        assert _rel(got, want) < 1e-5
        outs.append(_np(got))
    delta = np.abs(outs[1] - outs[0]).max(axis=-1)[0]
    assert delta[5] > 0 and delta[35] > 0


def test_loss_fn_grads_match_jax(J):
    jnp = J.jnp
    jcfg, tcfg = _configs(J)
    jvals, tvals = _weights(J)
    rng = np.random.default_rng(2)
    batch = {"features": _features(3, (2, 24, jcfg.frontend_dim)),
             "labels": rng.integers(0, jcfg.vocab_size, (2, 24)).astype(
                 np.int32)}
    jloss, jgrads = J.jax.value_and_grad(
        lambda p: J.api.loss_fn(p, jcfg, {k: jnp.asarray(v)
                                          for k, v in batch.items()}))(jvals)
    params = tree_map(lambda t: t.requires_grad_(), tvals)
    loss = tapi.loss_fn(params, tcfg, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) < 1e-5 * abs(float(jloss))
    want = dict(flatten(J.jax.tree.map(np.asarray, jgrads)))
    got = dict(flatten(tree_map(lambda p: p.grad, params)))
    assert sorted(got) == sorted(want)
    for path in want:
        assert _rel(got[path], want[path]) < 3e-4, path


def test_data_sources_equal_the_references(J):
    """`SyntheticAudioSource`, `CIFARLikeSource` and `source_for_config`
    draw the reference's arrays, key for key."""
    jp = J.pipeline
    cases = [(jp.SyntheticAudioSource(64, 504, 12, seed=3),
              tpipe.SyntheticAudioSource(64, 504, 12, seed=3)),
             (jp.CIFARLikeSource(seed=4), tpipe.CIFARLikeSource(seed=4))]
    for cfg_arch in (ARCH, "qwen3-1.7b"):
        cases.append((jp.source_for_config(J.get_config(cfg_arch, True), 16,
                                           seed=5),
                      tpipe.source_for_config(torch_config(cfg_arch, True),
                                              16, seed=5)))
    for want_src, got_src in cases:
        assert type(got_src).__name__ == type(want_src).__name__
        for step, shard in ((0, 0), (3, 1)):
            want = want_src.batch(step, shard, 2, 3)
            got = got_src.batch(step, shard, 2, 3)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_audio_has_no_decode_path():
    """As the reference: decode state, decode step, `generate` and the
    gateway raise `ValueError` for an encoder-only arch."""
    cfg = torch_config(ARCH, smoke=True)
    params, _ = tapi.init(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        tapi.init_decode_state(cfg, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        tapi.decode_step(params, cfg, None, torch.zeros(1, dtype=torch.long),
                         0)
    with pytest.raises(ValueError, match="encoder-only"):
        generate(cfg, params, batch=1, prompt_len=2, tokens=1, device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        GatewayEngine(cfg, params, device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        Session.from_arch(ARCH, smoke=True, device="cpu").serve(tokens=1)


def test_session_trains_on_frame_features(tmp_path):
    """`Session.train` feeds the encoder from `SyntheticAudioSource`
    (through `source_for_config`): finite losses near ln(vocab) on the
    CPU, where the flash backward is the plain version's."""
    s = Session.from_arch(ARCH, smoke=True, device="cpu")
    rep = s.train(2, global_batch=2, seq_len=16, checkpoint_dir=str(tmp_path))
    assert len(rep.losses) == 2 and all(np.isfinite(rep.losses))
    assert abs(rep.losses[0] - np.log(s.cfg.vocab_size)) < 1.5
