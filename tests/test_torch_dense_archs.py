"""The three dense archs the port adds — `stablelm-1.6b` (MHA, partial
rotary 0.25), `starcoder2-15b` (GQA, the 2-matrix GELU MLP) and `yi-6b`
(GQA) — held against the JAX package on the CPU at their SMOKE configs.

Both packages get the same weights (the reference's `init`, crossed with
`repro_torch.bridge`) and the same numpy tokens; the reference runs its
plain attention, the port its plain versions. Tolerances, as
tests/test_torch_model.py and tests/test_torch_moe.py hold the other
decoders: prefill logits 1e-5 of max |want| in fp32 and 2e-2 in bf16;
the loss 1e-5 relative and every gradient leaf 3e-4 of its max |value|
(sums in another order); decode logits 2e-5 in fp32; greedy streams
equal.

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
from repro_torch.launch import steps as tsteps
from repro_torch.models import api as tapi
from repro_torch.tree import flatten, tree_map

ARCHS = ["stablelm-1.6b", "starcoder2-15b", "yi-6b"]


@pytest.fixture(scope="module")
def J():
    """The JAX package, on the CPU."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.api.serving import generate
    from repro.configs import get_config
    from repro.models import api as japi
    return types.SimpleNamespace(jax=jax, jnp=jnp, generate=generate,
                                 get_config=get_config, api=japi)


def _configs(J, arch, dtype="float32"):
    return (J.get_config(arch, smoke=True).with_(dtype=dtype),
            torch_config(arch, smoke=True).with_(dtype=dtype))


def _weights(J, jcfg, seed=0):
    vals, _ = J.api.init(jcfg.with_(dtype="float32"),
                         J.jax.random.PRNGKey(seed))
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


def test_every_reference_arch_id_resolves():
    from repro_torch.configs import ARCH_IDS, get_config
    for arch in ARCHS:
        assert arch in ARCH_IDS
        assert get_config(arch).name == arch
        assert get_config(arch, smoke=True).name == arch


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_references(J, arch):
    """The copied configs, full and SMOKE, field for field (the port's
    `ModelConfig` drops only the reference's XLA switches)."""
    import dataclasses
    for smoke in (False, True):
        want = dataclasses.asdict(J.get_config(arch, smoke=smoke))
        got = dataclasses.asdict(torch_config(arch, smoke=smoke))
        for field in ("use_pallas", "unroll_layers"):
            want.pop(field)
        assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_param_shapes_match_reference(J, arch):
    """The published widths' parameter paths and shapes, without
    allocating: the reference's `param_shapes` against a draw under
    `FakeTensorMode`."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    want = {p: tuple(s.shape)
            for p, s in flatten(J.api.param_shapes(J.get_config(arch)))}
    with FakeTensorMode():
        vals, _ = tapi.init(torch_config(arch), torch.Generator())
        got = {p: tuple(t.shape) for p, t in flatten(vals)}
    assert got == want


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_jax(J, arch, dtype, tol):
    jcfg, tcfg = _configs(J, arch, dtype)
    jvals, tvals = _weights(J, jcfg)
    toks = _tokens(0, (2, 24), jcfg.vocab_size)
    want = J.api.prefill(jvals, jcfg, {"tokens": J.jnp.asarray(toks)})
    got = tsteps.make_prefill_step(tcfg)(tvals,
                                         {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 24, jcfg.vocab_size)
    assert got.dtype == getattr(torch, dtype)
    assert _rel(got, want.astype(J.jnp.float32)) < tol


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_grads_match_jax(J, arch):
    jnp = J.jnp
    jcfg, tcfg = _configs(J, arch)
    jvals, tvals = _weights(J, jcfg)
    toks = _tokens(3, (2, 17), jcfg.vocab_size)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
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


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(J, arch):
    """6 decode steps against an fp32 cache on both sides, the index a
    per-row vector as the gateway gives it."""
    jnp = J.jnp
    jcfg, tcfg = _configs(J, arch)
    jvals, tvals = _weights(J, jcfg)
    toks = _tokens(1, (2, 6), jcfg.vocab_size)
    jst, _ = J.api.init_decode_state(jcfg, 2, 6, dtype=jnp.float32)
    tst, _ = tapi.init_decode_state(tcfg, 2, 6, dtype=torch.float32,
                                    device="cpu")
    serve = tsteps.make_serve_step(tcfg)
    for i in range(6):
        want, jst = J.api.decode_step(jvals, jcfg, jst,
                                      jnp.asarray(toks[:, i]),
                                      jnp.full((2,), i, jnp.int32))
        got, tst = serve(tvals, tst, torch.from_numpy(toks[:, i]),
                         torch.full((2,), i))
        assert _rel(got, want) < 2e-5, i


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_streams_match_jax(J, arch):
    jcfg, tcfg = _configs(J, arch)
    jvals, tvals = _weights(J, jcfg)
    prompt = _tokens(2, (3, 6), jcfg.vocab_size)
    want = J.generate(jcfg, jvals, batch=3, prompt_len=6, tokens=5,
                      prompt=prompt)
    got = generate(tcfg, tvals, batch=3, prompt_len=6, tokens=5,
                   prompt=prompt, device="cpu")
    np.testing.assert_array_equal(np.asarray(got.generated),
                                  np.asarray(want.generated))


@pytest.mark.parametrize("arch", ARCHS)
def test_session_trains_and_serves_through_the_entry_points(arch,
                                                             tmp_path):
    """`Session.from_arch` on the CPU: 2 train steps (finite losses that
    change the weights) and two greedy serves with one seed."""
    s = Session.from_arch(arch, smoke=True, device="cpu")
    rep = s.train(2, global_batch=2, seq_len=16,
                  checkpoint_dir=str(tmp_path))
    assert len(rep.losses) == 2 and all(np.isfinite(rep.losses))
    runs = [s.serve(tokens=3, batch=2, prompt_len=4, seed=1)
            for _ in range(2)]
    assert torch.equal(torch.as_tensor(runs[0].generated),
                       torch.as_tensor(runs[1].generated))
