"""The port's training path held against the JAX package's, on the CPU at
the qwen3-1.7b SMOKE config, plus the card-only checks of the backward
kernel.

Both packages get the same weights (crossed with `repro_torch.bridge`)
and the same numpy batches (`data.pipeline.ShardedLoader`). Tolerances,
each with its reason:

* flash backward, plain version vs the Pallas kernel (interpret mode),
  fp32: 3e-4, as tests/test_kernels.py holds the Pallas gradients;
* gradients through the port's ops vs `jax.grad` of the reference's ops,
  and `loss_fn` value and gradients, fp32: 1e-4 of the leaf's max |value|
  (sums run in another order in the two frameworks);
* one optimizer update, compression round trip: 1e-6 relative (the same
  fp32 arithmetic, element by element);
* the 10-step loss and grad-norm trajectory: 1e-4 relative;
* a checkpoint written by one package, restored by the other: bit-exact
  arrays, the next-step loss to 1e-5 relative.

JAX is imported inside the fixtures, so the ``cuda`` tests also run on a
machine that has the card and no JAX:
``python -m pytest -m cuda tests/test_torch_train.py``.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import RunConfig
from repro_torch.configs import get_config as torch_config
from repro_torch.data.pipeline import ShardedLoader, SyntheticTokenSource
from repro_torch.dist import compression as tcomp
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps as tsteps
from repro_torch.models import api as tapi
from repro_torch import optim as toptim
from repro_torch.tree import flatten, tree_map

B, S = 4, 32


@pytest.fixture(scope="module")
def J():
    """The JAX package, on the CPU."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.checkpoint import Checkpointer as JCheckpointer
    from repro.configs import RunConfig as JRunConfig
    from repro.configs import get_config
    from repro.dist import compression as jcomp
    from repro.kernels import flash_attention as jfa
    from repro.kernels import ops as jops
    from repro.launch import steps as jsteps
    from repro.models import api as japi
    from repro import optim as joptim
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, Checkpointer=JCheckpointer, RunConfig=JRunConfig,
        get_config=get_config, comp=jcomp, fa=jfa, ops=jops, steps=jsteps,
        api=japi, optim=joptim)


@pytest.fixture(scope="module")
def fp32_model(J):
    jcfg = J.get_config("qwen3-1.7b", smoke=True).with_(dtype="float32")
    tcfg = torch_config("qwen3-1.7b", smoke=True).with_(dtype="float32")
    vals, _ = J.api.init(jcfg, J.jax.random.PRNGKey(0))
    return jcfg, tcfg, vals


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(np.asarray(t, dtype=np.float32))


def _tensors(jtree):
    """A JAX tree as the port's tensors (bit-exact, on the CPU)."""
    import jax
    return bridge.from_numpy(jax.tree.map(np.asarray, jtree), "cpu")


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


def _assert_trees_close(got, want, tol):
    want = dict(flatten(want))
    got = dict(flatten(got))
    assert sorted(got) == sorted(want)
    for path in want:
        assert _rel(got[path], want[path]) < tol, path


def _batches(cfg, n, global_batch=B, seq=S, shards=1):
    loader = ShardedLoader(SyntheticTokenSource(cfg.vocab_size, seq, seed=0),
                           global_batch)
    return [loader.next_global(shards) for _ in range(n)]


# ------------------------------------------------------------ the kernel
@pytest.mark.parametrize("Bq,Sq,H,KV,hd,causal", [
    (1, 128, 4, 4, 64, True),      # MHA
    (2, 128, 4, 2, 32, True),      # GQA
    (1, 128, 4, 2, 64, False),     # bidirectional
    (1, 128, 4, 4, 80, False),     # hubert-xlarge's head dim, bidirectional
    (2, 128, 4, 2, 80, True),      # hd 80, GQA, causal
])
def test_flash_attention_bwd_ref_matches_pallas(J, Bq, Sq, H, KV, hd, causal):
    rng = np.random.default_rng(0)
    q, do = (rng.standard_normal((Bq, Sq, H, hd)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((Bq, Sq, KV, hd)).astype(np.float32)
            for _ in range(2))
    jq, jk, jv, jdo = (J.jnp.asarray(a) for a in (q, k, v, do))
    out, lse = J.fa.flash_attention_fwd(jq, jk, jv, causal=causal,
                                        block_q=64, block_k=64,
                                        interpret=True)
    want = J.fa.flash_attention_bwd(jq, jk, jv, out, lse, jdo, causal=causal,
                                    block_q=64, block_k=64, interpret=True)
    got = ref.flash_attention_bwd_ref(
        *(torch.from_numpy(a) for a in (q, k, v)),
        torch.from_numpy(np.array(out)), torch.from_numpy(np.array(lse)),
        torch.from_numpy(do), causal)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=3e-4,
                                   rtol=3e-4)


@pytest.mark.parametrize("op", ["flash_attention", "rmsnorm"])
def test_op_gradients_match_jax(J, op):
    """Autograd through the port's ops (their plain versions here) against
    `jax.grad` through the reference's custom-vjp ops."""
    rng = np.random.default_rng(1)
    if op == "flash_attention":
        args = [rng.standard_normal(s).astype(np.float32)
                for s in ((2, 64, 4, 32), (2, 64, 2, 32), (2, 64, 2, 32))]
        w = rng.standard_normal((2, 64, 4, 32)).astype(np.float32)

        def jf(q, k, v):
            return (J.ops.flash_attention(q, k, v, True, 64, 64) * w).sum()

        def tf(q, k, v):
            return (ops.flash_attention(q, k, v, True)
                    * torch.from_numpy(w)).sum()
    else:
        args = [rng.standard_normal((3, 5, 64)).astype(np.float32),
                rng.uniform(0.5, 1.5, 64).astype(np.float32)]
        w = rng.standard_normal((3, 5, 64)).astype(np.float32)

        def jf(x, scale):
            return (J.ops.rmsnorm(x, scale, 1e-5) * w).sum()

        def tf(x, scale):
            return (ops.rmsnorm(x, scale, 1e-5) * torch.from_numpy(w)).sum()
    want = J.jax.grad(jf, argnums=tuple(range(len(args))))(
        *(J.jnp.asarray(a) for a in args))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    got = torch.autograd.grad(tf(*ts), ts)
    for g, wnt in zip(got, want):
        assert _rel(g, wnt) < 1e-4


# -------------------------------------------------------------- the loss
def test_loss_fn_value_and_grads_match_jax(J, fp32_model):
    jcfg, tcfg, jvals = fp32_model
    batch = _batches(tcfg, 1)[0]
    jloss, jgrads = J.jax.value_and_grad(
        lambda p: J.api.loss_fn(p, jcfg, {k: J.jnp.asarray(v)
                                          for k, v in batch.items()}))(jvals)
    params = tree_map(lambda t: t.requires_grad_(), _tensors(jvals))
    loss = tapi.loss_fn(params, tcfg, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) < 1e-5 * abs(float(jloss))
    _assert_trees_close(tree_map(lambda p: p.grad, params), jgrads, 1e-4)


# --------------------------------------------------------- the optimizer
def _opt_tree(rng, dtype=np.float32):
    return {"a": rng.standard_normal((6, 5)).astype(dtype),
            "b": {"c": rng.standard_normal((7,)).astype(dtype)}}


@pytest.mark.parametrize("name,master", [("adamw", False), ("adamw", True),
                                         ("adam", False), ("sgd", False),
                                         ("momentum", False)])
def test_optimizer_update_matches_jax(J, name, master):
    rng = np.random.default_rng(2)
    params, grads = _opt_tree(rng), _opt_tree(rng)
    jparams = J.jax.tree.map(J.jnp.asarray, params)
    jgrads = J.jax.tree.map(J.jnp.asarray, grads)
    if master:
        jparams = J.jax.tree.map(lambda p: p.astype(J.jnp.bfloat16), jparams)
        jgrads = J.jax.tree.map(lambda g: g.astype(J.jnp.bfloat16), jgrads)
    lr = J.optim.cosine_warmup(1e-2, 2, 10)
    jopt = J.optim.make_optimizer(name, lr, 0.1, master=master)
    topt = toptim.make_optimizer(name, toptim.cosine_warmup(1e-2, 2, 10), 0.1,
                                 master=master)
    jstate = jopt.init(jparams)
    tparams, tgrads = _tensors(jparams), _tensors(jgrads)
    tstate = topt.init(tparams)
    # two updates, the second at a step where the schedule and the bias
    # corrections are past their first values
    for step in (0, 3):
        jparams, jstate = jopt.update(jgrads, jstate, jparams,
                                      J.jnp.asarray(step, J.jnp.int32))
        tparams, tstate = topt.update(tgrads, tstate, tparams,
                                      torch.tensor(step, dtype=torch.int32))
    _assert_trees_close(tparams, jparams, 1e-6)
    if jstate:
        _assert_trees_close(tstate, jstate, 1e-6)
    assert dict(flatten(tparams))["a"].dtype == (
        torch.bfloat16 if master else torch.float32)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(J, max_norm):
    grads = _opt_tree(np.random.default_rng(3))
    jclipped, jnorm = J.optim.clip_by_global_norm(
        J.jax.tree.map(J.jnp.asarray, grads), max_norm)
    tclipped, tnorm = toptim.clip_by_global_norm(_tensors(grads), max_norm)
    assert abs(float(tnorm) - float(jnorm)) < 1e-6 * float(jnorm)
    _assert_trees_close(tclipped, jclipped, 1e-6)


@pytest.mark.parametrize("scheme", ["bf16", "int8", "topk"])
def test_error_feedback_roundtrip_matches_jax(J, scheme):
    rng = np.random.default_rng(4)
    # distinct magnitudes, so top-k keeps the same entries in both packages
    n = 6 * 50 + 120
    mags = rng.permutation(np.linspace(0.01, 3.0, n)).astype(np.float32)
    flat = mags * rng.choice([-1.0, 1.0], n).astype(np.float32)
    grads = {"w": flat[:300].reshape(6, 50), "v": flat[300:]}
    residual = {"w": np.zeros((6, 50), np.float32), "v": np.zeros(120, np.float32)}
    jef, tef = J.comp.ErrorFeedback(scheme), tcomp.ErrorFeedback(scheme)
    jr = J.jax.tree.map(J.jnp.asarray, residual)
    tr = _tensors(residual)
    for _ in range(2):  # the second round folds the first's residual in
        japplied, jr = jef.roundtrip(J.jax.tree.map(J.jnp.asarray, grads), jr)
        tapplied, tr = tef.roundtrip(_tensors(grads), tr)
        _assert_trees_close(tapplied, japplied, 1e-6)
        _assert_trees_close(tr, jr, 1e-6)
    assert tcomp.payload_bytes(tapplied, scheme) == J.comp.payload_bytes(
        japplied, scheme)
    assert tcomp.compression_ratio(scheme) == J.comp.compression_ratio(scheme)


# ---------------------------------------------------------- the train step
def _run_config(**kw):
    return dict(optimizer="adamw", lr=1e-3, weight_decay=0.1, warmup_steps=2,
                total_steps=10, grad_clip=1.0, **kw)


@pytest.mark.parametrize("extra", [{}, {"grad_compression": "int8",
                                        "microbatch": 2}],
                         ids=["plain", "int8-microbatch2"])
def test_train_trajectory_matches_jax(J, fp32_model, extra):
    """10 steps of `make_train_step` on identical batches: loss and
    grad-norm to 1e-4 relative at every step."""
    jcfg, tcfg, jvals = fp32_model
    jrun = J.RunConfig(**_run_config(**extra))
    trun = RunConfig(**_run_config(**extra))
    jstep, jopt = J.steps.make_train_step(jcfg, jrun)
    jstep = J.jax.jit(jstep)
    jstate = J.steps.TrainState(jvals, jopt.init(jvals),
                                J.jnp.zeros((), J.jnp.int32),
                                J.steps.init_residual(jvals, jrun))
    tstep, topt = tsteps.make_train_step(tcfg, trun)
    tparams = _tensors(jvals)
    tstate = tsteps.TrainState(tparams, topt.init(tparams),
                               torch.zeros((), dtype=torch.int32),
                               tsteps.init_residual(tparams, trun))
    for i, batch in enumerate(_batches(tcfg, 10)):
        jstate, jm = jstep(jstate, {k: J.jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        for key in ("loss", "grad_norm"):
            assert abs(float(tm[key]) - float(jm[key])) <= 1e-4 * abs(
                float(jm[key])), (i, key)
        assert int(tm["step"]) == int(jm["step"]) == i
        if "payload_bytes" in jm:
            assert tm["payload_bytes"] == float(jm["payload_bytes"])
    assert int(tstate.step) == 10


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_crosses_packages(J, fp32_model, tmp_path, writer):
    """A checkpoint one package writes after two steps restores bit for
    bit in the other, and both take the same third step (bf16 live
    weights under master_weights, so bf16 arrays cross too)."""
    jcfg, tcfg, jvals = fp32_model
    kw = _run_config(master_weights=True)
    jrun, trun = J.RunConfig(**kw), RunConfig(**kw)
    jstep, jopt = J.steps.make_train_step(jcfg, jrun)
    jstep = J.jax.jit(jstep)
    tstep, topt = tsteps.make_train_step(tcfg, trun)
    jparams = J.jax.tree.map(lambda p: p.astype(J.jnp.bfloat16), jvals)
    jstate = J.steps.TrainState(jparams, jopt.init(jparams),
                                J.jnp.zeros((), J.jnp.int32), ())
    tparams = _tensors(jparams)
    tstate = tsteps.TrainState(tparams, topt.init(tparams),
                               torch.zeros((), dtype=torch.int32), ())
    batches = [{k: v for k, v in b.items()} for b in _batches(tcfg, 3)]
    tb = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    jb = [{k: J.jnp.asarray(v) for k, v in b.items()} for b in batches]
    if writer == "jax":
        for b in jb[:2]:
            jstate, _ = jstep(jstate, b)
        J.Checkpointer(str(tmp_path)).save(2, jstate)
        tstate, step = Checkpointer(str(tmp_path)).restore(tstate)
    else:
        for b in tb[:2]:
            tstate, _ = tstep(tstate, b)
        Checkpointer(str(tmp_path)).save(2, tstate)
        jstate, step = J.Checkpointer(str(tmp_path)).restore(jstate)
    assert step == 2 and int(tstate.step) == int(jstate.step) == 2
    for path, want in flatten(J.jax.tree.map(np.asarray, jstate.params)):
        got = dict(flatten(tstate.params))[path]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))
    _, jm = jstep(jstate, jb[2])
    _, tm = tstep(tstate, tb[2])
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * float(jm["loss"])


def test_checkpoint_keys_are_the_references(tmp_path):
    cfg = torch_config("qwen3-1.7b", smoke=True)
    state = tsteps.init_train_state(cfg, RunConfig(grad_compression="int8"),
                                    device="cpu")
    Checkpointer(str(tmp_path)).save(1, state)
    import json
    index = json.load(open(tmp_path / "step_1" / "index.json"))
    assert {".params/embed", ".params/layers/attn/wq", ".opt/m/embed",
            ".opt/v/final_norm/scale", ".step",
            ".residual/layers/mlp/wg"} <= set(index)
    assert index[".step"]["dtype"] == "int32" and index[".step"]["shape"] == []


def test_checkpointer_validates_and_falls_back(tmp_path):
    from repro_torch.checkpoint import CheckpointCorruptError
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"w": torch.arange(6, dtype=torch.float32), "h": torch.ones(3).to(
        torch.bfloat16)}
    for step in (1, 2, 3):
        ck.save(step, tree_map(lambda t: t * step, tree))
    assert ck.all_steps() == [2, 3]                     # GC keeps 2
    ck.corrupt(3)
    with pytest.raises(CheckpointCorruptError):
        ck.validate(3)
    got, step, depth = ck.restore_latest_valid(tree)
    assert (step, depth) == (2, 1)
    assert torch.equal(got["w"], tree["w"] * 2)
    assert got["h"].dtype == torch.bfloat16 and torch.equal(got["h"],
                                                            tree["h"] * 2)
    assert ck.read_meta(2)["step"] == 2


# --------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _flash_inputs(device, Bq, Sq, Sk, H, KV, hd, dtype, fused=False):
    """q, k, v, dO from one seed; with ``fused``, q, k and v are strided
    views of one (B, S, H + 2 KV, hd) tensor, as a fused QKV projection
    gives them."""
    g = torch.Generator(device=device).manual_seed(5)
    dt = getattr(torch, dtype)
    q, do = (torch.randn((Bq, Sq, H, hd), generator=g, device=device).to(dt)
             for _ in range(2))
    k, v = (torch.randn((Bq, Sk, KV, hd), generator=g, device=device).to(dt)
            for _ in range(2))
    if fused:
        qkv = torch.cat([q, k, v], dim=2)
        q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("Bq,Sq,Sk,H,KV,hd,causal,dtype,tol,norm_tol,fused", [
    (1, 256, 256, 16, 8, 128, True, "bfloat16", 2e-2, 1e-2, False),
    (2, 200, 200, 4, 2, 64, True, "bfloat16", 2e-2, 1e-2, False),  # ragged
    (2, 192, 320, 4, 2, 64, False, "float32", 3e-4, 3e-4, False),  # bidir.
    (1, 100, 100, 4, 1, 32, True, "float32", 3e-4, 3e-4, False),   # MQA
    (1, 129, 129, 4, 2, 128, True, "bfloat16", 2e-2, 1e-2, False),  # tile+1
    # qwen3-1.7b's training shape
    (2, 2048, 2048, 16, 8, 128, True, "bfloat16", 2e-2, 1e-2, False),
    # zamba2-1.2b's attention: MHA at hd=64
    (1, 2048, 2048, 32, 32, 64, True, "bfloat16", 2e-2, 1e-2, False),
    (1, 300, 300, 8, 1, 128, True, "bfloat16", 2e-2, 1e-2, False),  # MQA
    (2, 160, 160, 4, 2, 32, True, "bfloat16", 2e-2, 1e-2, False),   # hd=32
    (2, 192, 192, 8, 2, 128, True, "bfloat16", 2e-2, 1e-2, True),   # fused
    # the live chaos plans' shape: S=32, below one 64-row TMA box
    (4, 32, 32, 16, 8, 128, True, "bfloat16", 2e-2, 1e-2, False),
    # hubert-xlarge's training shape at hd 80 (five 16-column TMA boxes),
    # bidirectional and causal; views of a fused QKV; ragged and GQA fp32
    (2, 2048, 2048, 16, 16, 80, False, "bfloat16", 2e-2, 1e-2, False),
    (2, 2048, 2048, 16, 16, 80, True, "bfloat16", 2e-2, 1e-2, False),
    (2, 192, 192, 4, 2, 80, False, "bfloat16", 2e-2, 1e-2, True),
    (1, 100, 100, 4, 4, 80, True, "float32", 3e-4, 3e-4, False),
    (1, 100, 100, 4, 2, 80, False, "float32", 3e-4, 3e-4, False),
    # stablelm-1.6b's (MHA at hd 64) and qwen2-vl-2b's (a group of 6 at
    # hd 128) training shapes
    (2, 2048, 2048, 32, 32, 64, True, "bfloat16", 2e-2, 1e-2, False),
    (2, 2048, 2048, 12, 2, 128, True, "bfloat16", 2e-2, 1e-2, False),
    # the edges of the dk/dv kernel's 64-key blocks and 64-query stages at
    # hd 80 and 64 (GQA): S = 64 (one whole block), 127 and 191 (a ragged
    # last block), causal and bidirectional; Sq 192 with Sk 320,
    # bidirectional
    *[(2, s, s, 4, 2, hd_, causal_, "bfloat16", 2e-2, 1e-2, False)
      for s in (64, 127, 191) for hd_ in (80, 64) for causal_ in (True, False)],
    *[(2, 192, 320, 4, 2, hd_, False, "bfloat16", 2e-2, 1e-2, False)
      for hd_ in (80, 64)],
])
def test_flash_bwd_kernel_matches_plain_on_card(cuda, Bq, Sq, Sk, H, KV, hd,
                                                causal, dtype, tol, norm_tol,
                                                fused):
    """max |kernel - plain| <= tol * max |plain| and |kernel - plain| /
    |plain| (Frobenius) <= norm_tol for dq, dk, dv. bf16 rounds p and ds
    to bf16 for their products; the norm bound holds the many small
    gradients past the first tiles, which the max bound cannot (measured
    on an H100: 2.5e-3 to 2.7e-3 at the bf16 cases, so 1e-2 leaves about
    3.7x)."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, do = _flash_inputs(cuda, Bq, Sq, Sk, H, KV, hd, dtype, fused)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    for gt, wt in zip(got, want):
        assert gt.dtype == wt.dtype and gt.shape == wt.shape
        assert bool(torch.isfinite(gt).all())
        assert _rel(gt, wt) <= tol
        assert float((gt.float() - wt.float()).norm()
                     / wt.float().norm()) <= norm_tol


@pytest.mark.cuda
def test_flash_bwd_kernel_single_token_on_card(cuda):
    """S=1: one key, so the softmax is constant and dq = dk = 0 exactly
    (ds = p (dp - delta) with dp = dO.v = delta). The kernel's dp (a
    tensor-core sum) and delta (the delta kernel's sum) round in different
    orders, so dq and dk are 0 to fp32 rounding of a 128-term dot product
    of unit normals; dv = dO, as the plain version's."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, do = _flash_inputs(cuda, 1, 1, 1, 4, 2, 128, "bfloat16")
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, True)
    torch.cuda.synchronize()
    assert float(dq.float().abs().max()) <= 1e-5
    assert float(dk.float().abs().max()) <= 1e-5
    assert _rel(dv, want[2]) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd", [("bfloat16", 128), ("float32", 128),
                                      ("bfloat16", 64)])
def test_flash_bwd_kernel_is_deterministic_on_card(cuda, dtype, hd):
    """No atomics: two backward calls on the same inputs give bit-equal
    dq, dk and dv (GQA, so dk and dv are sums over a group of heads)."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, do = _flash_inputs(cuda, 2, 520, 520, 8, 2, hd, dtype)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    first = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    second = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_kernel_at_hd80_is_deterministic_on_card(cuda, dtype,
                                                           causal):
    """hd 80 too: two backward calls give bit-equal dq, dk and dv (GQA,
    ragged). The delta kernel's rows take 8 lanes there, a power of two,
    so its shuffles stay inside one row and sum in a fixed order."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, do = _flash_inputs(cuda, 2, 520, 520, 8, 2, 80, dtype)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    first = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    second = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_backward_on_card_reaches_every_parameter(cuda):
    """The kernels' autograd Functions carry the gradient: every parameter
    leaf gets a finite, non-zero gradient, and the backward kernel ran once
    per layer."""
    cfg = torch_config("qwen3-1.7b", smoke=True)
    params, _ = tapi.init(cfg, device=cuda)
    params = tree_map(lambda p: p.requires_grad_(), params)
    batch = {k: torch.from_numpy(v).to(cuda)
             for k, v in _batches(cfg, 1, global_batch=2, seq=64)[0].items()}
    ops.reset_launches()
    tapi.loss_fn(params, cfg, batch).backward()
    torch.cuda.synchronize()
    assert ops.launches["flash_attention_bwd"] == cfg.n_layers
    for path, p in flatten(params):
        assert p.grad is not None, path
        assert bool(torch.isfinite(p.grad).all()), path
        assert float(p.grad.abs().sum()) > 0.0, path


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hubert-xlarge", "stablelm-1.6b",
                                  "qwen2-vl-2b"])
def test_full_width_backward_on_card_reaches_every_parameter(cuda, arch):
    """The three archs that train on one card, cut to 2 layers at full
    width (hubert's head dim 80, stablelm's MHA and partial rotary,
    qwen2-vl's group of 6 with three distinct M-RoPE rows): one backward
    gives every parameter leaf a finite, non-zero gradient, through one
    flash backward a layer and one RMSNorm backward a norm."""
    from repro_torch.data.pipeline import source_for_config
    cfg = torch_config(arch).with_(n_layers=2)
    params, _ = tapi.init(cfg, device=cuda)
    params = tree_map(lambda p: p.requires_grad_(), params)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in ShardedLoader(
        source_for_config(cfg, 256, seed=1), 2).next_global(1).items()}
    if cfg.family == "vlm":
        rng = np.random.default_rng(2)
        t = np.broadcast_to(np.arange(256), (2, 256))
        batch["positions"] = torch.from_numpy(np.stack(
            [t, *rng.integers(0, 768, (2, 2, 256))])).to(cuda)
    ops.reset_launches()
    tapi.loss_fn(params, cfg, batch).backward()
    torch.cuda.synchronize()
    assert ops.launches["flash_attention_bwd"] == 2
    assert ops.launches["rmsnorm_bwd"] == 2 * 2 + 1
    for path, p in flatten(params):
        assert p.grad is not None, path
        assert bool(torch.isfinite(p.grad).all()), path
        assert float(p.grad.abs().sum()) > 0.0, path
