"""Activation checkpointing (`cfg.remat`) in every family of the port,
held against the port without it and against the JAX package's `_remat`,
on the CPU at the SMOKE configs in fp32.

* Under ``"full"`` and ``"dots"`` the loss and every gradient leaf equal
  the port's ``"none"`` bit for bit: the recompute runs the same ops on
  the same inputs.
* They lie within the existing tolerances of the reference's `jax.grad`
  under the same policy: the loss within 1e-5 relative, each gradient
  leaf within 3e-4 of its max (as tests/test_torch_train.py,
  test_torch_ssm.py and test_torch_moe.py hold the gradients).
* What a policy keeps for the backward pass, counted after the forward:
  every op's output storage is tracked by a weak reference, and the bytes
  still alive (the weights and the batch aside) fall from ``"none"`` to
  ``"dots"`` to ``"full"``. ``"dots"`` keeps, beyond ``"full"``, exactly
  the ``mm`` outputs of the layers (7 a qwen3 layer: q, k, v, o, gate,
  up, down) and no ``bmm`` output (the MoE's expert products, which
  ``"none"`` keeps), as JAX's `checkpoint_dots_with_no_batch_dims`
  keeps products without a batch dimension.
* Prefill and decode take no gradient, so ``remat`` changes nothing there.

Tests marked ``cuda`` run on the card (skipped here): a depth-2 step
under each policy, whose loss and gradients are bit-equal to
``"none"``'s and whose recompute launches the forward kernels again.
"""
import gc
import types
import weakref

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import bridge
from repro_torch.configs import get_config as torch_config
from repro_torch.data.pipeline import ShardedLoader, source_for_config
from repro_torch.kernels import ops
from repro_torch.models import api as tapi
from repro_torch.models import transformer
from repro_torch.tree import flatten, tree_map

B, S = 2, 32
# (arch, config changes): the zamba2 SMOKE config at 5 layers keeps one
# Mamba2 layer after its last group (the tail's own checkpoints)
CASES = [("qwen3-1.7b", {}), ("granite-moe-3b-a800m", {}),
         ("deepseek-v2-lite-16b", {}), ("mamba2-1.3b", {}),
         ("zamba2-1.2b", {}), ("zamba2-1.2b", {"n_layers": 5}),
         ("hubert-xlarge", {})]
IDS = ["qwen3", "granite", "deepseek", "mamba2", "zamba2", "zamba2-tail",
       "hubert"]
REF_CASES = [c for c, i in zip(CASES, IDS) if i != "deepseek"]
REF_IDS = [i for i in IDS if i != "deepseek"]


@pytest.fixture(scope="module")
def J():
    """The JAX package, on the CPU."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import api as japi
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=get_config,
                                 api=japi)


def _config(arch, change, remat="none"):
    return torch_config(arch, smoke=True).with_(dtype="float32", remat=remat,
                                                **change)


def _batch(cfg):
    return ShardedLoader(source_for_config(cfg, S, seed=0),
                         B).next_global(1)


def _params(cfg):
    return tapi.init(cfg, torch.Generator().manual_seed(0), device="cpu")[0]


def _loss_and_grads(params, cfg, batch):
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = tapi.loss_fn(live, cfg, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    loss.backward()
    return loss.detach(), dict(flatten(tree_map(lambda t: t.grad, live)))


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch,change", CASES, ids=IDS)
def test_remat_is_bit_equal_to_none(arch, change, remat):
    cfg = _config(arch, change)
    params, batch = _params(cfg), _batch(cfg)
    loss, grads = _loss_and_grads(params, cfg, batch)
    rloss, rgrads = _loss_and_grads(params, cfg.with_(remat=remat), batch)
    assert torch.equal(rloss, loss)
    assert sorted(rgrads) == sorted(grads)
    for path, g in grads.items():
        assert torch.equal(rgrads[path], g), path


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch,change", REF_CASES, ids=REF_IDS)
def test_remat_grads_match_the_references(J, arch, change, remat):
    jcfg = J.get_config(arch, smoke=True).with_(dtype="float32",
                                                remat=remat, **change)
    tcfg = _config(arch, change, remat)
    jvals, _ = J.api.init(jcfg, J.jax.random.PRNGKey(0))
    batch = _batch(tcfg)
    jloss, jgrads = J.jax.value_and_grad(
        lambda p: J.api.loss_fn(p, jcfg, {k: J.jnp.asarray(v)
                                          for k, v in batch.items()}))(jvals)
    loss, grads = _loss_and_grads(
        bridge.from_numpy(J.jax.tree.map(np.asarray, jvals), "cpu"), tcfg,
        batch)
    assert abs(float(loss) - float(jloss)) < 1e-5 * abs(float(jloss))
    want = dict(flatten(J.jax.tree.map(np.asarray, jgrads)))
    assert sorted(grads) == sorted(want)
    for path, w in want.items():
        err = float(np.abs(grads[path].numpy() - w).max())
        assert err <= 3e-4 * float(np.abs(w).max()), path


class _Kept(TorchDispatchMode):
    """Every op's output storages, by op, each behind a weak reference:
    `alive()` gives those still alive (the storages of ``ignore``'s
    tensors aside) after a garbage collection."""

    def __init__(self, ignore):
        super().__init__()
        self.ignore = {id(t.untyped_storage()) for t in ignore}
        self.outs = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                s = t.untyped_storage()
                old = self.outs.get(id(s))
                if id(s) not in self.ignore and (old is None
                                                 or old[2]() is None):
                    self.outs[id(s)] = (func, s.nbytes(), weakref.ref(s))
        return out

    def alive(self):
        gc.collect()
        return [(f, n) for f, n, ref in self.outs.values()
                if ref() is not None]


def _kept_after_forward(cfg, params, batch):
    """(live output storages, by op) after the forward and before the
    backward of `loss_fn` under ``cfg.remat``."""
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    kept = _Kept([t for _, t in flatten(live)] + list(tb.values()))
    with kept:
        loss = tapi.loss_fn(live, cfg, tb)
    alive = kept.alive()
    loss.backward()            # the graph the forward kept is complete
    return alive


def _count(alive, op):
    return sum(1 for f, _ in alive if f is op)


def _bytes(alive):
    return sum(n for _, n in alive)


@pytest.mark.parametrize("arch,change,mm_a_layer", [
    ("qwen3-1.7b", {}, 7),             # q, k, v, o; gate, up, down
    ("granite-moe-3b-a800m", {}, 5),   # q, k, v, o; the router
    ("hubert-xlarge", {}, 6)],         # q, k, v, o; the GELU MLP's two
    ids=["qwen3", "granite", "hubert"])
def test_what_each_policy_keeps_for_the_backward(arch, change, mm_a_layer):
    aten = torch.ops.aten
    cfg = _config(arch, change)
    params, batch = _params(cfg), _batch(cfg)
    kept = {r: _kept_after_forward(cfg.with_(remat=r), params, batch)
            for r in ("none", "dots", "full")}
    assert _bytes(kept["none"]) > _bytes(kept["dots"]) > _bytes(kept["full"])
    # the experts' products are bmm outputs, which "none" keeps (the
    # SwiGLU saves them) and "dots" and "full" recompute
    if cfg.moe is not None:
        assert _count(kept["none"], aten.bmm.default) > 0
    assert _count(kept["dots"], aten.bmm.default) == \
        _count(kept["full"], aten.bmm.default) == 0
    # "dots" keeps each of the layers' mm outputs beyond "full"'s
    extra = _count(kept["dots"], aten.mm.default) - _count(
        kept["full"], aten.mm.default)
    assert extra == mm_a_layer * cfg.n_layers
    # ...and nothing else: the rest it recomputes as "full" does
    others = [(f, n) for f, n in kept["dots"] if f is not aten.mm.default]
    full_others = [(f, n) for f, n in kept["full"]
                   if f is not aten.mm.default]
    assert _bytes(others) == _bytes(full_others)


def test_dots_policy_saves_only_products_without_a_batch_dim():
    aten = torch.ops.aten
    from torch.utils.checkpoint import CheckpointPolicy
    for op in (aten.mm.default, aten.addmm.default):
        assert transformer.dots_policy(None, op) is CheckpointPolicy.MUST_SAVE
    for op in (aten.bmm.default, aten.baddbmm.default, aten.mul.Tensor,
               aten._to_copy.default, aten.empty.memory_format):
        assert transformer.dots_policy(None, op) is \
            CheckpointPolicy.PREFER_RECOMPUTE


def test_unknown_remat_policy_raises():
    cfg = _config("qwen3-1.7b", {}, "everything")
    with pytest.raises(ValueError, match="unknown remat policy"):
        _loss_and_grads(_params(cfg), cfg, _batch(cfg))


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-1.3b",
                                  "zamba2-1.2b"])
def test_prefill_and_decode_ignore_remat(arch, remat):
    cfg = _config(arch, {})
    rcfg = cfg.with_(remat=remat)
    params = _params(cfg)
    toks = torch.from_numpy(_batch(cfg)["tokens"][:, :8])
    with torch.no_grad():
        assert torch.equal(tapi.prefill(params, rcfg, {"tokens": toks}),
                           tapi.prefill(params, cfg, {"tokens": toks}))
        # a forward that records a graph checkpoints but gives the same
        # logits
    assert torch.equal(tapi.prefill(params, rcfg, {"tokens": toks}).detach(),
                       tapi.prefill(params, cfg, {"tokens": toks}).detach())
    states = [tapi.init_decode_state(c, B, 8, dtype=torch.float32,
                                     device="cpu")[0] for c in (cfg, rcfg)]
    with torch.no_grad():
        for i in range(8):
            outs = []
            for j, c in enumerate((cfg, rcfg)):
                logits, states[j] = tapi.decode_step(params, c, states[j],
                                                     toks[:, i], i)
                outs.append(logits)
            assert torch.equal(outs[0], outs[1]), i


# --------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_step_on_card_is_bit_equal_to_none(cuda, remat, dtype):
    """qwen3-1.7b at full width cut to 2 layers, B=2, S=256: the loss and
    every gradient leaf under the policy equal those without it, and the
    backward launches each layer's forward kernels once more (its flash
    forward and its four RMSNorm forwards; the final norm lies outside
    the layers)."""
    cfg = torch_config("qwen3-1.7b", smoke=False).with_(n_layers=2,
                                                        dtype=dtype)
    params = tapi.init(cfg, torch.Generator(device=cuda).manual_seed(0),
                       device=cuda)[0]
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in ShardedLoader(
        source_for_config(cfg, 256, seed=0), 2).next_global(1).items()}
    out = {}
    for r in ("none", remat):
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        ops.reset_launches()
        loss = tapi.loss_fn(live, cfg.with_(remat=r), batch)
        loss.backward()
        torch.cuda.synchronize()
        out[r] = (loss.detach(), dict(flatten(tree_map(lambda t: t.grad,
                                                       live))),
                  dict(ops.launches))
    loss, grads, launches = out["none"]
    rloss, rgrads, rlaunches = out[remat]
    assert torch.equal(rloss, loss)
    for path, g in grads.items():
        assert torch.equal(rgrads[path], g), path
    n = 4 * cfg.n_layers + 1
    assert launches["flash_attention_fwd"] == 2
    assert rlaunches["flash_attention_fwd"] == 4
    assert rlaunches["flash_attention_bwd"] == launches[
        "flash_attention_bwd"] == 2
    assert launches["rmsnorm_fwd"] == n
    assert rlaunches["rmsnorm_fwd"] == n + 4 * cfg.n_layers
    assert rlaunches["rmsnorm_bwd"] == launches["rmsnorm_bwd"] == n
