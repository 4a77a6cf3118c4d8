"""The paper's CIFAR-10 CNN zoo (`repro_torch.models.cnn`) held against
the JAX package's `models/cnn.py` on the CPU.

* C_m (`flops_per_image`) and `param_count` are equal for all 20 specs
  of `ZOO`: the §III speed models key on them.
* The forward's logits and the loss of a small ResNet and a small
  Shake-Shake `CNNSpec` agree to 1e-5 of max |want| (fp32, sums in
  another order), and every gradient leaf to 1e-4 of its max |value|;
  both packages get the same weights (crossed with `repro_torch.bridge`,
  HWIO convs and the ``stages`` lists as they are) and the same numpy
  images. Shake-Shake is held at ``key=None``, where alpha is 0.5.
* "SAME" padding at stride 2 pads (0, 1), where PyTorch's ``padding=1``
  pads (1, 1): a dedicated case holds the port's conv against
  `lax.conv_general_dilated`.

JAX is imported inside the fixture that needs it.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.models import cnn
from repro_torch.tree import flatten, tree_map

SMALL = [cnn.CNNSpec("tiny_resnet", "resnet", 2, 8),
         cnn.CNNSpec("tiny_shake", "shake_shake", 1, 8)]


@pytest.fixture(scope="module")
def J():
    """The JAX package's CNN zoo, on the CPU."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from jax import lax
    from repro.models import cnn as jcnn
    return types.SimpleNamespace(jax=jax, jnp=jnp, lax=lax, cnn=jcnn)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(np.asarray(t, dtype=np.float32))


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


def _jspec(J, spec):
    return J.cnn.CNNSpec(spec.name, spec.kind, spec.blocks_per_stage,
                         spec.base_width)


def _batch(seed, n=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 32, 32, 3)).astype(np.float32),
            rng.integers(0, cnn.N_CLASSES, n).astype(np.int32))


def test_the_zoo_is_the_references(J):
    """The same 20 specs under the same names: the paper's four and the
    16 custom variants."""
    assert list(cnn.ZOO) == list(J.cnn.ZOO)
    assert len(cnn.ZOO) == 20
    for name, spec in cnn.ZOO.items():
        want = J.cnn.ZOO[name]
        assert (spec.kind, spec.blocks_per_stage, spec.base_width,
                spec.depth) == (want.kind, want.blocks_per_stage,
                                want.base_width, want.depth)


@pytest.mark.parametrize("name", list(cnn.ZOO))
def test_complexity_and_parameters_equal_the_references(J, name):
    """C_m and the parameter count (counted on the meta device, the
    reference's via `jax.eval_shape`), exactly."""
    spec = cnn.ZOO[name]
    assert cnn.flops_per_image(spec) == J.cnn.flops_per_image(
        J.cnn.ZOO[name])
    assert cnn.param_count(spec) == J.cnn.param_count(J.cnn.ZOO[name])


@pytest.mark.parametrize("spec", SMALL, ids=lambda s: s.name)
def test_init_matches_reference_tree(J, spec):
    """Paths (``stages`` lists included), shapes and fp32."""
    want = dict(flatten(J.jax.tree.map(
        np.asarray, J.cnn.init_params(J.jax.random.PRNGKey(0),
                                      _jspec(J, spec)))))
    got = dict(flatten(cnn.init_params(torch.Generator().manual_seed(0),
                                       spec)))
    assert sorted(got) == sorted(want)
    assert "stages/1/0/proj" in got and "stages/0/0/b1/c1" in got
    for path, arr in want.items():
        assert tuple(got[path].shape) == arr.shape, path
        assert got[path].dtype == torch.float32, path


@pytest.mark.parametrize("size,k,cin,cout,stride", [
    (32, 3, 3, 8, 1), (32, 3, 8, 16, 2), (16, 3, 16, 32, 2),
    (32, 1, 8, 16, 2), (17, 3, 4, 4, 2), (15, 1, 4, 8, 1)])
def test_same_conv_matches_lax(J, size, k, cin, cout, stride):
    """`cnn._conv` (XLA's "SAME" padding, HWIO weights) against
    `lax.conv_general_dilated` in NHWC; at stride 2 with k = 3 PyTorch's
    symmetric ``padding=1`` would shift every window by one pixel."""
    rng = np.random.default_rng(size * 7 + stride)
    x = rng.standard_normal((2, size, size, cin)).astype(np.float32)
    w = rng.standard_normal((k, k, cin, cout)).astype(np.float32)
    want = J.lax.conv_general_dilated(
        J.jnp.asarray(x), J.jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = cnn._conv(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                    torch.from_numpy(w), stride).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-5
    if k == 3 and stride == 2 and size % 2 == 0:
        symmetric = torch.nn.functional.conv2d(
            torch.from_numpy(x).permute(0, 3, 1, 2),
            torch.from_numpy(w).permute(3, 2, 0, 1), stride=2,
            padding=1).permute(0, 2, 3, 1)
        assert _rel(symmetric, want) > 1e-2


@pytest.mark.parametrize("spec", SMALL, ids=lambda s: s.name)
def test_forward_loss_and_grads_match_jax(J, spec):
    js = _jspec(J, spec)
    jparams = J.cnn.init_params(J.jax.random.PRNGKey(1), js)
    params = bridge.from_numpy(J.jax.tree.map(np.asarray, jparams), "cpu")
    images, labels = _batch(2)
    jimg, jlab = J.jnp.asarray(images), J.jnp.asarray(labels)
    want_logits = J.cnn.forward(jparams, js, jimg)
    got_logits = cnn.forward(params, spec, torch.from_numpy(images))
    assert got_logits.shape == (4, cnn.N_CLASSES)
    assert _rel(got_logits, want_logits) < 1e-5
    jloss, jgrads = J.jax.value_and_grad(
        lambda p: J.cnn.loss_fn(p, js, jimg, jlab))(jparams)
    live = tree_map(lambda t: t.requires_grad_(), params)
    loss = cnn.loss_fn(live, spec, torch.from_numpy(images),
                       torch.from_numpy(labels))
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(
        float(jloss))
    want = dict(flatten(J.jax.tree.map(np.asarray, jgrads)))
    got = dict(flatten(tree_map(lambda t: t.grad, live)))
    assert sorted(got) == sorted(want)
    for path in want:
        assert _rel(got[path], want[path]) < 1e-4, path


def test_one_sgd_step_matches_jax(J):
    """The training step the benchmarks take (fig2_stability: the
    gradient of `loss_fn`, then SGD at 0.05), once, on the small ResNet:
    the updated weights agree to 1e-4 of each leaf's max, the gradients'
    tolerance (a norm bias starts at zero, so after one step it is all
    gradient)."""
    spec = SMALL[0]
    js = _jspec(J, spec)
    jparams = J.cnn.init_params(J.jax.random.PRNGKey(2), js)
    params = bridge.from_numpy(J.jax.tree.map(np.asarray, jparams), "cpu")
    images, labels = _batch(3, n=8)
    jg = J.jax.grad(lambda p: J.cnn.loss_fn(
        p, js, J.jnp.asarray(images), J.jnp.asarray(labels)))(jparams)
    jnew = J.jax.tree.map(lambda a, b: a - 0.05 * b, jparams, jg)
    live = tree_map(lambda t: t.requires_grad_(), params)
    cnn.loss_fn(live, spec, torch.from_numpy(images),
                torch.from_numpy(labels)).backward()
    with torch.no_grad():
        new = tree_map(lambda p: p - 0.05 * p.grad, live)
    want = dict(flatten(J.jax.tree.map(np.asarray, jnew)))
    for path, t in flatten(new):
        assert _rel(t, want[path]) < 1e-4, path


def test_shake_shake_draws_one_alpha_per_image():
    """With a generator, training mixes the branches by a uniform draw per
    image (the same generator state gives the same logits, another state
    other logits); without one, alpha is 0.5 as at inference."""
    spec = SMALL[1]
    params = cnn.init_params(torch.Generator().manual_seed(0), spec)
    images = torch.from_numpy(_batch(4)[0])
    fixed = cnn.forward(params, spec, images)
    assert torch.equal(cnn.forward(params, spec, images, train=True), fixed)
    a = cnn.forward(params, spec, images, train=True,
                    key=torch.Generator().manual_seed(1))
    b = cnn.forward(params, spec, images, train=True,
                    key=torch.Generator().manual_seed(1))
    c = cnn.forward(params, spec, images, train=True,
                    key=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.allclose(a, c)
    assert not torch.allclose(a, fixed)
