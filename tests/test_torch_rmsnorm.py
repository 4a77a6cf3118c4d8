"""The port's RMSNorm backward held against the JAX package's.

The reference differentiates RMSNorm by `jax.vjp` of its oracle
(`repro.kernels.ops._rn_bwd`); the port's backward on the card is a CUDA
kernel whose oracle is `repro_torch.kernels.ref.rmsnorm_bwd_ref`, written
from the formula. These tests hold that oracle against the reference's
custom VJP (its forward a Pallas kernel in interpret mode on the CPU) and
against autograd over the port's own `ref.rmsnorm_ref`. The kernel itself
is held against the oracle on the card (`tests/test_torch_kernels.py`,
``cuda``) and by ``chip_smoke.py``.

Tolerances: fp32 1e-4 of the largest gradient, as
`test_torch_train.py::test_op_gradients_match_jax`; bf16 inputs 2e-2 of
max |dx| (dx is rounded to bf16 once in each package, after sums taken in
another order) and 1e-3 of max |dscale| (fp32 in both).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

EPS = 1e-6
SHAPES = [(3, 5, 64), (37, 2048), (300, 128), (8, 4096)]
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 1e-3)}  # (dx, dscale)


@pytest.fixture
def jax_rmsnorm():
    """The reference's custom-VJP RMSNorm (Pallas in interpret mode)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    return jax, jnp, jops.rmsnorm


def _inputs(shape, seed=0):
    """x and dy normal with a per-row spread of scales, scale in
    [0.5, 1.5]; fp32 numpy arrays."""
    rng = np.random.default_rng(seed)
    spread = np.exp(rng.standard_normal(shape[:-1] + (1,)))
    x = (rng.standard_normal(shape) * spread).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    return x, dy, scale


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got, dtype=np.float32)
    want = want.float().numpy() if isinstance(want, torch.Tensor) else \
        np.asarray(want, dtype=np.float32)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_rmsnorm_bwd_ref_matches_the_references_vjp(jax_rmsnorm, shape,
                                                    dtype):
    jax, jnp, jrms = jax_rmsnorm
    x, dy, scale = _inputs(shape)
    jx, jdy = (jnp.asarray(a).astype(dtype) for a in (x, dy))
    _, vjp = jax.vjp(lambda a, s: jrms(a, s, EPS), jx, jnp.asarray(scale))
    want_dx, want_ds = vjp(jdy)
    tx, tdy = (torch.from_numpy(a).to(getattr(torch, dtype))
               for a in (x, dy))
    dx, ds = ref.rmsnorm_bwd_ref(tx, torch.from_numpy(scale), tdy, EPS)
    assert dx.dtype == tx.dtype and dx.shape == tx.shape
    assert ds.dtype == torch.float32 and ds.shape == (shape[-1],)
    tol_dx, tol_ds = TOL[dtype]
    assert _rel(dx, want_dx) < tol_dx
    assert _rel(ds, want_ds) < tol_ds


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_rmsnorm_bwd_ref_matches_autograd_over_the_plain_forward(shape,
                                                                 dtype):
    x, dy, scale = _inputs(shape, seed=1)
    tx, tdy = (torch.from_numpy(a).to(getattr(torch, dtype))
               for a in (x, dy))
    ts = torch.from_numpy(scale)
    xr, sr = tx.clone().requires_grad_(), ts.clone().requires_grad_()
    want_dx, want_ds = torch.autograd.grad(ref.rmsnorm_ref(xr, sr, EPS),
                                           (xr, sr), tdy)
    dx, ds = ref.rmsnorm_bwd_ref(tx, ts, tdy, EPS)
    tol_dx, tol_ds = TOL[dtype]
    assert _rel(dx, want_dx) < tol_dx
    assert _rel(ds, want_ds) < tol_ds


def test_cpu_rmsnorm_runs_no_kernel_either_way():
    """On the CPU `ops.rmsnorm` is the plain forward under autograd: no
    kernel runs and no launch is counted, forward or backward, and the
    gradients are autograd's over `ref.rmsnorm_ref`."""
    x, dy, scale = (torch.from_numpy(a) for a in _inputs((6, 256), seed=2))
    before = dict(ops.launches)
    a = [x.clone().requires_grad_(), scale.clone().requires_grad_()]
    w = [x.clone().requires_grad_(), scale.clone().requires_grad_()]
    got = torch.autograd.grad(ops.rmsnorm(*a, EPS), a, dy)
    want = torch.autograd.grad(ref.rmsnorm_ref(*w, EPS), w, dy)
    for g, wt in zip(got, want):
        assert torch.equal(g, wt)
    assert ops.launches == before


def test_rmsnorm_bwd_launcher_refuses_cpu_tensors():
    from repro_torch.kernels import rmsnorm as rn
    x = torch.zeros(2, 128)
    with pytest.raises(ValueError, match="CUDA"):
        rn.rmsnorm_bwd(x, torch.ones(128), x)
