"""Training of the three archs that train on one card — hubert-xlarge (the
audio encoder, here at head_dim 80, its full width's), stablelm-1.6b (MHA,
partial rotary) and qwen2-vl-2b (GQA, M-RoPE) — held against the JAX
package on the CPU at their SMOKE configs.

Both packages start from the same weights (crossed with
`repro_torch.bridge`) and take the same numpy batches (`source_for_config`:
frame features for the encoder, tokens otherwise; the VLM's batches carry
three distinct t/h/w position rows, since equal rows compute plain RoPE)
through five AdamW steps of `make_train_step`, the reference's jitted. The
loss and the gradient norm agree to 1e-4 relative at every step, as
tests/test_torch_train.py holds qwen3's trajectory (the sums run in
another order in the two frameworks).
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import RunConfig
from repro_torch.configs import get_config as torch_config
from repro_torch.data.pipeline import ShardedLoader, source_for_config
from repro_torch.launch import steps as tsteps

B, S, STEPS = 4, 32, 5
CASES = [("hubert-xlarge", {"head_dim": 80}), ("stablelm-1.6b", {}),
         ("qwen2-vl-2b", {})]


@pytest.fixture(scope="module")
def J():
    """The JAX package, on the CPU."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import RunConfig as JRunConfig
    from repro.configs import get_config
    from repro.launch import steps as jsteps
    from repro.models import api as japi
    return types.SimpleNamespace(jax=jax, jnp=jnp, RunConfig=JRunConfig,
                                 get_config=get_config, steps=jsteps,
                                 api=japi)


def _batches(cfg, seed=0):
    """STEPS global batches from the arch's source; the VLM's with three
    distinct position rows (t runs 0..S-1, h and w are drawn)."""
    loader = ShardedLoader(source_for_config(cfg, S, seed=seed), B)
    rng = np.random.default_rng(seed + 1)
    out = []
    for _ in range(STEPS):
        batch = loader.next_global(1)
        if cfg.family == "vlm":
            t = np.broadcast_to(np.arange(S), (B, S))
            batch["positions"] = np.stack(
                [t, *rng.integers(0, 3 * S, (2, B, S))]).astype(np.int32)
            assert not (batch["positions"][0] == batch["positions"][1]).all()
        out.append(batch)
    return out


@pytest.mark.parametrize("arch,change", CASES, ids=[a for a, _ in CASES])
def test_train_trajectory_matches_jax(J, arch, change):
    jcfg = J.get_config(arch, smoke=True).with_(dtype="float32", **change)
    tcfg = torch_config(arch, smoke=True).with_(dtype="float32", **change)
    kw = dict(optimizer="adamw", lr=1e-3, weight_decay=0.1, warmup_steps=2,
              total_steps=10, grad_clip=1.0)
    jrun, trun = J.RunConfig(**kw), RunConfig(**kw)
    jvals, _ = J.api.init(jcfg, J.jax.random.PRNGKey(0))
    jstep, jopt = J.steps.make_train_step(jcfg, jrun)
    jstep = J.jax.jit(jstep)
    jstate = J.steps.TrainState(jvals, jopt.init(jvals),
                                J.jnp.zeros((), J.jnp.int32),
                                J.steps.init_residual(jvals, jrun))
    tparams = bridge.from_numpy(J.jax.tree.map(np.asarray, jvals), "cpu")
    tstep, topt = tsteps.make_train_step(tcfg, trun)
    tstate = tsteps.TrainState(tparams, topt.init(tparams),
                               torch.zeros((), dtype=torch.int32),
                               tsteps.init_residual(tparams, trun))
    for i, batch in enumerate(_batches(tcfg)):
        jstate, jm = jstep(jstate, {k: J.jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        for key in ("loss", "grad_norm"):
            want = float(jm[key])
            assert np.isfinite(want)
            assert abs(float(tm[key]) - want) <= 1e-4 * abs(want), (i, key)
    assert int(tstate.step) == STEPS
