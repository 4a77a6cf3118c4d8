"""The port's §II asynchronous parameter-server emulation held against the
JAX package's, on the CPU.

* `ps_queue_sim` is host NumPy copied from the reference: its results are
  the reference's field for field, bit for bit, on the heap-parity cases
  of tests/test_fleet_batched.py, on the small heterogeneous branch, on
  the saturated and idle collapse branches and on random populations.
* `async_sgd` on a least-squares problem whose batches come from numpy by
  (worker, update index): losses within 1e-6 relative in fp32 (the same
  float32 arithmetic in another framework; the losses near convergence,
  float32 noise of about 1e-8, within 1e-6 of the largest), the staleness
  histogram,
  update counts and paces equal, the weights within 0.05 of the target
  (as tests/test_system.py asks of the reference); no snapshot is ever
  written and at most workers + 1 parameter trees stay alive.
* `Session.train(mode="async_ps")` at the qwen3-1.7b SMOKE config in
  fp32 from the reference's weights: every update's loss within 1e-4
  relative (as the sync trajectory is held), the events and the
  staleness payload equal, the sync-only arguments refused as the
  reference refuses them, and `serve()` on the trained weights; the CLI's
  ``train --mode async_ps``.
"""
import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch.__main__ import main
from repro_torch.api import session as tsession
from repro_torch.api.serving import generate
from repro_torch.configs import RunConfig
from repro_torch.core.ps_async import AsyncTrace, ps_queue_sim, async_sgd
from repro_torch.core.trainer import MembershipEvent
from repro_torch.tree import flatten

from torch_live_harness import one_torch_thread, same_weights

TARGET = np.array([1.0, -2.0, 0.5], np.float32)
PACES = [0.1, 0.1, 0.2, 0.3]


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.core import ps_async
    return jax, jnp, ps_async


# ----------------------------------------------------------- ps_queue_sim
QUEUE_CASES = [
    ([0.082] * 4, 1.87e6, dict(n_tensors=97)),      # unsaturated, uniform
    ([0.082] * 12, 1.87e6, dict(n_tensors=97)),     # saturated plateau
    ([0.05, 0.08, 0.22, 0.3, 0.082], 1.87e6, dict(n_tensors=97)),  # hetero
    ([0.1], 9.8e7, {}),                             # n=1 network-bound
    ([0.02] * 8, 9.8e7, dict(grad_compression="int8")),
    ([0.082] * 6, 1.87e6, dict(n_ps=2, n_tensors=97)),
    ([0.219, 0.219, 0.082, 0.064], 1.87e6, dict(n_tensors=97)),  # §II mix
    # the small heterogeneous branch (n <= 8, paces differ): scalar scan
    ([0.3, 0.1, 0.2], 5e7, dict(n_tensors=10, seed=3)),
    # the array rounds with a heterogeneous population above 8 workers
    ([0.05 + 0.01 * i for i in range(11)], 1.87e6, dict(n_tensors=97)),
    # the idle collapse: uniform paces far from saturating the PS
    ([0.4] * 10, 1e5, {}),
    # the saturated collapse at two PSes and top-k compression
    ([0.01] * 16, 5e7, dict(n_ps=2, grad_compression="topk")),
]


def _same_queue(got, want):
    assert got.worker_step_time == want.worker_step_time
    assert got.cluster_speed == want.cluster_speed
    assert got.ps_utilization == want.ps_utilization


@pytest.mark.parametrize("steps", [1, 60, 300])
@pytest.mark.parametrize("cts,mb,kw", QUEUE_CASES)
def test_ps_queue_sim_equals_the_reference(J, cts, mb, kw, steps):
    _same_queue(ps_queue_sim(cts, mb, steps=steps, **kw),
                J[2].ps_queue_sim(cts, mb, steps=steps, **kw))


@pytest.mark.parametrize("seed", range(6))
def test_ps_queue_sim_equals_the_reference_on_random_populations(J, seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(1, 24))
    cts = list(rng.choice([0.219, 0.082, 0.064], n)) if seed % 2 else \
        list(rng.uniform(0.01, 0.4, n))
    kw = dict(n_tensors=int(rng.integers(0, 120)),
              n_ps=int(rng.integers(1, 3)), seed=seed)
    mb = float(rng.choice([1.87e6, 5e7, 9.8e7]))
    _same_queue(ps_queue_sim(cts, mb, steps=120, **kw),
                J[2].ps_queue_sim(cts, mb, steps=120, **kw))


@pytest.mark.parametrize("steps", [0, -3])
def test_ps_queue_sim_refuses_no_steps(steps):
    with pytest.raises(ValueError, match="at least one step"):
        ps_queue_sim([0.1] * 12, 1.87e6, steps=steps)


# -------------------------------------------------------------- async_sgd
def _counted_data(make):
    """A data function whose batch depends on (worker, update index) only,
    from numpy; `async_sgd` calls it twice an update (gradient, then the
    post-update loss), so the index is the call count halved."""
    calls = [0]

    def data(worker, key):
        rng = np.random.default_rng([worker, calls[0] // 2])
        calls[0] += 1
        x = rng.standard_normal((16, 3)).astype(np.float32)
        return make(x), make(x @ TARGET)
    return data


def _torch_lsq(w, x, y):
    return torch.mean((x @ w - y) ** 2)


def test_async_sgd_equals_the_reference_on_least_squares(J):
    jax, jnp, jps = J
    jw, jtrace = jps.async_sgd(
        lambda w, x, y: jnp.mean((x @ w - y) ** 2), jnp.zeros(3),
        _counted_data(jnp.asarray), PACES, lr=0.05, total_updates=150)
    w, trace = async_sgd(_torch_lsq, torch.zeros(3),
                         _counted_data(torch.from_numpy), PACES, lr=0.05,
                         total_updates=150)
    assert isinstance(trace, AsyncTrace) and trace.applied_updates == 150
    # the late losses (~1e-8) are float32 rounding noise of residuals
    # near zero, where a relative bound means nothing: each loss is held
    # to 1e-6 of itself or of the largest loss
    np.testing.assert_allclose(trace.losses, jtrace.losses, rtol=1e-6,
                               atol=1e-6 * max(jtrace.losses))
    assert trace.staleness_hist == jtrace.staleness_hist
    assert trace.worker_updates == jtrace.worker_updates
    assert trace.worker_step_time == jtrace.worker_step_time
    assert max(trace.staleness_hist) >= 1
    assert trace.losses[-1] < 1e-2
    np.testing.assert_allclose(w.numpy(), TARGET, atol=0.05)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-6)


def test_async_sgd_key_gives_both_calls_of_an_update_one_batch():
    """The generator handed to the data function stands for the
    reference's per-update key: the gradient's call and the loss's call
    of one update draw the same numbers, the next update others."""
    drawn = []

    def data(worker, gen):
        x = torch.randn((16, 3), generator=gen)
        drawn.append(x)
        return x, x @ torch.from_numpy(TARGET)

    async_sgd(_torch_lsq, torch.zeros(3), data, PACES, lr=0.05,
              total_updates=5, seed=7)
    assert len(drawn) == 10
    for a, b in zip(drawn[::2], drawn[1::2]):
        assert torch.equal(a, b)
    assert not torch.equal(drawn[0], drawn[2])


def test_async_sgd_never_writes_a_snapshot():
    """Every tree a gradient was taken at is kept, with a copy of its
    values: an update written in place (into the current params, which
    the updating worker's snapshot and maybe others share) would change
    one of them."""
    seen = []

    def loss_fn(w, x, y):
        if w.requires_grad:
            seen.append((w, w.detach().clone()))
        return _torch_lsq(w, x, y)

    async_sgd(loss_fn, torch.zeros(3), _counted_data(torch.from_numpy),
              PACES, lr=0.05, total_updates=40)
    assert len(seen) == 40
    for live, copy in seen:
        assert torch.equal(live.detach(), copy)
    # stale snapshots were used: some gradients shared a pulled tree
    ptrs = [live.untyped_storage().data_ptr() for live, _ in seen]
    assert len(set(ptrs)) < len(ptrs)


def test_async_sgd_keeps_at_most_workers_plus_one_trees():
    """Each parameter tree (the first, and the one each update makes,
    which the post-update loss is taken at) is tracked by a weak
    reference: after every update at most one snapshot a worker and the
    current params are alive, with no garbage collection to help."""
    trees = []

    def tracked(w):
        trees.append(weakref.ref(w))
        return w

    def loss_fn(w, x, y):
        if not w.requires_grad:
            tracked(w)
        return _torch_lsq(w, x, y)

    alive = []
    enabled = gc.isenabled()
    gc.disable()
    try:
        async_sgd(loss_fn, tracked(torch.zeros(3)),
                  _counted_data(torch.from_numpy), PACES, lr=0.05,
                  total_updates=40,
                  on_update=lambda info: alive.append(
                      sum(r() is not None for r in trees)))
    finally:
        if enabled:
            gc.enable()
    assert len(alive) == 40 and max(alive) <= len(PACES) + 1
    assert max(alive) == len(PACES) + 1      # the bound is reached


# --------------------------------------------- Session.train(mode=async_ps)
def _async_pair(monkeypatch, J, **kw):
    """Both packages' sessions at the qwen3-1.7b SMOKE config in fp32 from
    the reference's seed-0 weights, after 10 async updates of 3 workers."""
    from repro.api import session as jsession
    from repro.configs import RunConfig as JRunConfig
    jcfg, tcfg = same_weights(monkeypatch)
    run = dict(lr=0.1, total_steps=10, seed=0)
    js = jsession.Session(jcfg, JRunConfig(**run, zero1=False),
                          arch="qwen3-1.7b")
    ts = tsession.Session(tcfg, RunConfig(**run), arch="qwen3-1.7b",
                          device="cpu")
    args = dict(global_batch=4, seq_len=32, members=3, mode="async_ps", **kw)
    jrep = js.train(10, **args)
    with one_torch_thread():
        trep = ts.train(10, **args)
    return js, ts, jrep, trep


def test_session_async_ps_equals_the_reference(monkeypatch, J):
    js, ts, jrep, trep = _async_pair(monkeypatch, J)
    assert trep.steps_run == jrep.steps_run == 10
    np.testing.assert_allclose(trep.losses, jrep.losses, rtol=1e-4)
    assert trep.final_loss == trep.losses[-1]
    assert (trep.epochs, trep.checkpoints, trep.restores) == (1, 0, 0)
    jsteps = [e.payload for e in js.bus.of_kind("async_step")]
    tsteps = [e.payload for e in ts.bus.of_kind("async_step")]
    assert len(tsteps) == 10
    for tp, jp in zip(tsteps, jsteps):
        assert {k: v for k, v in tp.items() if k != "loss"} == \
            {k: v for k, v in jp.items() if k != "loss"}
    (tstale,) = ts.bus.of_kind("staleness")
    (jstale,) = js.bus.of_kind("staleness")
    assert tstale.payload == jstale.payload
    assert sum(tstale.payload["hist"].values()) == 10
    assert max(tstale.payload["hist"]) >= 1
    assert tstale.payload["worker_step_time"] == {0: 0.1, 1: 0.2,
                                                  2: pytest.approx(0.3)}
    # serve() afterwards runs on the trained weights: the reference's
    trained = dict(flatten(js._last_state.params))
    for path, leaf in flatten(ts.params):
        want = torch.from_numpy(np.array(trained[path]))
        assert float((leaf - want).abs().max()) <= 1e-4 * float(
            want.abs().max())
    rep = ts.serve(tokens=3, batch=2, prompt_len=4)
    again = generate(ts.cfg, ts.params, batch=2, prompt_len=4, tokens=3,
                     device="cpu")
    assert torch.equal(rep.generated, again.generated)


def test_session_async_ps_paces_given(monkeypatch, J):
    js, ts, jrep, trep = _async_pair(monkeypatch, J,
                                     worker_step_times=[0.3, 0.05, 0.1])
    np.testing.assert_allclose(trep.losses, jrep.losses, rtol=1e-4)
    assert ts.bus.of_kind("staleness")[0].payload == \
        js.bus.of_kind("staleness")[0].payload


def _smoke_session():
    return tsession.Session.from_arch("qwen3-1.7b", device="cpu",
                                      total_steps=4)


@pytest.mark.parametrize("kw", [
    {"events": [MembershipEvent(1, "revoke", 1)]},
    {"checkpoint_dir": "somewhere"},
    {"predicted_speed": 1.0},
    {"ps_model": object()},
    {"workers": [object()]},
    {"resilience": object()},
    {"recalibration": object()},
], ids=lambda kw: next(iter(kw)))
def test_async_ps_refuses_the_sync_only_arguments(kw):
    name = next(iter(kw))
    with pytest.raises(ValueError, match=name):
        _smoke_session().train(2, mode="async_ps", global_batch=2,
                               seq_len=8, **kw)


def test_worker_step_times_and_unknown_modes_refused_in_sync():
    s = _smoke_session()
    with pytest.raises(ValueError, match="worker_step_times"):
        s.train(2, mode="sync", worker_step_times=[0.1, 0.2])
    with pytest.raises(ValueError, match="unknown train mode"):
        s.train(2, mode="definitely-not-a-mode")


def test_cli_train_async_ps(capsys):
    args = ["train", "--mode", "async_ps", "--device", "cpu", "--steps",
            "4", "--members", "2", "--global-batch", "2", "--seq", "16"]
    with one_torch_thread():
        assert main(args) == 0
    out = capsys.readouterr().out
    assert "arch=qwen3-1.7b mode=async_ps updates=4 loss " in out
    assert "staleness_hist={" in out


@pytest.mark.parametrize("extra", [["--checkpoint-dir", "x"],
                                   ["--revoke-at", "2"]])
def test_cli_async_ps_refuses_sync_flags(capsys, extra):
    args = ["train", "--mode", "async_ps", "--device", "cpu", "--steps",
            "2"] + extra
    assert main(args) == 2
    assert "--mode sync only" in capsys.readouterr().err
