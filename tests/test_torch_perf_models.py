"""The port's §III/§IV regression models held against the JAX package's on
the CPU: `regression.py` (MAE/MAPE, OLS, PCA, k-fold, the 4:1 split),
`svr.py` (the kernels, the dual solver, `SVR`, `grid_search_svr`), the
min-max features, `synth_dataset` and the Table II zoo, `table4_models`,
`WorkerSpeedPredictor`, `CheckpointTimePredictor` and the Eq (4)/(5)
composition of `cluster_model.py`.

Fits are held to 1e-12, SVR predictions to 1e-10, the chosen (C, ε) and
every `params_hash` exactly. The reference's modules import no JAX; they
are imported inside a fixture all the same, as in the port's other tests.
"""
import dataclasses
import math

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.core.perf_model import checkpoint_model as tckpt
from repro_torch.core.perf_model import cluster_model as tcluster
from repro_torch.core.perf_model import features as tfeat
from repro_torch.core.perf_model import regression as treg
from repro_torch.core.perf_model import speed_model as tspeed
from repro_torch.core.perf_model import svr as tsvr

FIT_TOL = dict(rtol=1e-12, atol=1e-12)
SVR_TOL = dict(rtol=1e-10, atol=1e-10)


@pytest.fixture(scope="module")
def J():
    """The JAX package's perf-model modules (NumPy only)."""
    pytest.importorskip("jax")
    import types

    from repro.core.perf_model import (checkpoint_model, cluster_model,
                                       features, regression, speed_model,
                                       svr)
    return types.SimpleNamespace(reg=regression, svr=svr, feat=features,
                                 speed=speed_model, ckpt=checkpoint_model,
                                 cluster=cluster_model)


def _data(seed, n=30, d=2, curved=False):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.0, 1.0, size=(n, d))
    y = 0.3 + X @ rng.uniform(0.5, 2.0, size=d) + rng.normal(0, 0.05, n)
    if curved:
        y = y + 0.8 * np.sin(4.0 * X[:, 0])
    return X, y


def _ckpt_rows(mod, seed, n=12):
    """Checkpoint rows whose T_c grows with S_c, as fig5's measurements
    do, on either package's `CkptRow`."""
    rng = np.random.default_rng(seed)
    s_d = np.geomspace(1e5, 5e9, n) * rng.uniform(0.8, 1.2, n)
    return [mod.CkptRow(f"m{i}", float(s), float(2e3 + s / 4e4),
                        float(1e3 + s / 1e5),
                        float(0.05 + s / 2.5e9 * rng.uniform(0.9, 1.1)))
            for i, s in enumerate(s_d)]


# ---------------------------------------------------------- regression
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_and_splits_equal_the_references(J, seed):
    X, y = _data(seed)
    pred = y + np.random.default_rng(seed + 9).normal(0, 0.1, y.size)
    assert treg.mae(y, pred) == J.reg.mae(y, pred)
    assert treg.mape(y, pred) == J.reg.mape(y, pred)
    for k in (2, 5, 7):
        for a, b in zip(treg.kfold_indices(y.size, k, seed),
                        J.reg.kfold_indices(y.size, k, seed)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(treg.train_test_split(X, y, 0.2, seed),
                    J.reg.train_test_split(X, y, 0.2, seed)):
        np.testing.assert_array_equal(a, b)
    got = treg.kfold_mae(treg.ols_fit, X, y, k=5, seed=seed)
    want = J.reg.kfold_mae(J.reg.ols_fit, X, y, k=5, seed=seed)
    np.testing.assert_allclose(got, want, **FIT_TOL)


@settings(deadline=None, max_examples=25)
@given(n=st.integers(4, 40), d=st.integers(1, 4), seed=st.integers(0, 99))
def test_ols_and_pca_equal_the_references(n, d, seed):
    pytest.importorskip("jax")
    from repro.core.perf_model import regression as jreg
    X, y = _data(seed, n=n, d=d)
    got, want = treg.LinearModel().fit(X, y), jreg.LinearModel().fit(X, y)
    np.testing.assert_allclose(got.w, want.w, **FIT_TOL)
    np.testing.assert_allclose(got.b, want.b, **FIT_TOL)
    np.testing.assert_allclose(got.predict(X), want.predict(X), **FIT_TOL)
    # a row vector of features is taken as one sample per entry
    np.testing.assert_allclose(treg.ols_fit(X[:, 0], y).predict(X[:, :1]),
                               jreg.ols_fit(X[:, 0], y).predict(X[:, :1]),
                               **FIT_TOL)
    k = min(2, d)
    tp, jp = treg.PCA(k).fit(X), jreg.PCA(k).fit(X)
    np.testing.assert_allclose(tp.mean_, jp.mean_, **FIT_TOL)
    np.testing.assert_allclose(tp.transform(X), jp.transform(X), **FIT_TOL)


def test_degenerate_inputs_raise_as_the_references(J):
    X = np.arange(10, dtype=float).reshape(-1, 1)
    y = 2.0 * X[:, 0] + 1.0
    for mod in (treg, J.reg):
        with pytest.raises(ValueError, match="empty"):
            mod.mae([], [])
        with pytest.raises(ValueError, match="all targets are zero"):
            mod.mape([0.0, 0.0], [1.0, 2.0])
        with pytest.raises(ValueError, match="k=12 invalid"):
            mod.kfold_mae(mod.ols_fit, X, y, k=12)
        with pytest.raises(ValueError, match="empty"):
            mod.kfold_mae(mod.ols_fit, X[:0], y[:0])


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (3.5, 3.5), (-2.0, 7.0)])
def test_features_equal_the_references(J, lo, hi):
    x = np.linspace(lo, hi, 9)
    assert tfeat.minmax_fit(x) == J.feat.minmax_fit(x)
    np.testing.assert_array_equal(tfeat.minmax_apply(x, lo, hi),
                                  J.feat.minmax_apply(x, lo, hi))
    c_gpu = np.array([s.teraflops for s in tfeat.GPU_SPECS.values()])
    np.testing.assert_array_equal(tfeat.c_norm(x[:4], c_gpu),
                                  J.feat.c_norm(x[:4], c_gpu))
    assert {k: dataclasses.asdict(v) for k, v in tfeat.GPU_SPECS.items()} \
        == {k: dataclasses.asdict(v) for k, v in J.feat.GPU_SPECS.items()}
    assert "h100" not in tfeat.GPU_SPECS


# ------------------------------------------------------------------ SVR
@pytest.mark.parametrize("kernel", ["poly", "rbf"])
def test_kernels_and_dual_solver_equal_the_references(J, kernel):
    X, y = _data(3, n=20, d=1, curved=True)
    tk = (tsvr.rbf_kernel(2.0) if kernel == "rbf"
          else tsvr.poly_kernel(2, 1.0, 0.7))
    jk = (J.svr.rbf_kernel(2.0) if kernel == "rbf"
          else J.svr.poly_kernel(2, 1.0, 0.7))
    K = tk(X, X)
    np.testing.assert_array_equal(K, jk(X, X))
    for C, eps in ((10.0, 0.01), (100.0, 0.1), (0.05, 0.0)):
        beta = tsvr._fit_dual(K, y, C, eps, passes=60)
        np.testing.assert_array_equal(beta,
                                      J.svr._fit_dual(K, y, C, eps, 60))
        assert tsvr._bias(K, y, beta, C, eps) == J.svr._bias(K, y, beta, C,
                                                             eps)


@pytest.mark.parametrize("kernel,gamma", [("rbf", None), ("poly", None),
                                          ("rbf", 1.0)])
@pytest.mark.parametrize("seed", [0, 4])
def test_svr_fit_and_predict_equal_the_references(J, kernel, gamma, seed):
    X, y = _data(seed, n=24, d=1, curved=True)
    got = tsvr.SVR(kernel=kernel, C=30.0, epsilon=0.02, gamma=gamma).fit(X, y)
    want = J.svr.SVR(kernel=kernel, C=30.0, epsilon=0.02,
                     gamma=gamma).fit(X, y)
    np.testing.assert_allclose(got.beta_, want.beta_, **SVR_TOL)
    np.testing.assert_allclose(got.b_, want.b_, **SVR_TOL)
    Xq = np.linspace(-0.2, 1.2, 17)[:, None]
    np.testing.assert_allclose(got.predict(Xq), want.predict(Xq), **SVR_TOL)
    assert got.n_support_ == want.n_support_
    assert np.all(np.abs(got.beta_) <= got.C + 1e-12)
    with pytest.raises(KeyError):
        tsvr.SVR(kernel="linear").fit(X, y)


@pytest.mark.parametrize("kernel", ["rbf", "poly"])
def test_grid_search_chooses_as_the_reference(J, kernel):
    X, y = _data(5, n=20, d=1, curved=True)
    tm, tinfo = tsvr.grid_search_svr(X, y, kernel, k=5, seed=1)
    jm, jinfo = J.svr.grid_search_svr(X, y, kernel, k=5, seed=1)
    assert (tinfo["C"], tinfo["epsilon"]) == (jinfo["C"], jinfo["epsilon"])
    np.testing.assert_allclose(
        [tinfo["kfold_mae"], tinfo["kfold_mae_std"]],
        [jinfo["kfold_mae"], jinfo["kfold_mae_std"]], **FIT_TOL)
    Xq = np.linspace(0.0, 1.0, 11)[:, None]
    np.testing.assert_allclose(tm.predict(Xq), jm.predict(Xq), **SVR_TOL)


# -------------------------------------------------------- §III Table II
def _same_reports(got, want, tol=FIT_TOL):
    assert [r.name for r in got] == [r.name for r in want]
    assert [r.input_feature for r in got] == [r.input_feature
                                              for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(
            [g.kfold_mae, g.kfold_mae_std, g.test_mae, g.test_mape],
            [w.kfold_mae, w.kfold_mae_std, w.test_mae, w.test_mape],
            err_msg=g.name, **tol)
        assert g.extra == w.extra, g.name


@pytest.mark.parametrize("seed", [0, 3])
def test_synth_dataset_equals_the_reference(J, seed):
    rows = tspeed.synth_dataset(tspeed.TABLE1_MODELS, samples_per=4,
                                seed=seed)
    assert rows == J.speed.synth_dataset(J.speed.TABLE1_MODELS,
                                         samples_per=4, seed=seed)
    gen = tspeed.calibrate_generators()["p100"]
    np.testing.assert_array_equal(
        gen.sample(1.54, np.random.default_rng(seed), 8),
        J.speed.calibrate_generators()["p100"].sample(
            1.54, np.random.default_rng(seed), 8))


def test_table2_reports_equal_the_references(J):
    rows = tspeed.synth_dataset(tspeed.TABLE1_MODELS, samples_per=5, seed=0)
    got = tspeed.table2_models(rows, seed=0)
    _same_reports(got, J.speed.table2_models(rows, seed=0))
    assert len(got) == 2 + 3 * 3


def _card_like_rows(seed):
    """Rows shaped like chip_smoke's phase 15 measurements: two archs on
    one card, C_m in GFLOPs, step times growing with it."""
    rng = np.random.default_rng(seed)
    rows = []
    for arch, slope in (("qwen3-1.7b", 6.1e-5), ("mamba2-1.3b", 1.1e-4)):
        for b, s in ((1, 512), (1, 1024), (2, 512), (1, 2048), (2, 1024),
                     (2, 2048)):
            c_m = 3.6e3 * b * s / 1e3 * (1.25 if arch[0] == "q" else 1.0)
            rows.append({"arch": arch, "gpu": "h100", "c_m": c_m,
                         "step_time": float(0.02 + slope * c_m
                                            * rng.uniform(0.97, 1.03))})
    return rows


@pytest.mark.parametrize("seed", [0, 1])
def test_worker_speed_predictor_equals_the_reference(J, seed):
    rows = _card_like_rows(seed)
    held = [rows[3], rows[9]]
    fit_rows = [r for r in rows if r not in held]
    got = tspeed.WorkerSpeedPredictor.fit(fit_rows, "h100")
    want = J.speed.WorkerSpeedPredictor.fit(fit_rows, "h100")
    assert got.params_hash() == want.params_hash()
    for r in rows:
        np.testing.assert_allclose(got.predict(r["c_m"]),
                                   want.predict(r["c_m"]), **SVR_TOL)
        assert got.speed(r["c_m"]) == want.speed(r["c_m"])
    assert got.score(held) == want.score(held)
    assert got.update(rows).params_hash() == want.update(rows).params_hash()
    with pytest.raises(ValueError):
        tspeed.WorkerSpeedPredictor.fit(rows, "v100")


# ---------------------------------------------------------------- §IV
@pytest.mark.parametrize("seed", [0, 2])
def test_table4_reports_equal_the_references(J, seed):
    got = tckpt.table4_models(_ckpt_rows(tckpt, seed), seed=seed)
    _same_reports(got, J.ckpt.table4_models(_ckpt_rows(J.ckpt, seed),
                                            seed=seed))
    assert [r.name for r in got] == ["univariate", "multivariate",
                                     "multivariate_pca2", "svr_rbf"]


def test_checkpoint_time_predictor_equals_the_reference(J):
    got = tckpt.CheckpointTimePredictor.fit(_ckpt_rows(tckpt, 1))
    want = J.ckpt.CheckpointTimePredictor.fit(_ckpt_rows(J.ckpt, 1))
    assert got.params_hash() == want.params_hash()
    for nbytes in (0.0, 1e6, 6.88e9, 2e10):
        assert got.predict(nbytes) == want.predict(nbytes)
        assert got.predict_seconds(nbytes) >= 0.0
    assert got.score(_ckpt_rows(tckpt, 2)) == want.score(
        _ckpt_rows(J.ckpt, 2))
    assert (got.update(_ckpt_rows(tckpt, 3)).params_hash()
            == want.update(_ckpt_rows(J.ckpt, 3)).params_hash())
    row = _ckpt_rows(tckpt, 0)[0]
    assert row.s_c == row.s_d + row.s_m + row.s_i


def test_checkpointer_sizes_give_a_row(tmp_path):
    """`Checkpointer.save`'s sizes are the (S_d, S_m, S_i) of a row, as
    benchmarks/fig5_checkpoint.py forms it."""
    import torch

    from repro_torch.checkpoint.checkpointer import Checkpointer
    tree = {"w": torch.ones(64, 32), "b": torch.zeros(32)}
    sizes = Checkpointer(str(tmp_path)).save(0, tree)
    row = tckpt.CkptRow("toy", sizes.s_d, sizes.s_m, sizes.s_i, 0.01)
    assert row.s_c == sizes.total and sizes.s_d == 4 * (64 * 32 + 32)


# ------------------------------------------------------- Eq (4) and (5)
@pytest.mark.parametrize("n_w,i_c,t_c,probs", [
    (1000, 100, 3.5, [0.1, 0.2]), (2000, 200, 34.65, [0.66] * 4),
    (7, 3, 0.0, []), (10_000, 10_000, 1.0, [1.0] * 8)])
def test_eq4_and_eq5_equal_the_references(J, n_w, i_c, t_c, probs):
    tin = tcluster.Eq4Inputs(n_w, i_c, t_c, 90.0, 120.0, probs)
    jin = J.cluster.Eq4Inputs(n_w, i_c, t_c, 90.0, 120.0, probs)
    assert tcluster.expected_revocations(probs) == \
        J.cluster.expected_revocations(probs)
    for sp in (0.09, 4.56, 130.0):
        assert tcluster.predict_total_time(sp, tin) == \
            J.cluster.predict_total_time(sp, jin)
    base = n_w / 4.56 + math.ceil(n_w / i_c) * t_c
    assert tcluster.predict_total_time(4.56, tin) >= base - 1e-9


@pytest.mark.parametrize("counts", [{"v100": 4}, {"k80": 2, "p100": 3},
                                    {"p100": 8, "v100": 4}])
@pytest.mark.parametrize("compression", ["none", "int8"])
def test_cluster_composition_equals_the_reference(J, counts, compression):
    speeds = {"k80": 4.56, "p100": 12.19, "v100": 15.61}
    tp = tcluster.HeterogeneousPredictor(speeds, 1.87e6, 1, 97, compression)
    jp = J.cluster.HeterogeneousPredictor(speeds, 1.87e6, 1, 97,
                                          compression)
    assert tp.predict(counts) == jp.predict(counts)
    tw = [tcluster.WorkerSpec(g, speeds[g]) for g, n in counts.items()
          for _ in range(n)]
    jw = [J.cluster.WorkerSpec(g, speeds[g]) for g, n in counts.items()
          for _ in range(n)]
    tps = tcluster.PSBottleneckModel(1.87e6, 1, n_tensors=97,
                                     compression=compression)
    jps = J.cluster.PSBottleneckModel(1.87e6, 1, n_tensors=97,
                                      compression=compression)
    for g in counts:
        assert tps.worker_step_time(tw, g) == jps.worker_step_time(jw, g)
        assert tps.worker_step_time(tw, g) >= 1.0 / speeds[g]
