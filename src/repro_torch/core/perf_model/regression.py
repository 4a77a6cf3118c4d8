"""Regression substrate (no sklearn in the container): OLS (uni/multivariate),
PCA preprocessing, k-fold cross-validation, MAE / MAPE — exactly the paper's
evaluation protocol (§III-B, §IV-C).

The port's copy of the JAX package's `core/perf_model/regression.py` (it
imports nothing of it).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import numpy as np


def mae(y_true, y_pred) -> float:
    y_true = np.asarray(y_true, float)
    if y_true.size == 0:
        raise ValueError("mae: empty input")
    return float(np.mean(np.abs(y_true - np.asarray(y_pred))))


def mape(y_true, y_pred) -> float:
    y_true = np.asarray(y_true, float)
    if y_true.size == 0:
        raise ValueError("mape: empty input")
    if not np.any(np.abs(y_true) > 0):
        raise ValueError("mape: all targets are zero (undefined denominator)")
    return float(np.mean(np.abs(y_true - np.asarray(y_pred))
                         / np.maximum(np.abs(y_true), 1e-12))) * 100.0


@dataclasses.dataclass
class LinearModel:
    """OLS y = X @ w + b (univariate or multivariate)."""
    w: np.ndarray = None
    b: float = 0.0

    def fit(self, X, y) -> "LinearModel":
        X = np.atleast_2d(np.asarray(X, float))
        if X.shape[0] != len(y):
            X = X.T
        A = np.concatenate([X, np.ones((X.shape[0], 1))], axis=1)
        coef, *_ = np.linalg.lstsq(A, np.asarray(y, float), rcond=None)
        self.w, self.b = coef[:-1], float(coef[-1])
        return self

    def predict(self, X) -> np.ndarray:
        X = np.atleast_2d(np.asarray(X, float))
        if X.shape[1] != len(self.w):
            X = X.T
        return X @ self.w + self.b


@dataclasses.dataclass
class PCA:
    """SVD-based PCA to n_components (paper preprocesses (S_d,S_m,S_i) -> 2)."""
    n_components: int = 2
    mean_: np.ndarray = None
    comps_: np.ndarray = None

    def fit(self, X) -> "PCA":
        X = np.asarray(X, float)
        self.mean_ = X.mean(axis=0)
        _, _, vt = np.linalg.svd(X - self.mean_, full_matrices=False)
        self.comps_ = vt[: self.n_components]
        return self

    def transform(self, X) -> np.ndarray:
        return (np.asarray(X, float) - self.mean_) @ self.comps_.T

    def fit_transform(self, X) -> np.ndarray:
        return self.fit(X).transform(X)


def ols_fit(X, y) -> LinearModel:
    return LinearModel().fit(X, y)


def kfold_indices(n: int, k: int, seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    return [idx[i::k] for i in range(k)]


def kfold_mae(fit_fn: Callable, X, y, k: int = 5, seed: int = 0
              ) -> Tuple[float, float]:
    """Returns (mean MAE, std MAE) across folds. fit_fn(Xtr, ytr) -> model
    with .predict."""
    X = np.atleast_2d(np.asarray(X, float))
    if X.shape[0] != len(y):
        X = X.T
    y = np.asarray(y, float)
    if y.size == 0:
        raise ValueError("kfold_mae: empty input")
    if k < 2 or k > y.size:
        raise ValueError(f"kfold_mae: k={k} invalid for n={y.size} "
                         "(need 2 <= k <= n, else a fold is empty)")
    folds = kfold_indices(len(y), k, seed)
    maes = []
    for i in range(k):
        te = folds[i]
        tr = np.concatenate([folds[j] for j in range(k) if j != i])
        model = fit_fn(X[tr], y[tr])
        maes.append(mae(y[te], model.predict(X[te])))
    return float(np.mean(maes)), float(np.std(maes))


def train_test_split(X, y, test_frac: float = 0.2, seed: int = 0):
    """The paper's 4:1 split."""
    X = np.atleast_2d(np.asarray(X, float))
    if X.shape[0] != len(y):
        X = X.T
    y = np.asarray(y, float)
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(y))
    n_test = max(1, int(round(len(y) * test_frac)))
    te, tr = idx[:n_test], idx[n_test:]
    return X[tr], y[tr], X[te], y[te]
