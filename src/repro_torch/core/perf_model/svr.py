"""ε-SVR (support vector regression) in the dual, as the paper uses
(Eqs 2-3): f(x) = Σ_i β_i K(x_i, x) + b, β_i = α_i - α_i*, with polynomial
and RBF kernels and box constraint |β_i| <= C (penalty p).

No sklearn in the container. Solver: exact cyclic coordinate descent on the
dual box-QP
    min_β  ½ βᵀKβ − yᵀβ + ε‖β‖₁   s.t. |β_i| ≤ C
(each coordinate has a closed-form soft-threshold + clip update), with the
bias b recovered from KKT-interior support vectors. The Σβ=0 equality of the
textbook dual is absorbed into the post-hoc bias fit — standard practice for
small-N kernel machines and indistinguishable at the paper's N=20 scale.

Grid-search CV mirrors §III-B exactly: p ∈ [10,100] step 10,
ε ∈ [0.01,0.1] step 0.01, k-fold MAE. Kernel matrices are computed once per
fold and shared across the whole grid.

The port's copy of the JAX package's `core/perf_model/svr.py` (it imports
nothing of it).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np

from repro_torch.core.perf_model.regression import kfold_indices, mae


def poly_kernel(degree: int = 2, coef0: float = 1.0, gamma: float = 1.0):
    def k(a, b):
        return (gamma * (a @ b.T) + coef0) ** degree
    return k


def rbf_kernel(gamma: float = 1.0):
    def k(a, b):
        aa = np.sum(a * a, axis=1)[:, None]
        bb = np.sum(b * b, axis=1)[None, :]
        d2 = aa + bb - 2.0 * (a @ b.T)
        return np.exp(-gamma * np.maximum(d2, 0.0))
    return k


def _fit_dual(K: np.ndarray, y: np.ndarray, C: float, eps: float,
              passes: int = 200, tol: float = 1e-8) -> np.ndarray:
    """Cyclic coordinate descent on the box-constrained ε-SVR dual."""
    n = len(y)
    beta = np.zeros(n)
    f = np.zeros(n)            # K @ beta, maintained incrementally
    # kernel matrices are symmetric, so the contiguous row K[i] stands in
    # for the strided column K[:, i] the update needs
    kdiag = np.diag(K)
    diag = np.maximum(kdiag.copy(), 1e-12)
    for _ in range(passes):
        max_delta = 0.0
        for i in range(n):
            r = y[i] - (f[i] - kdiag[i] * beta[i])  # residual excluding i
            # soft-threshold on epsilon, then box clip
            if r > eps:
                b_new = (r - eps) / diag[i]
            elif r < -eps:
                b_new = (r + eps) / diag[i]
            else:
                b_new = 0.0
            b_new = min(C, max(-C, b_new))
            d = b_new - beta[i]
            if d != 0.0:
                f += K[i] * d
                beta[i] = b_new
                max_delta = max(max_delta, abs(d))
        if max_delta < tol:
            break
    return beta


def _bias(K, y, beta, C, eps) -> float:
    f0 = K @ beta
    interior = (np.abs(beta) > 1e-9) & (np.abs(beta) < C - 1e-9)
    if interior.any():
        return float(np.mean(y[interior] - f0[interior]
                             - eps * np.sign(beta[interior])))
    return float(np.mean(y - f0))


@dataclasses.dataclass
class SVR:
    kernel: str = "rbf"           # rbf | poly
    C: float = 10.0               # paper's penalty p
    epsilon: float = 0.1
    gamma: Optional[float] = None  # default 1/(n_features * var)
    degree: int = 2
    passes: int = 200
    beta_: np.ndarray = None
    b_: float = 0.0
    X_: np.ndarray = None

    def _kfn(self, n_features: int, x_var: float) -> Callable:
        gamma = self.gamma
        if gamma is None:
            gamma = 1.0 / max(n_features * max(x_var, 1e-12), 1e-12)
        if self.kernel == "rbf":
            return rbf_kernel(gamma)
        if self.kernel == "poly":
            return poly_kernel(self.degree, coef0=1.0, gamma=gamma)
        raise KeyError(self.kernel)

    def fit(self, X, y) -> "SVR":
        X = np.atleast_2d(np.asarray(X, float))
        if X.shape[0] != len(y):
            X = X.T
        y = np.asarray(y, float)
        self.X_ = X
        self._kfn_cached = self._kfn(X.shape[1], float(X.var()))
        K = self._kfn_cached(X, X)
        self.beta_ = _fit_dual(K, y, self.C, self.epsilon, self.passes)
        self.b_ = _bias(K, y, self.beta_, self.C, self.epsilon)
        return self

    def predict(self, X) -> np.ndarray:
        X = np.atleast_2d(np.asarray(X, float))
        if self.X_.shape[1] != X.shape[1]:
            X = X.T
        K = self._kfn_cached(X, self.X_)
        return K @ self.beta_ + self.b_

    @property
    def n_support_(self) -> int:
        return int(np.sum(np.abs(self.beta_) > 1e-8))


def grid_search_svr(X, y, kernel: str = "rbf", k: int = 5, seed: int = 0,
                    penalties=None, epsilons=None) -> Tuple[SVR, dict]:
    """The paper's grid search: p ∈ [10,100] step 10, ε ∈ [0.01,0.1] step
    0.01, k-fold CV.

    The kernel is evaluated ONCE on the full dataset and every fold's
    train/test blocks are `np.ix_` selections into it — no per-fold
    kernel re-evaluation, and nothing kernel-shaped inside the (C, ε)
    double loop.
    """
    X = np.atleast_2d(np.asarray(X, float))
    if X.shape[0] != len(y):
        X = X.T
    y = np.asarray(y, float)
    penalties = penalties if penalties is not None else np.arange(10, 101, 10)
    epsilons = epsilons if epsilons is not None else np.arange(0.01, 0.101, 0.01)
    folds = kfold_indices(len(y), k, seed)

    proto = SVR(kernel=kernel)
    kfn = proto._kfn(X.shape[1], float(X.var()))
    K_full = kfn(X, X)                      # one kernel evaluation total
    cache = []
    for i in range(k):
        te = folds[i]
        tr = np.concatenate([folds[j] for j in range(k) if j != i])
        cache.append((K_full[np.ix_(tr, tr)], K_full[np.ix_(te, tr)],
                      y[tr], y[te]))

    best = None
    for C in penalties:
        for eps in epsilons:
            maes = []
            for K_tr, K_te, ytr, yte in cache:
                beta = _fit_dual(K_tr, ytr, float(C), float(eps), passes=60)
                b = _bias(K_tr, ytr, beta, float(C), float(eps))
                maes.append(mae(yte, K_te @ beta + b))
            score = float(np.mean(maes))
            if best is None or score < best["kfold_mae"]:
                best = {"C": float(C), "epsilon": float(eps),
                        "kfold_mae": score,
                        "kfold_mae_std": float(np.std(maes))}
    model = SVR(kernel=kernel, C=best["C"], epsilon=best["epsilon"]).fit(X, y)
    return model, best
