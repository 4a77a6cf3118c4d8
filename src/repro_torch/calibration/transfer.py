"""Cross-cell transfer: predict unmeasured (gpu, region) calibrations
from measured ones (PROFET / Habitat style; docs/calibration.md §transfer).

Step time. Habitat's observation: for compute-bound CNN training, step
time scales roughly inversely with peak throughput across GPUs of the
same family. Each measured GPU therefore yields a candidate curve for the
target (`t_target ≈ t_source * tf_source / tf_target`), and we combine
candidates with a geometric mean — multiplicative errors, log-space
average. Validated against Table I itself: predicting the p100 from the
k80 + v100 curves lands within ~6 % MAPE of the published p100 numbers.

Lifetime. Table V's revocation matrix is incomplete (two cells were never
offered). An additive log-odds decomposition
`logit(p24) ≈ mu + a[region] + b[gpu]`, least-squares fit over the
observed cells, fills the holes: region effects (us-west1 is calm,
europe-west1 is brutal) and GPU effects (v100 demand) separate cleanly.

The port's copy of the JAX package's `calibration/transfer.py` (it imports
nothing of it). `GPU_SPECS` has no H100 row, so a model for the card is
asked for with `target_teraflops=` (its dense bf16 peak).
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Tuple

import numpy as np


def _teraflops(gpu: str) -> float:
    from repro_torch.core.perf_model.features import GPU_SPECS
    if gpu not in GPU_SPECS:
        raise KeyError(f"unknown gpu {gpu!r}; known: {sorted(GPU_SPECS)}")
    return GPU_SPECS[gpu].teraflops


# ------------------------------------------------------------- step time
def transfer_step_time_model(target_gpu: str,
                             sources: Optional[Dict[str, object]] = None,
                             target_teraflops: Optional[float] = None):
    """Predict a `GPUStepTimeModel` for `target_gpu` from measured ones.

    `sources` defaults to every calibrated generator except the target
    (hold-one-out); `target_teraflops` overrides the spec sheet for GPUs
    not in `GPU_SPECS`. The returned model interpolates exactly like a
    calibrated one — downstream consumers cannot tell it apart.
    """
    from repro_torch.core.perf_model.speed_model import (
        GPUStepTimeModel, calibrate_generators)

    if sources is None:
        sources = {g: m for g, m in calibrate_generators().items()
                   if g != target_gpu}
    if not sources:
        raise ValueError("transfer_step_time_model: no source models")
    tf_t = (float(target_teraflops) if target_teraflops is not None
            else _teraflops(target_gpu))
    if tf_t <= 0:
        raise ValueError("target teraflops must be positive")

    first = next(iter(sources.values()))
    c_anchors = np.asarray(first.c_anchors, float)
    log_t = np.zeros_like(c_anchors)
    for gpu, model in sources.items():
        tf_s = _teraflops(gpu)
        for i, c in enumerate(c_anchors):
            log_t[i] += math.log(model.step_time(float(c)) * tf_s / tf_t)
    t_anchors = np.exp(log_t / len(sources))
    return GPUStepTimeModel(target_gpu, c_anchors.copy(), t_anchors)


# -------------------------------------------------------------- lifetime
def _logit(p: float) -> float:
    p = min(max(p, 1e-4), 1.0 - 1e-4)
    return math.log(p / (1.0 - p))


def fit_p24_effects(rates: Optional[Dict[Tuple[str, str], Optional[float]]]
                    = None) -> Dict[str, Dict[str, float]]:
    """Least-squares additive log-odds decomposition of the Table V
    revocation matrix. Returns `{"mu": ..., "region": {...}, "gpu": {...}}`
    with sum-to-zero effect coding (so `mu` is the grand mean log-odds)."""
    if rates is None:
        from repro_torch.core.transient.revocation import TABLE5_RATES
        rates = TABLE5_RATES
    cells = [(r, g, p) for (r, g), p in sorted(rates.items())
             if p is not None]
    if len(cells) < 3:
        raise ValueError("fit_p24_effects: need >= 3 observed cells")
    regions = sorted({r for r, _, _ in cells})
    gpus = sorted({g for _, g, _ in cells})
    # Columns: [mu, a_region (all but last), b_gpu (all but last)];
    # the dropped levels are recovered from the sum-to-zero constraint.
    n_r, n_g = len(regions) - 1, len(gpus) - 1
    X = np.zeros((len(cells), 1 + n_r + n_g))
    y = np.zeros(len(cells))
    for i, (r, g, p) in enumerate(cells):
        X[i, 0] = 1.0
        ri, gi = regions.index(r), gpus.index(g)
        if ri < n_r:
            X[i, 1 + ri] = 1.0
        else:
            X[i, 1:1 + n_r] = -1.0
        if gi < n_g:
            X[i, 1 + n_r + gi] = 1.0
        else:
            X[i, 1 + n_r:] = -1.0
        y[i] = _logit(p)
    beta, *_ = np.linalg.lstsq(X, y, rcond=None)
    a = {r: float(beta[1 + i]) for i, r in enumerate(regions[:-1])}
    a[regions[-1]] = -float(beta[1:1 + n_r].sum())
    b = {g: float(beta[1 + n_r + i]) for i, g in enumerate(gpus[:-1])}
    b[gpus[-1]] = -float(beta[1 + n_r:].sum())
    return {"mu": float(beta[0]), "region": a, "gpu": b}


def transfer_p24(region: str, gpu: str,
                 effects: Optional[Dict[str, Dict[str, float]]] = None
                 ) -> float:
    """Predicted 24h revocation probability for an unmeasured cell."""
    eff = effects or fit_p24_effects()
    if region not in eff["region"]:
        raise KeyError(f"region {region!r} never observed; "
                       f"known: {sorted(eff['region'])}")
    if gpu not in eff["gpu"]:
        raise KeyError(f"gpu {gpu!r} never observed; "
                       f"known: {sorted(eff['gpu'])}")
    z = eff["mu"] + eff["region"][region] + eff["gpu"][gpu]
    return 1.0 / (1.0 + math.exp(-z))


def transfer_lifetime_model(region: str, gpu: str,
                            effects: Optional[Dict[str, Dict[str, float]]]
                            = None):
    """A `LifetimeModel` for a cell Table V never measured: p24 from the
    log-odds decomposition, shape/scale from the cell's Fig 8 hint when
    one exists, else the global default."""
    from repro_torch.core.transient.revocation import (_SHAPE_HINTS,
                                                       LifetimeModel)

    p24 = transfer_p24(region, gpu, effects)
    k, mean_hint = _SHAPE_HINTS.get((region, gpu), (1.2, 12.0))
    lam = mean_hint / math.gamma(1.0 + 1.0 / k)
    return LifetimeModel(region, gpu, k, lam, p24)


def holdout_p24_report(rates: Optional[Dict[Tuple[str, str],
                                            Optional[float]]] = None
                       ) -> Iterable[Dict[str, float]]:
    """Leave-one-out check over the observed Table V cells: refit the
    effects without each cell, predict it, report the error. The
    calibration tests gate on this report's MAE."""
    if rates is None:
        from repro_torch.core.transient.revocation import TABLE5_RATES
        rates = TABLE5_RATES
    observed = {k: v for k, v in rates.items() if v is not None}
    rows = []
    for (r, g), actual in sorted(observed.items()):
        rest = dict(observed)
        rest.pop((r, g))
        try:
            eff = fit_p24_effects(rest)
            pred = transfer_p24(r, g, eff)
        except (KeyError, ValueError):
            continue  # cell's region or gpu unseen without it
        rows.append({"region": r, "gpu": g, "actual": actual,
                     "predicted": pred, "abs_err": abs(pred - actual)})
    return rows
