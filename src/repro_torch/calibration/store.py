"""`ModelStore` — one versioned registry for every calibrated estimator.

Before this layer, each consumer reached for its own module-level global:
`calibrate_generators()`'s memo for §III step times, `REGION_GPU_PARAMS`
for §V lifetimes, an ad-hoc `PSBottleneckModel` per call site. The store
replaces those *handles* (not the calibrations — the same memoized
instances seed it, so the unarmed path stays bit-identical) with:

  register(name, est)   file an estimator under a name, version 1
  current(name)         the live estimator
  update(name, est)     new version; the old one is kept as a snapshot
  version(name)         monotonically increasing int — what the
                        Controller stamps into each Detection
  rollback(name[, v])   reinstate an older snapshot (itself a new
                        version, so the audit trail stays append-only)
  snapshots(name)       [(version, params_hash)] audit trail

Naming convention (docs/calibration.md): `step_time/<gpu>`,
`cluster_speed`, `checkpoint_time`, `ps_capacity`,
`lifetime/<provider>/<region>/<gpu>`.

The port's copy of the JAX package's `calibration/store.py`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Snapshot:
    version: int
    estimator: object
    params_hash: str
    note: str = ""


class ModelStore:
    def __init__(self) -> None:
        self._snaps: Dict[str, List[Snapshot]] = {}

    # ------------------------------------------------------------ registry
    def register(self, name: str, estimator: object,
                 note: str = "calibrated") -> int:
        """File `estimator` under `name` (version 1). Re-registering an
        existing name is an error — use `update` for new versions."""
        if name in self._snaps:
            raise ValueError(f"model {name!r} already registered; "
                             "use update() for a new version")
        self._snaps[name] = [Snapshot(1, estimator,
                                      self._hash_of(estimator), note)]
        return 1

    def update(self, name: str, estimator: object,
               note: str = "refit") -> int:
        """File a new version of `name`; returns the new version number."""
        snaps = self._require(name)
        v = snaps[-1].version + 1
        snaps.append(Snapshot(v, estimator, self._hash_of(estimator), note))
        return v

    def rollback(self, name: str, version: Optional[int] = None) -> int:
        """Reinstate snapshot `version` (default: the one before current)
        as a NEW version, keeping the trail append-only."""
        snaps = self._require(name)
        if version is None:
            if len(snaps) < 2:
                raise ValueError(f"model {name!r} has no prior version "
                                 "to roll back to")
            target = snaps[-2]
        else:
            match = [s for s in snaps if s.version == version]
            if not match:
                raise ValueError(f"model {name!r} has no version {version}; "
                                 f"known: {[s.version for s in snaps]}")
            target = match[0]
        return self.update(name, target.estimator,
                           note=f"rollback->v{target.version}")

    # ------------------------------------------------------------- lookup
    def __contains__(self, name: str) -> bool:
        return name in self._snaps

    def names(self) -> List[str]:
        return sorted(self._snaps)

    def current(self, name: str) -> object:
        return self._require(name)[-1].estimator

    def get(self, name: str, default: object = None) -> object:
        snaps = self._snaps.get(name)
        return snaps[-1].estimator if snaps else default

    def version(self, name: str) -> int:
        return self._require(name)[-1].version

    def snapshots(self, name: str) -> List[Tuple[int, str]]:
        return [(s.version, s.params_hash) for s in self._require(name)]

    def at_version(self, name: str, version: int) -> object:
        for s in self._require(name):
            if s.version == version:
                return s.estimator
        raise ValueError(f"model {name!r} has no version {version}")

    # ------------------------------------------------------------ helpers
    def _require(self, name: str) -> List[Snapshot]:
        if name not in self._snaps:
            raise KeyError(f"unknown model {name!r}; "
                           f"registered: {self.names()}")
        return self._snaps[name]

    @staticmethod
    def _hash_of(estimator: object) -> str:
        fn = getattr(estimator, "params_hash", None)
        return fn() if callable(fn) else f"<unhashed:{type(estimator).__name__}>"

    # -------------------------------------------------------- construction
    @classmethod
    def with_static_calibrations(cls) -> "ModelStore":
        """Seed a store with the paper's static calibrations — the exact
        memoized `calibrate_generators()` instances, so resolving through
        the store is bit-identical to the module-global path."""
        from repro_torch.core.perf_model.speed_model import (
            calibrate_generators)

        store = cls()
        for gpu, gen in calibrate_generators().items():
            store.register(f"step_time/{gpu}", gen)
        return store
