"""GCP preemptible adapter — the paper's measured market, verbatim.

This adapter owns no numbers of its own: it re-exposes the Table V /
Fig 8-9 lifetime calibrations (`core/transient/revocation.py`), the Fig 6
startup stage means, the Fig 10 replacement anchors and the 2019-era GCP
price sheet (`core/perf_model/features.py`) through the `FleetProvider`
contract, so `provider="gcp"` (the default everywhere) is bit-for-bit the
pre-provider behavior: same objects, same RNG consumption, same outputs.

The port's copy of the JAX package's `providers/gcp.py` (it imports nothing
of it).
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.core.perf_model.features import GPU_SPECS
from repro_torch.core.transient.replacement import (_COLD_BASE,
                                                    _COMPLEXITY_SLOPE,
                                                    _WARM_BASE)
from repro_torch.core.transient.revocation import (MAX_LIFETIME_H,
                                                   REGION_GPU_PARAMS,
                                                   TABLE5_RATES)
from repro_torch.core.transient.startup import (_ONDEMAND_DISCOUNT,
                                                _STAGE_MEANS)
from repro_torch.providers.base import (FleetProvider, LifetimeLaw,
                                        Offering, ReplacementAnchors,
                                        StartupStages)
from repro_torch.providers.registry import register_provider

# The calibrated LifetimeModel predates the provider layer and must stay
# import-cycle-free, so it satisfies LifetimeLaw structurally; register it
# as a virtual subclass for isinstance-based checks.
from repro_torch.core.transient.revocation import LifetimeModel
LifetimeLaw.register(LifetimeModel)


class GCPPreemptible(FleetProvider):
    name = "gcp"
    display_name = "GCP preemptible"
    warning_seconds = 30.0        # ACPI G2 soft-off notice
    max_lifetime_hours = MAX_LIFETIME_H
    # §V finding: stock frameworks do not react to the preemption notice
    graceful_checkpoint_on_warning = False
    default_region = "us-central1"

    def offerings(self) -> Tuple[Offering, ...]:
        return tuple(Offering(r, g) for (r, g), rate in TABLE5_RATES.items()
                     if rate is not None)

    def lifetime_model(self, region: str, gpu: str) -> LifetimeLaw:
        self.check_offered(region, gpu)
        # the exact calibrated LifetimeModel instances — not copies — so
        # sampling consumes the RNG identically to the pre-provider code
        return REGION_GPU_PARAMS[(region, gpu)]

    def startup_stages(self, gpu: str) -> StartupStages:
        p, s, r = _STAGE_MEANS[gpu]
        return StartupStages(p, s, r, _ONDEMAND_DISCOUNT[gpu])

    def replacement_anchors(self) -> ReplacementAnchors:
        return ReplacementAnchors(_COLD_BASE, _WARM_BASE, _COMPLEXITY_SLOPE)

    def price(self, gpu: str, transient: bool = True) -> float:
        spec = GPU_SPECS[gpu]
        return spec.transient_price if transient else spec.hourly_price


GCP = register_provider(GCPPreemptible())
