"""Multi-cloud `FleetProvider` layer (docs/providers.md, DESIGN.md §5).

One interface owns everything that differs between transient-GPU markets
— the (region, gpu) offering grid, revocation-lifetime laws, startup and
replacement-time models, and hourly pricing — so the paper's Eq (4)/(5)
machinery plans, simulates and predicts on any of them:

    from repro_torch.providers import get_provider
    aws = get_provider("aws")
    aws.lifetime_model("us-east-1", "v100").prob_revoked_within(12.0)

Built-in adapters: `gcp` (the paper's Table V / Fig 8-9 calibrations,
bit-for-bit), `aws` (uncapped price-signal hazard, 2-min notice), `azure`
(eviction-rate tiers, 30 s notice). `provider=` parameters across
`repro_torch.core.transient` and `repro_torch.api.Session` accept either a
registry name or a `FleetProvider` instance.

The port's copy of the JAX package's `providers/` (it imports nothing of
it).
"""
from repro_torch.providers.base import (  # noqa: F401
    FleetProvider, LifetimeLaw, Offering, ReplacementAnchors, StartupStages)
from repro_torch.providers.registry import (  # noqa: F401
    available_providers, get_provider, register_provider)
from repro_torch.providers.gcp import GCP, GCPPreemptible  # noqa: F401
from repro_torch.providers.aws import AWS, AWSSpot  # noqa: F401
from repro_torch.providers.azure import AZURE, AzureLowPriority  # noqa: F401
