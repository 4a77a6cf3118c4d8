"""Provider registry: name -> FleetProvider singleton.

Adapters self-register at import time (repro_torch.providers.__init__ imports
them all), so `get_provider("gcp"|"aws"|"azure")` works out of the box and
third-party adapters only need a `register_provider` call.

The port's copy of the JAX package's `providers/registry.py` (it imports
nothing of it).
"""
from __future__ import annotations

from typing import Dict, List, Union

from repro_torch.providers.base import FleetProvider

_REGISTRY: Dict[str, FleetProvider] = {}

ProviderLike = Union[str, FleetProvider]


def register_provider(provider: FleetProvider) -> FleetProvider:
    """Register (or replace) a provider under `provider.name`."""
    if not provider.name:
        raise ValueError("provider.name must be a non-empty registry key")
    _REGISTRY[provider.name] = provider
    return provider


def available_providers() -> List[str]:
    return sorted(_REGISTRY)


def get_provider(provider: ProviderLike) -> FleetProvider:
    """Resolve a registry name to its provider; FleetProvider instances
    pass through, so every `provider=` parameter takes either form."""
    if isinstance(provider, FleetProvider):
        return provider
    if provider not in _REGISTRY:
        raise KeyError(f"unknown provider {provider!r}; "
                       f"known: {available_providers()}")
    return _REGISTRY[provider]
