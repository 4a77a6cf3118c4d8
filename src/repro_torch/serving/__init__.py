"""Serving layer of the port: the continuous-batching gateway."""
from repro_torch.serving.engine import GatewayEngine  # noqa: F401
