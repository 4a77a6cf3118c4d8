"""The four examples on the port, one module per script under `examples/`,
run as ``python -m repro_torch.examples.<name>``."""
