"""The paper's table and figure drivers on the port, one module per
reference module under `benchmarks/` (less `mc_speed`), run by
`repro_torch.bench.run` (`python -m repro_torch bench`)."""
