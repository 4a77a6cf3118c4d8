"""The paper's §III performance models, as far as the fleet simulator
needs them (the port's copy of the JAX package's `core/perf_model/`)."""
