"""Data sources of the port (a copy of the JAX package's `data/`)."""
