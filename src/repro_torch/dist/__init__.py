"""Distributed-training pieces of the port: gradient compression with
error feedback and elastic membership (copies of the JAX package's
`dist/compression.py` and `dist/elastic.py`)."""
