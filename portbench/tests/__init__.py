"""CPU tests of the benchmark (`python -m pytest -q portbench/tests`); the
``cuda`` ones skip where there is no card."""
