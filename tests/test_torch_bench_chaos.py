"""`repro_torch.bench.chaos`, `recalib` and `serving` held against the
reference's `benchmarks/` on the CPU (``device="cpu"``).

* chaos and recalib: every row equal, exactly. No field of these rows
  comes from a wall clock: the fleet ensembles are simulated and the
  live runs train under the runner's virtual clock, so the detections,
  latencies, actions, refits and deviations are the reference's.
* serving: the `serve_wave` and `plan` rows equal, exactly (host NumPy
  in both packages); the gateway's tok/s and decode percentiles are wall
  clocks, so that row need only be present, under the reference's name,
  with a finite positive value.

The port's live runs take one torch thread, as `torch_live_harness.py`
runs them: parallel test processes otherwise thrash.
"""
import math

import pytest
import torch


@pytest.fixture
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name", ["chaos", "recalib"])
def test_scorecard_rows_equal_the_references(name, one_thread):
    pytest.importorskip("jax")
    import importlib
    ref = importlib.import_module(f"benchmarks.{name}")
    port = importlib.import_module(f"repro_torch.bench.{name}")
    want = ref.run()
    assert want
    assert port.run(device="cpu") == want


def test_serving_host_rows_equal_the_references(one_thread):
    pytest.importorskip("jax")
    from benchmarks import serving as ref
    from repro_torch.bench import serving as port
    want = {r["name"]: r for r in ref.run()}
    got = {r["name"]: r for r in port.run(device="cpu")}
    assert list(got) == list(want)
    for name in ("serving/serve_wave", "serving/plan"):
        assert got[name] == want[name]
    assert "smoke=pass" in got["serving/serve_wave"]["derived"]
    gw = got["serving/gateway_tokens_per_s"]
    assert math.isfinite(gw["value"]) and gw["value"] > 0
    assert gw["derived"].endswith("(batch=4)")
