"""`repro_torch.bench.lm_speed_models` held against the reference's
`benchmarks/lm_speed_models.py` on the CPU (``device="cpu"``).

The step times are wall clocks of two different programs, so only their
form is held: one row per arch under the reference's names, each time
positive and finite. C_m (GFLOPs a forward batch, from the config) is
equal per arch, exactly, as each package's `measure` returns it.
"""
import math

import pytest

from repro_torch.bench import lm_speed_models as port
from repro_torch.configs import ARCH_IDS


def _recording(mod, monkeypatch):
    """Wrap ``mod.measure`` so the rows it returns to `run` are kept."""
    seen = []
    measure = mod.measure

    def recorded(*a, **kw):
        seen.append(measure(*a, **kw))
        return seen[-1]
    monkeypatch.setattr(mod, "measure", recorded)
    return seen


def test_lm_speed_rows_and_complexity_equal_the_references(monkeypatch):
    pytest.importorskip("jax")
    from benchmarks import lm_speed_models as ref
    ref_seen, port_seen = (_recording(ref, monkeypatch),
                           _recording(port, monkeypatch))
    want = ref.run()
    got = port.run(device="cpu")
    assert [r["name"] for r in got] == [r["name"] for r in want]
    assert [r["name"] for r in got[:len(ARCH_IDS)]] == \
        [f"lm_speed/{a}" for a in ARCH_IDS]
    # the arch rows' derived strings carry C_m only
    for g, w in zip(got[:len(ARCH_IDS)], want):
        assert g["derived"] == w["derived"]
    (ref_rows,), (port_rows,) = ref_seen, port_seen
    assert [r["arch"] for r in port_rows] == [r["arch"] for r in ref_rows]
    for g, w in zip(port_rows, ref_rows):
        assert g["c_m"] == w["c_m"], g["arch"]
        assert 0 < g["step_time"] < math.inf, g["arch"]
    for r in got:
        assert math.isfinite(r["value"]), r["name"]
