"""Both packages' trainers on the same weights, and one chaos scenario's
live plan run by both.

`same_weights` gives the port the JAX package's seed-0 weights of the
qwen3-1.7b SMOKE config in fp32 (as numpy arrays, since `torch` cannot
draw `jax.random` streams). `run_live_pair` drives the JAX package's
`chaos.runner._run_live` and the port's on that config, on the CPU, and
returns both scorecards with the child sessions the runners built, whose
buses hold the event histories. `assert_same_run` holds the port to the reference: the
scorecards and the event-kind sequences equal, every non-step event equal
field for field, and the losses within 1e-4 relative, as
`test_torch_train.py::test_train_trajectory_matches_jax` holds the train
step. A step's `payload_bytes` is held to one float32 rounding: the
reference computes it inside its jitted step in float32 (top-k's
28897.28 bytes at the SMOKE widths come out as 28897.279296875), the port
in Python floats.
"""
import contextlib
import types

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.api import session as tsession
from repro_torch.chaos import get_scenario as tget_scenario
from repro_torch.chaos import runner as trunner
from repro_torch.configs import RunConfig
from repro_torch.configs import get_config as tget_config
from repro_torch.models import api as tapi

LOSS_RTOL = 1e-4
PAYLOAD_RTOL = 2.0 ** -23        # one float32 rounding


def _recording(module, monkeypatch):
    """Patch ``module.Session`` with a subclass that keeps every instance
    (the runner builds its child session from that name at call time)."""
    made = []

    class Recording(module.Session):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(module, "Session", Recording)
    return made


def _armed(armed, resilience_cls, recalibration_cls):
    if armed == "resilience":
        return {"resilience": resilience_cls()}
    if armed == "recalibration":
        return {"recalibration": recalibration_cls()}
    return {}


def same_weights(monkeypatch):
    """The qwen3-1.7b SMOKE configs in fp32 of both packages, with the
    port's `api.init` patched to give the reference's seed-0 weights (the
    reference's trainer draws those itself)."""
    import jax
    from repro.configs import get_config as jget_config
    from repro.models import api as japi

    jcfg = jget_config("qwen3-1.7b", smoke=True).with_(dtype="float32")
    tcfg = tget_config("qwen3-1.7b", smoke=True).with_(dtype="float32")
    values = jax.tree.map(np.asarray,
                          japi.init(jcfg, jax.random.PRNGKey(0))[0])
    monkeypatch.setattr(tapi, "init", lambda cfg, generator=None, device=None:
                        (bridge.from_numpy(values, device), None))
    return jcfg, tcfg


@contextlib.contextmanager
def one_torch_thread():
    """The port's CPU ops on one thread: the driver runs test files in
    parallel processes, and the SMOKE model's small ops spread over every
    core of every process spend their time contending."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def run_live_pair(monkeypatch, name, armed=None, seed=0):
    from repro.api import session as jsession
    from repro.calibration import RecalibrationConfig as JRecal
    from repro.chaos import get_scenario as jget_scenario
    from repro.chaos import runner as jrunner
    from repro.configs import RunConfig as JRunConfig
    from repro.resilience import ResilienceConfig as JRes
    from repro_torch.calibration import RecalibrationConfig
    from repro_torch.resilience import ResilienceConfig

    jcfg, tcfg = same_weights(monkeypatch)

    j_made = _recording(jsession, monkeypatch)
    t_made = _recording(tsession, monkeypatch)
    jparent = jsession.Session(
        jcfg, JRunConfig(**_armed(armed, JRes, JRecal)), arch="qwen3-1.7b")
    tparent = tsession.Session(
        tcfg, RunConfig(**_armed(armed, ResilienceConfig,
                                 RecalibrationConfig)),
        arch="qwen3-1.7b", device="cpu")
    ref = jrunner._run_live(jparent, jget_scenario(name), seed)
    with one_torch_thread():
        port = trunner._run_live(tparent, tget_scenario(name), seed)
    return types.SimpleNamespace(ref=ref, port=port, jchild=j_made[-1],
                                 tchild=t_made[-1])


def assert_same_run(pair):
    assert pair.port == pair.ref
    jh = [(e.kind, e.payload) for e in pair.jchild.bus.history]
    th = [(e.kind, e.payload) for e in pair.tchild.bus.history]
    assert [k for k, _ in th] == [k for k, _ in jh]
    for (kind, tp), (_, jp) in zip(th, jh):
        if kind == "checkpoint":      # sizes differ by the JSON index's text
            assert tp["step"] == jp["step"]
            assert tp["sizes"].s_d == jp["sizes"].s_d
        elif kind == "step":
            assert sorted(tp) == sorted(jp)
            assert tp.get("grad_compression") == jp.get("grad_compression")
            assert tp["step"] == jp["step"]
            assert abs(tp["loss"] - jp["loss"]) <= LOSS_RTOL * abs(
                jp["loss"]), tp["step"]
            if "payload_bytes" in jp:
                assert abs(tp["payload_bytes"] - jp["payload_bytes"]) <= \
                    PAYLOAD_RTOL * jp["payload_bytes"], tp["step"]
        else:
            assert tp == jp, kind
    return th
