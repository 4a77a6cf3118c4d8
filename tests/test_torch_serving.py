"""The port's continuous-batching gateway (`repro_torch.serving.engine`,
`repro_torch.api`) held against the JAX package's on the CPU.

Greedy streams must be identical to the reference's for the same weights
and prompt (fp32 SMOKE model, bf16 decode state on both sides). Sampled
streams cannot match `jax.random.categorical` bit for bit, so sampling is
held to the reference's properties: two seeds diverge at token 0, and a
seed replays.
"""
import jax
import numpy as np
import pytest
import torch

from repro.api.serving import generate as jax_generate
from repro.configs import get_config
from repro.models import api as japi
from repro_torch import bridge
from repro_torch.api import Session
from repro_torch.api.serving import generate
from repro_torch.configs import get_config as torch_config
from repro_torch.serving.engine import GatewayEngine


@pytest.fixture(scope="module")
def fp32_model():
    jcfg = get_config("qwen3-1.7b", smoke=True).with_(dtype="float32")
    tcfg = torch_config("qwen3-1.7b", smoke=True).with_(dtype="float32")
    vals, _ = japi.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, vals, bridge.from_numpy(
        jax.tree.map(np.asarray, vals), "cpu")


def test_greedy_streams_match_jax(fp32_model):
    jcfg, tcfg, jvals, tvals = fp32_model
    prompt = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (3, 6)).astype(np.int32)
    want = jax_generate(jcfg, jvals, batch=3, prompt_len=6, tokens=5,
                        prompt=prompt)
    got = generate(tcfg, tvals, batch=3, prompt_len=6, tokens=5,
                   prompt=prompt, device="cpu")
    assert got.generated.shape == (3, 5)
    np.testing.assert_array_equal(np.asarray(got.generated),
                                  np.asarray(want.generated))
    assert got.device == "cpu" and got.decode_ms_p50 > 0.0


def _run_engine(cfg, params, joins, steps=40):
    """Drive one engine; `joins` maps step -> (slot, rid, prompt)."""
    eng = GatewayEngine(cfg, params, slots=2, max_len=16, seed=1,
                        device="cpu")
    done = {}
    for step in range(steps):
        if step in joins:
            slot, rid, prompt = joins[step]
            eng.join(slot, rid=rid, prompt=prompt, max_new=4)
        if not eng.busy() and step > max(joins):
            break
        for ev in eng.step():
            if "tokens" in ev:
                done[ev["rid"]] = ev["tokens"]
    return done


def test_staggered_join_matches_solo(fp32_model):
    """A request boarding mid-flight decodes the same greedy tokens it
    would alone — slots are isolated in the shared decode state, and a
    join zeroes its slot's stale rows."""
    _, tcfg, _, tvals = fp32_model
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6, 5, 3]]
    solo = {}
    for rid, prompt in enumerate(prompts):
        solo.update(_run_engine(tcfg, tvals, {0: (0, rid, prompt)}))
    staggered = _run_engine(tcfg, tvals, {0: (0, 0, prompts[0]),
                                          3: (1, 1, prompts[1])})
    assert staggered == solo
    # a slot reused after a retirement starts from a clean state
    reused = _run_engine(tcfg, tvals, {0: (0, 0, prompts[0]),
                                       12: (0, 1, prompts[1])})
    assert reused == solo


def test_temperature_diverges_at_token_zero(fp32_model):
    _, tcfg, _, tvals = fp32_model
    prompt = np.full((2, 8), 7, dtype=np.int32)
    a = generate(tcfg, tvals, batch=2, prompt_len=8, tokens=4,
                 temperature=1.0, seed=11, prompt=prompt, device="cpu")
    b = generate(tcfg, tvals, batch=2, prompt_len=8, tokens=4,
                 temperature=1.0, seed=12, prompt=prompt, device="cpu")
    ga, gb = np.asarray(a.generated), np.asarray(b.generated)
    assert ga.shape == gb.shape == (2, 4)
    assert (ga[:, 0] != gb[:, 0]).any(), \
        "seeds must be able to diverge at the first generated token"
    c = generate(tcfg, tvals, batch=2, prompt_len=8, tokens=4,
                 temperature=1.0, seed=11, prompt=prompt, device="cpu")
    np.testing.assert_array_equal(np.asarray(c.generated), ga)


def test_session_serve_replays_and_reports():
    s = Session.from_arch("qwen3-1.7b", smoke=True, device="cpu")
    a = s.serve(tokens=4, batch=2, prompt_len=6, seed=3)
    b = s.serve(tokens=4, batch=2, prompt_len=6, seed=3)
    assert torch.equal(a.generated, b.generated)
    assert 0.0 < a.decode_ms_p50 <= a.decode_ms_p95 <= a.decode_ms_p99
    ev = s.bus.of_kind("serve")[-1].payload
    assert ev["tokens"] == 4 and ev["device"] == "cpu"
    assert s.describe()["device"] == "cpu"


def test_join_validation():
    cfg = torch_config("qwen3-1.7b", smoke=True)
    eng = GatewayEngine(cfg, slots=1, max_len=8, device="cpu")
    with pytest.raises(ValueError, match="empty prompt"):
        eng.join(0, rid=0, prompt=[], max_new=2)
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.join(0, rid=0, prompt=[1] * 6, max_new=4)
    eng.join(0, rid=0, prompt=[1, 2], max_new=2)
    with pytest.raises(ValueError, match="occupied"):
        eng.join(0, rid=1, prompt=[1], max_new=1)


def test_cli_serve(capsys, monkeypatch):
    from repro_torch.__main__ import main
    assert main(["serve", "--device", "cpu", "--batch", "1",
                 "--prompt-len", "3", "--tokens", "2"]) == 0
    out = capsys.readouterr().out
    assert "device=cpu" in out and "tok/s" in out
    # no card and no --device: a clean error, exit 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["serve"]) == 2
    assert "device='cpu'" in capsys.readouterr().err
