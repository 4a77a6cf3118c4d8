"""The port's dry run (`repro_torch.launch.dryrun`, `launch/sweep.py`,
`python -m repro_torch dryrun`): its counts against closed forms, against
the JAX package's `model_flops` and XLA's own count of the same step, its
linearity in depth, its kernel calls against `chip_smoke.py`'s launch
counts, a full-width cell's record, the sweep's artifacts and the CLI."""
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import jax
import pytest
import torch

from repro.configs import RunConfig as JRunConfig
from repro.configs import ShapeConfig as JShapeConfig
from repro.configs import get_config as jget_config
from repro.launch import steps as jsteps
from repro.models import api as japi

from repro_torch.configs import (ALL_SHAPES, ARCH_IDS, ShapeConfig,
                                 get_config, valid_cells)
from repro_torch.kernels import event_select as es
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ss
from repro_torch.launch import dryrun, sweep
from repro_torch.launch.mesh import make_host_mesh

ROOT = pathlib.Path(__file__).resolve().parent.parent
TRAIN = ShapeConfig("t", 64, 2, "train")
# XLA's cost_analysis of the reference's unrolled SMOKE qwen3 train step
# (remat "full", plain attention, B=2, S=64, one CPU device) over the
# port's count of the same step: 403,478,080 / 357,007,360 = 1.1302 (jax
# 0.9.0, torch 2.13.0). XLA also counts the elementwise work, and the
# reference's plain attention scores all S^2 pairs where the flash
# kernel's cost counts the causal half.
XLA_OVER_PORT = (1.05, 1.25)


def _count(arch, shape, cfg=None):
    return dryrun.count_cell(arch, shape, make_host_mesh(), cfg=cfg)[0]


def _calls(counts):
    return {name: counts["kernels"].get(name, {}).get("calls", 0)
            for name in ops.launches}


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's dry-run module, whose import pins 512 host devices
    for the XLA it has not started: the environment is put back at once,
    so no later JAX work of this process sees it."""
    keep = {k: os.environ.get(k) for k in ("XLA_FLAGS", "JAX_PLATFORMS")}
    try:
        from repro.launch import dryrun as ref
    finally:
        for k, v in keep.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return ref


def test_dense_train_step_flops_equal_the_closed_form():
    """qwen3 SMOKE under remat "full": the layers' products 8 N T (forward,
    recompute, two backward products) less the recompute of each layer's
    last product, the MLP's down projection (the checkpoint's recompute
    stops once the last input its backward saves, the MLP's hidden, is
    rebuilt); the tied head's 6 N_head T; and the flash kernels' cost of
    2L forwards (the recompute runs attention again) and L backwards."""
    cfg = get_config("qwen3-1.7b", smoke=True)
    d, L, V, f = cfg.d_model, cfg.n_layers, cfg.vocab_size, cfg.d_ff
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B, S = TRAIN.global_batch, TRAIN.seq_len
    T = B * S
    n_layer = d * H * hd + 2 * d * KV * hd + H * hd * d + 3 * d * f
    aten = 8 * L * n_layer * T - 2 * L * f * d * T + 6 * V * d * T
    fwd = fa.fwd_cost(B, S, S, H, KV, hd, True, 2)
    bwd = fa.bwd_cost(B, S, S, H, KV, hd, True, 2)
    got = _count("qwen3-1.7b", TRAIN, cfg)
    assert got["aten_flops"] == aten
    k = got["kernels"]
    assert k["flash_attention_fwd"]["flops"] == 2 * L * fwd[0]
    assert k["flash_attention_bwd"]["flops"] == L * bwd[0]
    assert k["flash_attention_fwd"]["bytes"] == 2 * L * fwd[1]
    assert got["flops"] == aten + 2 * L * fwd[0] + L * bwd[0] + sum(
        k[n]["flops"] for n in ("rmsnorm_fwd", "rmsnorm_bwd"))
    # the kernels' costs are PERF.md's bound column at qwen3's shapes
    assert fa.fwd_cost(1, 2048, 2048, 16, 8, 128, True)[0] == \
        pytest.approx(17.19e9, rel=1e-3)


def test_model_flops_equal_the_references(ref_dryrun):
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        for shape in ALL_SHAPES:
            jshape = JShapeConfig(shape.name, shape.seq_len,
                                  shape.global_batch, shape.kind)
            assert dryrun.model_flops(cfg, shape) == \
                ref_dryrun.model_flops(jcfg, jshape), (arch, shape.name)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-1.3b"])
def test_count_is_linear_in_depth(arch):
    """The linearity the reference's probes assume: count(n) = overhead +
    n (count(2) - count(1)), here for every layer counted."""
    base = get_config(arch, smoke=True)
    c = [_count(arch, TRAIN, base.with_(n_layers=n)) for n in (1, 2, 3)]
    for key in ("flops", "aten_flops", "bytes", "aten_ops"):
        assert c[2][key] == c[0][key] + 2 * (c[1][key] - c[0][key]), key
    per = [_calls(x) for x in c]
    assert per[2] == {n: per[0][n] + 2 * (per[1][n] - per[0][n])
                      for n in per[0]}


def test_the_references_xla_count_lies_in_a_band_around_the_port_count():
    jcfg = jget_config("qwen3-1.7b", smoke=True).with_(remat="full",
                                                       unroll_layers=True)
    step, _ = jsteps.make_train_step(jcfg, JRunConfig())
    state = jsteps.train_state_specs(jcfg, JRunConfig())
    batch, _ = japi.batch_specs(jcfg, JShapeConfig("t", TRAIN.seq_len,
                                                   TRAIN.global_batch,
                                                   "train"))
    ca = jax.jit(step).lower(state, batch).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, list) else ca
    ratio = ca["flops"] / _count("qwen3-1.7b", TRAIN,
                                 get_config("qwen3-1.7b", smoke=True))["flops"]
    assert XLA_OVER_PORT[0] < ratio < XLA_OVER_PORT[1], ratio


def test_kernel_calls_equal_chip_smokes_launch_counts(chip_smoke):
    """qwen3 at full width as `chip_smoke.py` phases 4 and 21 run it: the
    remat "full" train step at B=2 and B=6 (S=2048) and the B=1 prefill
    call each kernel as often as the card launches it there; the meta
    calls add nothing to `ops.launches`."""
    cfg = get_config("qwen3-1.7b")
    L, n = cfg.n_layers, chip_smoke.norm_count(cfg)
    full = chip_smoke.counts(flash_attention_fwd=2 * L,
                             flash_attention_bwd=L, rmsnorm_fwd=n + 4 * L,
                             rmsnorm_bwd=n)
    prefill = chip_smoke.counts(flash_attention_fwd=L, rmsnorm_fwd=n)
    ops.reset_launches()
    for shape, want in ((ShapeConfig("t", 2048, 2, "train"), full),
                        (ShapeConfig("t", 2048, 6, "train"), full),
                        (ShapeConfig("p", 2048, 1, "prefill"), prefill)):
        got = _count("qwen3-1.7b", shape, cfg.with_(remat="full"))
        assert {k: v for k, v in _calls(got).items()
                if k in chip_smoke.KERNELS} == want, shape
    assert set(ops.launches.values()) == {0}


def test_full_width_qwen3_train_cell_on_both_meshes():
    """The reference's artifact checks (`tests/test_dryrun_artifacts.py`)
    on the port's record of qwen3 train_4k, and its keys."""
    ref_keys = {"arch", "shape", "mesh", "rules", "chips", "ok",
                "master_weights", "remat", "lower_s", "compile_s",
                "flops_per_device", "bytes_per_device", "memory",
                "collectives", "hlo_ops", "model_flops_total",
                "model_flops_per_device", "probe",
                "flops_per_device_corrected", "bytes_per_device_corrected",
                "collective_bytes_corrected", "useful_flops_ratio",
                "roofline", "bottleneck"}
    single = dryrun.run_cell("qwen3-1.7b", "train_4k", False)
    multi = dryrun.run_cell("qwen3-1.7b", "train_4k", True,
                            counts=single["counted"])
    for rec, chips in ((single, 256), (multi, 512)):
        assert ref_keys <= set(rec) and rec["ok"] and rec["chips"] == chips
        assert 0.01 < rec["useful_flops_ratio"] < 1.2
        assert rec["flops_per_device_corrected"] > 0
        assert rec["bytes_per_device_corrected"] > 0
        assert all(v >= 0 for v in rec["roofline"].values())
        assert rec["probe"] == {"probes": 0}
        assert rec["memory"]["argument_bytes"] > 0
        assert rec["collectives"]["weighted_total_bytes"] > 0
        assert rec["flops_per_device"] * chips == \
            pytest.approx(single["counted"]["flops"])
    # ZeRO-1 over "data": the reduction is a reduce-scatter and a gather
    assert single["collectives"]["reduce-scatter"]["count"] > 0
    assert single["collectives"]["all-reduce"]["count"] == 0


def test_decode_and_prefill_cells_count_no_collective():
    rec = dryrun.run_cell("mamba2-1.3b", "long_500k", False)
    assert rec["collectives"]["weighted_total_bytes"] == 0
    assert rec["roofline"]["collective_s"] == 0.0
    assert rec["counted"]["kernels"]["rmsnorm_fwd"]["calls"] == \
        2 * get_config("mamba2-1.3b").n_layers + 1


def test_sweep_writes_skip_err_and_cached_artifacts(tmp_path, monkeypatch):
    out = tmp_path / "dryrun_torch"
    out.mkdir()
    monkeypatch.setattr(sweep, "cells", lambda: [
        ("mamba2-1.3b", "long_500k", True),          # counted
        ("hubert-xlarge", "decode_32k", False),      # inapplicable
        ("qwen3-1.7b", "no_such_shape", True),       # fails
        ("qwen3-1.7b", "decode_32k", True)])         # cached
    cached = out / "qwen3-1.7b__decode_32k.json"
    cached.write_text("[]")
    ref_art = sorted((ROOT / "artifacts").rglob("*")) \
        if (ROOT / "artifacts").exists() else []
    lines = []
    assert sweep.sweep(out_dir=str(out), jobs=2, mesh="single",
                       timeout=600, progress=lines.append) == 1
    rec, = json.loads((out / "mamba2-1.3b__long_500k.json").read_text())
    assert rec["ok"] and rec["mesh"] == "16x16"
    skip, = json.loads((out / "hubert-xlarge__decode_32k.json").read_text())
    assert skip["skipped"] and not skip["ok"]
    assert (out / "qwen3-1.7b__no_such_shape.json.err").exists()
    assert not (out / "qwen3-1.7b__no_such_shape.json").exists()
    assert cached.read_text() == "[]"
    assert any("cached" in x for x in lines)
    assert sweep.DEFAULT_OUT_DIR == os.path.join("artifacts", "dryrun_torch")
    after = sorted((ROOT / "artifacts").rglob("*")) \
        if (ROOT / "artifacts").exists() else []
    assert after == ref_art


def test_dryrun_cli_with_and_without_sweep(tmp_path, monkeypatch):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = tmp_path / "q3.json"
    p = subprocess.run([sys.executable, "-m", "repro_torch", "dryrun",
                        "--arch", "qwen3-1.7b", "--shape", "train_4k",
                        "--mesh", "both", "--out", str(out)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr
    printed = [json.loads(x) for x in p.stdout.splitlines()]
    assert [(r["mesh"], r["ok"]) for r in printed] == \
        [("16x16", True), ("2x16x16", True)]
    assert [r["mesh"] for r in json.loads(out.read_text())] == \
        ["16x16", "2x16x16"]

    from repro_torch import __main__ as cli
    monkeypatch.setattr(sweep, "cells", lambda: [
        (a, s.name, s in valid_cells(get_config(a)))
        for a in ("hubert-xlarge",) for s in ALL_SHAPES
        if s.kind != "prefill" and s.kind != "train"])
    assert cli.main(["dryrun", "--sweep", "--jobs", "1", "--out-dir",
                     str(tmp_path / "sw")]) == 0
    assert sorted(os.listdir(tmp_path / "sw")) == [
        "hubert-xlarge__decode_32k.json", "hubert-xlarge__long_500k.json"]


def test_meta_calls_check_allocate_and_tally_without_launching():
    """On the meta device each wrapper holds its inputs to the kernel's
    rules, returns outputs of the kernel's shapes and dtypes, and adds a
    call and its cost to `ops.tally`, never to `ops.launches`."""
    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    ops.reset_launches()
    ops.reset_tally()
    t, i = ops.event_select(meta(100, 8, dtype=torch.float64))
    assert (t.shape, t.dtype, i.shape, i.dtype) == \
        ((100,), torch.float64, (100,), torch.int32)
    y = ops.ssd_scan(meta(1, 64, 4, 32), meta(1, 64, 4, dtype=torch.float32),
                     meta(4, dtype=torch.float32), meta(1, 64, 1, 16),
                     meta(1, 64, 1, 16), 32)
    assert (y.shape, y.dtype, y.device.type) == \
        ((1, 64, 4, 32), torch.bfloat16, "meta")
    assert ops.tally["event_select_fwd"] == \
        [1, *es.cost(100, 8, 8)]
    assert ops.tally["ssd_scan_fwd"] == [1, *ss.cost(1, 64, 4, 32, 1, 16,
                                                      32, 2)]
    assert set(ops.launches.values()) == {0}
    with pytest.raises(ValueError):          # head_dim 96 is not built
        ops.flash_attention(meta(1, 8, 2, 96), meta(1, 8, 2, 96),
                            meta(1, 8, 2, 96))
    with pytest.raises(ValueError):          # d % 8 != 0 in bf16
        ops.rmsnorm(meta(4, 12), meta(12, dtype=torch.float32))
    with pytest.raises(TypeError):           # fp16 is not taken
        ops.rmsnorm(meta(4, 16, dtype=torch.float16),
                    meta(16, dtype=torch.float32))


M, K, N = 64, 32, 48


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


# (what runs under the accountant, its bytes in closed form): every input
# read once (a broadcast dimension once), every output written once, a
# view or a bare allocation nothing
_BYTE_CASES = {
    "mm": (lambda: _meta(M, K) @ _meta(K, N), 2 * (M * K + K * N + M * N)),
    "broadcast_add": (lambda: _meta(M, N, dtype=torch.float32)
                      + _meta(N, dtype=torch.float32), 4 * (2 * M * N + N)),
    "expanded_add": (lambda: _meta(M, N, dtype=torch.float32)
                     + _meta(1, N, dtype=torch.float32).expand(M, N),
                     4 * (2 * M * N + N)),
    "transpose": (lambda: _meta(M, K).t(), 0),
    "contiguous_of_transpose": (lambda: _meta(M, K).t().contiguous(),
                                2 * 2 * M * K),
    "empty_like": (lambda: torch.empty_like(_meta(M, K)), 0),
    "in_place_mul": (lambda: _meta(M, N, dtype=torch.float32).mul_(2.0),
                     2 * 4 * M * N),
    "cast": (lambda: _meta(M, K).to(torch.float32), (2 + 4) * M * K),
    "sum_over_rows": (lambda: _meta(M, N, dtype=torch.float32).sum(0),
                      4 * (M * N + N)),
}


@pytest.mark.parametrize("case", sorted(_BYTE_CASES))
def test_accountant_bytes_equal_a_closed_form(case):
    """The byte count from both sides, one aten op at a time: phase 22's
    roofline gate on the card only catches a count that is too high."""
    fn, want = _BYTE_CASES[case]
    with dryrun.Accountant() as acc:
        fn()
    assert acc.bytes == want
    if case == "mm":
        assert acc.flops == 2 * M * K * N
