"""A training cell: the port's own training path at the configuration's
widths, from weights and batches the benchmark makes from the seed.

Set-up builds a `Session` (`Session.from_arch`, no checkpoints) and its
`TransientTrainer` with one member, whose `ShardedLoader` takes the feed
that the cell's reference names (`portbench/feed.py`); the benchmark's
weights go into the trainer's state.
The first `CHECKED_STEPS` steps go through `TransientTrainer.run_steps`,
the window's own call on the window's own feed, and warm every shape up;
the program's readings are taken from its state between them (its first
gradient, read back from AdamW's first moment, is kept on the host). The window
then runs that same trainer on that same state, one `run_steps` call a step,
until ``--seconds`` have passed. After the window closes the program is
freed and the reference follows the checked steps again from the same
weights and batches.

With ``--trace 1`` the window runs under the profiler for at most
`TRACE_STEPS` steps and the per-layer readers read its trace.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional

import torch

from portbench import check, harness, weights
from portbench.reference import train as plain
from portbench.trace import Trace, capture, span

#: steps that warm up and are checked against the reference
CHECKED_STEPS = 2
#: steps a traced window runs at most
TRACE_STEPS = 5


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    dims: dict
    reference: object
    batch: int
    seq: int
    setup_s: float = math.nan
    window_s: float = math.nan
    steps: int = 0
    peak_bytes: int = 0
    trace: Optional[Trace] = None

    @property
    def tokens_per_step(self) -> int:
        return self.batch * self.seq

    def kernel_calls(self) -> dict:
        return self.reference.kernel_calls(self.dims, self.batch, self.seq)

    def train_flops(self) -> float:
        return self.reference.train_flops(self.dims, self.batch, self.seq)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def feed_for(cell, dims: dict, seed: int):
    """The feed the cell's reference names, for its traffic and seed."""
    return cell.reference().FEED.for_cell(dims, cell.traffic, seed)


def checked_batches(cell, dims: dict, seed: int, device,
                    rows_kept: Optional[int] = None) -> list:
    """The checked steps' batches as the program's loader draws them, every
    key the feed yields, the first ``rows_kept`` rows of each where
    given."""
    feed = feed_for(cell, dims, seed)
    return [{k: torch.from_numpy(v[:rows_kept]).to(device)
             for k, v in feed.batch(step, 0, 1,
                                    cell.traffic["global_batch"]).items()}
            for step in range(CHECKED_STEPS)]


def _check_program_config(cfg, stated: dict) -> None:
    have = json.loads(json.dumps(dataclasses.asdict(cfg)))
    differ = {k: (have.get(k), v) for k, v in stated.items()
              if have.get(k) != v}
    if differ:
        raise ValueError(f"the program's configuration is not the one the "
                         f"file states (have, stated): {differ}")


class Program:
    """The port's trainer on the benchmark's weights, through its first
    checked steps."""

    def __init__(self, cell, seed: int, device, ckpt_dir: str):
        from repro_torch.api.session import Session
        from repro_torch.core.trainer import TransientTrainer
        from repro_torch.data.pipeline import ShardedLoader
        from repro_torch.launch import steps as st
        from repro_torch.models import api
        from repro_torch.tree import flatten

        self.flatten = flatten
        ref = cell.reference()
        self.dims = ref.dims(cell.config)
        self.specs = ref.param_specs(self.dims)
        self.seed, self.device = seed, device
        t, opt = cell.traffic, cell.traffic["optimizer"]
        prog = cell.config["program"]
        session = Session.from_arch(
            prog["arch"], smoke=prog["preset"] == "smoke", device=device,
            optimizer=opt["name"], lr=opt["lr"],
            weight_decay=opt["weight_decay"],
            warmup_steps=opt["warmup_steps"], total_steps=opt["total_steps"],
            grad_clip=opt["grad_clip"], checkpoint_interval=0,
            checkpoint_dir=ckpt_dir)
        _check_program_config(session.cfg, prog["config"])
        if session.run.master_weights != (opt["state_dtype"] != "float32"):
            raise ValueError("the program's optimizer state is not the "
                             f"{opt['state_dtype']} the traffic states")
        weights.check_names(self.specs, {
            n: tuple(v.shape) for n, v in flatten(api.param_shapes(
                session.cfg))})
        loader = ShardedLoader(feed_for(cell, self.dims, seed),
                               t["global_batch"])
        make_optimizer = st.make_optimizer

        def spanned_optimizer(*args, **kw):
            o = make_optimizer(*args, **kw)

            def update(*a):
                with span("optimizer"):
                    return o.update(*a)
            return o._replace(update=update)

        st.make_optimizer = spanned_optimizer
        try:
            self.trainer = TransientTrainer(session.cfg, session.run, loader,
                                            device=device)
        finally:
            st.make_optimizer = make_optimizer
        step = self.trainer.train_step

        def spanned_step(state, batch):
            with span("train_step"):
                return step(state, batch)

        self.trainer.train_step = spanned_step
        params = weights.nest(weights.make_all(self.specs, seed, device))
        self.state = st.TrainState(
            params, self.trainer.opt.init(params),
            torch.zeros((), dtype=torch.int32),
            st.init_residual(params, session.run))
        self.b1 = opt["b1"]

    def step(self) -> float:
        with span("run_steps"):
            self.state, report = self.trainer.run_steps(self.state, 1)
        return report.losses[0]

    def checked_steps(self) -> dict:
        """The first `CHECKED_STEPS` steps, and the program's readings: each
        loss, each leaf's first gradient as the optimizer got it (its
        first moment over 1 - b1; the gradient itself is kept on the host
        in ``first_grads``), each leaf's second moment and change."""
        losses = [self.step()]
        first = list(self.flatten(self.state.opt["m"]))
        # norms where the state lives: the host's fp32 reduction of a leaf
        # of 10^8 elements reads low by percents
        grad_norms = {name: float(torch.linalg.vector_norm(m)) / (1 - self.b1)
                      for name, m in first}
        self.first_grads = {name: m.to("cpu", copy=True).div_(1 - self.b1)
                            for name, m in first}
        losses += [self.step() for _ in range(CHECKED_STEPS - 1)]
        with torch.no_grad():
            moment_norms = {name: float(torch.linalg.vector_norm(v))
                            for name, v in self.flatten(self.state.opt["v"])}
            change_norms = {
                name: float(torch.linalg.vector_norm(
                    p - weights.make_leaf(self.specs, name, self.seed,
                                          self.device)))
                for name, p in self.flatten(self.state.params)}
        return {"losses": losses, "grad_norms": grad_norms,
                "moment_norms": moment_norms, "change_norms": change_norms}


def reference_readings(cell, seed: int, device, cast=plain.identity,
                       rows_kept: Optional[int] = None,
                       optimizer: Optional[dict] = None,
                       against: Optional[Dict[str, dict]] = None,
                       keep_grads: bool = False) -> dict:
    """The reference through the checked steps from the seed's weights and
    batches (the first ``rows_kept`` rows of each where given; the traffic's
    optimizer settings updated by ``optimizer``). ``grad_diffs[label]``
    holds each leaf's distance from its first gradient to the one
    ``against[label]`` holds (host tensors, by leaf name); with
    ``keep_grads`` its own first gradients come back on the host in
    ``first_grads``."""
    ref = cell.reference()
    dims = ref.dims(cell.config)
    specs = ref.param_specs(dims)
    t = cell.traffic
    batches = checked_batches(cell, dims, seed, device, rows_kept)
    against = against or {}
    diffs = {label: {} for label in against}
    kept = {}

    def first_grad(name, g):
        for label, grads in against.items():
            diffs[label][name] = float(torch.linalg.vector_norm(
                g - grads[name].to(g.device)))
        if keep_grads:
            kept[name] = g.to("cpu", copy=True)

    out = plain.follow(
        ref, dims, weights.make_all(specs, seed, device), batches,
        dict(t["optimizer"], **(optimizer or {})),
        initial=lambda n: weights.make_leaf(specs, n, seed, device),
        cast=cast, first_grad=first_grad)
    out["grad_diffs"] = diffs
    if keep_grads:
        out["first_grads"] = kept
    return out


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run(cell, seed: int, seconds: float, trace: bool, device,
        started: float) -> dict:
    t = cell.traffic
    on_card = torch.device(device).type == "cuda"
    with tempfile.TemporaryDirectory() as ckpt_dir:
        program = Program(cell, seed, device, ckpt_dir)
        readings = program.checked_steps()
        first_grads = program.first_grads
        run_ = Run(program.dims, cell.reference(), t["global_batch"],
                   t["seq_len"])
        _sync(device)
        run_.setup_s = time.perf_counter() - started
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        losses = []
        t0 = time.perf_counter()

        def window():
            while True:
                losses.append(program.step())
                elapsed = time.perf_counter() - t0
                if elapsed >= seconds or (trace and
                                          len(losses) >= TRACE_STEPS):
                    return

        if trace:
            run_.trace = capture(window, on_card)
            run_.window_s = run_.trace.window_s
        else:
            window()
            _sync(device)
            run_.window_s = time.perf_counter() - t0
        run_.steps = len(losses)
        if on_card:
            run_.peak_bytes = torch.cuda.max_memory_allocated()
        del program
    free(device)
    metrics = harness.read_metrics(cell, run_, trace)
    t0 = time.perf_counter()
    ref = reference_readings(cell, seed, device,
                             against={"program": first_grads})
    del first_grads
    readings["grad_diffs"] = ref["grad_diffs"]["program"]
    verdict = check.judge(check.numbers(readings, ref), cell.limits)
    print(f"portbench: set-up {run_.setup_s:.3f} s, window {run_.window_s:.3f}"
          f" s ({run_.steps} steps), reference {time.perf_counter() - t0:.3f}"
          " s", file=sys.stderr)
    result = {
        "correct": verdict["correct"], "attempted": run_.steps,
        "failed": sum(not math.isfinite(x) for x in losses),
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name() if on_card
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": run_.peak_bytes,
                   "power_limit": power_limit() if on_card else None}}
    if trace:
        result["device"]["busy_s"] = run_.trace.busy_s()
        result["device"]["window_s"] = run_.trace.window_s
        result["breakdown"] = run_.trace.breakdown()
    result["checks"] = verdict["checks"]
    return result
