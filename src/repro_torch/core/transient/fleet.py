"""Discrete-event transient-fleet simulator — the stand-in for the paper's
cloud measurement fleet (docs/DESIGN.md §2). Drives training-loop simulations:
revocations (per region/GPU/time-of-day), replacement startup, PS bottleneck,
checkpoint overhead — everything Eq (4) predicts, so predicted-vs-simulated
error is a meaningful §VI-A validation.

The port's copy of the JAX package's `core/transient/fleet.py` (it
imports nothing of it). The event and batched engines are NumPy on the
host, as there; `engine="jit"` is the port's device engine
(`fleet_jit.run_jit`, torch on the card).
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.perf_model.cluster_model import (PSBottleneckModel,
                                                       WorkerSpec,
                                                       cluster_speed)
from repro_torch.core.transient.replacement import ReplacementModel
from repro_torch.core.transient.revocation import RevocationSampler
from repro_torch.core.transient.startup import StartupModel


@dataclasses.dataclass(order=True)
class FleetEvent:
    t: float
    kind: str = dataclasses.field(compare=False)
    payload: dict = dataclasses.field(compare=False, default_factory=dict)


@dataclasses.dataclass
class SimWorker:
    wid: int
    gpu: str
    region: str
    speed: float           # steps/s on the target model
    alive: bool = True
    is_chief: bool = False
    #: launch-roster slot this worker (or its replacement chain) occupies;
    #: chaos straggler faults target slots, not wids
    slot: int = -1


@dataclasses.dataclass
class SimResult:
    total_time_s: float
    steps_done: int
    revocations: int
    replacements: int
    checkpoint_time_s: float
    recompute_time_s: float
    lost_steps: float
    events: List[Tuple[float, str]]
    monetary_cost: float
    provider: str = "gcp"
    region: str = ""
    #: quorum-pause wall-clock (resilience degradation; docs/resilience.md)
    paused_s: float = 0.0
    #: restore-retry stall wall-clock after stock-chief revocations
    restore_delay_s: float = 0.0


def _percentiles(xs: List[float]) -> Tuple[float, float, float]:
    a = np.asarray(xs, float)
    return (float(np.percentile(a, 50)), float(np.percentile(a, 90)),
            float(a.mean()))


@dataclasses.dataclass
class SimStats:
    """Distribution summary of a `FleetEnsemble` (§VI-A, beyond the paper's
    single-trajectory validation): p50/p90/mean of wall-clock, cost and
    revocations across trajectories, plus the standard error of the means.

    `finished` counts trajectories that completed every requested step;
    when `finished < n` the rest were censored (hit `max_hours`, or died
    with `replace=False`), so the time/cost percentiles understate the
    true distribution — check it before trusting the summary."""
    n: int
    time_p50_s: float
    time_p90_s: float
    time_mean_s: float
    time_stderr_s: float
    cost_p50: float
    cost_p90: float
    cost_mean: float
    cost_stderr: float
    revocations_p50: float
    revocations_p90: float
    revocations_mean: float
    replacements_mean: float
    finished: int = 0
    revocations_stderr: float = 0.0

    @classmethod
    def from_results(cls, results: List["SimResult"],
                     total_steps: Optional[int] = None) -> "SimStats":
        times = [r.total_time_s for r in results]
        costs = [r.monetary_cost for r in results]
        revs = [float(r.revocations) for r in results]
        n = len(results)
        finished = (n if total_steps is None else
                    sum(1 for r in results if r.steps_done >= total_steps))
        t50, t90, tm = _percentiles(times)
        c50, c90, cm = _percentiles(costs)
        r50, r90, rm = _percentiles(revs)

        def sem(xs):  # unbiased (ddof=1) standard error of the mean
            if n <= 1:
                return 0.0
            return float(np.std(xs, ddof=1)) / math.sqrt(n)

        return cls(n, t50, t90, tm, sem(times),
                   c50, c90, cm, sem(costs),
                   r50, r90, rm,
                   float(np.mean([r.replacements for r in results])),
                   finished=finished, revocations_stderr=sem(revs))


@dataclasses.dataclass
class FleetEnsemble:
    """`FleetSim.run_many` output: every trajectory plus summary stats."""
    results: List[SimResult]
    stats: SimStats
    provider: str = "gcp"
    region: str = ""

    def __len__(self) -> int:
        return len(self.results)


class FleetSim:
    """Simulate one training run on a transient cluster.

    Policies: `replace` (request a new transient server on revocation),
    `handover` (CM-DARE checkpoint-lease handover vs stock chief-IP restart).
    `provider` selects the market (revocation/startup/replacement laws from
    `repro_torch.providers`); with a provider whose revocation notice is long
    enough to flush a checkpoint (`graceful_checkpoint_on_warning` and
    `warning_seconds >= T_c`, e.g. AWS's 2-minute notice), a revoked chief
    checkpoints before dying, so stock identity-reuse loses no steps.

    `n_tensors` / `grad_compression` feed the Fig 4 PS capacity term the
    same way `Session.predict` does (§VI-B): the network share of the PS
    service time shrinks by `compression_ratio(scheme)` while the
    per-tensor RPC share stays, so predicted-vs-simulated error is
    meaningful for compressed runs too. Defaults reproduce the historic
    uncompressed, RPC-free capacity model.
    """

    def __init__(self, workers: List[SimWorker], *, model_gflops: float,
                 model_bytes: float, step_speed_of: Callable[[str], float],
                 checkpoint_interval_steps: int, checkpoint_time_s: float,
                 n_ps: int = 1, seed: int = 0, replace: bool = True,
                 handover: bool = True, price_of: Optional[Dict] = None,
                 provider: object = "gcp", n_tensors: int = 0,
                 grad_compression: str = "none", chaos: object = None,
                 resilience: object = None):
        from repro_torch.providers import get_provider
        self.workers = {w.wid: w for w in workers}
        if workers:
            workers[0].is_chief = True
        for idx, w in enumerate(workers):
            w.slot = idx
        # immutable launch roster, so `run_many` can respawn trajectories
        # after `run` has mutated self.workers
        self._roster = tuple((w.wid, w.gpu, w.region, w.speed)
                             for w in workers)
        self.model_gflops = model_gflops
        self.model_bytes = model_bytes
        self.speed_of = step_speed_of
        self.i_c = checkpoint_interval_steps
        self.t_c = checkpoint_time_s
        self.n_ps = n_ps
        self.n_tensors = n_tensors
        self.grad_compression = grad_compression
        self.replace = replace
        self.handover = handover
        self.provider = get_provider(provider)
        self.seed = seed
        self.rev = RevocationSampler(seed, self.provider)
        self.startup = StartupModel(seed + 1, self.provider)
        self.repl = ReplacementModel(seed + 2, self.provider)
        self.rng = np.random.default_rng(seed + 3)
        self.price_of = price_of or {}
        # a chaos.FaultTimeline compiled against this roster (or None):
        # hazard faults transform the FleetDraws lifetime streams, while
        # speed/PS/ckpt faults make the cluster piecewise-time-varying
        self.chaos = chaos
        # a repro_torch.resilience.ResilienceConfig (or None): quorum-tier
        # degradation gates effective speed, and stock-chief restores
        # stall for the keyed retry schedule — honored identically by
        # all three engines (docs/resilience.md)
        self.resilience = resilience

    def _respawn(self, seed: int) -> "FleetSim":
        """A fresh simulator over the same launch roster and physics, with
        its own seed — one ensemble trajectory."""
        workers = [SimWorker(wid, gpu, region, speed)
                   for wid, gpu, region, speed in self._roster]
        return FleetSim(workers, model_gflops=self.model_gflops,
                        model_bytes=self.model_bytes,
                        step_speed_of=self.speed_of,
                        checkpoint_interval_steps=self.i_c,
                        checkpoint_time_s=self.t_c, n_ps=self.n_ps,
                        seed=seed, replace=self.replace,
                        handover=self.handover, price_of=self.price_of,
                        provider=self.provider, n_tensors=self.n_tensors,
                        grad_compression=self.grad_compression,
                        chaos=self.chaos, resilience=self.resilience)

    def _cluster_speed(self, t: Optional[float] = None) -> float:
        """Cluster steps/s; with a chaos timeline and a sim clock `t`,
        straggler multipliers and the PS capacity factor at `t` apply
        (factors are constant within any span the run loop advances —
        chaos boundaries are scheduled as events)."""
        if self.chaos is None or t is None:
            alive = [WorkerSpec(w.gpu, w.speed)
                     for w in self.workers.values() if w.alive]
            if not alive:
                return 0.0
            ps = PSBottleneckModel(self.model_bytes, self.n_ps,
                                   n_tensors=self.n_tensors,
                                   compression=self.grad_compression)
            return cluster_speed(alive, ps)
        alive = [w for w in self.workers.values() if w.alive]
        if not alive:
            return 0.0
        ts = np.array([t])
        mults = self.chaos.speed_mults(ts)[0]
        raw = sum(w.speed * (mults[w.slot] if 0 <= w.slot < mults.size
                             else 1.0) for w in alive)
        ps = PSBottleneckModel(self.model_bytes, self.n_ps,
                               n_tensors=self.n_tensors,
                               compression=self.grad_compression)
        capacity = (ps.capacity_steps_per_s()
                    * float(self.chaos.ps_factor(ts)[0]))
        return min(raw, capacity)

    def run(self, total_steps: int, max_hours: float = 48.0,
            start_hour: float = 0.0, *,
            initial_lifetimes: Optional[Sequence[float]] = None,
            draws: Optional[object] = None, traj: int = 0) -> SimResult:
        """`start_hour`: local launch hour, so diurnal lifetime laws (GCP
        Fig 9, AWS price signal) see the planned launch cell.
        `initial_lifetimes`: pre-drawn lifetimes (hours, launch-roster
        order, np.inf = survived) — `run_many` injects one batched draw
        per trajectory; the default draws from `self.rev` as before.
        `draws` (a `fleet_batched.FleetDraws`) + `traj` switch every
        replacement-chain draw (startup, cold start, join lifetime) onto
        the counter-based per-(trajectory, slot, generation) streams the
        batched engine consumes, making this event loop the exact parity
        oracle for `run_many(engine="batched")`; the default `None`
        keeps the historic sequential streams bit-for-bit."""
        if self.chaos is not None and draws is None:
            # standalone chaos run: route all randomness through the
            # shared-draws streams (n=1), so hazard-transformed lifetimes
            # are identical to run_many(n=1) on either engine
            from repro_torch.core.transient.fleet_batched import FleetDraws
            draws = FleetDraws(self, 1, start_hour)
            traj = 0
            if initial_lifetimes is None:
                initial_lifetimes = draws.initial[0]
        q: List[FleetEvent] = []
        next_wid = max(self.workers) + 1
        # wid -> (roster slot, generation) for the shared-draws contract
        slot_of: Dict[int, Tuple[int, int]] = {
            w.wid: (idx, 0) for idx, w in enumerate(self.workers.values())}
        # resilience (docs/resilience.md): restore-retry stalls keyed on
        # (seed, traj, slot, gen) — through the shared draws when present
        # (parity with the batched/jit engines), else a local n=1 pool
        res = self.resilience
        n_slots = len(self._roster)
        if res is not None and res.restore_fail_p > 0.0:
            from repro_torch.resilience.policy import stall_pool
            _local_stalls: Dict[int, np.ndarray] = {}

            def restore_stall(slot: int, gen: int) -> float:
                if draws is not None:
                    return draws.restore_stall(res, traj, slot, gen)
                pool = _local_stalls.get(gen)
                if pool is None:
                    pool = _local_stalls[gen] = stall_pool(
                        res, self.seed, 1, n_slots, gen)
                return float(pool[0, slot])
        else:
            restore_stall = None

        def degr_factor() -> float:
            if res is None:
                return 1.0
            n_alive = sum(1 for w in self.workers.values() if w.alive)
            return res.degradation.speed_factor(n_alive, n_slots)
        # schedule revocations
        for idx, w in enumerate(self.workers.values()):
            lt = (float(initial_lifetimes[idx])
                  if initial_lifetimes is not None
                  else self.rev.lifetime(w.region, w.gpu,
                                         start_hour=start_hour))
            if math.isfinite(lt):
                heapq.heappush(q, FleetEvent(lt * 3600.0, "revoke",
                                             {"wid": w.wid}))
        if self.chaos is not None:
            # factor-change instants as no-op events: `advance` spans then
            # never cross a speed/PS/ckpt change, so its constant-speed
            # piecewise walk stays exact under faults
            for b in self.chaos.boundaries_s:
                if b < max_hours * 3600.0:
                    heapq.heappush(q, FleetEvent(float(b), "chaos"))
        t = 0.0
        steps = 0.0
        last_ckpt_step = 0
        ckpt_time = recompute = lost = 0.0
        paused_s = restore_s = 0.0
        stall_until = 0.0
        revocations = replacements = 0
        events: List[Tuple[float, str]] = []
        gpu_seconds: Dict[str, float] = {}

        def advance(to_t: float):
            """Advance wall-clock to `to_t`, producing steps at the current
            cluster speed with SEQUENTIAL checkpoint pauses (§IV-B) at every
            i_c boundary — exact piecewise simulation, no Zeno refinement."""
            nonlocal steps, t, ckpt_time, last_ckpt_step, paused_s, restore_s
            sp = self._cluster_speed(t)
            span = to_t - t
            for w in self.workers.values():
                if w.alive:
                    gpu_seconds[w.gpu] = gpu_seconds.get(w.gpu, 0.0) + span
            remaining = span
            blocked = (self.chaos is not None
                       and bool(self.chaos.ckpt_blocked(np.array([t]))[0]))
            if res is not None:
                # stall/pause gating: spans never cross a stall end (the
                # "resume" heap entry) or a membership event, so both
                # conditions are constant within this segment
                stalled = t < stall_until
                factor = degr_factor()
                if stalled:
                    restore_s += span
                elif factor == 0.0:
                    paused_s += span
                sp = 0.0 if stalled else sp * factor
            if sp > 0:
                if blocked:
                    # checkpoint-store outage: steps keep flowing but no
                    # save happens — no pause, and last_ckpt_step freezes
                    steps += sp * remaining
                    remaining = 0.0
                while remaining > 1e-12:
                    to_boundary = self.i_c - (steps % self.i_c)
                    if to_boundary <= 1e-9:
                        to_boundary = self.i_c
                    dt_needed = to_boundary / sp
                    if dt_needed <= remaining:
                        steps += to_boundary
                        remaining -= dt_needed
                        pause = min(self.t_c, remaining)
                        ckpt_time += pause
                        remaining -= pause
                        last_ckpt_step = int(round(steps))
                    else:
                        steps += sp * remaining
                        remaining = 0.0
            t = to_t

        def time_to_finish() -> float:
            """Wall-clock needed to reach total_steps from (steps, t),
            including future checkpoint pauses. Projects the *current*
            conditions forward — a pending chaos boundary is an event, so
            the projection is recomputed whenever conditions change."""
            sp = self._cluster_speed(t)
            if res is not None:
                sp = 0.0 if t < stall_until else sp * degr_factor()
            if sp <= 0:
                return float("inf")
            remaining_steps = total_steps - steps
            if (self.chaos is not None
                    and bool(self.chaos.ckpt_blocked(np.array([t]))[0])):
                return remaining_steps / sp
            n_ckpts = int(total_steps // self.i_c) - int(steps // self.i_c)
            return remaining_steps / sp + n_ckpts * self.t_c

        while steps < total_steps - 1e-6 and t < max_hours * 3600.0:
            sp = self._cluster_speed(t)
            if res is not None:
                sp = 0.0 if t < stall_until else sp * degr_factor()
            if sp <= 0.0 and not q:
                break
            t_finish = t + time_to_finish()
            if q and q[0].t < t_finish:
                ev = heapq.heappop(q)
                advance(max(ev.t, t))
                if ev.kind == "revoke":
                    w = self.workers.get(ev.payload["wid"])
                    if w is None or not w.alive:
                        continue
                    w.alive = False
                    revocations += 1
                    events.append((t, f"revoke w{w.wid} ({w.gpu})"))
                    if w.is_chief:
                        if self.handover:
                            # lease handover: another worker checkpoints
                            for o in self.workers.values():
                                if o.alive:
                                    o.is_chief = True
                                    break
                            events.append((t, "chief handover (no recompute)"))
                        elif (self.provider.graceful_checkpoint_on_warning
                                and self.provider.warning_seconds >= self.t_c):
                            # the market's revocation notice is long enough
                            # for the chief to flush a checkpoint before
                            # dying: nothing to recompute even without
                            # lease handover. The write overlaps the notice
                            # window (wall-clock already counted), so it
                            # does NOT accrue checkpoint pause time.
                            last_ckpt_step = int(round(steps))
                            events.append(
                                (t, "warning checkpoint (no recompute)"))
                        else:
                            # stock behavior: recompute from last checkpoint
                            lost_now = steps - last_ckpt_step
                            steps = float(last_ckpt_step)
                            lost += lost_now
                            # raw cluster speed on purpose: recompute runs
                            # once the fleet recovers, so the quorum gate
                            # does not inflate its conversion
                            rec = lost_now / max(self._cluster_speed(t), 1e-9)
                            recompute += rec
                            events.append(
                                (t, f"chief lost: recompute {lost_now:.0f} steps"))
                            if restore_stall is not None:
                                # restore-retry stall, keyed on the revoked
                                # occupant's generation (before the
                                # replacement bumps it); a later stall
                                # overwrites an active one
                                r_slot, r_gen = slot_of[w.wid]
                                delay = restore_stall(r_slot, r_gen)
                                stall_until = t + delay
                                if delay > 0.0:
                                    heapq.heappush(q, FleetEvent(
                                        stall_until, "resume"))
                                    events.append(
                                        (t, f"restore retries: stall "
                                            f"{delay:.1f}s"))
                    if self.replace:
                        slot, gen = slot_of[w.wid]
                        if draws is not None:
                            delay = draws.replacement_delay(
                                traj, slot, gen + 1)
                        else:
                            su = self.startup.sample(w.gpu,
                                                     after_revocation=True)
                            delay = su["total"] + self.repl.sample(
                                self.model_gflops, cold=True)
                        ready = t + delay
                        # stock mode (Fig 11): the replacement inherits the
                        # revoked chief's identity, so later chief
                        # revocations keep costing recompute; with handover
                        # a survivor was already promoted above
                        heapq.heappush(q, FleetEvent(
                            ready, "join",
                            {"gpu": w.gpu, "region": w.region,
                             "speed": w.speed, "slot": slot, "gen": gen + 1,
                             "chief": w.is_chief and not self.handover}))
                elif ev.kind == "chaos":
                    # factor-change boundary: advancing to it was the work
                    events.append((t, "chaos boundary"))
                elif ev.kind == "resume":
                    # restore-retry stall end: advancing to it was the work
                    events.append((t, "restore retries complete"))
                elif ev.kind == "join":
                    w = SimWorker(next_wid, ev.payload["gpu"],
                                  ev.payload["region"], ev.payload["speed"],
                                  is_chief=ev.payload.get("chief", False),
                                  slot=ev.payload.get("slot", -1))
                    next_wid += 1
                    self.workers[w.wid] = w
                    slot_of[w.wid] = (ev.payload.get("slot", -1),
                                      ev.payload.get("gen", 0))
                    replacements += 1
                    events.append((t, f"join w{w.wid} ({w.gpu})"))
                    if draws is not None:
                        slot, gen = slot_of[w.wid]
                        lt = draws.join_lifetime(
                            traj, slot, gen, start_hour + t / 3600.0)
                    else:
                        lt = self.rev.lifetime(
                            w.region, w.gpu,
                            start_hour=start_hour + t / 3600.0)
                    if math.isfinite(lt):
                        heapq.heappush(q, FleetEvent(
                            t + lt * 3600.0, "revoke", {"wid": w.wid}))
            else:
                advance(t_finish)

        cost = sum(secs / 3600.0 * self.price_of.get(g, 0.0)
                   for g, secs in gpu_seconds.items())
        regions = {w.region for w in self.workers.values()}
        # steps accumulates float increments, so a completed run can sit
        # an ulp below total_steps — the same epsilon the batched engine
        # applies keeps steps_done (and SimStats.finished) truthful
        return SimResult(t, int(steps + 1e-6), revocations, replacements,
                         ckpt_time, recompute, lost, events, cost,
                         provider=self.provider.name,
                         region=regions.pop() if len(regions) == 1 else "",
                         paused_s=paused_s, restore_delay_s=restore_s)

    def run_many(self, total_steps: int, n: int, max_hours: float = 48.0,
                 start_hour: float = 0.0, *,
                 engine: str = "batched",
                 device: object = None) -> FleetEnsemble:
        """Simulate `n` independent trajectories of the same launch.

        All randomness comes from one `fleet_batched.FleetDraws`: initial
        lifetimes are pre-drawn as a single (n, slots) matrix (one batched
        `RevocationSampler.lifetimes` call per (region, gpu) roster group,
        seeded with `self.seed` — the scheme this method has always used),
        and replacement-chain draws come from counter-based streams keyed
        on (seed, trajectory, slot, generation). Both engines therefore
        simulate the *same* trajectories:

        * ``engine="batched"`` (default) — the lockstep array engine
          (`fleet_batched.run_batched`): all trajectories advance
          simultaneously, next events found by vectorized min-reductions.
        * ``engine="event"`` — the per-trajectory discrete-event loop
          (`run`), kept as the parity oracle; identical
          revocation/replacement counts, times equal up to float
          association order.
        * ``engine="jit"`` — the device engine (`fleet_jit.run_jit`):
          the same lockstep rounds as torch float64 tensors on `device`
          (the CUDA card unless ``device="cpu"``; with no card and no
          explicit request it raises `NoCudaDevice`), draws
          pre-materialized, the next-event select a hand-written CUDA
          kernel. Same parity contract; requires a provider whose
          lifetime law has a device port (gcp/aws/azure). `device` is
          read by this engine only.

        `run(...)` with the same seed remains the single-trajectory path;
        `run_many` never perturbs its streams.
        """
        from repro_torch.core.transient.fleet_batched import (FleetDraws,
                                                              run_batched)
        if n < 1:
            raise ValueError(f"need at least one trajectory, got {n}")
        if engine not in ("batched", "event", "jit"):
            raise ValueError(f"unknown engine {engine!r}; "
                             f"known: ('batched', 'event', 'jit')")
        draws = FleetDraws(self, n, start_hour)
        if engine == "batched":
            results = run_batched(self, total_steps, n, max_hours,
                                  start_hour, draws=draws)
        elif engine == "jit":
            from repro_torch.core.transient.fleet_jit import run_jit
            results = run_jit(self, total_steps, n, max_hours,
                              start_hour, draws=draws, device=device)
        else:
            results = []
            for j in range(n):
                sim = self._respawn(self.seed + 1 + 4 * j)
                results.append(sim.run(total_steps, max_hours, start_hour,
                                       initial_lifetimes=draws.initial[j],
                                       draws=draws, traj=j))
        regions = {r.region for r in results}
        return FleetEnsemble(results,
                             SimStats.from_results(results, total_steps),
                             provider=self.provider.name,
                             region=regions.pop() if len(regions) == 1
                             else "")
