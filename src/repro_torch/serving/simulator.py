"""Revocation-tolerant serving-fleet simulator (docs/serving.md).

Models a continuous-batching inference fleet on revocable instances the
way `core.transient.fleet` models a training fleet: replicas decode in
fixed-cost *rounds* (one token per active request per round — the
continuous-batching cost model, where a decode iteration costs the same
whatever the occupancy up to the batch ceiling), requests wait in one
global `AdmissionQueue`, and the provider's `LifetimeLaw` decides when a
replica is revoked mid-flight.

Resilience semantics (armed = a `ResilienceConfig` is attached):

* **warned revocation** (AWS-style notice): the replica *drains* — it
  stops admitting at the notice and keeps decoding; whatever is still
  unfinished at the revocation hands over to survivors with its decode
  progress intact. Armed fleets drop zero in-flight requests on warned
  revocations — the serve_wave acceptance gate.
* **silent revocation** (GCP-style, stock frameworks ignore the notice):
  in-flight requests restart from scratch via requeue-with-retry — one
  `RetryPolicy.backoff` delay per attempt from keyed uniforms, dropped
  when attempts exhaust.
* **hedged re-dispatch**: a request in service past `hedge_timeout_s`
  (a straggling replica) is pulled back to the head of the queue and
  re-dispatched to a survivor.
* unarmed, every in-flight request on a revoked replica is dropped —
  warned or not.

Two engines, one trajectory core: ``engine="event"`` drives each
trajectory with a lazy-invalidation heap; ``engine="batched"`` recomputes
the candidate set as NumPy arrays and min-reduces. Both consume the same
keyed draws (`ReplicaSet` lifetimes, arrival/demand/priority streams,
retry jitter), so results agree within 1e-6 — the same parity contract
the training engines carry, enforced by the chaos runner's probe.

The port's copy of the JAX package's `serving/simulator.py` (it imports
nothing of it).
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.degradation import ServingDegradationPolicy
from repro_torch.serving.queue import AdmissionQueue
from repro_torch.serving.replica import ACTIVE, DOWN, Replica, ReplicaSet
from repro_torch.serving.requests import (COMPLETED, DROPPED, SHED,
                                          Request, RequestOutcome)

# keyed-stream tags (fixed forever; cf. chaos.injectors._TAG_INITIAL)
_TAG_ARRIVAL = 0x5E8A1
_TAG_DEMAND = 0x5E8A2
_TAG_PRIORITY = 0x5E8A3
_TAG_RETRY = 0x5E8A4

# event ranks — the (time, rank, idx) total order both engines share
_ROUND, _DRAIN, _DEATH, _JOIN, _ARRIVE, _REQUEUE, _HEDGE = range(7)


@dataclasses.dataclass(frozen=True)
class ServingWorkload:
    """One open-loop request stream: Poisson arrivals at
    `arrival_rate_per_s`, uniform token demands on
    [min_tokens, max_tokens], `high_priority_frac` of requests in
    priority class 0 (the rest class 1 — shed first under degradation)."""
    n_requests: int = 200
    arrival_rate_per_s: float = 2.0
    prompt_tokens: int = 32
    min_tokens: int = 8
    max_tokens: int = 32
    high_priority_frac: float = 0.25
    queue_capacity: int = 64
    queue_budget_s: float = 30.0
    hedge_timeout_s: float = 0.0           # 0 = hedging off


@dataclasses.dataclass(frozen=True)
class ServingScript:
    """A scenario's serving fleet, attached as `Scenario.serving`."""
    replicas: int = 4
    batch_ceiling: int = 8
    token_time_s: float = 0.05             # decode-round seconds at speed 1
    horizon_s: float = 3600.0
    workload: ServingWorkload = ServingWorkload()
    policy: ServingDegradationPolicy = ServingDegradationPolicy()


@dataclasses.dataclass
class ServingSimResult:
    """One trajectory's scorecard."""
    traj: int
    completed: int = 0
    shed_queue_full: int = 0
    shed_budget: int = 0
    shed_degraded: int = 0
    shed_horizon: int = 0
    dropped_inflight: int = 0
    dropped_warned: int = 0                # in-flight lost to WARNED revs
    handovers: int = 0
    requeues: int = 0
    hedges: int = 0
    revocations: int = 0
    warned_revocations: int = 0
    replacements: int = 0
    degraded_events: List[dict] = dataclasses.field(default_factory=list)
    recovery_cycles: int = 0               # degraded -> full transitions
    tokens_served: int = 0
    cost: float = 0.0
    total_time_s: float = 0.0
    latencies_s: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0))

    @property
    def shed(self) -> int:
        return (self.shed_queue_full + self.shed_budget
                + self.shed_degraded + self.shed_horizon)

    def latency_percentile(self, q: float) -> float:
        if self.latencies_s.size == 0:
            return math.inf
        return float(np.percentile(self.latencies_s, q))


def summarize_serving(results: List[ServingSimResult]) -> Dict[str, float]:
    """Ensemble means + pooled latency percentiles (JSON-serializable)."""
    lat = np.concatenate([r.latencies_s for r in results]) \
        if results else np.empty(0)
    mean = lambda f: round(float(np.mean([f(r) for r in results])), 6)
    return {
        "samples": len(results),
        "completed_mean": mean(lambda r: r.completed),
        "shed_mean": mean(lambda r: r.shed),
        "shed_degraded_mean": mean(lambda r: r.shed_degraded),
        "dropped_inflight_mean": mean(lambda r: r.dropped_inflight),
        "dropped_warned_total": int(sum(r.dropped_warned for r in results)),
        "handovers_mean": mean(lambda r: r.handovers),
        "requeues_mean": mean(lambda r: r.requeues),
        "hedges_mean": mean(lambda r: r.hedges),
        "revocations_mean": mean(lambda r: r.revocations),
        "replacements_mean": mean(lambda r: r.replacements),
        "recovery_cycles_mean": mean(lambda r: r.recovery_cycles),
        "degraded_events_mean": mean(lambda r: len(r.degraded_events)),
        "tokens_served_mean": mean(lambda r: r.tokens_served),
        "cost_mean": mean(lambda r: r.cost),
        "latency_p50_s": (round(float(np.percentile(lat, 50)), 6)
                          if lat.size else None),
        "latency_p99_s": (round(float(np.percentile(lat, 99)), 6)
                          if lat.size else None),
    }


class ServingDraws:
    """Keyed per-trajectory workload streams — identical on any engine."""

    def __init__(self, seed: int, workload: ServingWorkload, traj: int):
        self.seed = int(seed) % (2 ** 32)
        self.traj = int(traj)
        wl = workload
        n = wl.n_requests

        def stream(tag):
            return np.random.default_rng(
                np.random.SeedSequence((self.seed, tag, self.traj)))

        inter = (-np.log1p(-stream(_TAG_ARRIVAL).random(n))
                 / max(wl.arrival_rate_per_s, 1e-12))
        self.arrival_s = np.cumsum(inter)
        span = wl.max_tokens - wl.min_tokens + 1
        self.demand = (wl.min_tokens
                       + np.floor(stream(_TAG_DEMAND).random(n)
                                  * span).astype(int).clip(0, span - 1))
        self.priority = np.where(
            stream(_TAG_PRIORITY).random(n) < wl.high_priority_frac, 0, 1)

    def retry_u(self, rid: int, attempt: int) -> float:
        """Backoff-jitter uniform keyed per (traj, request, attempt)."""
        return float(np.random.default_rng(np.random.SeedSequence(
            (self.seed, _TAG_RETRY, self.traj, int(rid),
             int(attempt)))).random())


class _Entry:
    """One in-service request on a replica."""
    __slots__ = ("rid", "left", "hedge_s")

    def __init__(self, rid: int, left: int, hedge_s: float):
        self.rid, self.left, self.hedge_s = rid, left, hedge_s


class _Trajectory:
    """One trajectory's full state + event handlers. The two engine
    drivers differ ONLY in how they pick the next (time, rank, idx)."""

    def __init__(self, sim: "ServingFleetSim", traj: int,
                 lifetimes_h: np.ndarray):
        self.sim = sim
        self.traj = traj
        wl = sim.workload
        self.draws = ServingDraws(sim.seed, wl, traj)
        self.warned = sim.rset.warning_s > 0
        self.replicas = sim.rset.fresh(traj, lifetimes_h,
                                       warned=sim.armed and self.warned)
        n = sim.rset.n
        self.queue = AdmissionQueue(wl.queue_capacity, wl.queue_budget_s)
        self.active: List[List[_Entry]] = [[] for _ in range(n)]
        self.boarding: List[List[_Entry]] = [[] for _ in range(n)]
        self.round_end = [math.inf] * n
        self.entry_of: Dict[int, Tuple[_Entry, int]] = {}
        self.requests: Dict[int, Request] = {}
        self.served: Dict[int, int] = {}
        self.pending_requeue: Dict[int, float] = {}
        self.outcomes: Dict[int, RequestOutcome] = {}
        self.res = ServingSimResult(traj=traj)
        self.resolved = 0
        self.ai = 0
        self.tier = "full"
        self.spawned: List[Tuple[float, int, int]] = []
        # initial events
        if wl.n_requests:
            self.spawned.append((float(self.draws.arrival_s[0]), _ARRIVE, 0))
        for r in self.replicas:
            if math.isfinite(r.death_s):
                self.spawned.append((r.death_s, _DEATH, r.slot))
            if math.isfinite(r.drain_s):
                self.spawned.append((r.drain_s, _DRAIN, r.slot))

    # ------------------------------------------------------------ helpers
    def _speed(self, slot: int, t: float) -> float:
        tl = self.sim.rset.chaos
        if tl is None:
            return 1.0
        return float(tl.speed_mults(np.array([t]))[0, slot])

    def _round_time(self, slot: int, t: float) -> float:
        return self.sim.token_time_s / max(self._speed(slot, t), 1e-9)

    def _ceiling(self) -> int:
        return self.sim.policy.batch_ceiling(self.tier,
                                             self.sim.batch_ceiling)

    def _free(self, slot: int) -> int:
        return max(0, self._ceiling() - len(self.active[slot])
                   - len(self.boarding[slot]))

    def _finish(self, rid: int, status: str, t: float, reason: str = "",
                tokens: int = 0) -> None:
        req = self.requests[rid]
        self.outcomes[rid] = RequestOutcome(
            rid=rid, status=status, arrival_s=req.arrival_s, finished_s=t,
            priority=req.priority, tokens=tokens, reason=reason)
        self.resolved += 1

    def _sync_shed(self) -> None:
        """Move AdmissionQueue shed records into terminal outcomes."""
        while self.queue.shed:
            req, reason, t = self.queue.shed.pop(0)
            self._finish(req.rid, SHED, t, reason)
            if reason == "queue_full":
                self.res.shed_queue_full += 1
            else:
                self.res.shed_budget += 1

    def _retier(self, t: float) -> None:
        n_alive = sum(1 for r in self.replicas if r.status != DOWN)
        new = self.sim.policy.tier(n_alive, self.sim.rset.n)
        if new != self.tier:
            self.res.degraded_events.append(
                {"t_s": round(t, 6), "tier": new, "from": self.tier,
                 "alive": n_alive})
            if new == "full":
                self.res.recovery_cycles += 1
            self.tier = new

    # --------------------------------------------------------------- pump
    def _pump(self, t: float) -> None:
        """Dispatch queued requests onto admitting replicas (most free
        slots first; ties to the lowest slot). An idle replica starts a
        round immediately; a busy one boards the request for its next
        round boundary — token-level continuous batching."""
        self.queue.shed_expired(t)
        self._sync_shed()
        while len(self.queue):
            cands = [r for r in self.replicas
                     if r.can_admit() and self._free(r.slot) > 0]
            if not cands:
                break
            rep = max(cands, key=lambda r: (self._free(r.slot), -r.slot))
            req = self.queue.pop(t)
            self._sync_shed()
            if req is None:
                break
            if (self.sim.policy.sheds_low_priority(self.tier)
                    and req.priority > 0):
                self._finish(req.rid, SHED, t, "degraded")
                self.res.shed_degraded += 1
                continue
            cap = self.sim.policy.token_cap(self.tier, req.max_tokens)
            left = min(req.remaining, cap)
            hedge_s = (t + self.sim.workload.hedge_timeout_s
                       if self.sim.armed
                       and self.sim.workload.hedge_timeout_s > 0
                       else math.inf)
            e = _Entry(req.rid, left, hedge_s)
            self.entry_of[req.rid] = (e, rep.slot)
            if math.isfinite(hedge_s):
                self.spawned.append((hedge_s, _HEDGE, req.rid))
            if self.round_end[rep.slot] == math.inf:
                self.active[rep.slot].append(e)
                self.round_end[rep.slot] = t + self._round_time(rep.slot, t)
                self.spawned.append((self.round_end[rep.slot], _ROUND,
                                     rep.slot))
            else:
                self.boarding[rep.slot].append(e)

    # ------------------------------------------------------------ handlers
    def on_arrive(self, i: int, t: float) -> None:
        req = Request(rid=i, arrival_s=t,
                      prompt_tokens=self.sim.workload.prompt_tokens,
                      max_tokens=int(self.draws.demand[i]),
                      priority=int(self.draws.priority[i]))
        self.requests[i] = req
        self.served[i] = 0
        self.ai += 1
        if self.ai < self.sim.workload.n_requests:
            self.spawned.append((float(self.draws.arrival_s[self.ai]),
                                 _ARRIVE, self.ai))
        self.queue.offer(req, t)
        self._sync_shed()
        self._pump(t)

    def on_round(self, slot: int, t: float) -> None:
        still: List[_Entry] = []
        for e in self.active[slot]:
            e.left -= 1
            self.served[e.rid] += 1
            self.res.tokens_served += 1
            if e.left == 0:
                self.entry_of.pop(e.rid, None)
                req = self.requests[e.rid]
                req.remaining = 0
                self._finish(e.rid, COMPLETED, t, tokens=self.served[e.rid])
                self.res.completed += 1
            else:
                still.append(e)
        self.active[slot] = still + self.boarding[slot]
        self.boarding[slot] = []
        if self.active[slot]:
            self.round_end[slot] = t + self._round_time(slot, t)
            self.spawned.append((self.round_end[slot], _ROUND, slot))
        else:
            self.round_end[slot] = math.inf
        self._pump(t)

    def on_drain(self, slot: int, t: float) -> None:
        self.replicas[slot].start_drain()

    def on_death(self, slot: int, t: float) -> None:
        rep = self.replicas[slot]
        sim = self.sim
        inflight = self.active[slot] + self.boarding[slot]
        self.active[slot], self.boarding[slot] = [], []
        self.round_end[slot] = math.inf
        self.res.cost += max(0.0, t - rep.joined_s) / 3600.0 \
            * sim.rset.price_per_h
        self.res.revocations += 1
        if self.warned:
            self.res.warned_revocations += 1
        for e in inflight:
            self.entry_of.pop(e.rid, None)
            req = self.requests[e.rid]
            req.remaining = e.left
            if sim.armed and self.warned:
                # drain handover: survivors resume the remaining tokens
                self.res.handovers += 1
                self.queue.requeue_front(req, t)
            elif sim.armed:
                # silent revocation: restart from scratch after backoff
                req.attempts += 1
                if req.attempts <= sim.retry.max_attempts:
                    req.remaining = req.max_tokens
                    delay = sim.retry.backoff(
                        req.attempts, self.draws.retry_u(e.rid,
                                                         req.attempts))
                    ready = t + delay
                    self.pending_requeue[e.rid] = ready
                    self.spawned.append((ready, _REQUEUE, e.rid))
                    self.res.requeues += 1
                else:
                    self._finish(e.rid, DROPPED, t, "retries_exhausted")
                    self.res.dropped_inflight += 1
            else:
                self._finish(e.rid, DROPPED, t, "revoked")
                self.res.dropped_inflight += 1
                if self.warned:
                    self.res.dropped_warned += 1
        rep.kill(t, sim.rset.startup_s)
        self.spawned.append((rep.rejoin_s, _JOIN, slot))
        self._retier(t)
        self._pump(t)

    def on_join(self, slot: int, t: float) -> None:
        rep = self.replicas[slot]
        sim = self.sim
        lt_h = sim.rset.replacement_lifetime_h(self.traj, slot,
                                               rep.gen + 1, t / 3600.0)
        rep.rejoin(t, lt_h * 3600.0,
                   sim.rset.warning_s if sim.armed else 0.0)
        self.res.replacements += 1
        if math.isfinite(rep.death_s):
            self.spawned.append((rep.death_s, _DEATH, slot))
        if math.isfinite(rep.drain_s):
            self.spawned.append((rep.drain_s, _DRAIN, slot))
        self._retier(t)
        self._pump(t)

    def on_requeue(self, rid: int, t: float) -> None:
        del self.pending_requeue[rid]
        self.queue.offer(self.requests[rid], t)
        self._sync_shed()
        self._pump(t)

    def on_hedge(self, rid: int, t: float) -> None:
        e, slot = self.entry_of.pop(rid)
        for pool in (self.active, self.boarding):
            if e in pool[slot]:
                pool[slot].remove(e)
        if not self.active[slot] and not self.boarding[slot]:
            self.round_end[slot] = math.inf
        req = self.requests[rid]
        req.remaining = e.left
        self.res.hedges += 1
        self.queue.requeue_front(req, t)
        self._pump(t)

    _HANDLERS = {_ROUND: on_round, _DRAIN: on_drain, _DEATH: on_death,
                 _JOIN: on_join, _ARRIVE: on_arrive, _REQUEUE: on_requeue,
                 _HEDGE: on_hedge}

    def handle(self, rank: int, idx: int, t: float) -> None:
        self._HANDLERS[rank](self, idx, t)

    def valid(self, rank: int, idx: int, t: float) -> bool:
        """Lazy-invalidation test shared with the batched candidate set."""
        if rank == _ARRIVE:
            return True
        if rank == _ROUND:
            return (self.replicas[idx].status != DOWN
                    and self.round_end[idx] == t)
        if rank == _DRAIN:
            r = self.replicas[idx]
            return r.status == ACTIVE and not r.drained and r.drain_s == t
        if rank == _DEATH:
            r = self.replicas[idx]
            return r.status != DOWN and r.death_s == t
        if rank == _JOIN:
            r = self.replicas[idx]
            return r.status == DOWN and r.rejoin_s == t
        if rank == _REQUEUE:
            return self.pending_requeue.get(idx) == t
        if rank == _HEDGE:
            got = self.entry_of.get(idx)
            return got is not None and got[0].hedge_s == t
        return False

    # ----------------------------------------------------- batched driver
    def candidates(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All currently-valid (time, rank, idx) candidates as arrays —
        the batched engine min-reduces these instead of keeping a heap."""
        ts: List[float] = []
        rk: List[int] = []
        ix: List[int] = []

        def add(t, rank, idx):
            if math.isfinite(t):
                ts.append(t)
                rk.append(rank)
                ix.append(idx)

        if self.ai < self.sim.workload.n_requests:
            add(float(self.draws.arrival_s[self.ai]), _ARRIVE, self.ai)
        for r in self.replicas:
            if r.status == DOWN:
                add(r.rejoin_s, _JOIN, r.slot)
            else:
                add(r.death_s, _DEATH, r.slot)
                add(self.round_end[r.slot], _ROUND, r.slot)
                if r.status == ACTIVE and not r.drained:
                    add(r.drain_s, _DRAIN, r.slot)
        for rid, ready in self.pending_requeue.items():
            add(ready, _REQUEUE, rid)
        for rid, (e, _slot) in self.entry_of.items():
            add(e.hedge_s, _HEDGE, rid)
        return np.asarray(ts), np.asarray(rk), np.asarray(ix)

    # ------------------------------------------------------------ wrap-up
    def finalize(self, t_end: float) -> ServingSimResult:
        self.queue.shed_expired(min(t_end, self.sim.horizon_s))
        self._sync_shed()
        for req in self.queue.drain():
            self._finish(req.rid, SHED, t_end, "horizon")
            self.res.shed_horizon += 1
        for rid in list(self.entry_of):
            self.entry_of.pop(rid)
            self._finish(rid, DROPPED, t_end, "horizon")
            self.res.dropped_inflight += 1
        for rid in list(self.pending_requeue):
            del self.pending_requeue[rid]
            self._finish(rid, DROPPED, t_end, "horizon")
            self.res.dropped_inflight += 1
        lat = [o.latency_s for o in self.outcomes.values()
               if o.status == COMPLETED]
        self.res.latencies_s = np.sort(np.asarray(lat, float))
        self.res.total_time_s = max(
            (o.finished_s for o in self.outcomes.values()), default=0.0)
        for r in self.replicas:
            if r.status != DOWN:
                self.res.cost += max(0.0, self.res.total_time_s
                                     - r.joined_s) / 3600.0 \
                    * self.sim.rset.price_per_h
        return self.res


class ServingFleetSim:
    """`run_many(n, engine=...)` over the trajectory core above."""

    def __init__(self, rset: ReplicaSet, workload: ServingWorkload,
                 *, policy: Optional[ServingDegradationPolicy] = None,
                 resilience=None, token_time_s: float = 0.05,
                 batch_ceiling: int = 8, horizon_s: float = 3600.0,
                 seed: int = 0):
        from repro_torch.resilience import RetryPolicy
        self.rset = rset
        self.workload = workload
        self.policy = policy or ServingDegradationPolicy()
        self.resilience = resilience
        self.armed = resilience is not None
        self.retry = (resilience.retry if resilience is not None
                      else RetryPolicy())
        self.token_time_s = float(token_time_s)
        self.batch_ceiling = int(batch_ceiling)
        self.horizon_s = float(horizon_s)
        self.seed = int(seed)

    # ------------------------------------------------------------- engines
    def _run_event(self, core: _Trajectory) -> ServingSimResult:
        heap: List[Tuple[float, int, int]] = []
        for ev in core.spawned:
            heapq.heappush(heap, ev)
        core.spawned.clear()
        t = 0.0
        n = self.workload.n_requests
        while heap and core.resolved < n:
            t_ev, rank, idx = heapq.heappop(heap)
            if t_ev > self.horizon_s:
                t = self.horizon_s
                break
            if not core.valid(rank, idx, t_ev):
                continue
            t = t_ev
            core.handle(rank, idx, t)
            for ev in core.spawned:
                if math.isfinite(ev[0]):
                    heapq.heappush(heap, ev)
            core.spawned.clear()
        return core.finalize(min(t, self.horizon_s))

    def _run_batched(self, core: _Trajectory) -> ServingSimResult:
        t = 0.0
        n = self.workload.n_requests
        while core.resolved < n:
            core.spawned.clear()
            ts, rk, ix = core.candidates()
            if ts.size == 0:
                break
            # min over (time, rank, idx) — identical to the heap's order
            k = int(np.lexsort((ix, rk, ts))[0])
            if ts[k] > self.horizon_s:
                t = self.horizon_s
                break
            t = float(ts[k])
            core.handle(int(rk[k]), int(ix[k]), t)
        return core.finalize(min(t, self.horizon_s))

    # ---------------------------------------------------------------- API
    def run_many(self, samples: int = 8,
                 engine: str = "batched") -> List[ServingSimResult]:
        if engine not in ("batched", "event"):
            raise ValueError(f"unknown serving engine {engine!r}; "
                             "known: ('batched', 'event')")
        init = self.rset.initial_lifetimes_h(samples)
        out = []
        for traj in range(samples):
            core = _Trajectory(self, traj, init[traj])
            out.append(self._run_event(core) if engine == "event"
                       else self._run_batched(core))
        return out

    def run(self, traj: int = 0, engine: str = "batched",
            samples: int = 1) -> ServingSimResult:
        """Single trajectory (drawn from a `samples`-wide initial matrix
        so results match the same index of `run_many(samples)`)."""
        init = self.rset.initial_lifetimes_h(max(samples, traj + 1))
        core = _Trajectory(self, traj, init[traj])
        return (self._run_event(core) if engine == "event"
                else self._run_batched(core))
