"""Lockstep batched fleet engine — all N trajectories as one array program.

`FleetSim.run` walks one trajectory through a Python discrete-event loop
(heapq + per-interval stepping); fine for a single §VI-A validation run,
but ensembles and the sim-backed planner want 10k+ trajectories per call.
This module advances the whole ensemble simultaneously: per-trajectory
state lives in `(n,)` arrays, per-worker state in `(n, slots)` arrays, and
each lockstep round advances every live trajectory to its own next event
(a vectorized min-reduction over scheduled revocations/joins and the
Eq (4)-style time-to-finish) and applies at most one event per trajectory
with masked array ops. docs/DESIGN.md §2 documents the state layout and
the parity contract with the event engine.

Randomness is shared with the event engine through `FleetDraws`:

* initial lifetimes are pre-drawn as ONE `(n, slots)` matrix (one batched
  `RevocationSampler.lifetimes` call per (region, gpu) roster group — the
  exact scheme `run_many` has used since the vectorized-MC PR);
* every replacement-chain draw (startup stages after a revocation, the
  cold start, the replacement's own lifetime at its realized join hour)
  comes from a counter-based stream keyed by (seed, trajectory, slot,
  generation), so both engines consume identical values no matter in
  which order they reach each event.

That makes `run_many(engine="batched")` and `run_many(engine="event")`
trajectory-for-trajectory comparable: identical revocation/replacement
counts, and times/costs equal up to float association order (the batched
stepper uses a closed form for the checkpoint-pause walk the event loop
does incrementally). tests/test_fleet_batched.py pins both properties.

The port's copy of the JAX package's `core/transient/fleet_batched.py`
(it imports nothing of it). Its draws equal the reference's bit for bit
(tests/test_torch_fleet.py); it is the yardstick the device engine
(`fleet_jit`) is held against.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

import numpy as np

from repro_torch.core.perf_model.cluster_model import PSBottleneckModel
from repro_torch.core.transient.revocation import RevocationSampler
from repro_torch.core.transient.startup import POST_REVOCATION_COV

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.transient.fleet import FleetSim, SimResult


class FleetDraws:
    """Deterministic random draws shared by both fleet engines.

    One instance covers one `run_many` call:

    * `initial` — the pre-drawn `(n, slots)` initial-lifetime matrix
      (hours, np.inf = survived), one batched
      `RevocationSampler.lifetimes` call per (region, gpu) roster group.
    * replacement chains — per *generation level* g (the g-th
      replacement a slot has seen), one pre-drawn pool: an `(n, slots)`
      matrix of join delays (post-revocation §V-B startup + Fig 10 cold
      start, drawn in one vectorized call) and an `(n, slots, K)` block
      of uniforms the lifetime law turns into the replacement's lifetime
      at its realized join hour (`LifetimeLaw.sample_from_uniforms`).
      Pools are keyed on (seed, level) and drawn lazily, so both engines
      read identical values no matter in which order they reach each
      event. Laws without a uniform-block sampler fall back to one
      counter-based stream per (trajectory, slot, generation).
    """

    def __init__(self, sim: "FleetSim", n: int, start_hour: float):
        self.seed = int(sim.seed)
        self.provider = sim.provider
        self.model_gflops = sim.model_gflops
        self.start_hour = float(start_hour)
        # the sim's chaos timeline (hazard faults transform every lifetime
        # this object hands out — both engines therefore share identical
        # post-fault revocation timelines by construction)
        self.chaos = getattr(sim, "chaos", None)
        roster = sim._roster
        self.n = n
        self.n_slots = len(roster)
        groups = {}
        for idx, (_, gpu, region, _) in enumerate(roster):
            groups.setdefault((region, gpu), []).append(idx)
        samp = RevocationSampler(self.seed, self.provider)
        pre = np.empty((n, len(roster)))
        for (region, gpu), idxs in groups.items():
            draws = samp.lifetimes(region, gpu, n * len(idxs), start_hour)
            pre[:, idxs] = draws.reshape(n, len(idxs))
        if self.chaos is not None:
            pre = self.chaos.transform_initial(pre)
        self.initial = pre
        # per-slot laws and delay moments, resolved once
        self._laws = [self.provider.lifetime_model(region, gpu)
                      for _, gpu, region, _ in roster]
        anchors = self.provider.replacement_anchors()
        cold = anchors.cold_start_s(self.model_gflops)
        self._delay_means = np.array(
            [list(self.provider.startup_stages(gpu).means(True)) + [cold]
             for _, gpu, _, _ in roster])                       # (S, 4)
        self._delay_sds = self._delay_means * POST_REVOCATION_COV
        self._delay_sds[:, 3] = 0.05 * self._delay_means[:, 3]
        # laws without a uniform-block sampler draw from per-key fallback
        # streams, so their pool contribution is a single placeholder
        # column, not the default 33
        self._K = max([getattr(law, "SAMPLE_UNIFORMS_K", 33)
                       if getattr(law, "sample_from_uniforms", None)
                       is not None else 1
                       for law in self._laws], default=1)
        self._levels = {}
        # restore-retry stall pools (repro_torch.resilience): keyed like the
        # replacement levels, shared by all three engines
        self._stall_levels = {}

    def _level(self, gen: int):
        """The pre-drawn pool of generation level `gen` (lazy, keyed on
        (seed, gen) — identical whenever and from whichever engine it is
        first requested)."""
        pool = self._levels.get(gen)
        if pool is None:
            rng = np.random.default_rng(np.random.SeedSequence(
                (self.seed % (2 ** 32), 0x6A01, gen)))
            stages = rng.normal(self._delay_means, self._delay_sds,
                                size=(self.n, self.n_slots, 4))
            delays = np.maximum(1.0, stages).sum(axis=-1)
            uniforms = rng.random((self.n, self.n_slots, self._K))
            pool = self._levels[gen] = (delays, uniforms)
        return pool

    def _fallback_rng(self, traj: int, slot: int,
                      gen: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence(
            (self.seed % (2 ** 32), int(traj), int(slot), int(gen))))

    def replacement_delay(self, traj: int, slot: int, gen: int) -> float:
        """Seconds from a revocation to the replacement's join: the §V-B
        post-revocation startup (4x CoV) plus the Fig 10 cold start —
        the same laws `StartupModel.sample(after_revocation=True)` and
        `ReplacementModel.sample(cold=True)` draw from. The draw is fully
        determined by the slot (a replacement inherits its slot's gpu)."""
        return float(self._level(gen)[0][traj, slot])

    def _raw_join_lifetime(self, traj: int, slot: int, gen: int,
                           start_hour_abs: float) -> float:
        law = self._laws[slot]
        if getattr(law, "sample_from_uniforms", None) is None:
            return float(law.sample(self._fallback_rng(traj, slot, gen),
                                    1, start_hour_abs)[0])
        U = self._level(gen)[1][traj, slot][None, :]
        return float(law.sample_from_uniforms(
            U, np.array([start_hour_abs]))[0])

    def join_lifetime(self, traj: int, slot: int, gen: int,
                      start_hour_abs: float) -> float:
        """The replacement's own lifetime (hours; np.inf = survived),
        drawn at its realized local join hour so diurnal laws see it —
        from the slot's own (region, gpu) lifetime law. Chaos hazard
        faults (keyed on (seed, fault, traj, slot, gen)) then thin it."""
        lt = self._raw_join_lifetime(traj, slot, gen, start_hour_abs)
        if self.chaos is not None:
            lt = float(self.chaos.transform_joins(
                np.array([lt]), np.array([traj]), np.array([slot]),
                np.array([gen]),
                np.array([start_hour_abs - self.start_hour]))[0])
        return lt

    def restore_stall_level(self, res, gen: int) -> np.ndarray:
        """The `(n, slots)` restore-retry stall matrix (seconds) for
        generation level `gen` — the keyed-deterministic delay a
        stock-chief trajectory spends retrying its checkpoint reload
        after the slot's generation-`gen` occupant is revoked (lazy,
        keyed on (seed + resilience seed, gen); identical whichever
        engine asks first)."""
        pool = self._stall_levels.get(gen)
        if pool is None:
            from repro_torch.resilience.policy import stall_pool
            pool = self._stall_levels[gen] = stall_pool(
                res, self.seed, self.n, self.n_slots, gen)
        return pool

    def restore_stall(self, res, traj: int, slot: int, gen: int) -> float:
        return float(self.restore_stall_level(res, gen)[traj, slot])

    def restore_stalls_batch(self, res, trajs: np.ndarray,
                             slots: np.ndarray,
                             gens: np.ndarray) -> np.ndarray:
        """Vectorized `restore_stall` over one lockstep round's
        stock-chief revocations, grouped by generation level."""
        out = np.empty(len(trajs))
        for g in np.unique(gens):
            rows = gens == g
            out[rows] = self.restore_stall_level(res, int(g))[trajs[rows],
                                                              slots[rows]]
        return out

    def replacement_delays_batch(self, trajs: np.ndarray, slots: np.ndarray,
                                 gens: np.ndarray) -> np.ndarray:
        """Vectorized `replacement_delay` over one lockstep round's
        revocations, grouped by generation level."""
        out = np.empty(len(trajs))
        for g in np.unique(gens):
            rows = gens == g
            out[rows] = self._level(int(g))[0][trajs[rows], slots[rows]]
        return out

    def join_lifetimes_batch(self, trajs: np.ndarray, slots: np.ndarray,
                             gens: np.ndarray,
                             hours: np.ndarray) -> np.ndarray:
        """Vectorized `join_lifetime` over one lockstep round's joins,
        grouped by roster slot (= by lifetime law)."""
        out = np.empty(len(trajs))
        for s in np.unique(slots):
            rows = np.where(slots == s)[0]
            law = self._laws[s]
            if getattr(law, "sample_from_uniforms", None) is None:
                out[rows] = [self._raw_join_lifetime(int(i), int(s), int(g),
                                                     float(h))
                             for i, g, h in zip(trajs[rows], gens[rows],
                                                hours[rows])]
                continue
            gg = gens[rows]
            U = np.empty((rows.size, self._K))
            for g in np.unique(gg):
                sub = gg == g
                U[sub] = self._level(int(g))[1][trajs[rows[sub]], s]
            out[rows] = law.sample_from_uniforms(U, hours[rows])
        if self.chaos is not None:
            out = self.chaos.transform_joins(
                out, trajs, slots, gens,
                np.asarray(hours, float) - self.start_hour)
        return out


@dataclasses.dataclass
class _State:
    """The lockstep ensemble state: `(n,)` per-trajectory arrays plus
    `(n, slots)` per-worker-slot arrays. A *slot* is one launch-roster
    position; a revoked slot whose replacement is pending has
    `alive=False` and a finite `join_t`, and the joined worker inherits
    the slot's (gpu, region, speed) with `gen` bumped — exactly the
    identity chain the event engine's wid dict builds one object at a
    time."""
    t: np.ndarray              # (n,) sim clock, seconds
    steps: np.ndarray          # (n,) fractional steps done
    last_ckpt: np.ndarray      # (n,) last checkpointed step
    ckpt_time: np.ndarray      # (n,) cumulative checkpoint pause, s
    recompute: np.ndarray      # (n,) cumulative recompute accounting, s
    lost: np.ndarray           # (n,) steps rolled back (stock chief loss)
    revocations: np.ndarray    # (n,) int
    replacements: np.ndarray   # (n,) int
    alive: np.ndarray          # (n, S) bool
    chief: np.ndarray          # (n, S) bool
    gen: np.ndarray            # (n, S) int: generation occupying the slot
    order_key: np.ndarray      # (n, S) dict-insertion rank (chief promotion)
    next_key: np.ndarray       # (n,) next insertion rank to hand out
    revoke_t: np.ndarray       # (n, S) absolute revocation time, s (inf=none)
    join_t: np.ndarray         # (n, S) absolute pending-join time, s (inf=none)
    alive_seconds: np.ndarray  # (n, S) cost integrator: alive wall-clock
    done: np.ndarray           # (n,) bool
    stall_t: np.ndarray        # (n,) restore-retry stall end, s (<=t: none)
    paused: np.ndarray         # (n,) quorum-pause seconds accrued
    restore_s: np.ndarray      # (n,) restore-retry stall seconds accrued


def run_batched(sim: "FleetSim", total_steps: int, n: int,
                max_hours: float = 48.0, start_hour: float = 0.0,
                draws: Optional[FleetDraws] = None, raw: bool = False):
    """Advance `n` trajectories of `sim`'s launch roster in lockstep.

    Returns one `SimResult` per trajectory (in trajectory order). The
    per-event text log is not materialized (`events=[]`) — it is the one
    `SimResult` field that cannot be array-typed; everything else matches
    the event engine under the shared-`draws` contract. `raw=True`
    returns the same stats as a dict of per-trajectory arrays instead of
    `SimResult` objects — the engine-core form `bench_jit_engine` times
    (building n dataclasses costs more than a 65k-trajectory ensemble
    run) and array consumers aggregate directly.
    """
    from repro_torch.core.transient.fleet import SimResult

    if n < 1:
        raise ValueError(f"need at least one trajectory, got {n}")
    if draws is None:
        draws = FleetDraws(sim, n, start_hour)
    roster = sim._roster
    S = len(roster)
    slot_gpu = [gpu for _, gpu, _, _ in roster]
    slot_region = [region for _, _, region, _ in roster]
    slot_speed = np.array([speed for _, _, _, speed in roster], float)
    cap = PSBottleneckModel(sim.model_bytes, sim.n_ps,
                            n_tensors=sim.n_tensors,
                            compression=sim.grad_compression
                            ).capacity_steps_per_s()
    i_c, t_c = float(sim.i_c), float(sim.t_c)
    total = float(total_steps)
    tmax = max_hours * 3600.0
    chaos = getattr(sim, "chaos", None)
    handover, replace = sim.handover, sim.replace
    graceful = (sim.provider.graceful_checkpoint_on_warning
                and sim.provider.warning_seconds >= sim.t_c)
    # resilience (docs/resilience.md): quorum degradation gates effective
    # speed on the alive fraction; stock-chief restores stall for the
    # keyed retry schedule. res_on=False keeps every array op untouched.
    res = getattr(sim, "resilience", None)
    res_on = res is not None
    stall_on = res_on and res.restore_fail_p > 0.0
    if res_on:
        quorum = float(res.degradation.quorum)
        shrink_below = float(res.degradation.shrink_below)
        shrink_factor = float(res.degradation.shrink_factor)

    st = _State(
        t=np.zeros(n), steps=np.zeros(n), last_ckpt=np.zeros(n),
        ckpt_time=np.zeros(n), recompute=np.zeros(n), lost=np.zeros(n),
        revocations=np.zeros(n, int), replacements=np.zeros(n, int),
        alive=np.ones((n, S), bool), chief=np.zeros((n, S), bool),
        gen=np.zeros((n, S), int),
        order_key=np.tile(np.arange(S, dtype=float), (n, 1)),
        next_key=np.full(n, float(S)),
        revoke_t=np.where(np.isfinite(draws.initial),
                          draws.initial * 3600.0, np.inf),
        join_t=np.full((n, S), np.inf),
        alive_seconds=np.zeros((n, S)),
        done=np.zeros(n, bool),
        stall_t=np.zeros(n), paused=np.zeros(n), restore_s=np.zeros(n))
    st.chief[:, 0] = True   # FleetSim.__init__ marks workers[0] chief

    def _cluster_speed(rows: np.ndarray) -> np.ndarray:
        if chaos is None:
            return np.minimum(st.alive[rows] @ slot_speed, cap)
        # chaos factors at the segment start: straggler multipliers per
        # slot plus the PS capacity factor (constant within any advanced
        # span — factor boundaries are lockstep events)
        m = chaos.speed_mults(st.t[rows])
        return np.minimum((st.alive[rows] * m) @ slot_speed,
                          cap * chaos.ps_factor(st.t[rows]))

    def _degr_factor(rows: np.ndarray) -> np.ndarray:
        """Quorum-tier speed factor per row: pause (0) below `quorum`
        alive fraction, `shrink_factor` below `shrink_below`, else 1.
        The factor gates forward progress only — the stock-chief
        recompute conversion stays at raw cluster speed (recompute
        happens after the fleet recovers)."""
        frac = st.alive[rows].sum(axis=1) / S
        return np.where(frac < quorum, 0.0,
                        np.where(frac < shrink_below, shrink_factor, 1.0))

    def _advance(rows: np.ndarray, target: np.ndarray) -> None:
        """Closed form of the event engine's `advance`: walk `rows` from
        their clocks to `target`, producing steps at cluster speed with a
        sequential `t_c` pause at every `i_c` boundary. k boundaries fit
        in a span: the first at `b0/sp`, each further one a full
        `i_c/sp + t_c` cycle later; only the final pause can be partial."""
        span = target - st.t[rows]
        a = st.alive[rows]
        st.alive_seconds[rows] += a * span[:, None]
        if chaos is None:
            sp = np.minimum(a @ slot_speed, cap)
            blk = np.zeros(rows.size, bool)
        else:
            m = chaos.speed_mults(st.t[rows])
            sp = np.minimum((a * m) @ slot_speed,
                            cap * chaos.ps_factor(st.t[rows]))
            blk = chaos.ckpt_blocked(st.t[rows])
        if res_on:
            # stall/pause gating (the event engine's `advance` mirror):
            # spans never cross a stall end or a membership event, so
            # both conditions are constant within this segment
            stalled = st.t[rows] < st.stall_t[rows]
            factor = _degr_factor(rows)
            st.restore_s[rows] += np.where(stalled, span, 0.0)
            st.paused[rows] += np.where(~stalled & (factor == 0.0),
                                        span, 0.0)
            sp = np.where(stalled, 0.0, sp * factor)
        pos = (sp > 0) & (span > 1e-12)
        if pos.any():
            spp = np.where(pos, sp, 1.0)
            s0 = st.steps[rows]
            b0 = i_c - s0 % i_c
            b0 = np.where(b0 <= 1e-9, i_c, b0)
            d0 = b0 / spp
            cycle = i_c / spp + t_c
            k = np.where(span >= d0,
                         np.floor((span - d0) / cycle) + 1.0, 0.0)
            r = span - d0 - (k - 1.0) * cycle
            pause = np.minimum(t_c, r)
            boundary = s0 + b0 + (k - 1.0) * i_c
            stepped = np.where(
                k > 0, boundary + spp * np.maximum(0.0, r - pause),
                s0 + spp * span)
            new_ck = np.where(k > 0, (k - 1.0) * t_c + pause, 0.0)
            # checkpoint-store outage: steps keep flowing, nothing saves —
            # no pause, and last_ckpt freezes (the event engine's blocked
            # branch in `advance`)
            stepped = np.where(blk, s0 + spp * span, stepped)
            new_ck = np.where(blk, 0.0, new_ck)
            st.steps[rows] = np.where(pos, stepped, s0)
            st.ckpt_time[rows] += np.where(pos, new_ck, 0.0)
            st.last_ckpt[rows] = np.where(pos & (k > 0) & ~blk,
                                          np.round(boundary),
                                          st.last_ckpt[rows])
        st.t[rows] = target

    while True:
        act = ~st.done
        if not act.any():
            break
        rows = np.where(act)[0]
        ev_all = np.concatenate([st.revoke_t[rows], st.join_t[rows]], axis=1)
        ev_arg = np.argmin(ev_all, axis=1)
        ev_t = ev_all[np.arange(rows.size), ev_arg]
        sp = _cluster_speed(rows)
        if chaos is None:
            blk = np.zeros(rows.size, bool)
            nb = np.full(rows.size, np.inf)
        else:
            blk = chaos.ckpt_blocked(st.t[rows])
            # factor-change boundaries are (no-op) events, exactly like
            # the heap entries the event engine pushes — and like those,
            # boundaries at/after tmax are never scheduled
            nb = chaos.next_boundary(st.t[rows])
            nb = np.where(nb < tmax, nb, np.inf)
        if res_on:
            # a pending stall end is a pure-advancement boundary, exactly
            # like a chaos factor change (the event engine's no-op
            # "resume" heap entry); effective speed is gated meanwhile
            stall_ev = np.where(st.stall_t[rows] > st.t[rows],
                                st.stall_t[rows], np.inf)
            nb = np.minimum(nb, stall_ev)
            sp = np.where(np.isfinite(stall_ev), 0.0,
                          sp * _degr_factor(rows))
        with np.errstate(divide="ignore", invalid="ignore"):
            rel = np.where(
                sp > 0,
                (total - st.steps[rows]) / np.where(sp > 0, sp, 1.0)
                + np.where(blk, 0.0,
                           (np.floor(total / i_c)
                            - np.floor(st.steps[rows] / i_c)) * t_c),
                np.inf)
        t_fin = st.t[rows] + rel
        # the event loop's `sp <= 0 and not q: break` — all dead, nothing
        # scheduled (not even a chaos boundary that could revive the PS):
        # freeze the trajectory where it stands
        stuck = np.isinf(ev_t) & (sp <= 0) & np.isinf(nb)
        st.done[rows[stuck]] = True
        nxt = np.minimum(ev_t, nb)
        # matches `if q and q[0].t < t_finish` (strict)
        ev = ~stuck & (nxt < t_fin)
        fin = ~stuck & ~ev
        move = rows[ev | fin]
        target = np.where(ev, np.maximum(nxt, st.t[rows]), t_fin)[ev | fin]
        _advance(move, target)
        st.done[rows[fin]] = True   # steps reached total (modulo float fuzz)

        # a chaos boundary (nb < ev_t) is pure advancement — only worker
        # events mutate fleet state
        real = ev & (ev_t <= nxt)
        er = rows[real]
        if er.size:
            slot = ev_arg[real] % S
            is_join = ev_arg[real] >= S
            # ---------------------------------------------------- revokes
            ri, rs = er[~is_join], slot[~is_join]
            if ri.size:
                was_chief = st.chief[ri, rs]
                st.alive[ri, rs] = False
                st.revoke_t[ri, rs] = np.inf
                st.revocations[ri] += 1
                if handover:
                    hri, hrs = ri[was_chief], rs[was_chief]
                    if hri.size:
                        st.chief[hri, hrs] = False
                        # promote the first-inserted alive worker — the
                        # event engine's dict-order scan
                        keys = np.where(st.alive[hri], st.order_key[hri],
                                        np.inf)
                        best = np.argmin(keys, axis=1)
                        has = np.isfinite(
                            keys[np.arange(hri.size), best])
                        st.chief[hri[has], best[has]] = True
                elif graceful:
                    # the market's notice window covers T_c: flush a
                    # checkpoint at the current step, lose nothing
                    gri = ri[was_chief]
                    st.last_ckpt[gri] = np.round(st.steps[gri])
                else:
                    sri = ri[was_chief]
                    if sri.size:
                        lost_now = st.steps[sri] - st.last_ckpt[sri]
                        st.steps[sri] = st.last_ckpt[sri]
                        st.lost[sri] += lost_now
                        sp_after = _cluster_speed(sri)
                        st.recompute[sri] += (lost_now
                                              / np.maximum(sp_after, 1e-9))
                        if stall_on:
                            # restore-retry stall: the trajectory reloads
                            # its checkpoint under the retry schedule —
                            # keyed on the revoked occupant's generation,
                            # drawn BEFORE the replacement bumps it. A
                            # later stall overwrites an active one.
                            srs = rs[was_chief]
                            delay = draws.restore_stalls_batch(
                                res, sri, srs, st.gen[sri, srs])
                            st.stall_t[sri] = st.t[sri] + delay
                if replace:
                    new_gen = st.gen[ri, rs] + 1
                    delay = draws.replacement_delays_batch(ri, rs, new_gen)
                    st.join_t[ri, rs] = st.t[ri] + delay
                    st.gen[ri, rs] = new_gen
                    # stock mode: the replacement inherits the chief
                    # identity (st.chief[slot] is simply left set);
                    # handover already cleared it above
            # ------------------------------------------------------ joins
            ji, js = er[is_join], slot[is_join]
            if ji.size:
                st.alive[ji, js] = True
                st.join_t[ji, js] = np.inf
                st.replacements[ji] += 1
                st.order_key[ji, js] = st.next_key[ji]
                st.next_key[ji] += 1
                lts = draws.join_lifetimes_batch(
                    ji, js, st.gen[ji, js], start_hour + st.t[ji] / 3600.0)
                st.revoke_t[ji, js] = np.where(
                    np.isfinite(lts), st.t[ji] + lts * 3600.0, np.inf)
        st.done |= st.steps >= total - 1e-6
        st.done |= st.t >= tmax

    price = np.array([sim.price_of.get(g, 0.0) for g in slot_gpu])
    cost = (st.alive_seconds / 3600.0) @ price
    regions = set(slot_region)
    region = regions.pop() if len(regions) == 1 else ""
    if raw:
        return {"total_time_s": st.t,
                "steps_done": (st.steps + 1e-6).astype(np.int64),
                "revocations": st.revocations.astype(np.int64),
                "replacements": st.replacements.astype(np.int64),
                "checkpoint_time_s": st.ckpt_time,
                "recompute_time_s": st.recompute,
                "lost_steps": st.lost, "monetary_cost": cost,
                "paused_s": st.paused, "restore_delay_s": st.restore_s}
    return [SimResult(
        total_time_s=float(st.t[j]),
        steps_done=int(st.steps[j] + 1e-6),
        revocations=int(st.revocations[j]),
        replacements=int(st.replacements[j]),
        checkpoint_time_s=float(st.ckpt_time[j]),
        recompute_time_s=float(st.recompute[j]),
        lost_steps=float(st.lost[j]),
        events=[], monetary_cost=float(cost[j]),
        provider=sim.provider.name, region=region,
        paused_s=float(st.paused[j]),
        restore_delay_s=float(st.restore_s[j])) for j in range(n)]
