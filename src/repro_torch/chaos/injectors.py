"""Chaos fault primitives and the `FaultTimeline` the fleet engines consume.

The chaos subsystem (docs/DESIGN.md §7, docs/chaos.md) injects faults with
known ground truth into all three execution paths. This module owns the
*primitives* — each a frozen dataclass with a start, a duration and a
magnitude, all relative to launch (hours of elapsed sim time) — and the
`FaultTimeline` that compiles a list of them against one launch roster:

  * `PreemptionWave` / `PriceSpike` — *hazard* faults: extra revocation
    hazard over a window (a correlated regional capacity reclaim, or a
    spot-price rise through the fleet's bid on AWS/Azure-style markets).
    They act on *lifetimes*, not on the clock: every drawn lifetime is
    deterministically transformed by an inverse-CDF thinning of the
    window overlap, using draws keyed on (seed, fault, trajectory, slot,
    generation) — so the batched and event engines see bit-identical
    revocation timelines no matter in which order they consume them.
  * `StragglerFault` — silently scales one roster slot's step speed
    (degraded NIC / thermal throttling; Table III heterogeneity gone bad).
  * `PSCrash` — scales the PS capacity ceiling (0 = hard down).
  * `CheckpointOutage` — the checkpoint store fails saves: steps produce
    no checkpoint-boundary pauses and `last_ckpt` stops advancing, so a
    stock chief revocation after the window rolls further back.

Speed/PS/ckpt faults are piecewise-constant in time; `boundaries_s` lists
every instant a factor changes, and both engines treat those instants as
(no-op) events so constant-speed advancement never spans a factor change.

The port draws the keyed join uniforms with `keyed_uniforms`, one
vectorized pass over all keys that gives NumPy's per-key
``default_rng(SeedSequence(key)).random()`` bit for bit, where the
reference builds one Generator per key.

The port's copy of the JAX package's `chaos/injectors.py` (it imports
nothing of it).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

# domain-separation tags for the keyed hazard draws (arbitrary constants,
# fixed forever so recorded scorecards stay reproducible)
_TAG_INITIAL = 0xC4A05
_TAG_JOIN = 0xC4A15

# NumPy's SeedSequence hash constants and PCG64's 128-bit multiplier
_M32 = 0xFFFFFFFF
_INIT_A, _MULT_A = 0x43B0D7E5, 0x931E8875
_INIT_B, _MULT_B = 0x8B51F9DD, 0x58F38DED
_MIX_L, _MIX_R = 0xCA01F9DD, 0x4973F715
_PCG_MULT = (2549297995355413924, 4865540595714422341)


def _mul64(a: np.ndarray, b: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Full 64 x 64 -> 128-bit products of uint64 arrays, as (hi, lo)."""
    m, s = np.uint64(_M32), np.uint64(32)
    a0, a1, b0, b1 = a & m, a >> s, b & m, b >> s
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = (p00 >> s) + (p01 & m) + (p10 & m)
    return p11 + (p01 >> s) + (p10 >> s) + (mid >> s), (p00 & m) | (mid << s)


def _pcg_step(h, lo, inc_h, inc_lo):
    """One PCG64 LCG step on 128-bit (hi, lo) states:
    state * multiplier + inc (mod 2**128)."""
    mh, ml = np.uint64(_PCG_MULT[0]), np.uint64(_PCG_MULT[1])
    ph, pl = _mul64(lo, np.full_like(lo, ml))
    h = ph + lo * mh + h * ml
    lo = pl + inc_lo
    return h + inc_h + (lo < pl).astype(np.uint64), lo


def keyed_uniforms(keys: np.ndarray) -> np.ndarray:
    """``np.random.default_rng(np.random.SeedSequence(tuple(row))).random()``
    for every row of an ``(N, W)`` integer key array whose entries lie in
    [0, 2**32), as one vectorized pass: SeedSequence's entropy mixing
    (pool of 4 words) and PCG64's seeding and first double, written out on
    uint32/uint64 arrays. Bit for bit NumPy's value (tests/
    test_torch_fleet.py), in place of one Generator per key: the device
    engine's pools need 262,144 keys per level at 65,536 trajectories of
    4 slots (`chip_smoke.py` phase 13 times both ways)."""
    keys = np.asarray(keys)
    if keys.ndim != 2 or (keys.size and (keys.min() < 0
                                         or keys.max() > _M32)):
        raise ValueError("keyed_uniforms takes (N, W) keys in [0, 2**32)")
    words = keys.astype(np.uint32)
    n, w = words.shape
    sh16 = np.uint32(16)
    with np.errstate(over="ignore"):
        hc = _INIT_A

        def hashmix(v):
            nonlocal hc
            v = v ^ np.uint32(hc)
            hc = (hc * _MULT_A) & _M32
            v = v * np.uint32(hc)
            return v ^ (v >> sh16)

        def mix(x, y):
            r = np.uint32(_MIX_L) * x - np.uint32(_MIX_R) * y
            return r ^ (r >> sh16)

        pool = [hashmix(words[:, i] if i < w else np.zeros(n, np.uint32))
                for i in range(4)]
        for i_src in range(4):
            for i_dst in range(4):
                if i_src != i_dst:
                    pool[i_dst] = mix(pool[i_dst], hashmix(pool[i_src]))
        for i_src in range(4, w):
            for i_dst in range(4):
                pool[i_dst] = mix(pool[i_dst], hashmix(words[:, i_src]))
        # generate_state(4, uint64): 8 words cycled from the pool
        hb, state = _INIT_B, []
        for i in range(8):
            v = pool[i % 4] ^ np.uint32(hb)
            hb = (hb * _MULT_B) & _M32
            v = v * np.uint32(hb)
            state.append((v ^ (v >> sh16)).astype(np.uint64))
        seed_h, seed_l, inc_h, inc_l = (
            state[2 * i] | (state[2 * i + 1] << np.uint64(32))
            for i in range(4))
        # pcg64_set_seed: inc = initseq << 1 | 1; state = 0, step,
        # += initstate, step; then next64 = step, XSL-RR output
        ih = (inc_h << np.uint64(1)) | (inc_l >> np.uint64(63))
        il = (inc_l << np.uint64(1)) | np.uint64(1)
        lo = il + seed_l
        h = ih + seed_h + (lo < il).astype(np.uint64)
        h, lo = _pcg_step(h, lo, ih, il)
        h, lo = _pcg_step(h, lo, ih, il)
        x = h ^ lo
        rot = h >> np.uint64(58)
        out = (x >> rot) | (x << ((np.uint64(64) - rot) & np.uint64(63)))
    return (out >> np.uint64(11)).astype(np.float64) * (1.0 / 2.0 ** 53)


@dataclasses.dataclass(frozen=True)
class PreemptionWave:
    """Correlated preemption wave: `hazard_per_h` of *extra* revocation
    hazard over [start, start+duration), hitting every roster worker in
    `region` (None = all regions) that is alive during the window."""
    start_h: float
    duration_h: float
    hazard_per_h: float
    region: Optional[str] = None
    kind: str = dataclasses.field(default="preemption_wave", repr=False)

    @property
    def end_h(self) -> float:
        return self.start_h + self.duration_h


@dataclasses.dataclass(frozen=True)
class PriceSpike:
    """Market price rises through the fleet's bid: same mechanics as a
    wave (extra hazard over a window) but provider-wide by default —
    demand spikes hit every region's spot pool at once."""
    start_h: float
    duration_h: float
    hazard_per_h: float
    region: Optional[str] = None
    kind: str = dataclasses.field(default="price_spike", repr=False)

    @property
    def end_h(self) -> float:
        return self.start_h + self.duration_h


@dataclasses.dataclass(frozen=True)
class StragglerFault:
    """One roster slot silently runs at `speed_factor` x its speed."""
    start_h: float
    duration_h: float
    slot: int
    speed_factor: float
    kind: str = dataclasses.field(default="straggler", repr=False)

    @property
    def end_h(self) -> float:
        return self.start_h + self.duration_h


@dataclasses.dataclass(frozen=True)
class PSCrash:
    """PS capacity scaled by `capacity_factor` (0 = the server is down
    and training stalls until the window ends)."""
    start_h: float
    duration_h: float
    capacity_factor: float
    kind: str = dataclasses.field(default="ps_crash", repr=False)

    @property
    def end_h(self) -> float:
        return self.start_h + self.duration_h


@dataclasses.dataclass(frozen=True)
class CheckpointOutage:
    """Checkpoint saves fail fast during the window."""
    start_h: float
    duration_h: float
    kind: str = dataclasses.field(default="ckpt_outage", repr=False)

    @property
    def end_h(self) -> float:
        return self.start_h + self.duration_h


_HAZARD_KINDS = (PreemptionWave, PriceSpike)
Fault = object  # any of the dataclasses above


class FaultTimeline:
    """A scenario's faults compiled against one launch roster.

    `roster` is `FleetSim._roster` — tuples of (wid, gpu, region, speed)
    in slot order; `seed` is the *scenario* seed (hazard draws must not
    depend on the per-trajectory engine seeds, or the engines would
    diverge). All times are seconds of elapsed sim time; fault fields are
    hours of elapsed sim time.
    """

    def __init__(self, faults: Iterable[Fault],
                 roster: Sequence[Tuple], seed: int = 0):
        self.faults: Tuple[Fault, ...] = tuple(faults)
        self.seed = int(seed) % (2 ** 32)
        self.regions = tuple(r for _, _, r, _ in roster)
        self.n_slots = len(self.regions)
        self.hazards = tuple((i, f) for i, f in enumerate(self.faults)
                             if isinstance(f, _HAZARD_KINDS)
                             and f.hazard_per_h > 0)
        self.stragglers = tuple(f for f in self.faults
                                if isinstance(f, StragglerFault))
        self.ps = tuple(f for f in self.faults if isinstance(f, PSCrash))
        self.outages = tuple(f for f in self.faults
                             if isinstance(f, CheckpointOutage))
        for f in self.stragglers:
            if not 0 <= f.slot < self.n_slots:
                raise ValueError(f"straggler slot {f.slot} outside the "
                                 f"{self.n_slots}-slot roster")
        # every instant a piecewise factor changes (hazard faults act on
        # lifetimes, not on clocked factors, so they add no boundaries)
        bounds = sorted({b * 3600.0
                         for f in (*self.stragglers, *self.ps, *self.outages)
                         for b in (f.start_h, f.end_h) if b > 0})
        self.boundaries_s = np.asarray(bounds, float)

    # ------------------------------------------------- piecewise factors
    def speed_mults(self, t_s: np.ndarray) -> np.ndarray:
        """(m, slots) per-worker speed multipliers at each time (seconds).
        Factors are evaluated at the *start* of a constant-speed segment;
        windows are half-open [start, end)."""
        t = np.asarray(t_s, float)
        out = np.ones((t.size, self.n_slots))
        for f in self.stragglers:
            active = (t >= f.start_h * 3600.0) & (t < f.end_h * 3600.0)
            out[active, f.slot] *= f.speed_factor
        return out

    def ps_factor(self, t_s: np.ndarray) -> np.ndarray:
        """(m,) PS capacity multipliers at each time (seconds)."""
        t = np.asarray(t_s, float)
        out = np.ones(t.size)
        for f in self.ps:
            active = (t >= f.start_h * 3600.0) & (t < f.end_h * 3600.0)
            out[active] *= f.capacity_factor
        return out

    def ckpt_blocked(self, t_s: np.ndarray) -> np.ndarray:
        """(m,) bool: is the checkpoint store down at each time."""
        t = np.asarray(t_s, float)
        out = np.zeros(t.size, bool)
        for f in self.outages:
            out[(t >= f.start_h * 3600.0) & (t < f.end_h * 3600.0)] = True
        return out

    def next_boundary(self, t_s: np.ndarray) -> np.ndarray:
        """(m,) the next factor-change instant strictly after each time
        (seconds; inf when none remain)."""
        t = np.asarray(t_s, float)
        if self.boundaries_s.size == 0:
            return np.full(t.size, np.inf)
        idx = np.searchsorted(self.boundaries_s, t, side="right")
        padded = np.append(self.boundaries_s, np.inf)
        return padded[idx]

    def factor_tables(self) -> Tuple[np.ndarray, np.ndarray,
                                     np.ndarray, np.ndarray]:
        """Piecewise-constant factor tables for device-resident engines
        (`fleet_jit`): `(boundaries_s, speed_mults, ps_factor,
        ckpt_blocked)` where segment i covers `[b_{i-1}, b_i)` (b_{-1}=0,
        b_m=inf) and the three tables hold each segment's factors,
        evaluated at its start — shapes `(m,)`, `(m+1, slots)`, `(m+1,)`,
        `(m+1,)`. `searchsorted(boundaries_s, t, 'right')` is the segment
        index at time t, the same half-open [start, end) semantics the
        callable factor methods implement."""
        starts = np.concatenate([[0.0], self.boundaries_s])
        return (self.boundaries_s, self.speed_mults(starts),
                self.ps_factor(starts), self.ckpt_blocked(starts))

    def hazard_tables(self) -> Tuple[np.ndarray, np.ndarray,
                                     np.ndarray, np.ndarray]:
        """The hazard faults as arrays for device-resident engines:
        `(start_h, end_h, hazard_per_h, cols)` with shapes `(F,)` x3 and
        `(F, slots)` (bool: does fault f hit slot s's region), in
        `self.hazards` order — the order `transform_*` applies them."""
        F = len(self.hazards)
        starts = np.array([f.start_h for _, f in self.hazards], float)
        ends = np.array([f.end_h for _, f in self.hazards], float)
        rates = np.array([f.hazard_per_h for _, f in self.hazards], float)
        cols = (np.array([self._cols(f.region) for _, f in self.hazards],
                         bool) if F else np.zeros((0, self.n_slots), bool))
        return starts, ends, rates, cols

    def join_uniform_matrix(self, n: int, gen: int) -> np.ndarray:
        """The keyed join-transform uniforms for one generation level as
        an `(n, slots, F)` matrix — element [traj, slot, fi] is exactly
        the `(seed, _TAG_JOIN, fault, traj, slot, gen)` draw
        `transform_joins` makes, pre-materialized so a device-resident
        engine can apply the hazard thinning without host callbacks."""
        F = len(self.hazards)
        out = np.empty((n, self.n_slots, F))
        tj, sl = np.meshgrid(np.arange(n), np.arange(self.n_slots),
                             indexing="ij")
        for k, (fi, _) in enumerate(self.hazards):
            keys = np.stack([np.full(tj.size, self.seed), np.full(
                tj.size, _TAG_JOIN), np.full(tj.size, fi), tj.ravel(),
                sl.ravel(), np.full(tj.size, gen)], axis=1)
            out[:, :, k] = keyed_uniforms(keys).reshape(n, self.n_slots)
        return out

    # ------------------------------------------------ hazard transforms
    def _cols(self, region: Optional[str]) -> np.ndarray:
        return np.array([region is None or r == region
                         for r in self.regions], bool)

    @staticmethod
    def _apply_hazard(lt: np.ndarray, U: np.ndarray, f, h0) -> np.ndarray:
        """Thin one hazard window into drawn lifetimes.

        A worker alive over [h0, h0+lt) overlaps the window for
        `overlap = min(end, h0+lt) - max(start, h0)` hours; an extra
        exponential clock `tau ~ Exp(hazard)` fires inside the overlap
        with exactly the survival probability the added hazard implies,
        and a firing clock moves the revocation earlier — survivors
        (lt = inf) die iff tau lands inside the window."""
        a = np.maximum(f.start_h, h0)
        b = np.minimum(f.end_h, h0 + lt)
        overlap = b - a
        tau = -np.log1p(-U) / f.hazard_per_h
        killed = (overlap > 0) & (tau < overlap)
        return np.where(killed, np.minimum(lt, a + tau - h0), lt)

    def transform_initial(self, lifetimes_h: np.ndarray) -> np.ndarray:
        """Apply every hazard fault to the pre-drawn `(n, slots)`
        initial-lifetime matrix (initial workers launch at elapsed hour
        0). One keyed `(n, slots)` uniform matrix per fault, so the
        transform is a pure function of (seed, fault index)."""
        out = np.array(lifetimes_h, float, copy=True)
        for fi, f in self.hazards:
            cols = self._cols(f.region)
            if not cols.any():
                continue
            rng = np.random.default_rng(np.random.SeedSequence(
                (self.seed, _TAG_INITIAL, fi)))
            U = rng.random(out.shape)
            new = self._apply_hazard(out, U, f, 0.0)
            out = np.where(cols[None, :], new, out)
        return out

    def transform_joins(self, lifetimes_h: np.ndarray, trajs: np.ndarray,
                        slots: np.ndarray, gens: np.ndarray,
                        elapsed_h: np.ndarray) -> np.ndarray:
        """Apply every hazard fault to replacement-join lifetimes.
        `elapsed_h` is each join's elapsed sim time (hours since launch).
        Draws are keyed on (seed, fault, traj, slot, gen): identical no
        matter which engine asks first, or in what batch grouping."""
        lt = np.array(lifetimes_h, float, copy=True)
        if not self.hazards or lt.size == 0:
            return lt
        trajs = np.asarray(trajs, int)
        slots = np.asarray(slots, int)
        gens = np.asarray(gens, int)
        h0 = np.asarray(elapsed_h, float)
        for fi, f in self.hazards:
            cols = self._cols(f.region)
            rows = cols[slots]
            if not rows.any():
                continue
            m = trajs.size
            U = keyed_uniforms(np.stack(
                [np.full(m, self.seed), np.full(m, _TAG_JOIN),
                 np.full(m, fi), trajs, slots, gens], axis=1))
            new = self._apply_hazard(lt, U, f, h0)
            lt = np.where(rows, new, lt)
        return lt

    # ------------------------------------------------------ ground truth
    def truth_spans(self) -> List[dict]:
        """The recorded ground-truth timeline: one dict per fault with
        its window in seconds — what the evaluator scores against."""
        spans = []
        for f in self.faults:
            span = {"kind": f.kind, "start_s": f.start_h * 3600.0,
                    "end_s": f.end_h * 3600.0}
            for field in ("region", "slot", "hazard_per_h",
                          "speed_factor", "capacity_factor"):
                if hasattr(f, field):
                    span[field] = getattr(f, field)
            spans.append(span)
        return spans
