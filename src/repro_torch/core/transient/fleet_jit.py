"""The device fleet engine (`engine="jit"`): the lockstep simulator of
`fleet_batched` with every trajectory's state as torch float64 tensors on
one device — the port of the JAX package's `core/transient/fleet_jit.py`.

The reference compiles one round of the lockstep simulator into a
`lax.while_loop` body. Here "jit" is the device engine, with no tracing:
the same round (`_round`, the reference's `body` line for line) runs
eagerly on the tensors, driven by a host loop that reads the reference's
loop condition back once per round. An inactive trajectory is a fixed
point of the round, so that read decides only when the host takes over.
Trajectory state is `(n,)` / `(n, slots)` tensors, the next-event select
is the hand-written CUDA kernel behind `kernels.ops.event_select` (its
plain version for CPU tensors), and every draw the engines share is
materialized up front, as in the reference:

* the `(n, slots)` initial-lifetime matrix is `FleetDraws.initial`
  verbatim (chaos hazard transforms already applied on host);
* generation-level replacement pools (`FleetDraws._level`) are stacked to
  `(G * slots, n)` delays and `(G * slots, n, K)` uniforms, folded as
  `(level * S + slot, trajectory, ...)`. The per-slot
  `LifetimeLaw.sample_from_uniforms` samplers are ported to tensor form
  (GCP truncated Weibull with the 16-round Fig 9 diurnal thinning, AWS
  inverse cumulative hazard on the per-launch-hour grids, Azure inverse
  exponential), so all engines consume identical uniforms and agree
  exactly on revocation and replacement counts;
* chaos `FaultTimeline` factors become piecewise-constant tables indexed
  by `searchsorted(boundaries, t)`, and the keyed join-hazard uniforms a
  `(G * slots, n, F)` matrix.

Pools are level-paged: G levels are materialized up front; a trajectory
whose next revocation needs a deeper replacement chain freezes
(`stalled`) before mutating anything, the round loop drains everyone
else, and the host doubles G and re-enters with the carried state, so
the frozen trajectory replays its pending round against the grown pools.
Above `COMPACT_MIN` (read at call time) trajectories the host pages
finished rows out once the active set halves and re-enters at the next
power of two. Neither schedule changes a result: the round is
elementwise per trajectory.

Every float is float64 and the counters int32, whatever torch's default
dtype. The join sampler runs every round, masked to the rows that join
(the reference skips it behind a `lax.cond` when no row joins, which
would cost a second device-to-host read per round here; the masked
result is identical). The port runs on one device: the reference's
trajectory sharding across devices (`_shard`, `_put`) has no
counterpart.
"""
from __future__ import annotations

import math
from typing import TYPE_CHECKING, Dict, Optional

import numpy as np
import torch

from repro_torch.core.perf_model.cluster_model import PSBottleneckModel
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ops import event_select

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.transient.fleet import FleetSim
    from repro_torch.core.transient.fleet_batched import FleetDraws

#: generation levels materialized before the first entry; doubled on
#: every stall re-entry
INITIAL_LEVELS = 4

#: widths at or below this run to completion without compaction; above
#: it the round loop stops once the active set halves, the host pages
#: finished trajectories out and re-enters at the next power of two
COMPACT_MIN = 4096

_GPU_CODES = {"k80": 0, "v100": 1}  # 2 = the p100-family default weight
_ENVELOPE_INV = 1.0 / 2.5           # 1 / _DIURNAL_MAX_WEIGHT
_GCP_CAP_H = 24.0                   # revocation.MAX_LIFETIME_H
_INF = math.inf
_F64 = torch.float64


# ---------------------------------------------------------------------------
# tensor ports of the three `sample_from_uniforms` laws
# ---------------------------------------------------------------------------
def _diurnal_weight(code: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """`revocation._diurnal_weight` with the gpu string as a code tensor
    (squares as products, as NumPy's ``** 2``)."""
    h = torch.remainder(h, 24.0)
    dk, dv, dp = h - 10.0, h - 9.0, h - 13.0
    wk = 1.0 + 1.5 * torch.exp(-(dk * dk) / 8.0)
    wv = torch.where((h >= 16.0) & (h < 20.0), 0.0,
                     1.0 + 0.6 * torch.exp(-(dv * dv) / 18.0))
    wp = 1.0 + 0.8 * torch.exp(-(dp * dp) / 32.0)
    return torch.where(code == 0, wk, torch.where(code == 1, wv, wp))


def _sample_gcp(U, hours, p24, k, lam, raw24, code):
    """`LifetimeModel.sample_from_uniforms`, params gathered per row:
    column 0 decides the 24 h survival mass, then 16 (candidate, accept)
    pairs run the diurnal thinning, with the hard-zero +4 h push."""
    inv_k = 1.0 / k

    def inv_cdf(u):
        return lam * torch.pow(-torch.log(1.0 - u * raw24), inv_k)

    revoked = U[:, 0] < p24
    cand = inv_cdf(U[:, 1])
    pending = U[:, 2] >= _diurnal_weight(code, hours + cand) * _ENVELOPE_INV
    for j in range(1, 16):
        c2 = inv_cdf(U[:, 1 + 2 * j])
        cand = torch.where(pending, c2, cand)
        acc = (U[:, 2 + 2 * j]
               < _diurnal_weight(code, hours + c2) * _ENVELOPE_INV)
        pending = pending & ~acc
    w = _diurnal_weight(code, hours + cand)
    cand = torch.where(pending & (w == 0.0), cand + 4.0, cand)
    return torch.where(revoked, torch.clamp(cand, max=_GCP_CAP_H), _INF)


def _sample_aws(U, hours, slot, ts_all, cum_all):
    """`PriceSignalLifetime.sample_from_uniforms`: inverse cumulative
    hazard of column 0 on the slot's 15-min-quantized launch-hour grid,
    as an elementwise bisection (12 gathered probes per row), as the
    reference does.

    `ts_all`: (S, P) time grids; `cum_all`: (S, 96, P) cumulative-hazard
    grids per quantized hour key."""
    P = ts_all.shape[-1]
    target = -torch.log(1.0 - U[:, 0])
    key = torch.remainder(
        torch.round(torch.remainder(hours, 24.0) * 4.0).long(), 96)
    cum2 = cum_all.reshape(-1, P)
    row = slot * 96 + key
    lo = torch.zeros_like(row)
    hi = torch.full_like(row, P)
    for _ in range(12):  # 2^12 >= P + 1 outcomes
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        v = cum2[row, torch.clamp(mid, max=P - 1)]
        upd = lo < hi
        right = upd & (v <= target)
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(upd & ~right, mid, hi)
    j = torch.clamp(lo, 1, P - 1)        # searchsorted(cum, target, 'right')
    c0, c1 = cum2[row, j - 1], cum2[row, j]
    t0, t1 = ts_all[slot, j - 1], ts_all[slot, j]
    out = t0 + (target - c0) * ((t1 - t0) / (c1 - c0))
    return torch.where(target > cum2[row, P - 1], _INF, out)


def _sample_azure(U, hazard, horizon):
    """`TieredEvictionLifetime.sample_from_uniforms`: inverse-transform
    exponential; inf beyond the sampling horizon."""
    t = -torch.log(1.0 - U[:, 0]) / hazard
    return torch.where(t > horizon, _INF, t)


def _law_spec(sim: "FleetSim"):
    """Classify the roster's lifetime laws into one kind plus stacked
    per-slot parameter arrays. Raises for laws the device samplers cannot
    reproduce (custom providers): those rosters need `engine="batched"`,
    whose per-key fallback streams handle any law."""
    from repro_torch.core.transient.revocation import LifetimeModel
    from repro_torch.providers.aws import PriceSignalLifetime
    from repro_torch.providers.azure import TieredEvictionLifetime

    laws = [sim.provider.lifetime_model(region, gpu)
            for _, gpu, region, _ in sim._roster]
    if all(isinstance(law, LifetimeModel) for law in laws):
        raw24 = [1.0 - math.exp(-((_GCP_CAP_H / law.lam) ** law.k))
                 for law in laws]
        return "gcp", {
            "law_p24": np.array([law.p24 for law in laws]),
            "law_k": np.array([law.k for law in laws]),
            "law_lam": np.array([law.lam for law in laws]),
            "law_raw24": np.array(raw24),
            "law_code": np.array([_GPU_CODES.get(law.gpu, 2)
                                  for law in laws], np.int64)}
    if all(isinstance(law, PriceSignalLifetime) for law in laws):
        ts_all, cum_all = [], []
        for law in laws:
            grids = [law._grid(kq / 4.0) for kq in range(96)]
            ts_all.append(grids[0][0])
            cum_all.append(np.stack([c for _, c in grids]))
        return "aws", {"law_ts": np.stack(ts_all),
                       "law_cum": np.stack(cum_all)}
    if all(isinstance(law, TieredEvictionLifetime) for law in laws):
        return "azure", {
            "law_hazard": np.array([law.hazard_per_h for law in laws]),
            "law_horizon": np.array([law.horizon_h for law in laws])}
    raise ValueError(
        "engine='jit' ports the provider's lifetime law to the device and "
        "supports the gcp/aws/azure law families; this roster's laws "
        f"({sorted({type(law).__name__ for law in laws})}) have no "
        "jittable port — use engine='batched' instead")


# ---------------------------------------------------------------------------
# one lockstep round (the reference's `body`)
# ---------------------------------------------------------------------------
def _segment(ar, t):
    """Chaos factor tables at time t: (speed mults, PS factor, ckpt
    blocked) and the next factor boundary."""
    seg = torch.searchsorted(ar["boundaries"], t, right=True)
    return (ar["speed_table"][seg], ar["ps_table"][seg],
            ar["blk_table"][seg], ar["boundaries_inf"][seg])


def _cluster_speed(ar, t, alive):
    mults, psf, _, _ = _segment(ar, t)
    return torch.minimum((alive * mults * ar["slot_speed"]).sum(dim=1),
                         ar["cap"] * psf)


def _join_lifetimes(ar, kind, U, hours, slot):
    if kind == "gcp":
        return _sample_gcp(U, hours, ar["law_p24"][slot], ar["law_k"][slot],
                           ar["law_lam"][slot], ar["law_raw24"][slot],
                           ar["law_code"][slot])
    if kind == "aws":
        return _sample_aws(U, hours, slot, ar["law_ts"], ar["law_cum"])
    return _sample_azure(U, ar["law_hazard"][slot], ar["law_horizon"][slot])


def _chaos_join(ar, lt, Uj, slot, elapsed_h):
    """`FaultTimeline.transform_joins` on the pre-keyed uniform matrix:
    fault windows thin each lifetime in fault order."""
    for f in range(ar["hz_start"].shape[0]):
        a = torch.maximum(ar["hz_start"][f], elapsed_h)
        b = torch.minimum(ar["hz_end"][f], elapsed_h + lt)
        tau = -torch.log1p(-Uj[:, f]) / ar["hz_rate"][f]
        killed = ((b - a) > 0) & (tau < (b - a))
        new = torch.where(killed, torch.minimum(lt, a + tau - elapsed_h), lt)
        lt = torch.where(ar["hz_cols"][f][slot], new, lt)
    return lt


def _round(st: Dict[str, torch.Tensor], ar: Dict[str, torch.Tensor], *,
           kind: str, handover: bool, graceful: bool, replace: bool,
           resilient: bool, G: int) -> Dict[str, torch.Tensor]:
    """Advance every active trajectory to its next event and apply it —
    the reference's `body`, line for line. Inactive rows come out
    unchanged."""
    S = ar["slot_speed"].shape[0]
    t, steps = st["t"], st["steps"]
    act = ~st["done"] & ~st["stalled"]
    ev_all = torch.cat([st["revoke_t"], st["join_t"]], dim=1)
    ev_all = torch.where(act[:, None], ev_all, _INF)
    ev_t, ev_arg = event_select(ev_all)
    mults, psf, blk, nb = _segment(ar, t)
    sp = torch.minimum((st["alive"] * mults * ar["slot_speed"]).sum(dim=1),
                       ar["cap"] * psf)
    nb = torch.where(nb < ar["tmax"], nb, _INF)
    if resilient:
        # a pending restore-retry stall end is a pure-advancement boundary
        # (the event engine's no-op "resume" heap entry, never clipped at
        # tmax); effective speed is gated to 0 meanwhile, and otherwise by
        # the quorum tier on the alive fraction
        stall_ev = torch.where(st["stall_t"] > t, st["stall_t"], _INF)
        nb = torch.minimum(nb, stall_ev)
        frac = st["alive"].sum(dim=1, dtype=_F64) / S
        factor = torch.where(
            frac < ar["quorum"], 0.0,
            torch.where(frac < ar["shrink_below"], ar["shrink_factor"], 1.0))
        sp = torch.where(torch.isfinite(stall_ev), 0.0, sp * factor)
    i_c, t_c, total = ar["i_c"], ar["t_c"], ar["total"]
    rel = torch.where(
        sp > 0,
        (total - steps) / torch.where(sp > 0, sp, 1.0)
        + torch.where(blk, 0.0, (torch.floor(total / i_c)
                                 - torch.floor(steps / i_c)) * t_c),
        _INF)
    t_fin = t + rel
    stuck = act & torch.isinf(ev_t) & (sp <= 0) & torch.isinf(nb)
    nxt = torch.minimum(ev_t, nb)
    ev = act & ~stuck & (nxt < t_fin)          # strict: event first
    fin = act & ~stuck & ~ev
    col = ev_arg.long()
    slot = torch.remainder(col, S)
    real = ev & (ev_t <= nxt)                  # vs a chaos boundary
    is_rev = real & (col < S)
    gen_at = torch.gather(st["gen"], 1, slot[:, None])[:, 0]
    # level paging: a revoke whose replacement needs a pool level beyond
    # G freezes the trajectory BEFORE any mutation; the host grows the
    # pools and re-enters
    if replace:
        stall_now = is_rev & (gen_at + 1 > G)
    else:
        stall_now = torch.zeros_like(is_rev)
    stalled = st["stalled"] | stall_now
    move = (ev | fin) & ~stall_now
    target = torch.where(ev, torch.maximum(nxt, t), t_fin)
    # ---- closed-form advance to `target` (fleet_batched._advance)
    span = torch.where(move, target - t, 0.0)
    if resilient:
        # exclusive accrual per span: a stall span is restore delay; a
        # quorum pause (not stalled, factor 0) is paused time
        seg_stall = st["stall_t"] > t
        restore_s = st["restore_s"] + torch.where(seg_stall, span, 0.0)
        paused = st["paused"] + torch.where(~seg_stall & (factor == 0.0),
                                            span, 0.0)
    alive_seconds = st["alive_seconds"] + st["alive"] * span[:, None]
    pos = move & (sp > 0) & (span > 1e-12)
    spp = torch.where(sp > 0, sp, 1.0)
    s0 = steps
    b0 = i_c - torch.remainder(s0, i_c)
    b0 = torch.where(b0 <= 1e-9, i_c, b0)
    d0 = b0 / spp
    cycle = i_c / spp + t_c
    k = torch.where(span >= d0, torch.floor((span - d0) / cycle) + 1.0, 0.0)
    r = span - d0 - (k - 1.0) * cycle
    pause = torch.minimum(t_c, r)
    boundary = s0 + b0 + (k - 1.0) * i_c
    stepped = torch.where(k > 0,
                          boundary + spp * torch.clamp(r - pause, min=0.0),
                          s0 + spp * span)
    new_ck = torch.where(k > 0, (k - 1.0) * t_c + pause, 0.0)
    stepped = torch.where(blk, s0 + spp * span, stepped)
    new_ck = torch.where(blk, 0.0, new_ck)
    steps = torch.where(pos, stepped, s0)
    ckpt_time = st["ckpt_time"] + torch.where(pos, new_ck, 0.0)
    last_ckpt = torch.where(pos & (k > 0) & ~blk, torch.round(boundary),
                            st["last_ckpt"])
    t = torch.where(move, target, t)
    done = st["done"] | stuck | (fin & ~stall_now)
    # --------------------------------------------------------- revokes
    is_rev = is_rev & ~stall_now
    is_join = real & (col >= S)
    onehot = ar["slot_ids"][None, :] == slot[:, None]
    rev2d = onehot & is_rev[:, None]
    was_chief = (st["chief"] & rev2d).any(dim=1)
    alive = st["alive"] & ~rev2d
    revoke_t = torch.where(rev2d, _INF, st["revoke_t"])
    revocations = st["revocations"] + is_rev
    chief, lost, recompute = st["chief"], st["lost"], st["recompute"]
    if resilient:
        stall_t = st["stall_t"]
    if handover:
        chief = chief & ~rev2d
        keys = torch.where(alive, st["order_key"], _INF)
        best = torch.argmin(keys, dim=1)       # first index on ties
        promote = is_rev & was_chief & torch.isfinite(keys.min(dim=1).values)
        best2d = ar["slot_ids"][None, :] == best[:, None]
        chief = chief | (best2d & promote[:, None])
    elif graceful:
        gm = is_rev & was_chief
        last_ckpt = torch.where(gm, torch.round(steps), last_ckpt)
    else:
        sm = is_rev & was_chief
        lost_now = torch.where(sm, steps - last_ckpt, 0.0)
        steps = torch.where(sm, last_ckpt, steps)
        lost = lost + lost_now
        sp_after = _cluster_speed(ar, t, alive)   # post-revoke fleet
        # raw cluster speed on purpose: recompute happens after the fleet
        # recovers, so degradation never inflates it
        recompute = recompute + torch.where(
            sm, lost_now / torch.clamp(sp_after, min=1e-9), 0.0)
        if resilient:
            # restore-retry stall, keyed on the revoked occupant's
            # generation (pre-bump — the replace block below bumps it); a
            # later stall overwrites an active one, even shortening it
            lvl_s = torch.clamp(gen_at, 0, G - 1).long()
            sdelay = ar["stalls"][lvl_s * S + slot, st["orig"]]
            stall_t = torch.where(sm, t + sdelay, stall_t)
    gen, join_t = st["gen"], st["join_t"]
    orig = st["orig"]        # row in the full-width pools
    if replace:
        lvl = torch.clamp(gen_at, 0, G - 1).long()     # level new_gen - 1
        delay = ar["delays"][lvl * S + slot, orig]
        join_t = torch.where(rev2d, (t + delay)[:, None], join_t)
        gen = gen + rev2d
    # ----------------------------------------------------------- joins
    join2d = onehot & is_join[:, None]
    alive = alive | join2d
    join_t = torch.where(join2d, _INF, join_t)
    replacements = st["replacements"] + is_join
    order_key = torch.where(join2d, st["next_key"][:, None], st["order_key"])
    next_key = st["next_key"] + is_join
    # the joining worker's lifetime: one gather per pool (pools stay
    # full-width; compaction only permutes `orig`), then the law sampler,
    # for every row and kept where a join happened
    li = torch.clamp(gen_at - 1, 0, G - 1).long() * S + slot
    U = ar["uniforms"][li, orig, :]                          # (n, K)
    lts = _join_lifetimes(ar, kind, U, ar["start_hour"] + t / 3600.0, slot)
    if ar["hz_start"].shape[0]:
        Uj = ar["join_U"][li, orig, :]                       # (n, F)
        lts = _chaos_join(ar, lts, Uj, slot, t / 3600.0)
    revoke_t = torch.where(
        join2d, torch.where(torch.isfinite(lts), t + lts * 3600.0,
                            _INF)[:, None], revoke_t)
    done = done | (steps >= total - 1e-6) | (t >= ar["tmax"])
    out = {"t": t, "steps": steps, "last_ckpt": last_ckpt,
           "ckpt_time": ckpt_time, "recompute": recompute, "lost": lost,
           "revocations": revocations, "replacements": replacements,
           "alive": alive, "chief": chief, "gen": gen,
           "order_key": order_key, "next_key": next_key,
           "revoke_t": revoke_t, "join_t": join_t,
           "alive_seconds": alive_seconds, "done": done,
           "stalled": stalled, "orig": orig}
    if resilient:
        out["stall_t"] = stall_t
        out["paused"] = paused
        out["restore_s"] = restore_s
    return out


def _more_rounds(st: Dict[str, torch.Tensor]) -> bool:
    """The reference's loop condition, read back to the host: any active
    row, and above `COMPACT_MIN` rows only while more than half are
    active (so the host can compact)."""
    act = ~st["done"] & ~st["stalled"]
    a = int(act.sum())
    w = act.shape[0]
    if w <= COMPACT_MIN:
        return a > 0
    return a > 0 and 2 * a > w


# ---------------------------------------------------------------------------
# host driver: pools, level paging, compaction
# ---------------------------------------------------------------------------
def _pools(draws: "FleetDraws", G: int, has_chaos: bool, res,
           device: torch.device) -> Dict[str, torch.Tensor]:
    """FleetDraws generation levels 1..G as device tensors in the folded
    `(level * S + slot, trajectory, ...)` layout `_round` indexes. Cached
    on the draws object: the pools are pure functions of (draws, G, res),
    so repeat calls reuse the device copies; the keyed join-hazard
    uniforms are kept per level on the host, so growing G draws only the
    new levels. With a `ResilienceConfig` the restore-retry stall levels
    ride along, indexed by the revoked occupant's generation (0..G-1 —
    level paging freezes any revoke whose occupant reached G before it
    mutates state)."""
    key = (G, bool(has_chaos), res, str(device))
    cache = draws.__dict__.setdefault("_device_pools", {})
    if key in cache:
        return cache[key]
    n, S, K = draws.n, draws.n_slots, draws._K

    def put(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

    delays = np.empty((G, S, n))
    uniforms = np.empty((G, S, n, K))
    for g in range(1, G + 1):
        d, u = draws._level(g)
        delays[g - 1] = d.T
        uniforms[g - 1] = np.swapaxes(u, 0, 1)
    out = {"delays": put(delays.reshape(G * S, n)),
           "uniforms": put(uniforms.reshape(G * S, n, K))}
    del delays, uniforms
    if res is not None:
        stalls = np.empty((G, S, n))
        for g in range(G):
            stalls[g] = draws.restore_stall_level(res, g).T
        out["stalls"] = put(stalls.reshape(G * S, n))
    if has_chaos:
        F = len(draws.chaos.hazards)
        levels = draws.__dict__.setdefault("_join_uniform_levels", {})
        ju = np.empty((G, S, n, F))
        for g in range(1, G + 1):
            if g not in levels:
                levels[g] = draws.chaos.join_uniform_matrix(n, g)
            ju[g - 1] = np.swapaxes(levels[g], 0, 1)
        out["join_U"] = put(ju.reshape(G * S, n, F))
    else:
        out["join_U"] = torch.zeros((G * S, n, 0), dtype=_F64, device=device)
    cache.clear()            # keep at most one (the deepest) G resident
    cache[key] = out
    return out


def _pow2ceil(x: int) -> int:
    return 1 << (max(1, x) - 1).bit_length()


#: state fields pulled to host as rows finish (the result fields)
_HARVEST = ("t", "steps", "ckpt_time", "recompute", "lost", "revocations",
            "replacements", "alive_seconds")


def run_jit(sim: "FleetSim", total_steps: int, n: int,
            max_hours: float = 48.0, start_hour: float = 0.0,
            draws: Optional["FleetDraws"] = None, raw: bool = False, *,
            device: DeviceLike = None, stats: Optional[dict] = None):
    """Advance `n` trajectories of `sim`'s roster on `device` (the CUDA
    card unless ``device="cpu"``; with no card and no explicit request it
    raises `NoCudaDevice`).

    Same contract as `fleet_batched.run_batched` (which documents the
    round semantics): one `SimResult` per trajectory, exact
    revocation/replacement parity with both other engines under the
    shared `FleetDraws`, times/costs to float tolerance. With `raw=True`
    the per-trajectory stats come back as a dict of arrays (the keys of
    `run_batched(raw=True)`).

    `stats`, when given a dict, receives what the host loop did:
    ``rounds`` (calls of the round), ``entries`` (round loops entered:
    the first, one per compaction and one per pool doubling),
    ``doublings`` and ``levels`` (the final G).
    """
    from repro_torch.core.transient.fleet import SimResult
    from repro_torch.core.transient.fleet_batched import FleetDraws

    if n < 1:
        raise ValueError(f"need at least one trajectory, got {n}")
    kind, law_arrays = _law_spec(sim)
    dev = resolve_device(device)
    if draws is None:
        draws = FleetDraws(sim, n, start_hour)
    roster = sim._roster
    S = len(roster)
    slot_speed = np.array([speed for _, _, _, speed in roster], float)
    cap = PSBottleneckModel(sim.model_bytes, sim.n_ps,
                            n_tensors=sim.n_tensors,
                            compression=sim.grad_compression
                            ).capacity_steps_per_s()
    chaos = getattr(sim, "chaos", None)
    has_chaos = chaos is not None
    has_haz = has_chaos and len(chaos.hazards) > 0
    graceful = (sim.provider.graceful_checkpoint_on_warning
                and sim.provider.warning_seconds >= sim.t_c)
    resil = getattr(sim, "resilience", None)
    resilient = resil is not None
    flags = dict(kind=kind, handover=bool(sim.handover),
                 graceful=bool(graceful), replace=bool(sim.replace),
                 resilient=resilient)

    def put(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

    def scalar(x):
        return torch.tensor(float(x), dtype=_F64, device=dev)

    if has_chaos:
        bounds, sp_tab, ps_tab, blk_tab = chaos.factor_tables()
        hz_s, hz_e, hz_r, hz_c = chaos.hazard_tables()
    else:
        bounds = np.zeros(0)
        sp_tab, ps_tab = np.ones((1, S)), np.ones(1)
        blk_tab = np.zeros(1, bool)
        hz_s = hz_e = hz_r = np.zeros(0)
        hz_c = np.zeros((0, S), bool)
    ar = {"slot_speed": put(slot_speed), "cap": scalar(cap),
          "i_c": scalar(sim.i_c), "t_c": scalar(sim.t_c),
          "total": scalar(total_steps), "tmax": scalar(max_hours * 3600.0),
          "start_hour": scalar(start_hour),
          "boundaries": put(np.asarray(bounds, float)),
          "boundaries_inf": put(np.append(np.asarray(bounds, float),
                                          np.inf)),
          "speed_table": put(sp_tab), "ps_table": put(ps_tab),
          "blk_table": put(blk_tab), "hz_start": put(hz_s),
          "hz_end": put(hz_e), "hz_rate": put(hz_r), "hz_cols": put(hz_c),
          "slot_ids": torch.arange(S, device=dev)}
    if resilient:
        ar["quorum"] = scalar(resil.degradation.quorum)
        ar["shrink_below"] = scalar(resil.degradation.shrink_below)
        ar["shrink_factor"] = scalar(resil.degradation.shrink_factor)
    for name, arr in law_arrays.items():
        ar[name] = put(arr)

    chief0 = np.zeros((n, S), bool)
    chief0[:, 0] = True                 # FleetSim marks workers[0]
    st = {"t": np.zeros(n), "steps": np.zeros(n),
          "last_ckpt": np.zeros(n), "ckpt_time": np.zeros(n),
          "recompute": np.zeros(n), "lost": np.zeros(n),
          "revocations": np.zeros(n, np.int32),
          "replacements": np.zeros(n, np.int32),
          "alive": np.ones((n, S), bool), "chief": chief0,
          "gen": np.zeros((n, S), np.int32),
          "order_key": np.tile(np.arange(S, dtype=float), (n, 1)),
          "next_key": np.full(n, float(S)),
          "revoke_t": np.where(np.isfinite(draws.initial),
                               draws.initial * 3600.0, np.inf),
          "join_t": np.full((n, S), np.inf),
          "alive_seconds": np.zeros((n, S)),
          "done": np.zeros(n, bool), "stalled": np.zeros(n, bool),
          "orig": np.arange(n, dtype=np.int64)}
    if resilient:
        st["stall_t"] = np.zeros(n)
        st["paused"] = np.zeros(n)
        st["restore_s"] = np.zeros(n)
    st = {key: put(v) for key, v in st.items()}

    if sim.replace:
        # start deep enough for every level a previous call on these
        # draws already materialized — warm calls take one entry
        G = INITIAL_LEVELS
        while G < max(draws._levels, default=0):
            G *= 2
    else:
        G = 1

    # lane -> original trajectory map, plus the host result buffers rows
    # are scattered into as compaction drops them from the device
    sel = np.arange(n)
    valid = np.ones(n, bool)
    harvest = _HARVEST + (("paused", "restore_s") if resilient else ())
    res = {key: np.zeros(n, np.int64 if key in
                         ("revocations", "replacements") else float)
           for key in harvest if key != "alive_seconds"}
    res["alive_seconds"] = np.zeros((n, S))
    if not resilient:     # raw output always carries both keys
        res["paused"] = np.zeros(n)
        res["restore_s"] = np.zeros(n)

    def scatter(lanes: np.ndarray) -> None:
        """Pull `lanes`' stats off the device into the result buffers (a
        device-side gather first, so the transfer is proportional to the
        rows leaving, not the loop width)."""
        if not lanes.size:
            return
        idx = put(lanes.astype(np.int64))
        rows = sel[lanes]
        for key in harvest:
            res[key][rows] = st[key].index_select(0, idx).cpu().numpy()

    ar_g = dict(ar)
    ar_g.update(_pools(draws, G, has_haz, resil, dev))
    rounds = entries = doublings = 0
    while True:
        entries += 1
        while _more_rounds(st):
            st = _round(st, ar_g, G=G, **flags)
            rounds += 1
        done = st["done"].cpu().numpy()
        if np.any(st["stalled"].cpu().numpy() & valid):
            # deepest replacement chains outgrew the pools: double them
            # and replay the frozen trajectories' pending rounds
            G *= 2
            doublings += 1
            ar_g.update(_pools(draws, G, has_haz, resil, dev))
            st["stalled"] = torch.zeros_like(st["stalled"])
        keep = valid & ~done
        a = int(keep.sum())
        if a == 0:
            scatter(np.flatnonzero(valid))
            break
        w2 = max(COMPACT_MIN, _pow2ceil(a))
        if w2 < len(sel):
            scatter(np.flatnonzero(valid & ~keep))
            idx = np.zeros(w2, np.int64)
            idx[:a] = np.flatnonzero(keep)
            padmask = np.zeros(w2, bool)
            padmask[a:] = True
            idx_d = put(idx)
            st = {key: v.index_select(0, idx_d) for key, v in st.items()}
            st["done"] = st["done"] | put(padmask)
            sel = sel[idx]
            valid = ~padmask
    if stats is not None:
        stats.update(rounds=rounds, entries=entries, doublings=doublings,
                     levels=G)

    price = np.array([sim.price_of.get(g, 0.0) for _, g, _, _ in roster])
    cost = (res["alive_seconds"] / 3600.0) @ price
    regions = {region for _, _, region, _ in roster}
    region = regions.pop() if len(regions) == 1 else ""
    if raw:
        return {"total_time_s": res["t"],
                "steps_done": (res["steps"] + 1e-6).astype(np.int64),
                "revocations": res["revocations"],
                "replacements": res["replacements"],
                "checkpoint_time_s": res["ckpt_time"],
                "recompute_time_s": res["recompute"],
                "lost_steps": res["lost"], "monetary_cost": cost,
                "paused_s": res["paused"],
                "restore_delay_s": res["restore_s"]}
    return [SimResult(
        total_time_s=float(res["t"][j]),
        steps_done=int(res["steps"][j] + 1e-6),
        revocations=int(res["revocations"][j]),
        replacements=int(res["replacements"][j]),
        checkpoint_time_s=float(res["ckpt_time"][j]),
        recompute_time_s=float(res["recompute"][j]),
        lost_steps=float(res["lost"][j]),
        events=[], monetary_cost=float(cost[j]),
        provider=sim.provider.name, region=region,
        paused_s=float(res["paused"][j]),
        restore_delay_s=float(res["restore_s"][j])) for j in range(n)]
