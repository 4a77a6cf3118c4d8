"""Asynchronous parameter-server runtime emulation (§II) — the twin of
the JAX package's `core/ps_async.py`.

Two layers:

1. `ps_queue_sim` — event-driven queueing model of the PS architecture:
   each worker alternates (compute step_time) -> (PS service
   2*model_bytes/bw). Reproduces Table III / Fig 4: per-worker step time
   flat until aggregate demand saturates the PS, then uniform slowdown;
   adding a PS (§VI-B) restores throughput. Host NumPy, a copy of the
   reference's with the package name changed: its results are the
   reference's bit for bit.

2. `async_sgd` — asynchronous SGD with bounded staleness in PyTorch: each
   worker computes gradients at a stale snapshot of the parameters
   (`torch.autograd.grad` on detached leaves, on the snapshot's device:
   on the card the forward and backward run the flash-attention and
   RMSNorm kernels); the PS applies updates in arrival order, out of
   place, so snapshots never change under a worker.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.perf_model.cluster_model import PS_NET_BYTES_PER_S
from repro_torch.tree import flatten, tree_map


# ---------------------------------------------------------------------------
# 1. queueing model
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PSQueueResult:
    worker_step_time: Dict[int, float]   # effective mean step time per worker
    cluster_speed: float                 # aggregate steps/s
    ps_utilization: float


def ps_queue_sim(compute_times: Sequence[float], model_bytes: float,
                 n_ps: int = 1, ps_bw: float = PS_NET_BYTES_PER_S,
                 steps: int = 400, seed: int = 0,
                 n_tensors: int = 0,
                 grad_compression: str = "none") -> PSQueueResult:
    """Workers with given per-step compute times sharing n_ps servers.

    Per-update service follows the calibrated PS law (cluster_model):
    max(network, per-tensor RPC) / n_ps — variables are striped across
    PSes. `grad_compression` shrinks the network term by
    `compression_ratio` (§VI-B), exactly as `PSBottleneckModel` does.

    Async semantics: a worker pushing to a FREE PS proceeds immediately
    (apply/pull overlap its next compute); pushing to a BUSY PS waits for
    the queue to drain (the Table III saturation regime).

    The stepper is the fleet engine's next-event array reduction instead
    of a per-push Python heap (docs/DESIGN.md §2): each round sorts the
    pending arrivals once, computes every admissible start time in one
    Lindley-recursion cummax, and serves the longest prefix whose order
    cannot be perturbed by a re-arrival — the whole worker population per
    round. When the queue is fully saturated and the per-cycle service
    order reaches its fixed point (always, for homogeneous compute
    times), whole service cycles collapse into one closed-form batch, so
    the Table III saturation regime costs O(1) rounds instead of
    O(steps). Results match the retired per-push heap loop up to float
    association order: the closed-form Lindley starts can differ from
    the incremental ones in the last bits, so two arrivals closer than
    that noise may serve in either order — transient serve-order swaps
    that keep aggregates within ~0.5% for short runs and vanish as
    steps grow (tests/test_fleet_batched.py fuzzes the bound against a
    pinned copy of the heap loop). Small heterogeneous populations
    (n <= 8) keep a scalar next-event scan — the array rounds would pay
    ~20 numpy calls per 1-2 served pushes there.
    """
    from repro_torch.core.perf_model.cluster_model import PSBottleneckModel
    if steps < 1:
        raise ValueError(f"need at least one step per worker, got {steps}")
    n = len(compute_times)
    ct = np.asarray(compute_times, float)
    service = PSBottleneckModel(model_bytes, n_ps, ps_bw,
                                n_tensors=n_tensors,
                                compression=grad_compression).service_time_s()
    rng = np.random.default_rng(seed)
    pending = ct * rng.uniform(0.2, 1.0, size=n)   # next arrival per worker
    remaining = np.full(n, steps)
    done_steps = np.zeros(n, int)
    finish_t = np.zeros(n, float)
    widx = np.arange(n)
    ks = widx * service
    ps_free_at = 0.0
    busy = 0.0
    n_live = n
    if n <= 8 and ct.min() < ct.max():
        # a small heterogeneous population rarely reaches a collapsible
        # steady state, so the array rounds would pay their per-round
        # overhead for 1-2 served pushes each; a scalar next-event scan
        # (min over <= 8 floats, first-minimum = lowest worker id like
        # the heap's tuple order) is faster there
        arr = [float(p) for p in pending]
        cts = [float(c) for c in ct]
        left = [steps] * n
        while n_live:
            w = arr.index(min(arr))
            start = arr[w] if arr[w] > ps_free_at else ps_free_at
            ps_free_at = start + service
            busy += service
            done_steps[w] += 1
            finish_t[w] = start
            left[w] -= 1
            if left[w] > 0:
                arr[w] = start + cts[w]
            else:
                arr[w] = float("inf")
                n_live -= 1
        eff = {w: finish_t[w] / done_steps[w] for w in range(n)}
        total_time = float(finish_t.max())
        return PSQueueResult(eff, float(done_steps.sum()) / total_time,
                             busy / total_time)
    while n_live:
        # arrivals in (time, worker) order — kind="stable" reproduces the
        # heap's (time, worker-id) tuple comparison; finished workers
        # (pending=inf) sort to the tail and are dropped
        order = np.argsort(pending, kind="stable")[:n_live]
        a = pending[order]
        m = order.size
        # Lindley recursion in closed form: s_k = max(a_k, s_{k-1} + S)
        #   => s_k = k*S + max(ps_free_at, cummax_j<=k (a_j - j*S))
        base = np.maximum.accumulate(np.maximum(a - ks[:m], ps_free_at))
        starts = ks[:m] + base
        # a served worker's next push; workers on their last step never
        # return, so they cannot constrain the prefix
        re_arr = np.where(remaining[order] > 1, starts + ct[order], np.inf)
        # serve the longest prefix no re-arrival can interleave into:
        # item k is safe iff every re-arrival produced before it lands at
        # or after a_k (ties defer to the next round's (time, worker)
        # sort, matching heap tie-breaking)
        safe = np.ones(m, bool)
        if m > 1:
            safe[1:] = a[1:] < np.minimum.accumulate(re_arr)[:-1]
        k = int(np.argmin(safe)) if not safe.all() else m
        served = order[:k]
        s_served = starts[:k]
        done_steps[served] += 1
        finish_t[served] = s_served
        busy += k * service
        ps_free_at = s_served[-1] + service
        remaining[served] -= 1
        rem = remaining[served]
        pending[served] = np.where(rem > 0, s_served + ct[served], np.inf)
        n_live -= int(np.count_nonzero(rem == 0))
        # ---- steady states: collapse whole service cycles --------------
        # After a round that served the whole population once, the next
        # cycles may be exact time-shifted copies; when the shift
        # invariance is provable, C = min(remaining) - 1 cycles are
        # served in closed form instead of C more rounds.
        if k == m and np.all(remaining[order] > 1):
            cycles = int(remaining[order].min()) - 1
            key = pending[order]            # next cycle's arrival times
            last = None                     # final-cycle starts, if any
            if cycles > 0 and np.all(np.diff(key) > 0):
                # (a) saturated: THIS round was served back-to-back
                # (constant Lindley base, so starts = base + k*S — only
                # then does `key <= ps_free_at + k*S` reduce to the
                # shift-invariant `ct_k <= m*S`), arrivals stay in this
                # order (strictly, so ties cannot reshuffle), every
                # worker re-arrives before its next back-to-back turn,
                # and cycles stay separated in arrival time — each cycle
                # is the last one shifted by m*service, the Table III
                # plateau regime.
                if (base[0] == base[-1]
                        and np.all(key <= ps_free_at + ks[:m])
                        and key[0] + m * service > key[-1]):
                    last = (ps_free_at + ks[:m]
                            + (cycles - 1) * m * service)
                # (b) idle (uniform paces): every start equals its
                # arrival, gaps fit the service time, and uniform
                # compute times shift all arrivals alike — each cycle is
                # the last one shifted by the common compute time.
                elif (ct[order[0]] == ct[order].min() == ct[order].max()
                        and key[0] >= ps_free_at
                        and np.all(np.diff(key) >= service)
                        and key[0] + ct[order[0]] >= key[-1] + service):
                    last = key + (cycles - 1) * ct[order[0]]
            if last is not None:
                done_steps[order] += cycles
                finish_t[order] = last
                busy += cycles * m * service
                ps_free_at = last[-1] + service
                remaining[order] -= cycles
                pending[order] = last + ct[order]
    eff = {w: finish_t[w] / done_steps[w] for w in range(n)}
    total_time = float(finish_t.max())
    return PSQueueResult(eff, float(done_steps.sum()) / total_time,
                         busy / total_time)


# ---------------------------------------------------------------------------
# 2. async-SGD emulation with bounded staleness
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class AsyncTrace:
    losses: List[float]
    applied_updates: int
    staleness_hist: Dict[int, int]
    #: updates each worker actually pushed over the run (the realized
    #: share of progress — fast workers dominate)
    worker_updates: Dict[int, int] = dataclasses.field(default_factory=dict)
    #: each worker's configured pace, echoed for the telemetry consumer
    #: (this emulation has no PS contention, so pace IS the step time;
    #: `ps_queue_sim` models the contended regime)
    worker_step_time: Dict[int, float] = dataclasses.field(
        default_factory=dict)


def _grad(loss_fn: Callable, params, batch) -> object:
    """The gradient of ``loss_fn(params, *batch)`` as a tree of
    params' structure, taken on detached leaves: nothing accumulates
    into ``.grad`` and the snapshot is not touched."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    leaves = [t for _, t in flatten(live)]
    with torch.enable_grad():
        grads = torch.autograd.grad(loss_fn(live, *batch), leaves)
    by_leaf = dict(zip(map(id, leaves), grads))
    return tree_map(lambda t: by_leaf[id(t)], live)


def async_sgd(loss_fn: Callable, params, data_for_worker: Callable,
              worker_step_times: Sequence[float], lr: float = 0.1,
              total_updates: int = 200, seed: int = 0,
              on_update: Optional[Callable[[dict], None]] = None
              ) -> Tuple[object, AsyncTrace]:
    """Emulate async PS training: workers produce gradients computed at the
    params snapshot they last pulled; the PS applies them on arrival.

    worker_step_times sets each worker's pace; staleness emerges naturally
    from pace differences (fast workers update many times while a slow
    worker's gradient is in flight). `on_update` (if given) observes every
    applied update — `Session.train(mode="async_ps")` forwards it onto the
    event bus.

    ``data_for_worker(w, gen)`` gives a batch as a tuple of
    ``loss_fn``'s arguments after the params. It is called twice an
    update, as in the reference: once for the gradient and once for the
    loss logged after the update. ``gen`` stands for the reference's
    per-update ``jax.random`` key: a `torch.Generator` seeded from a
    stream seeded with ``seed``, made anew for each call in the same
    state, so both calls of an update draw the same numbers.

    The update is ``p - lr * g``, out of place: each worker's snapshot
    and the current params share no storage that is ever written, so at
    most ``len(worker_step_times) + 1`` parameter trees are alive.
    """
    n = len(worker_step_times)
    rng = np.random.default_rng(seed)
    # each worker holds (pull_version, params_snapshot, ready_time)
    q: List[Tuple[float, int]] = []
    snaps = []
    for w, st in enumerate(worker_step_times):
        snaps.append((0, params))
        heapq.heappush(q, (st * rng.uniform(0.5, 1.5), w))
    version = 0
    losses = []
    stale_hist: Dict[int, int] = {}
    pushes: Dict[int, int] = {w: 0 for w in range(n)}
    keys = torch.Generator().manual_seed(seed)

    def key(sub: int) -> torch.Generator:
        return torch.Generator().manual_seed(sub)

    while version < total_updates:
        t, w = heapq.heappop(q)
        pull_v, snap = snaps[w]
        sub = int(torch.randint(0, 2 ** 62, (), generator=keys))
        batch = data_for_worker(w, key(sub))
        g = _grad(loss_fn, snap, batch)
        staleness = version - pull_v
        stale_hist[staleness] = stale_hist.get(staleness, 0) + 1
        params = tree_map(lambda p, gg: p - lr * gg, params, g)
        del g
        version += 1
        with torch.no_grad():
            loss = float(loss_fn(params, *data_for_worker(w, key(sub))))
        losses.append(loss)
        pushes[w] += 1
        if on_update is not None:
            on_update({"update": version, "worker": w,
                       "staleness": staleness, "loss": loss, "t": t})
        snaps[w] = (version, params)
        heapq.heappush(q, (t + worker_step_times[w], w))
    step_time = {w: float(st) for w, st in enumerate(worker_step_times)}
    return params, AsyncTrace(losses, version, stale_hist, pushes, step_time)
