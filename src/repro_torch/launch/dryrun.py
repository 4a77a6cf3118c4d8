"""The dry run of the port: price an (arch x shape) cell on a production
mesh without the chips — the twin of the JAX package's
`launch/dryrun.py`, by counting where the reference asks XLA.

The reference lowers each cell on 512 placeholder host devices and reads
XLA's `cost_analysis`, `memory_analysis` and the collectives of the
compiled HLO. PyTorch has no compiler to ask, so the port runs its own
step once, eagerly, on the meta device (tensors with a shape and a dtype
and no memory) at the cell's global shapes, and counts what it does:

* FLOPs: the aten products (`torch.utils.flop_counter`'s formulas) plus
  the hand-written kernels' own count (`kernels.ops.tally`, each kernel's
  cost function), which the step reaches through the same autograd
  Functions as on the card, so the backward and a checkpoint's recompute
  are counted as they run there;
* bytes: each aten op's inputs read and outputs written once (views move
  nothing; a broadcast input counts its distinct elements) plus the
  kernels' bytes: eager PyTorch's unfused traffic, which is what the port
  moves;
* peak live bytes: every storage from its creation to its release,
  arguments included, as `torch.cuda.max_memory_allocated` sees one card
  run the same step (it also rounds each block to 512 B and holds
  cuBLAS's workspace, which the count does not);
* kernel calls by name.

The record keeps the reference's keys, so its readers
(`benchmarks/roofline.py`) read a port record. Where a key's source
differs, the record says so:

* ``memory.argument_bytes`` per device is exact: the step's arguments
  (train state, ZeRO-1 included, and batch; or params, decode state and
  tokens) summed over their shards under the resolved shardings;
* ``flops_per_device``, ``bytes_per_device`` and ``memory.temp_bytes`` are
  the counted (global) step split evenly over the mesh's chips
  (``"per_device": "even split of the counted step"``);
* ``collectives`` holds the data-parallel gradient reduction computed
  from the resolved parameter shardings: an all-reduce (ring factor 2) a
  leaf, or a reduce-scatter and an all-gather under ZeRO-1, over the
  batch's mesh axes the leaf does not shard over. Tensor-parallel
  activation collectives are not counted, and say so;
* there is no scan to correct (every layer runs and is counted), so
  ``probe`` is ``{"probes": 0}`` and the ``*_corrected`` keys equal the
  counted ones; ``collective_stats`` over HLO text has nothing to read.

The roofline uses one card's published rates (`repro_torch.device`): an
NVIDIA H100 SXM 80GB HBM3 at 700 W, 989 TFLOP/s dense bf16 for every
product and 3.35 TB/s of HBM3, and NVLink 4 at 450 GB/s a direction for
every collective. A 16x16 or 2x16x16 mesh of such cards spans 32 or 64
nodes of 8, whose links between nodes are slower than NVLink: the
collective term is a lower bound there.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
      --shape train_4k --mesh single --out artifacts/dryrun_torch/q3.json
"""
from __future__ import annotations

import argparse
import json
import math
import time
import weakref
from typing import Any, Dict, Optional, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import (ARCH_IDS, SHAPES, RunConfig, ShapeConfig,
                                 get_config, valid_cells)
from repro_torch.device import (H100_HBM_BYTES_PER_S, H100_NVLINK_BYTES_PER_S,
                                H100_PEAK_FLOPS)
from repro_torch.dist import sharding as sh
from repro_torch.kernels import ops
from repro_torch.launch import steps as st
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import api
from repro_torch.tree import flatten

PEAK_FLOPS = H100_PEAK_FLOPS["bfloat16"]
HBM_BW = H100_HBM_BYTES_PER_S
LINK_BW = H100_NVLINK_BYTES_PER_S

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
# ring-cost multipliers applied to a collective's per-device buffer
_RING_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}
# ops that allocate without writing
_ALLOCATORS = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided"}


def _moves_no_bytes(func) -> bool:
    """A view (an output that aliases an input without writing it) or an
    allocation without a write."""
    return (func._overloadpacket.__name__ in _ALLOCATORS
            or any(r.alias_info is not None and not r.alias_info.is_write
                   for r in func._schema.returns))


def _read_bytes(t: torch.Tensor) -> int:
    """Bytes an op reads of ``t``: its distinct elements (a broadcast
    dimension, stride 0, is read once)."""
    n = math.prod(d for d, s in zip(t.shape, t.stride()) if s != 0)
    return n * t.element_size()


class Accountant(TorchDispatchMode):
    """Counts the aten ops that touch a meta tensor: FLOPs, bytes, ops,
    and the live bytes of meta storages with their peak."""

    def __init__(self):
        super().__init__()
        # imported here: it pulls in torch._dynamo (~2 s)
        from torch.utils.flop_counter import flop_registry
        self._flops_of = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._tracked: Dict[int, int] = {}

    def track(self, tree) -> None:
        """Count the storages of a tree's meta tensors as live."""
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor) and t.is_meta:
                self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        st_ = t.untyped_storage()
        key = st_._cdata
        if key in self._tracked:
            return
        n = st_.nbytes()
        self._tracked[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st_, self._release, key)

    def _release(self, key: int) -> None:
        self.live -= self._tracked.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not any(t.is_meta for t in ins + outs):
            return out            # the host's own scalars (step, lr)
        self.ops += 1
        packet = func._overloadpacket
        if packet in self._flops_of:
            self.flops += self._flops_of[packet](*args, **kwargs,
                                                 out_val=out)
        if not _moves_no_bytes(func):
            self.bytes += (sum(_read_bytes(t) for t in ins)
                           + sum(t.numel() * t.element_size() for t in outs))
        for t in outs:
            if t.is_meta:
                self._track(t)
        return out


def _shard_bytes(shardings, tensors) -> int:
    """Per-device bytes of ``tensors`` under ``shardings`` (trees of one
    structure; a `TrainState` counts field by field, and its empty
    fields count nothing)."""
    if isinstance(tensors, st.TrainState):
        shardings, tensors = shardings._asdict(), tensors._asdict()
    total = 0
    for (_, s), (_, t) in zip(flatten(shardings), flatten(tensors)):
        if isinstance(t, torch.Tensor):
            total += (math.prod(s.shard_shape(tuple(t.shape)))
                      * t.element_size())
    return total


def _grad_collectives(mesh, rules, p_sh, o_sh, params,
                      zero1: bool) -> Dict[str, Any]:
    """The data-parallel gradient reduction: each parameter leaf's
    gradient is reduced over the batch's mesh axes that the leaf does not
    shard over; an all-reduce, or under ZeRO-1 (where the optimizer state
    took the data axis) a reduce-scatter of the gradient and an
    all-gather of the updated shard. Bytes are each device's buffer."""
    stats: Dict[str, Any] = {k: {"count": 0, "bytes": 0}
                             for k in _COLLECTIVES}
    (batch_entry,) = sh.logical_spec(("batch",), rules, mesh)
    dp_axes = sh.axes_of(batch_entry)
    sizes = mesh.shape
    o_leaves = ([s for _, s in flatten(o_sh["m"])]
                if zero1 and isinstance(o_sh, dict) and "m" in o_sh
                else None)
    for i, ((_, s), (_, t)) in enumerate(zip(flatten(p_sh),
                                             flatten(params))):
        used = {a for e in s.spec for a in sh.axes_of(e)}
        group = math.prod(sizes[a] for a in dp_axes if a not in used)
        if group == 1:
            continue
        nbytes = math.prod(s.shard_shape(tuple(t.shape))) * t.element_size()
        if o_leaves is not None and o_leaves[i].spec != s.spec:
            for kind in ("reduce-scatter", "all-gather"):
                stats[kind]["count"] += 1
                stats[kind]["bytes"] += nbytes
        else:
            stats["all-reduce"]["count"] += 1
            stats["all-reduce"]["bytes"] += nbytes
    stats["weighted_total_bytes"] = int(sum(
        stats[k]["bytes"] * _RING_FACTOR[k] for k in _COLLECTIVES))
    stats["tensor_parallel_activations"] = "not counted"
    return stats


def count_cell(arch: str, shape: Union[str, ShapeConfig], mesh,
               rules=sh.MEGATRON_RULES, run: Optional[RunConfig] = None,
               cfg=None, counts: Optional[Dict[str, Any]] = None):
    """Build one (arch x shape) cell's step, resolve its shardings on
    ``mesh`` and run it once on the meta device at the shape's global
    sizes under an `Accountant`. Returns (counts, meta): the counted
    FLOPs, bytes, peak, ops and kernel calls; the config, the shape, the
    step's per-device argument bytes and, for train, its gradient
    collectives. The counts do not depend on the mesh: ``counts`` from
    the same cell on another mesh skips the run."""
    cfg = cfg if cfg is not None else get_config(arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    if shape.kind == "train" and cfg.remat == "none":
        # activation checkpointing is mandatory at these shapes (temp memory
        # otherwise exceeds HBM by >10x), as in the reference
        cfg = cfg.with_(remat="full")
    run = run or RunConfig()
    meta: Dict[str, Any] = {"cfg": cfg, "shape": shape, "collectives": None}
    if shape.kind == "train":
        step, _ = st.make_train_step(cfg, run)
        state = st.train_state_specs(cfg, run)
        state_sh = st.train_state_shardings(mesh, cfg, run, rules)
        b_sh, batch = st.batch_shardings(mesh, cfg, shape, rules)
        args = (state, batch)
        meta["argument_bytes"] = (_shard_bytes(state_sh, state)
                                  + _shard_bytes(b_sh, batch))
        meta["collectives"] = _grad_collectives(
            mesh, rules, state_sh.params, state_sh.opt, state.params,
            run.zero1)
    elif shape.kind == "prefill":
        step = st.make_prefill_step(cfg)
        params, p_axes = api.param_specs(cfg)
        p_sh = sh.tree_shardings(mesh, p_axes, rules, params)
        b_sh, batch = st.batch_shardings(mesh, cfg, shape, rules)
        args = (params, batch)
        meta["argument_bytes"] = (_shard_bytes(p_sh, params)
                                  + _shard_bytes(b_sh, batch))
    else:  # decode / long_decode: one token against a full cache
        step = st.make_serve_step(cfg)
        params, p_axes = api.param_specs(cfg)
        p_sh = sh.tree_shardings(mesh, p_axes, rules, params)
        state, s_axes = api.decode_state_specs(
            cfg, shape.global_batch, shape.seq_len)
        s_sh = sh.tree_shardings(mesh, s_axes, rules, state)
        tokens = torch.empty((shape.global_batch,), dtype=torch.int32,
                             device="meta")
        tok_sh = sh.named_sharding(mesh, ("batch",), rules,
                                   tokens.shape)
        args = (params, state, tokens, shape.seq_len - 1)
        meta["argument_bytes"] = (
            _shard_bytes(p_sh, params) + _shard_bytes(s_sh, state)
            + _shard_bytes(tok_sh, tokens) + 4)      # + the index
    if counts is None:
        counts = _count(step, args)
    return counts, meta


def _count(step, args) -> Dict[str, Any]:
    """Run ``step(*args)`` once under an `Accountant`."""
    acct = Accountant()
    acct.track(args)
    at_start = acct.live
    in_storages = {t.untyped_storage()._cdata for t in tree_leaves(args)
                   if isinstance(t, torch.Tensor) and t.is_meta}
    ops.reset_tally()
    with acct:
        out = step(*args)
    new_out = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
               for t in tree_leaves(out)
               if isinstance(t, torch.Tensor) and t.is_meta
               and t.untyped_storage()._cdata not in in_storages}
    kernels = {name: {"calls": int(row[0]), "flops": row[1],
                      "bytes": row[2]}
               for name, row in ops.tally.items() if row[0]}
    return {
        "flops": acct.flops + sum(k["flops"] for k in kernels.values()),
        "aten_flops": acct.flops,
        "bytes": acct.bytes + sum(k["bytes"] for k in kernels.values()),
        "peak_bytes": acct.peak,
        "arguments_bytes": at_start,
        "output_bytes": sum(new_out.values()),
        "aten_ops": acct.ops,
        "kernels": kernels,
    }


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N*D (dense) / 6*N_active*D, D = tokens processed."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def roofline(flops: float, nbytes: float,
             coll_bytes: float = 0.0) -> Dict[str, float]:
    """The least seconds the card could take for the counted work, term
    by term."""
    return {"compute_s": flops / PEAK_FLOPS, "memory_s": nbytes / HBM_BW,
            "collective_s": coll_bytes / LINK_BW}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             rules_name: str = "megatron", zero1: bool = True,
             master_weights: bool = False, remat: str = "none",
             microbatch: int = 0, kv_quant: bool = False,
             counts: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One cell on one production mesh, as a record with the reference's
    keys (the module docstring says where their sources differ) and the
    global count under ``counted``, which another mesh's record of the
    same cell can take as ``counts``."""
    rules = sh.RULE_SETS[rules_name]
    shape = SHAPES[shape_name]
    if shape.is_decode and rules_name == "megatron":
        rules = sh.DECODE_RULES
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size
    run = RunConfig(zero1=zero1, master_weights=master_weights,
                    microbatch=microbatch)
    cfg_override = None
    if remat != "none" or kv_quant:
        cfg_override = get_config(arch).with_(
            **({"remat": remat} if remat != "none" else {}),
            **({"kv_quant": True} if kv_quant else {}))
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "rules": rules_name, "chips": int(n_chips), "ok": False,
        "master_weights": master_weights, "remat": remat,
        "device": "meta (counted, eager PyTorch)",
        "per_device": "even split of the counted step",
    }
    t0 = time.time()
    counts, meta = count_cell(arch, shape_name, mesh, rules, run,
                              cfg=cfg_override, counts=counts)
    # the reference's two phases are one here: build and count
    rec["lower_s"] = 0.0
    rec["compile_s"] = round(time.time() - t0, 2)

    rec["flops_per_device"] = counts["flops"] / n_chips
    rec["bytes_per_device"] = counts["bytes"] / n_chips
    rec["memory"] = {
        "argument_bytes": int(meta["argument_bytes"]),
        "output_bytes": int(counts["output_bytes"] / n_chips),
        "temp_bytes": int((counts["peak_bytes"] - counts["arguments_bytes"])
                          / n_chips),
        "generated_code_bytes": 0,
        "peak_bytes_counted": int(counts["peak_bytes"]),
    }
    coll = meta["collectives"] or {
        **{k: {"count": 0, "bytes": 0} for k in _COLLECTIVES},
        "weighted_total_bytes": 0,
        "tensor_parallel_activations": "not counted"}
    rec["collectives"] = coll
    rec["hlo_ops"] = {"fusion": 0, "while": 0}
    rec["counted"] = counts

    cfg, shp = meta["cfg"], meta["shape"]
    mf = model_flops(cfg, shp)
    rec["model_flops_total"] = mf
    rec["model_flops_per_device"] = mf / n_chips

    flops_dev = rec["flops_per_device"]
    bytes_dev = rec["bytes_per_device"]
    coll_dev = float(coll["weighted_total_bytes"])
    rec["probe"] = {"probes": 0}
    rec["flops_per_device_corrected"] = flops_dev
    rec["bytes_per_device_corrected"] = bytes_dev
    rec["collective_bytes_corrected"] = coll_dev
    rec["useful_flops_ratio"] = (mf / n_chips) / flops_dev if flops_dev else 0.0
    rec["roofline"] = roofline(flops_dev, bytes_dev, coll_dev)
    terms = rec["roofline"]
    rec["bottleneck"] = max(terms, key=terms.get)
    rec["ok"] = True
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.dryrun",
        description="count (arch x shape) cells on the meta device and "
                    "price them on the production meshes")
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--shape", required=True, choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="both")
    ap.add_argument("--rules", default="megatron", choices=tuple(sh.RULE_SETS))
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--master-weights", action="store_true")
    ap.add_argument("--remat", default="none",
                    choices=("none", "full", "dots"))
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if SHAPES[args.shape] not in valid_cells(cfg):
        rec = {"arch": args.arch, "shape": args.shape, "ok": False,
               "skipped": True,
               "reason": "cell skipped per DESIGN.md §4 (arch-applicability)"}
        print(json.dumps(rec))
        if args.out:
            with open(args.out, "w") as f:
                json.dump([rec], f, indent=1)
        return

    recs = []
    meshes = {"single": [False], "multi": [True], "both": [False, True]}
    counts = None
    for multi in meshes[args.mesh]:
        rec = run_cell(args.arch, args.shape, multi, args.rules,
                       zero1=not args.no_zero1,
                       master_weights=args.master_weights, remat=args.remat,
                       microbatch=args.microbatch, kv_quant=args.kv_quant,
                       counts=counts)
        counts = rec["counted"]
        print(json.dumps({k: rec[k] for k in
                          ("arch", "shape", "mesh", "ok", "compile_s",
                           "flops_per_device", "bottleneck")}))
        recs.append(rec)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(recs, f, indent=1)


if __name__ == "__main__":
    main()
