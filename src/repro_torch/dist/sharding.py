"""Logical-axis sharding of the port: rules, resolution, divisibility
fallback, trees — the twin of the JAX package's `dist/sharding.py`.

Models name every parameter/activation dimension with a *logical* axis
("batch", "heads", "ff", ...). A rule-set maps logical names to mesh
axes; resolution turns a tuple of logical names into a `PartitionSpec`
for a concrete mesh. The contract is the reference's:

* a rule value may be a mesh-axis name (``"model"``), a tuple of mesh-axis
  names (``("pod", "data")`` — sharded over the product), or ``None``;
* tuple rules are filtered to the axes present in the target mesh,
  preserving order (so the same rule-set works on single- and multi-pod
  meshes);
* a mesh axis is used at most once per spec — later duplicates replicate;
* unknown logical names replicate;
* ``divisible_spec`` drops any mesh axis that does not divide the concrete
  dimension (for tuples: the longest divisible prefix survives).

PyTorch has no mesh type that exists without devices, so the port brings
its own three: `PartitionSpec` (a tuple of entries), `AbstractMesh` (axis
names and sizes, no devices) and `NamedSharding` (a mesh and a spec, with
`shard_shape`). They price a layout (`launch/dryrun.py`); nothing in the
port partitions a tensor by them, as one card has nothing to shard.

``use_sharding(mesh, rules)`` installs an ambient context that
``constrain(x, *names)`` reads. Outside it ``constrain`` returns ``x``.
Inside it the spec is resolved against ``x.shape`` (a bad name count or
axis raises, as JAX would) and ``x`` is returned unchanged. The port's
models do not call ``constrain``: on one card it would be the identity.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

from repro_torch.tree import tree_map

Rule = Union[str, Tuple[str, ...], None]
Rules = Dict[str, Rule]

# ---------------------------------------------------------------------------
# rule-sets (the reference's, verbatim)
# ---------------------------------------------------------------------------
# Training default: Megatron-style tensor parallelism over "model", data
# parallelism over ("pod", "data").
MEGATRON_RULES: Rules = {
    "batch": ("pod", "data"),
    "moe_groups": ("pod", "data"),
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "experts": "model",
    "vocab": "model",
    "ssm_inner": "model",
    "ssm_heads": "model",
    "conv_dim": "model",
}

# Decode: keep the TP layout but let the (small) decode batch also absorb the
# "model" axis when divisible — at decode shapes the batch is the only large
# dimension, and the divisibility fallback drops the extra axis otherwise.
DECODE_RULES: Rules = dict(MEGATRON_RULES, batch=("pod", "data", "model"))

# Expert parallelism: experts across "model", everything else data-parallel.
EP_RULES: Rules = {
    "batch": ("pod", "data"),
    "moe_groups": ("pod", "data"),
    "experts": "model",
    "vocab": "model",
}

# Pure data parallelism: flatten every mesh axis into the batch.
DP_RULES: Rules = {
    "batch": ("pod", "data", "model"),
    "moe_groups": ("pod", "data", "model"),
}

# DP + EP hybrid (MoE without tensor parallelism).
DPEP_RULES: Rules = {
    "batch": ("pod", "data"),
    "moe_groups": ("pod", "data"),
    "experts": "model",
}

# FSDP-flavored: parameters sharded along their "embed" dim over the data
# axis (gathered on use); activations stay batch-sharded (the duplicate-axis
# rule replicates "embed" wherever "batch" already took "data").
FSDP_RULES: Rules = {
    "batch": ("pod", "data"),
    "moe_groups": ("pod", "data"),
    "embed": "data",
    "vocab": "model",
}

RULE_SETS: Dict[str, Rules] = {
    "megatron": MEGATRON_RULES, "decode": DECODE_RULES, "ep": EP_RULES,
    "dp": DP_RULES, "dpep": DPEP_RULES, "fsdp": FSDP_RULES,
}


# ---------------------------------------------------------------------------
# the layout types
# ---------------------------------------------------------------------------
class PartitionSpec(tuple):
    """One entry a dimension: ``None`` (replicated), a mesh-axis name, or
    a tuple of names (sharded over their product). Trailing dimensions
    past the spec's length are replicated. A one-name tuple is kept as
    the bare name, as JAX's `PartitionSpec` keeps it."""

    def __new__(cls, *entries: Rule):
        return super().__new__(cls, (e[0] if isinstance(e, tuple)
                                     and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class AbstractMesh:
    """A device mesh by axis names and sizes alone (no devices): what
    rule resolution and the dry run need of a mesh."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"mesh sizes {self.axis_sizes} and names "
                             f"{self.axis_names} differ in length")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh axis names {self.axis_names} repeat")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def abstract_mesh(axis_sizes: Sequence[int],
                  axis_names: Sequence[str]) -> AbstractMesh:
    return AbstractMesh(tuple(int(n) for n in axis_sizes), tuple(axis_names))


def axes_of(entry: Rule) -> Tuple[str, ...]:
    """The mesh axes a spec entry shards over, in order."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclass(frozen=True)
class NamedSharding:
    """A spec laid on a mesh."""
    mesh: AbstractMesh
    spec: PartitionSpec

    def __post_init__(self):
        seen = set()
        for entry in self.spec:
            for a in axes_of(entry):
                if a not in self.mesh.axis_names:
                    raise ValueError(f"spec {self.spec} names axis {a!r}, "
                                     f"not in mesh {self.mesh.axis_names}")
                if a in seen:
                    raise ValueError(f"spec {self.spec} uses axis {a!r} "
                                     "twice")
                seen.add(a)

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of one device's shard of a ``shape`` array; raises
        where a sharded dimension does not divide evenly."""
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} is longer than the rank "
                             f"of shape {tuple(shape)}")
        sizes = self.mesh.shape
        entries = list(self.spec) + [None] * (len(shape) - len(self.spec))
        out = []
        for dim, entry in zip(shape, entries):
            n = math.prod(sizes[a] for a in axes_of(entry))
            if dim % n:
                raise ValueError(f"dimension {dim} of {tuple(shape)} does "
                                 f"not divide over {entry} ({n} devices)")
            out.append(dim // n)
        return tuple(out)


# ---------------------------------------------------------------------------
# resolution
# ---------------------------------------------------------------------------
def logical_spec(names: Sequence[Optional[str]], rules: Rules,
                 mesh) -> PartitionSpec:
    """Resolve logical axis names to a PartitionSpec on `mesh`.

    Tuple rules keep tuple form after filtering to the mesh's axes; each
    mesh axis is consumed at most once (later claims replicate).
    """
    mesh_axes = set(mesh.axis_names)
    used: set = set()
    entries = []
    for name in names:
        rule = rules.get(name) if name is not None else None
        entry: Rule = None
        if isinstance(rule, str):
            if rule in mesh_axes and rule not in used:
                entry = rule
                used.add(rule)
        elif isinstance(rule, tuple):
            keep = tuple(a for a in rule if a in mesh_axes and a not in used)
            if keep:
                entry = keep
                used.update(keep)
        entries.append(entry)
    return PartitionSpec(*entries)


def divisible_spec(mesh, spec: PartitionSpec,
                   shape: Sequence[int]) -> PartitionSpec:
    """Drop mesh axes that do not divide the concrete dims of `shape`.

    For tuple entries the longest divisible *prefix* survives (a tuple
    shards over the product of its axes, in order). Singleton tuples
    collapse to the bare axis name.
    """
    sizes = dict(mesh.shape)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        keep = []
        prod = 1
        for a in axes_of(entry):
            if dim % (prod * sizes[a]) == 0:
                keep.append(a)
                prod *= sizes[a]
            else:
                break
        out.append(None if not keep
                   else keep[0] if len(keep) == 1 else tuple(keep))
    return PartitionSpec(*out)


def spec(names: Sequence[Optional[str]], rules: Rules, mesh,
         shape: Optional[Sequence[int]] = None) -> PartitionSpec:
    """logical_spec + (optional) divisibility fallback in one call."""
    s = logical_spec(names, rules, mesh)
    return s if shape is None else divisible_spec(mesh, s, shape)


def named_sharding(mesh, names: Sequence[Optional[str]], rules: Rules,
                   shape: Sequence[int]) -> NamedSharding:
    if len(names) > len(shape):
        raise ValueError(f"{len(names)} logical axes {tuple(names)} for a "
                         f"rank-{len(shape)} shape {tuple(shape)}")
    return NamedSharding(mesh, spec(names, rules, mesh, shape))


def tree_shardings(mesh, axes_tree, rules: Rules, specs_tree):
    """Map a tree of logical-axes tuples and a matching tree of tensors
    (any with ``.shape``: meta tensors in the dry run) to a tree of
    NamedShardings. Axes tuples are leaves of `repro_torch.tree`."""
    return tree_map(
        lambda ax, t: named_sharding(mesh, ax, rules, tuple(t.shape)),
        axes_tree, specs_tree)


# ---------------------------------------------------------------------------
# ambient context
# ---------------------------------------------------------------------------
_CTX = threading.local()


@contextlib.contextmanager
def use_sharding(mesh, rules: Rules):
    """Install (mesh, rules) as the ambient sharding context that
    `constrain` reads."""
    prev = getattr(_CTX, "active", None)
    _CTX.active = (mesh, rules)
    try:
        yield
    finally:
        _CTX.active = prev


def current_sharding() -> Optional[Tuple[Any, Rules]]:
    return getattr(_CTX, "active", None)


def constrain(x, *names: Optional[str]):
    """Outside a sharding context, ``x``. Inside one, the sharding of
    ``x`` by the logical ``names`` is resolved (raising on a name count
    longer than the rank) and ``x`` is returned: one card has nothing to
    partition."""
    ctx = current_sharding()
    if ctx is None:
        return x
    mesh, rules = ctx
    named_sharding(mesh, names, rules, tuple(x.shape))
    return x
