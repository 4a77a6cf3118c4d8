"""Nested-dict parameter trees: the port's stand-in for JAX pytrees.

Parameters, decode state and their logical axes are plain nested dicts
(and lists, as the CNN zoo's ``stages``) whose leaves are tensors (or
`models.layers.Param`s while a tree is being built). Paths join dict
keys and list indices with ``/``, as the reference checkpointer names
its arrays (``layers/attn/wq``, ``stages/0/1/b1/c1``).
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to every leaf (to the matching leaves of ``rest``,
    trees of the same structure, as further arguments); the dict and
    list structure is kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def flatten(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs in key order, list items in index order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from flatten(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree

