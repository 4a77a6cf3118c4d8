"""Elastic membership for transient clusters (§V) — a copy of the JAX
package's `dist/elastic.py` (standard library only).

A training run on revocable servers is a sequence of *membership epochs*:
the member set is fixed within an epoch and rolls on every revocation or
join. The global batch is an invariant of the run — each epoch re-splits it
across the surviving members (the paper's data-parallel recovery semantics:
no data is dropped or duplicated across a membership change).

`ElasticMembership` is pure bookkeeping — the trainer drives it from its
event stream, the fleet simulator from sampled revocations.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Tuple


@dataclasses.dataclass(frozen=True)
class Member:
    """One worker: a transient accelerator server."""
    id: int
    gpu: str = "v5e"


@dataclasses.dataclass(frozen=True)
class Epoch:
    """An immutable membership epoch: who is in it and how the global batch
    is split across them (first members absorb the remainder)."""
    number: int
    members: Tuple[Member, ...]
    batch_of: Dict[int, int]


def split_batch(global_batch: int, member_ids: List[int]) -> Dict[int, int]:
    """Even split of `global_batch` with the remainder spread over the
    first members; always sums to `global_batch`."""
    n = len(member_ids)
    if n == 0:
        return {}
    per, rem = divmod(global_batch, n)
    return {mid: per + (1 if i < rem else 0)
            for i, mid in enumerate(member_ids)}


class ElasticMembership:
    """Mutable membership state; every revoke/join rolls the epoch."""

    def __init__(self, members: Iterable[Member], global_batch: int):
        self._members: Dict[int, Member] = {m.id: m for m in members}
        self.global_batch = int(global_batch)
        self.epoch_no = 0
        # launch-roster size: the denominator of the quorum fraction a
        # DegradationPolicy tiers on (replacement joins restore it toward
        # 1.0; over-joins may push it above — both are meaningful)
        self.roster_size = max(1, len(self._members))

    # ------------------------------------------------------------- queries
    @property
    def n_alive(self) -> int:
        return len(self._members)

    @property
    def alive_fraction(self) -> float:
        return self.n_alive / self.roster_size

    def __contains__(self, member_id: int) -> bool:
        return member_id in self._members

    def alive(self) -> Tuple[Member, ...]:
        return tuple(self._members.values())

    def current_epoch(self) -> Epoch:
        return Epoch(self.epoch_no, self.alive(),
                     split_batch(self.global_batch, list(self._members)))

    # ------------------------------------------------------------- events
    def revoke(self, member_id: int) -> Epoch:
        if member_id not in self._members:
            raise KeyError(f"member {member_id} is not in the cluster")
        del self._members[member_id]
        self.epoch_no += 1
        return self.current_epoch()

    def join(self, member: Member) -> Epoch:
        if member.id in self._members:
            raise KeyError(f"member {member.id} already in the cluster")
        self._members[member.id] = member
        self.epoch_no += 1
        return self.current_epoch()
