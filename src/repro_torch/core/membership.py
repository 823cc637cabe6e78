"""Cluster membership views: epochs, diffs, quorum (paper §III-C).

A ClusterView is an immutable snapshot of the healthy HPC-service catalog.
The epoch increments whenever the member *set* changes — it is the version
number the elastic runtime keys resharding off.

A copy of the JAX package's core/membership.py: the port imports nothing of
that package.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Tuple

from repro_torch.core.registry import ServiceEntry

HPC_SERVICE = "hpc-node"


@dataclass(frozen=True)
class Member:
    node_id: str
    address: str
    n_devices: int
    role: str = "compute"  # head | compute

    @staticmethod
    def from_entry(e: ServiceEntry) -> "Member":
        return Member(
            node_id=e.node_id,
            address=e.address,
            n_devices=int(e.meta.get("n_devices", "1")),
            role=e.meta.get("role", "compute"),
        )


@dataclass(frozen=True)
class ClusterView:
    epoch: int
    members: Tuple[Member, ...]  # sorted by node_id

    @property
    def node_ids(self) -> FrozenSet[str]:
        return frozenset(m.node_id for m in self.members)

    @property
    def total_devices(self) -> int:
        return sum(m.n_devices for m in self.members)

    @property
    def head(self) -> Optional[Member]:
        heads = [m for m in self.members if m.role == "head"]
        return heads[0] if heads else None

    @property
    def compute(self) -> Tuple[Member, ...]:
        return tuple(m for m in self.members if m.role == "compute")

    def has_quorum(self, expected: int) -> bool:
        return len(self.members) > expected // 2


@dataclass(frozen=True)
class ViewDiff:
    joined: Tuple[str, ...]
    left: Tuple[str, ...]

    @property
    def changed(self) -> bool:
        return bool(self.joined or self.left)


def diff(old: Optional[ClusterView], new: ClusterView) -> ViewDiff:
    old_ids = old.node_ids if old else frozenset()
    return ViewDiff(
        joined=tuple(sorted(new.node_ids - old_ids)),
        left=tuple(sorted(old_ids - new.node_ids)),
    )


class ViewTracker:
    """Builds monotonically-epoched views from catalog snapshots."""

    def __init__(self):
        self._view: Optional[ClusterView] = None

    @property
    def view(self) -> Optional[ClusterView]:
        return self._view

    def update(self, entries: List[ServiceEntry]) -> Tuple[ClusterView, ViewDiff]:
        members = tuple(sorted((Member.from_entry(e) for e in entries),
                               key=lambda m: m.node_id))
        if self._view is not None and members == self._view.members:
            return self._view, ViewDiff((), ())
        epoch = (self._view.epoch + 1) if self._view else 1
        new = ClusterView(epoch=epoch, members=members)
        d = diff(self._view, new)
        self._view = new
        return new, d
