"""Key-table sharding over owner shards.

The counterpart of the JAX package's parallel/mesh.py. There, the slot
dimension of the key table is sharded over a 2-D mesh of chips
("region", "shard") and a key's owner chip is a hash of the key. Here the
R x S owner shards of one table live on ONE device, as slices of one
i64[R, S, C, 8] tensor; the owner hash is the same, so a key has the same
owner in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from gubernator_tpu_torch.ops.decide import I64, ROW_ALGO, TABLE_ROW_FIELDS, _VACANT
from gubernator_tpu_torch.utils.fnv import fnv1a_64_str
from gubernator_tpu_torch.utils.platform import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Shard geometry: R regions x S shards, each with its own table of
    `capacity_per_shard` rows."""

    n_shards: int
    capacity_per_shard: int
    n_regions: int = 1

    @property
    def n_owners(self) -> int:
        return self.n_regions * self.n_shards

    @property
    def capacity(self) -> int:
        return self.n_owners * self.capacity_per_shard

    def owner_coords(self, owner: int) -> Tuple[int, int]:
        """(region, shard) of a linear owner index (mesh.py:100)."""
        return divmod(owner, self.n_shards)


def shard_of_key(key: str, n_owners: int) -> int:
    """Deterministic owner (linear shard index) of a rate-limit key
    (mesh.py:123 of the JAX package)."""
    return fnv1a_64_str(key) % n_owners


def make_sharded_table(plan: MeshPlan, device=None) -> torch.Tensor:
    """Fresh vacant row table i64[R, S, C, 8] on one device (the card unless
    `device` says otherwise)."""
    state = torch.zeros(
        (plan.n_regions, plan.n_shards, plan.capacity_per_shard,
         TABLE_ROW_FIELDS), dtype=I64, device=resolve_device(device))
    state[..., ROW_ALGO] = _VACANT
    return state
