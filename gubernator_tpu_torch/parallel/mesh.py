"""Key-table sharding over owner shards, in two placements.

The counterpart of the JAX package's parallel/mesh.py. There, the slot
dimension of the key table is sharded over a 2-D mesh of chips
("region", "shard") and a key's owner chip is a hash of the key. Here a
MeshPlan places the R x S owners in one of two ways:

- with no mesh, the owners are slices of ONE i64[R, S, C, 8] tensor on one
  device, and each kernel launches once for all of them (its owner grid
  dimension);
- with a mesh (make_mesh: an R x S grid of torch devices, one owner a
  cell, as the JAX package puts one shard on each device), each mesh entry
  holds its own vacant i64[1, 1, C, 8] table on its own device and its own
  stream, and each kernel launches once an entry. A device may repeat: four
  entries that all name cuda:0 run the code that four distinct cards run,
  each on its own stream, but for the cross-card all-reduce, which
  launches once a card (ops/ring.py): it sums entries that share a card in
  one pass through local pointers, and reads the other cards' entries
  through peer pointers behind flags in peer memory.

The owner hash is the same in both placements and both packages, so a key
has the same owner everywhere; owner o is mesh entry o (row-major, as the
JAX package's my_id = region * S + shard).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from gubernator_tpu_torch.ops.decide import I64, ROW_ALGO, TABLE_ROW_FIELDS, _VACANT
from gubernator_tpu_torch.ops.ring import entry_streams
from gubernator_tpu_torch.utils.fnv import fnv1a_64_str
from gubernator_tpu_torch.utils.platform import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An R x S grid of devices, one owner a cell (the port's counterpart of
    a jax.sharding.Mesh over ("region", "shard")). A device may repeat."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def n_regions(self) -> int:
        return len(self.devices)

    @property
    def n_shards(self) -> int:
        return len(self.devices[0])

    @property
    def shape(self) -> Tuple[int, int]:
        return self.n_regions, self.n_shards

    @property
    def entries(self) -> Tuple[torch.device, ...]:
        """The devices in owner order (row-major)."""
        return tuple(d for row in self.devices for d in row)

    def streams(self) -> Tuple[Optional[torch.cuda.Stream], ...]:
        """One stream an entry on the cards, made at first use and shared by
        every user of the same cards in the same order; None for an entry
        on the CPU, whose work runs in order as it is called."""
        ents = self.entries
        if all(d.type == "cpu" for d in ents):
            return (None,) * len(ents)
        if any(d.type == "cpu" for d in ents):
            raise ValueError("a mesh lies on the cards or on the CPU, not on both")
        return entry_streams([d.index for d in ents])


def _mesh_device(d: Union[str, torch.device]) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda":
        return torch.device("cuda", 0 if dev.index is None else dev.index)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: expected cuda or cpu")
    return dev


def make_mesh(n_shards: Optional[int] = None, n_regions: int = 1,
              devices: Optional[Sequence[Union[str, torch.device]]] = None) -> Mesh:
    """The (region, shard) mesh over `devices` (mesh.py:104 of the JAX
    package): by default every visible card; "cpu" entries for the CPU. A
    device may appear more than once. Nothing on a card is touched."""
    if devices is None:
        n = torch.cuda.device_count()
        if not n:
            raise RuntimeError("no card is visible; pass devices= (torch.device('cpu') "
                               "entries run the plain PyTorch versions on the CPU)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [_mesh_device(d) for d in devices]
    if n_shards is None:
        if len(devices) % n_regions:
            raise ValueError(f"{len(devices)} devices not divisible into {n_regions} regions")
        n_shards = len(devices) // n_regions
    need = n_regions * n_shards
    if need < 1:
        raise ValueError(f"a mesh needs at least one entry, got {n_regions} x {n_shards}")
    if need > len(devices):
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return Mesh(tuple(tuple(devices[r * n_shards:(r + 1) * n_shards])
                      for r in range(n_regions)))


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Shard geometry: R regions x S shards, each with its own table of
    `capacity_per_shard` rows; with `mesh`, each owner on its mesh entry."""

    n_shards: int
    capacity_per_shard: int
    n_regions: int = 1
    mesh: Optional[Mesh] = None

    def __post_init__(self):
        if self.mesh is not None and self.mesh.shape != (self.n_regions, self.n_shards):
            raise ValueError(f"the mesh is {self.mesh.shape}, the plan "
                             f"{(self.n_regions, self.n_shards)}")

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


def on_stream(stream: Optional[torch.cuda.Stream]):
    """The context that makes `stream` current (None: the CPU, nothing)."""
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)


def make_sharded_table(plan: MeshPlan, device=None) -> Union[torch.Tensor, List[torch.Tensor]]:
    """Fresh vacant rows. With no mesh: one i64[R, S, C, 8] tensor on one
    device (the card unless `device` says otherwise). With a mesh: a list,
    in owner order, of one i64[1, 1, C, 8] table an entry, each made on its
    entry's device and stream (so the entry's later launches come after
    it); `device` must then be None."""
    if plan.mesh is None:
        state = torch.zeros(
            (plan.n_regions, plan.n_shards, plan.capacity_per_shard,
             TABLE_ROW_FIELDS), dtype=I64, device=resolve_device(device))
        state[..., ROW_ALGO] = _VACANT
        return state
    if device is not None:
        raise ValueError("a mesh plan places each table on its entry's device")
    tables = []
    for dev, stream in zip(plan.mesh.entries, plan.mesh.streams()):
        with on_stream(stream):
            t = torch.zeros((1, 1, plan.capacity_per_shard, TABLE_ROW_FIELDS), dtype=I64,
                            device=dev)
            t[..., ROW_ALGO] = _VACANT
        tables.append(t)
    return tables


def mesh_tables_numpy(tables: Sequence[torch.Tensor], streams, n_regions: int,
                      n_shards: int, field: Optional[int] = None) -> np.ndarray:
    """The mesh form's tables on the host as one i64[R, S, C, 8] array (or
    i64[R, S, C] of one `field`), each entry read on its own stream once its
    work there is done."""
    parts = []
    for t, stream in zip(tables, streams):
        with on_stream(stream):
            parts.append((t[0, 0] if field is None else t[0, 0, :, field]).cpu().numpy())
    return np.stack(parts).reshape(n_regions, n_shards, *parts[0].shape)
