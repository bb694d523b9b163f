"""GLOBAL-behavior synchronization over the owner shards of one device.

The counterpart of the JAX package's parallel/global_sync.py, whose one
compiled step runs on every chip of a mesh. Here the R x S shards are
slices of one i64[R, S, C, 8] tensor on one device:

1. hit aggregation: every shard's local hit deltas for the registered
   global keys are all-reduced, giving the cluster-total hits per key;
2. owner apply: each shard runs the decision kernel on its own table, with
   the slot of every key it does not own set to -1 (a padding lane): one
   sharded decide for all shards (ops/decide.py decide_sharded, one launch
   on the card);
3. broadcast: each shard's response columns, masked to zero where it is
   not the owner, are stacked into one [n_owners, 4G] all-reduce whose sum
   IS the authoritative mirror;
4. the deltas come back zeroed.

`collectives` picks the all-reduce: "ring" is ops/ring.py (the CUDA ring
kernel on the card, its plain version on the CPU) and needs one region;
"psum" is a plain sum over the shard axis, the reference the ring is held
against.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from gubernator_tpu_torch.ops.decide import I32, I64, WIDE, decide_sharded
from gubernator_tpu_torch.ops.ring import ring_all_reduce
from gubernator_tpu_torch.parallel.mesh import MeshPlan
from gubernator_tpu_torch.utils.platform import resolve_device


class GlobalMirror(NamedTuple):
    """Replicated authoritative status of every registered global key."""

    status: torch.Tensor  # i32[G]
    limit: torch.Tensor  # i64[G]
    remaining: torch.Tensor  # i64[G]
    reset_time: torch.Tensor  # i64[G]


class GlobalConfig(NamedTuple):
    """Per-global-key request config, maintained by the host from the
    latest request seen."""

    slot: torch.Tensor  # i32[G] owner-shard table slot; -1 unregistered
    owner: torch.Tensor  # i32[G] linear shard index of the owner
    limit: torch.Tensor  # i64[G]
    duration: torch.Tensor  # i64[G]
    algorithm: torch.Tensor  # i32[G]
    behavior: torch.Tensor  # i32[G] (GLOBAL bit already stripped by the host)
    greg_expire: torch.Tensor  # i64[G]
    greg_interval: torch.Tensor  # i64[G]
    fresh: torch.Tensor  # bool[G] owner slot newly assigned


def _psum(x: torch.Tensor) -> torch.Tensor:
    """Every row the (wrapping) sum of all rows of x[n, L]."""
    return x.sum(0, keepdim=True).expand_as(x).clone()


def make_global_sync(plan: MeshPlan, collectives: str = "psum", device=None):
    """Build the one-step GLOBAL sync over the plan's shards.

    Returns fn(state, delta, cfg, now) -> (state, mirror, zeroed delta):
    - state: i64[R, S, C, 8] sharded table, updated IN PLACE and returned;
    - delta: i64[R, S, G] — each shard's local hit deltas;
    - cfg: GlobalConfig of [G] tensors.
    All of them must lie on the device the step was built for (the card
    unless `device` says otherwise)."""
    if collectives not in ("psum", "ring"):
        raise ValueError(f"unknown collectives '{collectives}'")
    if collectives == "ring" and plan.n_regions != 1:
        raise ValueError(
            "ring collectives support single-region plans only (the ring "
            "reduces over the shard axis; psum handles multi-region)")
    dev = resolve_device(device)
    n = plan.n_owners
    reduce = ring_all_reduce if collectives == "ring" else _psum

    def step(state: torch.Tensor, delta: torch.Tensor, cfg: GlobalConfig,
             now) -> Tuple[torch.Tensor, GlobalMirror, torch.Tensor]:
        for what, t in (("state", state), ("delta", delta), ("cfg.slot", cfg.slot)):
            if t.device != dev:
                raise ValueError(f"{what} is on {t.device}, the step on {dev}")
        G = delta.shape[-1]
        total = reduce(delta.reshape(n, G))  # [n, G], every row the sum
        packed = torch.stack([
            cfg.slot.to(I64), total[0], cfg.limit, cfg.duration,
            cfg.algorithm.to(I64), cfg.behavior.to(I64), cfg.greg_expire,
            cfg.greg_interval, cfg.fresh.to(I64)])  # wide i64[9, G]
        owners = torch.arange(n, dtype=cfg.owner.dtype, device=dev)
        mine = (cfg.owner[None, :] == owners[:, None]) & (cfg.slot >= 0)  # [n, G]
        pk = packed.expand(n, 9, G).clone()
        pk[:, 0] = torch.where(mine, pk[:, 0], -1)
        pk[:, 1] = total
        out = decide_sharded(WIDE, state, pk.view(*state.shape[:2], 9, G), None,
                             now)  # one launch for every owner
        masked = torch.where(mine[:, None, :], out.view(n, 4, G), 0).view(n, 4 * G)
        summed = reduce(masked)[0].view(4, G)
        mirror = GlobalMirror(
            status=summed[0].to(I32),
            limit=summed[1],
            remaining=summed[2],
            reset_time=summed[3],
        )
        return state, mirror, torch.zeros_like(delta)

    return step
