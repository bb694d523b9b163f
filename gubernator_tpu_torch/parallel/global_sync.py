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

Over a mesh plan (parallel/mesh.py make_mesh) the step runs as the JAX
package runs it on every device (global_sync.py:101-163 there): each mesh
entry holds its own table, its own i64[G] hit deltas and its own copy of
the config, and its work goes on its own stream. The deltas are
all-reduced; each entry runs the sharded decide on its own table with the
lanes it does not own set to -1; each entry's owner-masked i64[4G]
response columns are all-reduced into the mirror. "ring" is the cross-card
all-reduce (ops/ring.py ring_all_reduce_mesh, two a step as the JAX package
takes two collective ids; on the cards one launch a card, the Pallas ring's
hops summed in one pass); "psum" is the plain reference, a sum of copies
gathered onto entry 0 and copied back to every entry.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch

from gubernator_tpu_torch.ops.decide import I32, I64, WIDE, decide_sharded
from gubernator_tpu_torch.ops.ring import ring_all_reduce, ring_all_reduce_mesh
from gubernator_tpu_torch.parallel.mesh import MeshPlan, on_stream
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
    if plan.mesh is not None:
        if device is not None:
            raise ValueError("a mesh plan runs each entry's step on its own device")
        return _make_mesh_step(plan, collectives)
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


def _psum_mesh(xs: Sequence[torch.Tensor], streams) -> List[torch.Tensor]:
    """The mesh form's plain all-reduce: every entry's tensor copied onto
    entry 0 (its stream first waits for each entry's), summed there, and the
    (wrapping) sum copied back to every entry (each entry's stream waiting
    for entry 0's)."""
    s0 = streams[0]
    dev0 = xs[0].device
    with on_stream(s0):
        for st in streams[1:]:
            if st is not None:
                s0.wait_stream(st)
        total = torch.stack([x.to(dev0) for x in xs]).sum(0)
    outs = []
    for x, st in zip(xs, streams):
        with on_stream(st):
            if st is not None:
                st.wait_stream(s0)
            outs.append(total.to(x.device, copy=True))
    # entry 0's stream reuses `total` and the copies' memory only after
    # every entry has read it
    for st in streams[1:]:
        if st is not None:
            s0.wait_stream(st)
    return outs


def _make_mesh_step(plan: MeshPlan, collectives: str):
    """The step over a mesh plan (see the module's docstring). Returns
    fn(states, deltas, cfgs, now) -> (states, mirror, zeroed deltas):
    - states: one i64[1, 1, C, 8] table an entry (make_sharded_table),
      updated IN PLACE and returned;
    - deltas: one i64[G] an entry, on its device and ready on its stream;
    - cfgs: one GlobalConfig of [G] tensors an entry, on its device.
    The mirror is entry 0's, ready on entry 0's stream (every entry holds
    the same sums)."""
    n = plan.n_owners
    mesh = plan.mesh

    def step(states, deltas, cfgs, now):
        streams = mesh.streams()
        for o, dev in enumerate(mesh.entries):
            for what, t in (("state", states[o]), ("delta", deltas[o]),
                            ("cfg.slot", cfgs[o].slot)):
                if t.device != dev:
                    raise ValueError(f"entry {o}'s {what} is on {t.device}, the entry on {dev}")
        if collectives == "ring":
            totals = ring_all_reduce_mesh(deltas)
        else:
            totals = _psum_mesh(deltas, streams)
        G = deltas[0].shape[-1]
        masked = []
        for o in range(n):
            cfg = cfgs[o]
            with on_stream(streams[o]):
                mine = (cfg.owner == o) & (cfg.slot >= 0)  # my_id = region * S + shard
                packed = torch.stack([
                    torch.where(mine, cfg.slot.to(I64), -1), totals[o], cfg.limit,
                    cfg.duration, cfg.algorithm.to(I64), cfg.behavior.to(I64),
                    cfg.greg_expire, cfg.greg_interval, cfg.fresh.to(I64)])  # wide i64[9, G]
                out = decide_sharded(WIDE, states[o], packed.view(1, 1, 9, G), None, now)
                masked.append(torch.where(mine[None, :], out.view(4, G), 0).view(4 * G))
        if collectives == "ring":
            summed = ring_all_reduce_mesh(masked)
        else:
            summed = _psum_mesh(masked, streams)
        with on_stream(streams[0]):
            cols = summed[0].view(4, G)
            mirror = GlobalMirror(status=cols[0].to(I32), limit=cols[1],
                                  remaining=cols[2], reset_time=cols[3])
        zeroed = []
        for d, st in zip(deltas, streams):
            with on_stream(st):
                zeroed.append(torch.zeros_like(d))
        return states, mirror, zeroed

    return step
