"""State carried across between the JAX package and the port.

The JAX package holds its state as jax arrays; the port as torch tensors.
These functions take the JAX package's arrays as numpy (np.asarray of a jax
array, or any array-like) and give the port's tensors, and back, checking
the layouts both packages share:

- the i64[C, 8] table and the i64[R, S, C, 8] sharded table;
- a staging buffer: wide i64[.., 9, W], compact i32[.., 5, W], interned
  i32[.., 2, W] with its i64[256, 2] config table, lean i32[.., W] lane
  words with their i64[128, 4] config table;
- the GLOBAL sync's GlobalConfig and GlobalMirror;
- a device-directory engine's state (carry_devdir_state);
- a sharded engine's state (carry_sharded_state): its table, each owner's
  key directory and its GLOBAL registry and mirror.

Nothing here imports JAX: a caller that has jax arrays converts them with
np.asarray first (or passes them, since np.asarray accepts them).
"""

from __future__ import annotations

import numpy as np
import torch

from gubernator_tpu_torch.ops.decide import (
    COMPACT_ROWS,
    INTERN_MAX_CFG,
    INTERN_ROWS,
    LEAN_MAX_CFG,
    TABLE_ROW_FIELDS,
)
from gubernator_tpu_torch.parallel.global_sync import GlobalConfig, GlobalMirror
from gubernator_tpu_torch.parallel.sharded import _GlobalEntry
from gubernator_tpu_torch.types import RateLimitReq
from gubernator_tpu_torch.utils.platform import resolve_device

_NP_TO_TORCH = {np.dtype(np.int64): torch.int64, np.dtype(np.int32): torch.int32,
                np.dtype(np.bool_): torch.bool}


def to_torch(a, dtype, device=None) -> torch.Tensor:
    """An array-like of exactly numpy `dtype` as a contiguous tensor on
    `device` (the card unless the caller says otherwise). The values are
    copied, never reinterpreted."""
    arr = np.ascontiguousarray(np.asarray(a))
    if arr.dtype != np.dtype(dtype):
        raise ValueError(f"expected {np.dtype(dtype)}, got {arr.dtype}")
    return torch.from_numpy(arr.copy()).to(resolve_device(device))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def table_to_torch(table, device=None) -> torch.Tensor:
    """i64[C, 8] or i64[R, S, C, 8] table -> tensor."""
    arr = np.asarray(table)
    if arr.ndim not in (2, 4) or arr.shape[-1] != TABLE_ROW_FIELDS:
        raise ValueError(f"a table is i64[C, 8] or i64[R, S, C, 8], got "
                         f"{arr.shape}")
    return to_torch(arr, np.int64, device)


def table_to_numpy(state: torch.Tensor) -> np.ndarray:
    if state.dtype != torch.int64 or state.shape[-1] != TABLE_ROW_FIELDS:
        raise ValueError(f"not a table: {state.dtype}{tuple(state.shape)}")
    return to_numpy(state)


def staging_to_torch(packed, cfg=None, device=None):
    """A staging buffer -> tensor(s). Wide is i64 with 9 rows, compact i32
    with 5 rows; lean i32 lane words and interned i32 rows (slot, meta) come
    with their config table as `cfg` (lean i64[128, 4], interned
    i64[256, 2]) and return (staging, cfg) then."""
    arr = np.asarray(packed)
    if cfg is not None:
        cfg_arr = np.asarray(cfg)
        lean = cfg_arr.shape == (LEAN_MAX_CFG, 4)
        interned = (cfg_arr.shape == (INTERN_MAX_CFG, 2) and arr.ndim >= 2
                    and arr.shape[-2] == INTERN_ROWS)
        if arr.dtype != np.int32 or not (lean or interned):
            raise ValueError("lean staging is i32 lane words plus an "
                             f"i64[{LEAN_MAX_CFG}, 4] config table; interned "
                             f"staging i32[.., {INTERN_ROWS}, W] plus an "
                             f"i64[{INTERN_MAX_CFG}, 2] one")
        return (to_torch(arr, np.int32, device),
                to_torch(cfg_arr, np.int64, device))
    if arr.dtype == np.int64 and arr.ndim >= 2 and arr.shape[-2] == 9:
        return to_torch(arr, np.int64, device)
    if arr.dtype == np.int32 and arr.ndim >= 2 and arr.shape[-2] == COMPACT_ROWS:
        return to_torch(arr, np.int32, device)
    raise ValueError(f"not a wide or compact staging buffer: "
                     f"{arr.dtype}{arr.shape}")


_CONFIG_DTYPES = dict(slot=np.int32, owner=np.int32, limit=np.int64,
                      duration=np.int64, algorithm=np.int32,
                      behavior=np.int32, greg_expire=np.int64,
                      greg_interval=np.int64, fresh=np.bool_)
_MIRROR_DTYPES = dict(status=np.int32, limit=np.int64, remaining=np.int64,
                      reset_time=np.int64)


def global_config_to_torch(cfg, device=None) -> GlobalConfig:
    """Any object with the GlobalConfig fields (the JAX package's
    GlobalConfig included) -> the port's GlobalConfig."""
    return GlobalConfig(**{f: to_torch(getattr(cfg, f), dt, device)
                           for f, dt in _CONFIG_DTYPES.items()})


def global_mirror_to_torch(mirror, device=None) -> GlobalMirror:
    return GlobalMirror(**{f: to_torch(getattr(mirror, f), dt, device)
                           for f, dt in _MIRROR_DTYPES.items()})


def fields_to_numpy(nt) -> dict:
    """{field: numpy array} of a GlobalConfig or GlobalMirror, the port's
    or the JAX package's."""
    return {f: to_numpy(v) if isinstance(v, torch.Tensor) else np.asarray(v)
            for f, v in nt._asdict().items()}


def carry_devdir_state(engine, fps, touch, table, probe_seq: int,
                       rounds_since_sweep: int) -> None:
    """Give a port DevDirEngine the state of a JAX package's DevDirEngine:
    its `fps` and `touch` columns and its table (numpy, or anything
    np.asarray takes), its `_probe_seq` epoch and its
    `_rounds_since_sweep` count. The columns are copied into the engine's
    tensors on its device. From there both engines, given the same
    requests, continue bit for bit."""
    C = engine.capacity
    fps_arr, touch_arr = np.asarray(fps), np.asarray(touch)
    if fps_arr.shape != (C,) or touch_arr.shape != (C,):
        raise ValueError(f"fps and touch must be i64[{C}], got {fps_arr.shape} "
                         f"and {touch_arr.shape}")
    if np.asarray(table).shape != (C, TABLE_ROW_FIELDS):
        raise ValueError(f"the table must be i64[{C}, {TABLE_ROW_FIELDS}], got "
                         f"{np.asarray(table).shape}")
    with engine._lock:
        engine.fps.copy_(to_torch(fps_arr, np.int64, engine.device))
        engine.touch.copy_(to_torch(touch_arr, np.int64, engine.device))
        engine.state.copy_(table_to_torch(table, engine.device))
        engine._probe_seq = int(probe_seq)
        engine._rounds_since_sweep = int(rounds_since_sweep)


_CARRY_FILLER = "\x00carry\x00"  # no request key starts with a NUL byte


def _carry_directory(directory, items) -> None:
    """Give an EMPTY native key directory the keys of `items` ((key, slot)
    pairs, most recently used first, as NativeKeyDirectory.items() lists
    them) at the same slots and in the same LRU order, with the free slots
    handed out in ascending order afterwards (the order a directory that
    never dropped a key keeps). Every slot is first taken by a filler key;
    then, oldest first, each key's filler is dropped and the key looked
    up, which takes exactly the slot just freed; the fillers of the free
    slots go last, highest slot first."""
    C = directory.capacity
    if len(directory):
        raise ValueError("carry into an empty directory")
    fill = [f"{_CARRY_FILLER}{i}" for i in range(C)]
    slots, _ = directory.lookup(fill)
    if slots != list(range(C)):
        raise RuntimeError("a fresh directory did not hand out slots 0..C-1 in order")
    used = set()
    for key, slot in reversed(list(items)):
        if not 0 <= slot < C or slot in used:
            raise ValueError(f"slot {slot} of {key!r} is outside [0, {C}) or taken twice")
        used.add(slot)
        directory.drop(fill[slot])
        got, _ = directory.lookup([key])
        if got[0] != slot:
            raise RuntimeError(f"{key!r} took slot {got[0]}, not {slot}")
    for slot in range(C - 1, -1, -1):
        if slot not in used:
            directory.drop(fill[slot])


def carry_sharded_state(engine, table, directories, globals_, gfree, gnext: int,
                        gdelta, mirror) -> None:
    """Give a FRESH port ShardedEngine the state of a JAX package's
    ShardedEngine of the same geometry:

    - `table`: its i64[R, S, C, 8] table (numpy, or anything np.asarray
      takes);
    - `directories`: each owner's (key, slot) pairs, most recently used
      first (its directories' items()); see _carry_directory for the free
      slots;
    - `globals_`: its GLOBAL registry as (key, entry) pairs in LRU order
      (its `_globals.items()`), each entry with gidx, owner, req (any
      object with the request's fields, or None), seen and last_ms;
    - `gfree`, `gnext`, `gdelta`: its free gidx list, high-water mark and
      queued hits; `mirror`: its host mirror (status, limit, remaining,
      reset_time).

    From there both engines, given the same requests, continue bit for
    bit."""
    plan = engine.plan
    want = (plan.n_regions, plan.n_shards, plan.capacity_per_shard, TABLE_ROW_FIELDS)
    if np.asarray(table).shape != want:
        raise ValueError(f"the table must be i64{list(want)}, got {np.asarray(table).shape}")
    directories = list(directories)
    if len(directories) != plan.n_owners:
        raise ValueError(f"{len(directories)} directories for {plan.n_owners} owners")
    G = engine.global_capacity
    gdelta = np.asarray(gdelta, np.int64)
    if gdelta.shape != (G,):
        raise ValueError(f"gdelta must be i64[{G}], got {gdelta.shape}")
    with engine._lock:
        engine.state.copy_(table_to_torch(table, engine.device))
        for directory, items in zip(engine.directories, directories):
            _carry_directory(directory, items)
        engine._globals.clear()
        for key, e in globals_:
            entry = _GlobalEntry(int(e.gidx), int(e.owner), int(e.last_ms))
            entry.seen = bool(e.seen)
            if e.req is not None:
                r = e.req
                entry.req = RateLimitReq(
                    name=r.name, unique_key=r.unique_key, hits=int(r.hits),
                    limit=int(r.limit), duration=int(r.duration),
                    algorithm=int(r.algorithm), behavior=int(r.behavior))
            engine._globals[key] = entry
        engine._gfree = [int(g) for g in gfree]
        engine._gnext = int(gnext)
        engine._gdelta = gdelta.copy()
        engine._mirror = GlobalMirror(**{f: np.array(getattr(mirror, f), dt)
                                         for f, dt in _MIRROR_DTYPES.items()})
