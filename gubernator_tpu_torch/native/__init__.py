"""The C++ key directory (native/keydir.cpp), loaded through ctypes.

keydir.cpp is a byte-for-byte copy of the JAX package's, so both packages'
directories assign the same slots to the same key stream, LRU recycling at
a full table included. This module binds the parts the engine uses:

- NativeKeyDirectory: the open-addressing LRU map key -> slot, with the row
  mirrors of the lone-request path (decide_one, mirror_seed, mirror_flush)
  and the packed-arena calls of the binary snapshot (items_raw,
  peek_slots_raw, lookup_raw);
- prep_pack_fast: the one-pass window prep (validate, first-occurrence
  round split, directory lookup and pack of the wide staging rows in one C
  call over the request objects);
- prep_pack_columnar: the same pass over the peerlink wire columns, with
  the GIL released;
- prep_pack_interned and prep_pack_lean: that pass emitting the interned
  (i32[2, W] + an i64[256, 2] config table) and lean (i32[W] + i64[128, 4])
  staging formats, their config tables kept across windows in an
  InternPrepState / LeanPrepState;
- prep_route_sharded and prep_route_columnar: the sharded engine's
  one-pass prep, which also routes each lane to its owner shard and looks
  it up in that owner's directory, over request objects or wire columns;
- fingerprint_batch: the device directory's 63-bit key fingerprints, and
  owner_batch: the owner shard of each key;
- make_key_directory: the engine's factory.

The library is built by g++ at first use into _build/ (ops/_build.py). The
JAX package falls back to the python directory when the build fails; this
one raises, so a missing fast window never goes unseen. Only GUBER_NO_NATIVE
picks the python directory.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from gubernator_tpu_torch.ops import _build

_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_PYLIB: Optional[ctypes.PyDLL] = None


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the native library; raises RuntimeError
    with the compiler's output on failure."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        lib = _build.load("keydir")
        c = ctypes
        lib.keydir_new.restype = c.c_void_p
        lib.keydir_new.argtypes = [c.c_int64]
        lib.keydir_free.restype = None
        lib.keydir_free.argtypes = [c.c_void_p]
        lib.keydir_lookup_batch.restype = c.c_int64
        lib.keydir_lookup_batch.argtypes = [
            c.c_void_p, c.c_char_p, c.c_void_p, c.c_int32, c.c_void_p,
            c.c_void_p, c.c_void_p, c.c_void_p,
        ]
        lib.keydir_mirror_seed.restype = None
        lib.keydir_mirror_seed.argtypes = [
            c.c_void_p, c.c_char_p, c.c_int32, c.c_void_p,
        ]
        lib.keydir_decide_one.restype = c.c_int32
        lib.keydir_decide_one.argtypes = [
            c.c_void_p, c.c_char_p, c.c_int32, c.c_int64, c.c_int64,
            c.c_int64, c.c_int32, c.c_int32, c.c_int64, c.c_void_p,
        ]
        lib.keydir_mirror_flush.restype = c.c_int32
        lib.keydir_mirror_flush.argtypes = [
            c.c_void_p, c.c_void_p, c.c_int32,
        ]
        lib.keydir_drop.restype = None
        lib.keydir_drop.argtypes = [c.c_void_p, c.c_char_p, c.c_int32]
        lib.keydir_peek.restype = c.c_int32
        lib.keydir_peek.argtypes = [c.c_void_p, c.c_char_p, c.c_int32]
        lib.keydir_dump.restype = c.c_int64
        lib.keydir_dump.argtypes = [
            c.c_void_p, c.c_void_p, c.c_int64, c.c_void_p, c.c_void_p, c.c_int64,
        ]
        lib.keydir_peek_batch.restype = c.c_int64
        lib.keydir_peek_batch.argtypes = [
            c.c_void_p, c.c_char_p, c.c_void_p, c.c_int64, c.c_void_p,
        ]
        lib.keydir_size.restype = c.c_int64
        lib.keydir_size.argtypes = [c.c_void_p]
        lib.keydir_evictions.restype = c.c_int64
        lib.keydir_evictions.argtypes = [c.c_void_p]
        lib.keydir_prep_pack_columnar.restype = c.c_int32
        lib.keydir_prep_pack_columnar.argtypes = [
            c.c_void_p, c.c_int32, c.c_char_p, c.c_void_p, c.c_void_p,
            c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
            c.c_int64, c.c_void_p, c.c_int32, c.c_void_p, c.c_void_p,
            c.c_void_p, c.c_void_p, c.c_void_p,
        ]
        lib.keydir_intern_max_cfg.restype = c.c_int64
        lib.keydir_intern_max_cfg.argtypes = []
        lib.keydir_intern_hash_slots.restype = c.c_int64
        lib.keydir_intern_hash_slots.argtypes = []
        lib.keydir_prep_pack_interned.restype = c.c_int32
        lib.keydir_prep_pack_interned.argtypes = [
            # kd, n, keys, key_off, name_len, hits, limit, duration,
            # algorithm, behavior, slow_mask, iw, width, cfg, n_cfg,
            # cfg_hash, lane_item, leftover, n_leftover_out, inject,
            # n_inject: 21 parameters
            c.c_void_p, c.c_int32, c.c_char_p, c.c_void_p, c.c_void_p,
            c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
            c.c_int64, c.c_void_p, c.c_int32, c.c_void_p, c.c_void_p,
            c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
            c.c_void_p,
        ]
        lib.keydir_lean_max_cfg.restype = c.c_int64
        lib.keydir_lean_max_cfg.argtypes = []
        lib.keydir_lean_hash_slots.restype = c.c_int64
        lib.keydir_lean_hash_slots.argtypes = []
        # the same 21 parameters (iw i32[width], cfg i64[128, 4], cfg_hash
        # i32[512])
        lib.keydir_prep_pack_lean.restype = c.c_int32
        lib.keydir_prep_pack_lean.argtypes = list(lib.keydir_prep_pack_interned.argtypes)
        lib.fnv1a_fingerprint_batch.restype = None
        lib.fnv1a_fingerprint_batch.argtypes = [
            c.c_char_p, c.c_void_p, c.c_int32, c.c_void_p,
        ]
        lib.fnv1a_owner_batch.restype = None
        lib.fnv1a_owner_batch.argtypes = [
            c.c_char_p, c.c_void_p, c.c_int32, c.c_int32, c.c_void_p,
        ]
        # pure C, no CPython API: the CDLL releases the GIL for the pass
        lib.keydir_prep_route_columnar.restype = c.c_int32
        lib.keydir_prep_route_columnar.argtypes = [
            c.c_void_p, c.c_int32, c.c_int32, c.c_char_p, c.c_void_p,
            c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
            c.c_void_p, c.c_int64, c.c_void_p, c.c_void_p, c.c_void_p,
            c.c_void_p, c.c_void_p,
        ]
        _LIB = lib
        return lib


def load_pydll() -> ctypes.PyDLL:
    """The same library via PyDLL: calls hold the GIL, as the prep pass over
    request objects requires."""
    global _PYLIB
    load_library()
    with _LIB_LOCK:
        if _PYLIB is None:
            c = ctypes
            lib = ctypes.PyDLL(str(_build.library_path("keydir")))
            lib.keydir_prep_pack_fast.restype = c.c_int32
            lib.keydir_prep_pack_fast.argtypes = [
                c.c_void_p, c.py_object, c.c_void_p, c.c_int32, c.c_int64,
                c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
            ]
            lib.keydir_prep_route_sharded.restype = c.c_int32
            lib.keydir_prep_route_sharded.argtypes = [
                c.c_void_p, c.c_int32, c.py_object, c.c_int64,
                c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
            ]
            _PYLIB = lib
        return _PYLIB


# prep_pack_fast return codes (keydir.cpp)
PREP_FALLBACK = -1
PREP_OVERCOMMIT = -2


def _inject_out(inject: Optional[np.ndarray], n: int) -> np.ndarray:
    """Where the C call writes up to n dirty-mirror rows: the caller's
    array (a C-contiguous i64[R, 8] with R >= n, checked), or a new
    i64[n, 8]."""
    if inject is None:
        return np.empty((n, 8), np.int64)
    if (inject.dtype != np.int64 or inject.ndim != 2 or inject.shape[1] != 8
            or inject.shape[0] < n or not inject.flags.c_contiguous):
        raise ValueError(f"inject must be a C-contiguous i64[>= {n}, 8], got "
                         f"{inject.dtype}{inject.shape}")
    return inject


def prep_pack_fast(directory: "NativeKeyDirectory", requests,
                   packed: np.ndarray, greg_mask: int,
                   inject: Optional[np.ndarray] = None):
    """One-pass native window prep: validate + first-occurrence round split
    + directory lookup + pack in one C call. `packed` must be a zeroed
    C-contiguous i64[9, width]. The inject rows are written into `inject`
    when given (a C-contiguous i64[R, 8] of at least min(len(requests),
    width) rows: the engine's page-locked staging), else into a new array;
    either way the returned `inject` is a view of the first rows.

    Returns (n0, lane_item, leftover, inject): n0 lanes packed (lane j
    answers requests[lane_item[j]]), with `leftover` the item indices the
    python pipeline must run AFTER this round (invalid / gregorian /
    duplicate occurrences) and `inject` the i64[m, 8] dirty-mirror rows
    (slot + 7 row values) the engine must scatter into the device table
    BEFORE this window decides. n0 is PREP_FALLBACK or PREP_OVERCOMMIT on
    the non-sequence/oversize and over-commit paths; an over-commit may
    abort mid-lookup with mirror rows already collected (their flags
    cleared), so `inject` comes back then too."""
    if (packed.dtype != np.int64 or packed.ndim != 2 or packed.shape[0] != 9
            or not packed.flags.c_contiguous):
        raise ValueError(f"packed must be a C-contiguous i64[9, width], got "
                         f"{packed.dtype}{packed.shape}")
    lib = load_pydll()
    width = packed.shape[1]
    n = len(requests)
    lane_item = np.empty(width, np.int32)
    leftover = np.empty(n, np.int32)
    n_left = np.zeros(1, np.int32)
    inject = _inject_out(inject, min(n, width))  # C writes none past `width` lanes
    n_inj = np.zeros(1, np.int32)
    n0 = lib.keydir_prep_pack_fast(
        directory._kd, requests, packed.ctypes.data, width, greg_mask,
        lane_item.ctypes.data, leftover.ctypes.data, n_left.ctypes.data,
        inject.ctypes.data, n_inj.ctypes.data,
    )
    if n0 < 0:
        return n0, None, None, inject[:int(n_inj[0])]
    return (n0, lane_item[:n0], leftover[:int(n_left[0])],
            inject[:int(n_inj[0])])


def prep_pack_columnar(directory: "NativeKeyDirectory", n: int,
                       keys, key_off, name_len, hits, limit, duration,
                       algorithm, behavior, slow_mask: int,
                       packed: np.ndarray, inject: Optional[np.ndarray] = None):
    """Columnar one-pass window prep: the peerlink wire columns straight
    into the wide staging rows, no RateLimitReq objects. The C pass runs
    without the GIL (the CDLL releases it around the call).

    `keys` is the name+unique_key byte arena (bytes or a ctypes buffer);
    key_off i32[>= n+1]; name_len, algorithm, behavior i32[n]; hits, limit,
    duration i64[n]; `packed` a zeroed C-contiguous i64[9, width]; lanes
    whose behavior has a bit of `slow_mask` come back as leftover. `inject`
    is prep_pack_fast's: the caller's i64[R, 8] with R >= min(n, width),
    or None for a new array.

    Returns (n0, lane_item, leftover, inject) like prep_pack_fast."""
    if (packed.dtype != np.int64 or packed.ndim != 2 or packed.shape[0] != 9
            or not packed.flags.c_contiguous):
        raise ValueError(f"packed must be a C-contiguous i64[9, width], got "
                         f"{packed.dtype}{packed.shape}")
    lib = load_library()
    width = packed.shape[1]
    lane_item = np.empty(width, np.int32)
    leftover = np.empty(n, np.int32)
    n_left = np.zeros(1, np.int32)
    inject = _inject_out(inject, min(n, width))  # C writes none past `width` lanes
    n_inj = np.zeros(1, np.int32)
    n0 = lib.keydir_prep_pack_columnar(
        directory._kd, n, keys,
        key_off.ctypes.data, name_len.ctypes.data, hits.ctypes.data,
        limit.ctypes.data, duration.ctypes.data, algorithm.ctypes.data,
        behavior.ctypes.data, slow_mask, packed.ctypes.data, width,
        lane_item.ctypes.data, leftover.ctypes.data, n_left.ctypes.data,
        inject.ctypes.data, n_inj.ctypes.data,
    )
    if n0 < 0:
        return n0, None, None, inject[:int(n_inj[0])]
    return (n0, lane_item[:n0], leftover[:int(n_left[0])],
            inject[:int(n_inj[0])])


# keydir_prep_pack_interned / _lean: the window needs more distinct configs
# than the config table holds; the directory and the config state are
# untouched, and the caller re-preps the window through prep_pack_columnar
PREP_CFG_OVERFLOW = -3
# keydir_prep_pack_lean: the directory's capacity exceeds the 24-bit lane
# field (the caller skipped ops/decide.py lean_capacity_ok); checked before
# the lookup, so the directory and config state are untouched
PREP_SLOT_WIDE = -4


class InternPrepState:
    """Caller-owned state of the interned columnar prep, kept across
    windows: the i64[256, 2] (limit, duration) config table the device
    receives, its fill count, and the C side's find-or-insert map. The
    sizes come from the C side's constants."""

    def __init__(self):
        lib = load_library()
        self.cfg = np.zeros((lib.keydir_intern_max_cfg(), 2), np.int64)
        self._n_cfg = np.zeros(1, np.int32)
        self._hash = np.zeros((lib.keydir_intern_hash_slots(), 2), np.int64)

    @property
    def n_cfg(self) -> int:
        return int(self._n_cfg[0])


class LeanPrepState:
    """Caller-owned state of the lean columnar prep: the i64[128, 4]
    (limit, duration, algorithm, behavior) config table, its fill count,
    and the C side's find-or-insert map (i32[512] of id + 1)."""

    def __init__(self):
        lib = load_library()
        self.cfg = np.zeros((lib.keydir_lean_max_cfg(), 4), np.int64)
        self._n_cfg = np.zeros(1, np.int32)
        self._hash = np.zeros(lib.keydir_lean_hash_slots(), np.int32)

    @property
    def n_cfg(self) -> int:
        return int(self._n_cfg[0])


def _prep_pack_cfg(fn, width: int, directory: "NativeKeyDirectory", n: int,
                   keys, key_off, name_len, hits, limit, duration,
                   algorithm, behavior, slow_mask: int, iw: np.ndarray,
                   state, inject: Optional[np.ndarray] = None):
    """The call shared by the two config-interning preps: only the C
    entry point, the staging's width and the state differ. Returns
    (n0, lane_item, leftover, inject) like prep_pack_columnar."""
    if iw.dtype != np.int32 or not iw.flags.c_contiguous:
        raise ValueError(f"iw must be a C-contiguous int32 array, got {iw.dtype}")
    lane_item = np.empty(width, np.int32)
    leftover = np.empty(n, np.int32)
    n_left = np.zeros(1, np.int32)
    inject = _inject_out(inject, min(n, width))
    n_inj = np.zeros(1, np.int32)
    n0 = fn(
        directory._kd, n, keys,
        key_off.ctypes.data, name_len.ctypes.data, hits.ctypes.data,
        limit.ctypes.data, duration.ctypes.data, algorithm.ctypes.data,
        behavior.ctypes.data, slow_mask, iw.ctypes.data, width,
        state.cfg.ctypes.data, state._n_cfg.ctypes.data,
        state._hash.ctypes.data,
        lane_item.ctypes.data, leftover.ctypes.data, n_left.ctypes.data,
        inject.ctypes.data, n_inj.ctypes.data,
    )
    if n0 < 0:
        return n0, None, None, inject[:int(n_inj[0])]
    return (n0, lane_item[:n0], leftover[:int(n_left[0])],
            inject[:int(n_inj[0])])


def prep_pack_interned(directory: "NativeKeyDirectory", n: int,
                       keys, key_off, name_len, hits, limit, duration,
                       algorithm, behavior, slow_mask: int,
                       iw: np.ndarray, state: InternPrepState,
                       inject: Optional[np.ndarray] = None):
    """Columnar one-pass prep emitting the interned staging format
    (ops/decide.py decide_packed_interned): `iw` is i32[2, width], every
    lane written (no zeroing needed); `state` keeps the config table across
    windows. Lanes the format cannot carry go to `leftover`; a window that
    needs more than 256 distinct configs returns PREP_CFG_OVERFLOW with the
    directory and config state untouched (the caller re-preps that window
    through prep_pack_columnar). `inject` as in prep_pack_columnar.

    Returns (n0, lane_item, leftover, inject) like prep_pack_columnar."""
    if iw.ndim != 2 or iw.shape[0] != 2:
        raise ValueError(f"iw must be i32[2, width], got {iw.shape}")
    lib = load_library()
    return _prep_pack_cfg(
        lib.keydir_prep_pack_interned, iw.shape[1], directory, n, keys,
        key_off, name_len, hits, limit, duration, algorithm, behavior,
        slow_mask, iw, state, inject)


def prep_pack_lean(directory: "NativeKeyDirectory", n: int,
                   keys, key_off, name_len, hits, limit, duration,
                   algorithm, behavior, slow_mask: int,
                   iw: np.ndarray, state: LeanPrepState,
                   inject: Optional[np.ndarray] = None):
    """Columnar one-pass prep emitting the lean staging format
    (ops/decide.py decide_packed_lean): `iw` is i32[width], one word a
    lane, every lane written; `state` keeps the config table. Lanes the
    format cannot carry (hits != 1, out-of-range values, slow-mask
    behaviors) go to `leftover`; more than 128 distinct configs returns
    PREP_CFG_OVERFLOW, a directory past 24-bit slots PREP_SLOT_WIDE, each
    with the directory and config state untouched.

    Returns (n0, lane_item, leftover, inject) like prep_pack_columnar."""
    if iw.ndim != 1:
        raise ValueError(f"iw must be i32[width], got {iw.shape}")
    lib = load_library()
    return _prep_pack_cfg(
        lib.keydir_prep_pack_lean, iw.shape[0], directory, n, keys,
        key_off, name_len, hits, limit, duration, algorithm, behavior,
        slow_mask, iw, state, inject)


def _route_out(n: int, n_owners: int):
    """The output arrays of the two routing preps: cols i64[9, n] (zeroed),
    lane_item i32[n], owner_count i32[n_owners], leftover i32[n] and its
    count."""
    return (np.zeros((9, n), np.int64), np.empty(n, np.int32),
            np.empty(n_owners, np.int32), np.empty(n, np.int32),
            np.zeros(1, np.int32))


def _route_result(n0, cols, lane_item, owner_count, leftover, n_left):
    if n0 < 0:
        return n0, None, None, None, None
    return (n0, cols, lane_item[:n0], owner_count, leftover[:int(n_left[0])])


def prep_route_sharded(directories, requests, greg_mask: int):
    """The sharded one-pass window prep over request objects: validate,
    first-occurrence split, owner routing (fnv1a % n_owners) and each
    owner's directory lookup in one C call (keydir_prep_route_sharded).

    Returns (n0, cols, lane_item, owner_count, leftover): `cols` is
    i64[9, len(requests)] with the first n0 lanes owner-major in the wide
    staging row order (rows 6 and 7 zero); lane j answers
    requests[lane_item[j]]; owner o owns the owner_count[o] lanes at
    offset sum(owner_count[:o]); `leftover` are the item indices the python
    pipeline runs AFTER this round (invalid, lanes with a bit of
    `greg_mask`, duplicate occurrences). n0 is PREP_FALLBACK or
    PREP_OVERCOMMIT on those paths, and the rest None then."""
    lib = load_pydll()
    n, n_owners = len(requests), len(directories)
    handles = (ctypes.c_void_p * n_owners)(*[d._kd for d in directories])
    out = _route_out(n, n_owners)
    cols, lane_item, owner_count, leftover, n_left = out
    n0 = lib.keydir_prep_route_sharded(
        handles, n_owners, requests, greg_mask, cols.ctypes.data,
        lane_item.ctypes.data, owner_count.ctypes.data, leftover.ctypes.data,
        n_left.ctypes.data)
    return _route_result(n0, *out)


def prep_route_columnar(directories, n: int, keys, key_off, name_len,
                        hits, limit, duration, algorithm, behavior,
                        slow_mask: int):
    """prep_route_sharded over the peerlink wire columns (prep_pack_columnar's
    layout), with the GIL released. Lanes whose behavior has a bit of
    `slow_mask` come back as leftover. Returns prep_route_sharded's tuple."""
    lib = load_library()
    n_owners = len(directories)
    handles = (ctypes.c_void_p * n_owners)(*[d._kd for d in directories])
    out = _route_out(n, n_owners)
    cols, lane_item, owner_count, leftover, n_left = out
    n0 = lib.keydir_prep_route_columnar(
        handles, n_owners, n, keys, key_off.ctypes.data, name_len.ctypes.data,
        hits.ctypes.data, limit.ctypes.data, duration.ctypes.data,
        algorithm.ctypes.data, behavior.ctypes.data, slow_mask,
        cols.ctypes.data, lane_item.ctypes.data, owner_count.ctypes.data,
        leftover.ctypes.data, n_left.ctypes.data)
    return _route_result(n0, *out)


def owner_batch(keys: Sequence[str], n_owners: int) -> np.ndarray:
    """i32[n]: fnv1a64(key) % n_owners for each key, in C (the batch form
    of parallel/mesh.py shard_of_key)."""
    lib = load_library()
    data, offsets = _pack_keys(keys)
    out = np.empty(len(keys), np.int32)
    lib.fnv1a_owner_batch(data, offsets.ctypes.data, len(keys), n_owners,
                          out.ctypes.data)
    return out


def _pack_keys(keys: Sequence[str]) -> Tuple[bytes, np.ndarray]:
    """Concatenate utf-8 keys; offsets[n+1] int64. When the joined text is
    pure ASCII, character counts are byte counts and no per-key encode is
    needed."""
    n = len(keys)
    joined = "".join(keys)
    data = joined.encode("utf-8")
    offsets = np.zeros(n + 1, np.int64)
    if len(data) == len(joined):
        lens = np.fromiter(map(len, keys), np.int64, count=n)
    else:
        blobs = [k.encode("utf-8") for k in keys]
        data = b"".join(blobs)
        lens = np.fromiter(map(len, blobs), np.int64, count=n)
    np.cumsum(lens, out=offsets[1:])
    return data, offsets


def fingerprint_batch(keys: Sequence[str]) -> np.ndarray:
    """i64[n]: the 63-bit nonzero fingerprints of `keys` for the device
    directory (ops/devdir.py key_fingerprint, in C)."""
    lib = load_library()
    data, offsets = _pack_keys(keys)
    out = np.empty(len(keys), np.int64)
    lib.fnv1a_fingerprint_batch(data, offsets.ctypes.data, len(keys), out.ctypes.data)
    return out


class NativeKeyDirectory:
    """The python KeyDirectory's contract (models/keyspace.py) over the C++
    open-addressing LRU table, plus the row mirrors."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._lib = load_library()
        self._kd = self._lib.keydir_new(capacity)
        if not self._kd:
            raise MemoryError("keydir_new failed")

    def __del__(self):
        kd = getattr(self, "_kd", None)
        if kd:
            self._lib.keydir_free(kd)
            self._kd = None

    def __len__(self) -> int:
        return int(self._lib.keydir_size(self._kd))

    def __contains__(self, key: str) -> bool:
        return self.peek_slot(key) >= 0

    @property
    def evictions(self) -> int:
        return int(self._lib.keydir_evictions(self._kd))

    def lookup(self, keys: Sequence[str]) -> Tuple[List[int], List[bool]]:
        slots, fresh, _inject = self.lookup_inject(keys)
        return slots, fresh

    def lookup_inject(self, keys: Sequence[str], inject: Optional[np.ndarray] = None):
        """lookup() + the dirty-mirror rows (i64[m, 8]: slot + 7 row
        values) that must be scattered into the device table BEFORE the
        window these slots feed. The rows are written into `inject` when
        given (a C-contiguous i64[R, 8], R >= len(keys)), else into a new
        array; the returned rows are a view of its first m."""
        data, offsets = _pack_keys(keys)
        n = len(keys)
        slots = np.empty(n, np.int32)
        fresh = np.empty(n, np.uint8)
        inject = _inject_out(inject, n)
        n_inj = np.zeros(1, np.int32)
        done = self._lib.keydir_lookup_batch(
            self._kd, data, offsets.ctypes.data, n,
            slots.ctypes.data, fresh.ctypes.data,
            inject.ctypes.data, n_inj.ctypes.data,
        )
        if done != n:
            raise RuntimeError(
                f"key directory over-committed: >{self.capacity} distinct "
                "keys in one lookup"
            )
        return (slots.tolist(), fresh.astype(bool).tolist(),
                inject[:int(n_inj[0])])

    def mirror_seed(self, key: str, row7: Sequence[int]) -> None:
        """Install a device row copy as the key's mirror; decide_one then
        serves the key natively until a batch lookup invalidates it."""
        b = key.encode("utf-8")
        row = np.ascontiguousarray(row7, np.int64)  # no copy for an i64[7]
        if row.shape != (7,):
            raise ValueError(f"a mirror row has 7 fields, got {row.shape}")
        self._lib.keydir_mirror_seed(self._kd, b, len(b), row.ctypes.data)

    def mirror_flush(self, max_rows: int = 4096) -> np.ndarray:
        """Drain dirty mirrors: returns i64[m, 8] reconciliation rows
        (callers loop until empty)."""
        inject = np.empty((max_rows, 8), np.int64)
        m = self._lib.keydir_mirror_flush(
            self._kd, inject.ctypes.data, max_rows)
        return inject[:m]

    def decide_one(self, key: str, hits: int, limit: int, duration: int,
                   algorithm: int, behavior: int, now_ms: int = 0):
        """Native lone decision against the mirror: (status, limit,
        remaining, reset_time), or None on a miss (take the kernel path).
        now_ms=0 reads the wall clock in C."""
        b = key.encode("utf-8")
        out = np.empty(4, np.int64)
        hit = self._lib.keydir_decide_one(
            self._kd, b, len(b), hits, limit, duration, algorithm,
            behavior, now_ms, out.ctypes.data)
        return tuple(out.tolist()) if hit else None

    def drop(self, key: str) -> None:
        b = key.encode("utf-8")
        self._lib.keydir_drop(self._kd, b, len(b))

    def peek_slot(self, key: str) -> int:
        b = key.encode("utf-8")
        return int(self._lib.keydir_peek(self._kd, b, len(b)))

    def items_raw(self) -> Tuple[bytes, np.ndarray, np.ndarray]:
        """(key_blob, offsets i64[n+1], slots i32[n]), most recently used
        first, with no per-key decode: the streamed snapshot's directory
        walk."""
        n = len(self)
        if n == 0:
            return b"", np.zeros(1, np.int64), np.empty(0, np.int32)
        buf_cap = 1 << 16
        while True:
            key_buf = ctypes.create_string_buffer(buf_cap)
            offsets = np.empty(n + 1, np.int64)
            slots = np.empty(n, np.int32)
            count = self._lib.keydir_dump(
                self._kd, key_buf, buf_cap, offsets.ctypes.data,
                slots.ctypes.data, n,
            )
            if count >= 0:
                break
            buf_cap = max(buf_cap * 2, -count)
        count = int(count)
        return (key_buf.raw[:int(offsets[count])], offsets[:count + 1],
                slots[:count])

    def peek_slots_raw(self, key_blob: bytes, offsets: np.ndarray) -> np.ndarray:
        """Batch peek over a packed key arena -> i32 slots (-1 = absent),
        LRU order untouched: one C pass per snapshot slab."""
        n = len(offsets) - 1
        out = np.empty(n, np.int32)
        if n:
            off = np.ascontiguousarray(offsets, np.int64)
            self._lib.keydir_peek_batch(
                self._kd, key_blob, off.ctypes.data, n, out.ctypes.data)
        return out

    def lookup_raw(self, key_blob: bytes, offsets: np.ndarray):
        """lookup_inject over a packed key arena (the binary restore: no
        per-key str round trip). Returns (slots i32[n], fresh bool[n],
        dirty-mirror rows i64[m, 8])."""
        n = len(offsets) - 1
        slots = np.empty(n, np.int32)
        fresh = np.empty(n, np.uint8)
        inject = np.empty((max(n, 1), 8), np.int64)
        n_inj = np.zeros(1, np.int32)
        off = np.ascontiguousarray(offsets, np.int64)
        done = self._lib.keydir_lookup_batch(
            self._kd, key_blob, off.ctypes.data, n,
            slots.ctypes.data, fresh.ctypes.data,
            inject.ctypes.data, n_inj.ctypes.data,
        )
        if done != n:
            raise RuntimeError(
                f"key directory over-committed: >{self.capacity} distinct "
                "keys in one lookup"
            )
        return slots, fresh.astype(bool), inject[:int(n_inj[0])]

    def items(self) -> List[Tuple[str, int]]:
        """(key, slot) pairs, most recently used first."""
        raw, offsets, slots = self.items_raw()
        return [(raw[offsets[i]:offsets[i + 1]].decode("utf-8"), int(slots[i]))
                for i in range(len(slots))]

    def keys(self) -> List[str]:
        return [k for k, _ in self.items()]


def make_key_directory(capacity: int):
    """The engine's directory: the native one, or the python KeyDirectory
    when GUBER_NO_NATIVE is set. Raises when the native library cannot be
    built."""
    if not os.environ.get("GUBER_NO_NATIVE"):
        return NativeKeyDirectory(capacity)
    from gubernator_tpu_torch.models.keyspace import KeyDirectory

    return KeyDirectory(capacity)
