"""The C++ key directory (native/keydir.cpp), loaded through ctypes.

keydir.cpp is a byte-for-byte copy of the JAX package's, so both packages'
directories assign the same slots to the same key stream, LRU recycling at
a full table included. This module binds the parts the engine uses:

- NativeKeyDirectory: the open-addressing LRU map key -> slot, with the row
  mirrors of the lone-request path (decide_one, mirror_seed, mirror_flush);
- prep_pack_fast: the one-pass window prep (validate, first-occurrence
  round split, directory lookup and pack of the wide staging rows in one C
  call over the request objects);
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
        lib.keydir_size.restype = c.c_int64
        lib.keydir_size.argtypes = [c.c_void_p]
        lib.keydir_evictions.restype = c.c_int64
        lib.keydir_evictions.argtypes = [c.c_void_p]
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

    def items(self) -> List[Tuple[str, int]]:
        """(key, slot) pairs, most recently used first."""
        n = len(self)
        if n == 0:
            return []
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
        raw = key_buf.raw
        return [(raw[offsets[i]:offsets[i + 1]].decode("utf-8"), int(slots[i]))
                for i in range(int(count))]

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
