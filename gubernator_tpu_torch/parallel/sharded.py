"""Sharded rate-limit engine and the GLOBAL behaviour, on one device.

The counterpart of the JAX package's parallel/sharded.py `ShardedEngine`.
There, the key table is sharded over a ("region", "shard") mesh of chips and
one batch window is one `shard_map` program in which each chip applies the
lanes routed to it. Here the R x S owner shards are slices of ONE
i64[R, S, C, 8] table on one device (parallel/mesh.py), and a window is one
launch of the sharded decide (ops/decide.py decide_sharded): owner o's
lanes read and write only its own C rows. A key's owner is the same hash in
both packages, and so is every slot its owner's directory gives it.

Behavior=GLOBAL (the reference's eventually consistent mode) as the JAX
package has it:
- a request is answered from the host mirror of the owners' last broadcast,
  and its hits are queued for the next sync;
- a key's first touch (mirror miss) is decided by its owner at once, and
  its hits are not queued;
- between syncs the mirror's `remaining` is deducted by the queued hits it
  admits, and the request is rejected when they do not fit;
- global_sync() applies the summed hits at each key's owner and broadcasts
  the owner's answer into the mirror (parallel/global_sync.py);
- the registry of global keys is an LRU of `global_capacity` entries: idle
  entries are swept after each sync, a full registry evicts its least
  recently touched entry with no queued hits, and only when every entry
  holds queued hits does a new key fall back to the owner (counted).

The Store path gathers and injects rows through the sharded row kernels
(ops/rows.py gather_sharded, inject_sharded), one launch each for every
owner. On CUDA each window's staging goes up through page-locked memory
without a wait, its response comes back when it is read (the pipelined and
columnar calls read it at collect time). On the CPU the same path runs the
plain PyTorch versions.

The constructor takes `n_shards`, `n_regions` and `device` (the card
unless the caller asks for the CPU) and the JAX package's other arguments
with their defaults. It has no `mesh=` and no `donate=`: there is no device
mesh to pass, and the table is always updated in place.
"""

from __future__ import annotations

import datetime as _dt
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gubernator_tpu_torch import native
from gubernator_tpu_torch.models.engine import EngineStats
from gubernator_tpu_torch.models.prep import (
    WorkItem,
    bucket_pow2 as _bucket_pow2,
    bucket_width,
    preprocess,
)
from gubernator_tpu_torch.obs import witness
from gubernator_tpu_torch.ops.decide import (
    LEAN,
    ROW_ALGO,
    ROW_DURATION,
    ROW_EXPIRE,
    ROW_LIMIT,
    ROW_REMAINING,
    ROW_STAMP,
    ROW_STATUS,
    WIDE,
    decide_sharded,
    lean_capacity_ok,
    lean_window,
    pack_window,
    staging_policy,
    widen_compact_out,
)
from gubernator_tpu_torch.ops.rows import gather_sharded, inject_sharded
from gubernator_tpu_torch.parallel.global_sync import (
    GlobalConfig,
    GlobalMirror,
    make_global_sync,
)
from gubernator_tpu_torch.parallel.mesh import MeshPlan, make_sharded_table, shard_of_key
from gubernator_tpu_torch.store import BucketSnapshot
from gubernator_tpu_torch.types import Behavior, RateLimitReq, RateLimitResp, Status
from gubernator_tpu_torch.utils.gregorian import gregorian_duration, gregorian_expiration
from gubernator_tpu_torch.utils.interval import millisecond_now
from gubernator_tpu_torch.utils.platform import resolve_device

_GLOBAL = int(Behavior.GLOBAL)
_GREG = int(Behavior.DURATION_IS_GREGORIAN)
# lanes the native fast path hands to the python pipeline: gregorian (host
# calendar math) and GLOBAL (the mirror tier)
_SLOW_MASK = _GREG | _GLOBAL
_OVERCOMMIT = native.PREP_OVERCOMMIT

# GlobalConfig's fields as numpy dtypes, in field order
_CFG_DTYPES = (np.int32, np.int32, np.int64, np.int64, np.int32, np.int32,
               np.int64, np.int64, np.bool_)


class _GlobalEntry:
    """Host record of one registered global key."""

    __slots__ = ("gidx", "owner", "req", "seen", "last_ms")

    def __init__(self, gidx: int, owner: int, now_ms: int):
        self.gidx = gidx
        self.owner = owner
        self.req: Optional[RateLimitReq] = None
        self.seen = False  # at least one broadcast has filled the mirror
        self.last_ms = now_ms  # last request touch (LRU and idle sweep)


class ShardedEngine:
    """Authoritative rate-limit state in R x S owner shards of one table."""

    # Scan groups are capped at 32 windows of exactly min_width lanes, as
    # the single-table engine's are.
    _MAX_SCAN = 32

    def __init__(
        self,
        n_shards: Optional[int] = None,
        n_regions: int = 1,
        capacity_per_shard: int = 1 << 17,
        global_capacity: int = 1024,
        min_width: int = 64,
        max_width: int = 8192,
        loader=None,
        store=None,
        collectives: str = "psum",
        global_idle_ms: int = 60_000,
        device=None,
    ):
        """`n_shards` None means one shard a region."""
        self.device = resolve_device(device)
        self.plan = MeshPlan(n_shards=n_shards or 1,
                             capacity_per_shard=capacity_per_shard,
                             n_regions=n_regions)
        self.state = make_sharded_table(self.plan, self.device)
        # "auto" ships eligible windows on the 4 B/lane lean wire; "wide"
        # pins the i64[9] format
        self._staging = staging_policy()
        self._lean_ok = lean_capacity_ok(capacity_per_shard)
        self._sync = make_global_sync(self.plan, collectives=collectives,
                                      device=self.device)
        self.store = store
        self.directories = [native.make_key_directory(capacity_per_shard)
                            for _ in range(self.plan.n_owners)]
        # the native one-pass prep and owner routing (see _fast_window)
        self._prep_fast = (
            native.prep_route_sharded
            if all(isinstance(d, native.NativeKeyDirectory) for d in self.directories)
            else None)
        self.min_width = min_width
        self.max_width = min(max_width, capacity_per_shard)
        self._lock = witness.make_lock("sharded.engine")
        self.loader = loader

        # ---- GLOBAL behaviour's host state ----------------------------
        self.global_capacity = global_capacity
        self.global_idle_ms = global_idle_ms
        # oldest touch first: a touch moves its entry to the end, so the LRU
        # victim is the first entry with no queued hits
        self._globals: "OrderedDict[str, _GlobalEntry]" = OrderedDict()
        self._gfree: List[int] = []  # recycled gidx slots
        self._gnext = 0  # high-water mark of allocated gidx
        self._gdelta = np.zeros((global_capacity,), np.int64)  # queued hits
        self._mirror = GlobalMirror(  # host copy of the last broadcast
            status=np.zeros((global_capacity,), np.int32),
            limit=np.zeros((global_capacity,), np.int64),
            remaining=np.zeros((global_capacity,), np.int64),
            reset_time=np.zeros((global_capacity,), np.int64),
        )
        self.stats = {
            "requests": 0,
            "batches": 0,
            "rounds": 0,
            "over_limit": 0,
            "errors": 0,
            "global_hits_queued": 0,
            "global_syncs": 0,
            "global_mirror_answers": 0,
            "global_evictions": 0,
            "global_registry_fallbacks": 0,
            "lean_windows": 0,  # windows shipped on the 4 B/lane wire
        }
        for s in EngineStats.STAGES:
            self.stats[f"{s}_ns"] = 0

        if loader is not None:
            self.load_snapshot(loader.load())

    # ------------------------------------------------------------------ API

    def warmup(self) -> None:
        """Run every width bucket and scan depth the engine dispatches, in
        each staging format, on all-padding windows (the table is not
        touched); with a Store, the gathers and injects of its widths; then
        one GLOBAL step on an empty config and zero deltas. On CUDA this
        builds and loads the kernels before the first request. Live GLOBAL
        state (registered keys, queued hits) never feeds it, so warming a
        serving engine applies nothing twice."""
        R, S = self.plan.n_regions, self.plan.n_shards
        widths = []
        w = self.min_width
        while w < self.max_width:
            widths.append(w)
            w *= 2
        widths.append(self.max_width)
        with self._lock:
            lean_warm = self._staging != "wide" and self._lean_ok
            C = self.plan.capacity_per_shard
            for width in widths:
                packed = np.zeros((R, S, 9, width), np.int64)
                packed[:, :, 0, :] = -1
                decide_sharded(WIDE, self.state, self._up(packed), None, 0)
                if lean_warm:
                    ln = lean_window(packed, C)
                    decide_sharded(LEAN, self.state, self._up(ln[0]), self._up(ln[1]), 0)
            k = 2
            while k <= self._MAX_SCAN:
                packed = np.zeros((R, S, k, 9, self.min_width), np.int64)
                packed[:, :, :, 0, :] = -1
                decide_sharded(WIDE, self.state, self._up(packed), None, 0, scan=True)
                if lean_warm:
                    ln = lean_window(packed, C)
                    decide_sharded(LEAN, self.state, self._up(ln[0]), self._up(ln[1]), 0,
                                   scan=True)
                k *= 2
            if self.store is not None:
                # the Store path gathers and injects at the window widths,
                # and a sync's write-through gathers at widths up to
                # global_capacity
                gather_widths = set(widths)
                w = self.min_width
                while w < self.global_capacity:
                    gather_widths.add(w)
                    w *= 2
                gather_widths.add(bucket_width(self.global_capacity, self.min_width,
                                               self.global_capacity))
                for width in sorted(gather_widths):
                    slotmat = self._up(np.full((R, S, width), -1, np.int32))
                    gather_sharded(self.state, slotmat)
                    if width in widths:
                        inject_sharded(self.state, slotmat,
                                       self._up(np.zeros((R, S, 7, width), np.int64)))
            G = self.global_capacity
            empty = [np.full((G,), -1, np.int32)] + [
                np.zeros((G,), dt) for dt in _CFG_DTYPES[1:]]
            self._sync(self.state, self._up(np.zeros((R, S, G), np.int64)),
                       GlobalConfig(*(self._up(a) for a in empty)), 0)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def owner_of(self, key: str) -> int:
        return shard_of_key(key, self.plan.n_owners)

    def key_count(self) -> int:
        """Live keys across every shard's directory."""
        return sum(len(d) for d in self.directories)

    # ------------------------------------------------------- persistence SPI

    def snapshot(self, include_expired: bool = False) -> List[BucketSnapshot]:
        """Live rows across every shard, as the JAX package's
        ShardedEngine.snapshot lists them."""
        out = []
        now = millisecond_now()
        with self._lock:
            tbl = self.state.cpu().numpy()  # [R, S, C, 8]
            for owner, directory in enumerate(self.directories):
                r_, s_ = self.plan.owner_coords(owner)
                for key, slot in directory.items():
                    row = tbl[r_, s_, slot]
                    algo = int(row[ROW_ALGO])
                    expire = int(row[ROW_EXPIRE])
                    if algo < 0:
                        continue
                    if not include_expired and now > expire:
                        continue
                    out.append(BucketSnapshot(
                        key=key, algo=algo,
                        limit=int(row[ROW_LIMIT]),
                        remaining=int(row[ROW_REMAINING]),
                        duration=int(row[ROW_DURATION]),
                        stamp=int(row[ROW_STAMP]),
                        expire_at=expire,
                        status=int(row[ROW_STATUS])))
        return out

    def load_snapshot(self, items) -> int:
        """Seed table rows from a Loader at boot: each key through its
        owner's directory, in chunks of max_width (a snapshot larger than a
        shard evicts its oldest keys instead of over-committing)."""
        items = list(items)
        if not items:
            return 0
        with self._lock:
            tbl = self.state.cpu().numpy()  # on the CPU: the table itself
            n = 0
            by_owner: Dict[int, list] = {}
            for it in items:
                by_owner.setdefault(self.owner_of(it.key), []).append(it)
            for owner, rows in by_owner.items():
                r_, s_ = self.plan.owner_coords(owner)
                for start in range(0, len(rows), self.max_width):
                    chunk = rows[start:start + self.max_width]
                    slots, _ = self.directories[owner].lookup([it.key for it in chunk])
                    for it, slot in zip(chunk, slots):
                        tbl[r_, s_, slot, :7] = (
                            it.algo, it.limit, it.remaining, it.duration,
                            it.stamp, it.expire_at, it.status)
                        n += 1
            if self.device.type != "cpu":
                self.state.copy_(torch.from_numpy(tbl))
        return n

    def close(self) -> None:
        """Flush queued GLOBAL hits through one last sync when anything
        persists (so the Loader's snapshot and the Store's copies hold every
        admitted hit), then save through the Loader."""
        if ((self.loader is not None or self.store is not None)
                and self.global_pending_hits()):
            self.global_sync()
        if self.loader is not None:
            self.loader.save(self.snapshot())

    def get_rate_limits(
        self, requests: Sequence[RateLimitReq], now_ms: Optional[int] = None
    ) -> List[RateLimitResp]:
        if now_ms is None:
            now_ms = millisecond_now()
        if (self._prep_fast is not None and self.store is None
                and 0 < len(requests) <= self.max_width):
            fast = self._fast_window(requests, now_ms)
            if fast is not None:
                return fast
        return self._slow_window(requests, now_ms)

    def _fast_window(self, requests, now_ms) -> Optional[List[RateLimitResp]]:
        """Native one-pass window: validation, first-occurrence split, owner
        routing and each owner's lookup in one C call
        (native.prep_route_sharded). Leftover lanes (invalid, gregorian,
        GLOBAL, duplicate occurrences) run through the python pipeline AFTER
        this round."""
        with self._lock:
            t0 = time.perf_counter_ns()  # excludes the lock wait
            n0, cols, lane_item, owner_count, leftover = self._prep_fast(
                self.directories, requests, _SLOW_MASK)
            if n0 == _OVERCOMMIT:
                self._raise_overcommit()
            if n0 < 0:
                return None
            t1 = time.perf_counter_ns()
            self.stats["prep_ns"] += t1 - t0
            self.stats["requests"] += n0
            self.stats["batches"] += 1
            responses: List[Optional[RateLimitResp]] = [None] * len(requests)
            if n0:
                out, placed = self._pack_and_decide(
                    cols, lane_item, owner_count, now_ms, t1)
                t3 = time.perf_counter_ns()
                out = self._fetch_mesh(out)  # waits for this window
                t4 = time.perf_counter_ns()
                self.stats["device_ns"] += t4 - t3
                self._demux(out, placed, responses)
                self.stats["demux_ns"] += time.perf_counter_ns() - t4
        if len(leftover):
            idxs = leftover.tolist()
            tail = self._slow_window(
                [requests[i] for i in idxs], now_ms, count_batch=False)
            for i, resp in zip(idxs, tail):
                responses[i] = resp
        return responses  # type: ignore[return-value]

    # ------------------------------------------------------- columnar path

    def supports_columnar(self) -> bool:
        """True when the zero-object columnar path is available: the native
        directories and no Store."""
        return self._prep_fast is not None and self.store is None

    def _prep_columnar(self, n, keys, key_off, name_len, hits, limit, duration,
                       algorithm, behavior, slow_mask):
        return native.prep_route_columnar(
            self.directories, n, keys, key_off, name_len, hits, limit,
            duration, algorithm, behavior, slow_mask | _SLOW_MASK)

    def submit_columnar(self, n: int, keys, key_off, name_len, hits, limit,
                        duration, algorithm, behavior, slow_mask: int,
                        now_ms: Optional[int] = None):
        """Launch one columnar window: the wire columns routed to their
        owners in one GIL-free C pass (native.prep_route_columnar) and
        decided in one sharded launch. Returns the handle for
        complete_columnar, or None when the path cannot take the window
        (nothing mutated)."""
        if not 0 < n <= self.max_width:
            return None
        if now_ms is None:
            now_ms = millisecond_now()
        with self._lock:
            t0 = time.perf_counter_ns()
            n0, cols, lane_item, owner_count, leftover = self._prep_columnar(
                n, keys, key_off, name_len, hits, limit, duration, algorithm,
                behavior, slow_mask)
            if n0 == _OVERCOMMIT:
                self._raise_overcommit()
            if n0 < 0:
                return None
            t1 = time.perf_counter_ns()
            self.stats["prep_ns"] += t1 - t0
            self.stats["requests"] += n0
            self.stats["batches"] += 1
            out, placed = None, []
            if n0:
                out, placed = self._pack_and_decide(
                    cols, lane_item, owner_count, now_ms, t1)
        return (out, placed, leftover, n0)

    def _raise_overcommit(self):
        raise RuntimeError(
            "key directory over-committed: "
            f">{self.plan.capacity_per_shard} distinct keys on one shard "
            "in one lookup")

    def _pack_and_decide(self, cols, lane_item, owner_count, now_ms, t1):
        """Pack the owner-major staging columns into the [R, S, 9, w] window
        and launch it: the one copy of the packing, shared by the object and
        columnar fast paths. Returns (_dispatch_mesh handle, placed) with
        placed rows (r, s, None, lanes). Caller holds the lock; `t1` is the
        pack's start."""
        R, S = self.plan.n_regions, self.plan.n_shards
        counts = owner_count.tolist()
        w = bucket_width(max(counts), self.min_width, self.max_width)
        packed = np.zeros((R, S, 9, w), np.int64)
        packed[:, :, 0, :] = -1
        placed = []
        lanes = lane_item.tolist()
        pos = 0
        for o, cnt in enumerate(counts):
            if not cnt:
                continue
            r_, s_ = self.plan.owner_coords(o)
            packed[r_, s_, :, :cnt] = cols[:, pos:pos + cnt]
            placed.append((r_, s_, None, lanes[pos:pos + cnt]))
            pos += cnt
        t2 = time.perf_counter_ns()
        self.stats["pack_ns"] += t2 - t1
        self.stats["rounds"] += 1
        handle = self._dispatch_mesh(packed, now_ms)
        self.stats["device_ns"] += time.perf_counter_ns() - t2
        return handle, placed

    def _scatter_cols(self, rows, placed, o_st, o_li, o_re, o_rs) -> int:
        """Owner blocks' response rows into the caller's columns; returns
        the OVER_LIMIT count."""
        over = 0
        for r_, s_, _k, lanes in placed:
            blk = rows[r_, s_]
            cnt = len(lanes)
            li = np.asarray(lanes, np.int64)
            o_st[li] = blk[0, :cnt]
            o_li[li] = blk[1, :cnt]
            o_re[li] = blk[2, :cnt]
            o_rs[li] = blk[3, :cnt]
            over += int(np.count_nonzero(blk[0, :cnt] == int(Status.OVER_LIMIT)))
        return over

    def complete_columnar(self, handle, out_status, out_limit,
                          out_remaining, out_reset) -> np.ndarray:
        """Wait for a submitted window and scatter its responses to their
        item positions. Returns the leftover indices (run them through the
        request-object path AFTER this round)."""
        out, placed, leftover, n0 = handle
        if n0:
            t0 = time.perf_counter_ns()
            rows = self._fetch_mesh(out)
            t1 = time.perf_counter_ns()
            over = self._scatter_cols(rows, placed, out_status, out_limit,
                                      out_remaining, out_reset)
            t2 = time.perf_counter_ns()
            with self._lock:  # concurrent completers: counters stay exact
                self.stats["over_limit"] += over
                self.stats["device_ns"] += t1 - t0
                self.stats["demux_ns"] += t2 - t1
        return leftover

    # ------------------------------------------- pipelined columnar serving
    # One sharded launch a window, no readback between launches, the group
    # cut at the first window that yields leftovers (models/engine.py has
    # the ordering argument).

    def launch_columnar_windows(self, windows, slow_mask: int,
                                now_ms: Optional[int] = None, staging=None):
        """Launch a PREFIX of 1..K columnar windows without waiting for any
        response. handle[0] is the consumed windows' meta list (each meta's
        last element its leftover indices), handle[1] an over-commit message
        or None. `staging` is taken for the contract's sake: each window's
        staging is its own."""
        if not self.supports_columnar():
            return None
        if not windows or any(not 0 < wc[0] <= self.max_width for wc in windows):
            return None
        if now_ms is None:
            now_ms = millisecond_now()
        metas = []
        failed = None
        for k, wc in enumerate(windows):
            (n, keys, key_off, name_len, hits, limit, duration,
             algorithm, behavior) = wc
            with self._lock:
                t0 = time.perf_counter_ns()
                n0, cols, lane_item, owner_count, leftover = self._prep_columnar(
                    n, keys, key_off, name_len, hits, limit, duration,
                    algorithm, behavior, slow_mask)
                if n0 == _OVERCOMMIT:
                    # earlier windows are launched; this one and the rest
                    # are not consumed (the caller error-fills them)
                    failed = ("key directory over-committed: "
                              f">{self.plan.capacity_per_shard} distinct "
                              "keys on one shard in one lookup")
                    break
                if n0 < 0:
                    if k == 0:
                        return None  # nothing mutated: object fallback
                    # nothing committed for THIS window: it retires whole
                    # through the caller's leftover path
                    metas.append((0, None, [], np.arange(n, dtype=np.int32)))
                    break
                t1 = time.perf_counter_ns()
                self.stats["prep_ns"] += t1 - t0
                self.stats["requests"] += n0
                self.stats["batches"] += 1
                out, placed = None, []
                if n0:
                    out, placed = self._pack_and_decide(
                        cols, lane_item, owner_count, now_ms, t1)
                metas.append((n0, out, placed, leftover))
            if len(leftover):
                break  # the group's cut: leftovers retire first
        return (metas, failed)

    def collect_columnar_windows(self, handle, outs):
        """Wait for a launched columnar group's responses (in launch order)
        and scatter each window's owner blocks into the caller's columns."""
        metas, _failed = handle
        leftovers = []
        for (n0, out, placed, leftover), (o_st, o_li, o_re, o_rs) in zip(metas, outs):
            if n0:
                t0 = time.perf_counter_ns()
                rows = self._fetch_mesh(out)
                t1 = time.perf_counter_ns()
                over = self._scatter_cols(rows, placed, o_st, o_li, o_re, o_rs)
                t2 = time.perf_counter_ns()
                with self._lock:
                    self.stats["over_limit"] += over
                    self.stats["device_ns"] += t1 - t0
                    self.stats["demux_ns"] += t2 - t1
            leftovers.append(leftover)
        return leftovers

    # ----------------------------------------------------- pipelined serving
    # The launch/collect split the combiner's depth-N pipeline drives: one
    # sharded launch a window, table updates chained in stream order, no
    # readback between launches.

    def supports_pipeline(self) -> bool:
        """True when the non-blocking launch/collect split is available
        (native routing prep, no Store)."""
        return self._prep_fast is not None and self.store is None

    def launch_windows(self, windows, now_ms: Optional[int] = None,
                       staging=None):
        """Launch 1..K request-object windows (one launch each) without
        waiting for any response. Returns the handle for collect_windows,
        or None when the pipelined path cannot take the group (nothing
        mutated). `staging` is taken for the contract's sake."""
        if not self.supports_pipeline():
            return None
        if not windows or any(not 0 < len(wk) <= self.max_width for wk in windows):
            return None
        if now_ms is None:
            now_ms = millisecond_now()
        meta = []
        tails = []
        for wk in windows:
            with self._lock:
                t0 = time.perf_counter_ns()
                n0, cols, lane_item, owner_count, leftover = self._prep_fast(
                    self.directories, wk, _SLOW_MASK)
                if n0 == _OVERCOMMIT:
                    self._raise_overcommit()
                if n0 < 0:
                    # nothing committed for THIS window: it retires whole
                    # through the python tail below
                    n0, out, placed = 0, None, []
                    leftover = np.arange(len(wk), dtype=np.int32)
                else:
                    t1 = time.perf_counter_ns()
                    self.stats["prep_ns"] += t1 - t0
                    self.stats["requests"] += n0
                    self.stats["batches"] += 1
                    out, placed = None, []
                    if n0:
                        out, placed = self._pack_and_decide(
                            cols, lane_item, owner_count, now_ms, t1)
                meta.append((n0, out, placed, leftover))
            # Leftover tails retire NOW, after this window's launch and
            # before the next window preps, so a key pending in the tail is
            # never overtaken by its next arrival. Waits for its own
            # response; rare path.
            if leftover is not None and len(leftover):
                idxs = leftover.tolist()
                tails.append(self._slow_window(
                    [wk[i] for i in idxs], now_ms, count_batch=False))
            else:
                tails.append(None)
        return (windows, meta, tails)

    def collect_windows(self, handle):
        """Wait for a launched group's responses (in launch order) and
        demux: one response list per window. Runs outside the engine lock
        except for the demux's counters."""
        windows, meta, tails = handle
        results = []
        for k, wk in enumerate(windows):
            n0, out, placed, leftover = meta[k]
            responses: List[Optional[RateLimitResp]] = [None] * len(wk)
            if n0:
                t0 = time.perf_counter_ns()
                rows = self._fetch_mesh(out)
                t1 = time.perf_counter_ns()
                with self._lock:  # _demux adds to the counters
                    self.stats["device_ns"] += t1 - t0
                    self._demux(rows, placed, responses)
                    self.stats["demux_ns"] += time.perf_counter_ns() - t1
            tail = tails[k]
            if tail is not None:
                for i, resp in zip(leftover.tolist(), tail):
                    responses[i] = resp
            results.append(responses)
        return results

    def launch_noop(self, width: Optional[int] = None):
        """Launch one all-padding window (the table is not touched), for the
        combiner's depth probe."""
        R, S = self.plan.n_regions, self.plan.n_shards
        w = width or self.min_width
        packed = np.zeros((R, S, 9, w), np.int64)
        packed[:, :, 0, :] = -1
        with self._lock:
            return self._dispatch_mesh(packed, 0)

    def collect_noop(self, handle) -> None:
        """Wait for a launch_noop's response."""
        self._fetch_mesh(handle)

    def _slow_window(self, requests, now_ms,
                     count_batch: bool = True) -> List[RateLimitResp]:
        """The python pipeline: full validation, gregorian, the GLOBAL
        mirror, duplicate rounds. `count_batch` is False for a fast window's
        leftover tail (the client batch was counted there)."""
        t0 = time.perf_counter_ns()
        responses, rounds, n_errors = preprocess(requests, now_ms)
        prep_ns = time.perf_counter_ns() - t0  # excludes the lock wait below
        with self._lock:
            self.stats["prep_ns"] += prep_ns
            self.stats["requests"] += len(requests)
            self.stats["batches"] += 1 if count_batch else 0
            self.stats["errors"] += n_errors
            windows: List[List[WorkItem]] = []
            for round_work in rounds:
                kernel_items = [item for item in round_work
                                if not self._try_answer_global(item, responses, now_ms)]
                if kernel_items:
                    self.stats["rounds"] += 1
                    for start in range(0, len(kernel_items), self.max_width):
                        windows.append(kernel_items[start:start + self.max_width])
            head, tail = self._split_scannable(windows)
            for wk in head:
                self._apply_round(wk, now_ms, responses)
            if tail:
                self._apply_rounds_scanned(tail, now_ms, responses)
        return responses  # type: ignore[return-value]

    def global_sync(self, now_ms: Optional[int] = None) -> int:
        """One GLOBAL sync: the queued hits summed and applied at each key's
        owner, the owners' answers broadcast into the mirror. Returns the
        number of keys broadcast."""
        if now_ms is None:
            now_ms = millisecond_now()
        with self._lock:
            live = [(k, e) for k, e in self._globals.items() if e.req is not None]
            if not live:
                return 0
            cfg = self._build_global_config(now_ms)
            delta = self._place_delta()
            # the keys that carried hits this window, before the zeroing:
            # the Store write-through skips the others
            touched = {int(g) for g in np.nonzero(self._gdelta)[0]}
            _state, mirror, _ = self._sync(
                self.state, self._up(delta), GlobalConfig(*(self._up(a) for a in cfg)),
                now_ms)
            # a writable host copy: mirror answers deduct from it
            self._mirror = GlobalMirror(*(c.cpu().numpy().copy() for c in mirror))
            self._gdelta[:] = 0
            for _k, e in live:
                e.seen = True
            self.stats["global_syncs"] += 1
            if self.store is not None and touched:
                self._store_write_global(
                    [(k, e) for k, e in live if e.gidx in touched], cfg)
            self._sweep_globals(now_ms)
            return len(live)

    def global_pending_hits(self) -> int:
        return int(self._gdelta.sum())

    def global_registry_size(self) -> int:
        return len(self._globals)

    # ------------------------------------------------------------- internals

    def _up(self, a: np.ndarray) -> torch.Tensor:
        """One host array onto the engine's device. On CUDA the copy goes
        through page-locked memory and does not wait: it is ordered before
        any later launch on the stream."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _try_answer_global(self, item: WorkItem, responses, now_ms: int) -> bool:
        """Answer a GLOBAL request from the mirror and queue its hits for
        the next sync. False when the item must go to its owner (not
        GLOBAL, a first touch, or a full registry)."""
        i, r, _ge, _gi = item
        if not int(r.behavior) & _GLOBAL:
            return False
        key = r.hash_key()
        entry = self._globals.get(key)
        if entry is None:
            gidx = self._alloc_gidx(now_ms)
            if gidx < 0:
                # every slot holds queued hits: the owner decides this one,
                # and the next touch tries again
                self.stats["global_registry_fallbacks"] += 1
                return False
            entry = _GlobalEntry(gidx, self.owner_of(key), now_ms)
            self._globals[key] = entry
        else:
            self._globals.move_to_end(key)
        entry.req = r
        entry.last_ms = now_ms
        if not entry.seen:
            return False  # first touch: the owner decides
        self._gdelta[entry.gidx] += r.hits
        self.stats["global_hits_queued"] += int(r.hits)
        self.stats["global_mirror_answers"] += 1
        # Admission against the last broadcast: deduct the hits that fit,
        # reject the rest without deducting (the token bucket's answer).
        g = entry.gidx
        rem = int(self._mirror.remaining[g])
        st = int(self._mirror.status[g])
        if r.hits > 0:
            if rem == 0 or r.hits > rem:
                st = int(Status.OVER_LIMIT)
            else:
                rem -= r.hits
                self._mirror.remaining[g] = rem
        if st == Status.OVER_LIMIT:
            self.stats["over_limit"] += 1
        responses[i] = RateLimitResp(
            status=st,
            limit=int(self._mirror.limit[g]),
            remaining=rem,
            reset_time=int(self._mirror.reset_time[g]),
        )
        return True

    def _alloc_gidx(self, now_ms: int) -> int:
        """A registry slot: the free list, then high-water growth, then the
        LRU entry with no queued hits evicted. -1 when every slot holds
        queued hits."""
        if self._gfree:
            return self._gfree.pop()
        if self._gnext < self.global_capacity:
            g = self._gnext
            self._gnext += 1
            return g
        for key, e in self._globals.items():
            if self._gdelta[e.gidx]:
                continue
            self._evict_global(key, e)
            return self._gfree.pop()
        return -1

    def _evict_global(self, key: str, entry: _GlobalEntry) -> None:
        """Drop one registered key and recycle its gidx. Its row stays in
        the table (its own expiry handles it); a re-registered key starts
        again with a first touch at its owner."""
        del self._globals[key]
        g = entry.gidx
        self._gdelta[g] = 0  # zero by precondition; kept so
        self._mirror.status[g] = 0
        self._mirror.limit[g] = 0
        self._mirror.remaining[g] = 0
        self._mirror.reset_time[g] = 0
        self._gfree.append(g)
        self.stats["global_evictions"] += 1

    def _sweep_globals(self, now_ms: int) -> None:
        """Evict the keys not touched for global_idle_ms. Runs after a sync,
        when every queued hit has just been applied."""
        idle = [(k, e) for k, e in self._globals.items()
                if now_ms - e.last_ms > self.global_idle_ms and not self._gdelta[e.gidx]]
        for k, e in idle:
            self._evict_global(k, e)

    def _split_scannable(self, windows: List[List[WorkItem]]):
        """Per-round head + scannable tail (the single-table engine's rule):
        the trailing windows of at most min_width lanes ride the scan when
        there are at least two and they fit a shard four times over."""
        if len(windows) <= 1:
            return windows, []
        split = len(windows)
        while split > 0 and len(windows[split - 1]) <= self.min_width:
            split -= 1
        tail = windows[split:]
        if (len(tail) < 2 or
                sum(len(w) for w in tail) * 4 > self.plan.capacity_per_shard):
            return windows, []
        return windows[:split], tail

    def _route_lanes(self, round_work: List[WorkItem]):
        """A window's items split by owner."""
        lanes: List[List[WorkItem]] = [[] for _ in range(self.plan.n_owners)]
        for item in round_work:
            lanes[self.owner_of(item[1].hash_key())].append(item)
        return lanes

    def _pack_lanes(self, lanes, w: int, packed, placed, k: Optional[int], pre=None):
        """Fill one window's [R, S, 9, w] slice (packed[..., k, :, :] when k
        is given) and record one (r, s, k, [response indices]) demux group
        per owner. `pre`, when given, maps owner -> (slots, fresh) the
        caller already resolved (the Store path looks keys up before its
        read-through)."""
        for owner, items in enumerate(lanes):
            if not items:
                continue
            r_, s_ = self.plan.owner_coords(owner)
            t = time.perf_counter_ns()
            if pre is None:
                slots, fresh = self.directories[owner].lookup(
                    [it[1].hash_key() for it in items])
            else:
                slots, fresh = pre[owner]
            t2 = time.perf_counter_ns()
            self.stats["lookup_ns"] += t2 - t
            dst = packed[r_, s_] if k is None else packed[r_, s_, k]
            pack_window(items, slots, fresh, w, out=dst)
            self.stats["pack_ns"] += time.perf_counter_ns() - t2
            placed.append((r_, s_, k, [item[0] for item in items]))

    def _demux(self, out, placed, responses) -> None:
        """One response buffer into responses: `placed` rows are
        (r, s, k, [response indices]), lanes 0..n-1 of each owner in index
        order; k is None outside the scan."""
        over = int(Status.OVER_LIMIT)
        for r_, s_, k, idxs in placed:
            row = out[r_, s_] if k is None else out[r_, s_, k]
            status, limit, remaining, reset = row[:, :len(idxs)].tolist()
            for j, i in enumerate(idxs):
                st = status[j]
                if st == over:
                    self.stats["over_limit"] += 1
                responses[i] = RateLimitResp(
                    status=st, limit=limit[j], remaining=remaining[j],
                    reset_time=reset[j])

    @staticmethod
    def _row_snapshot(rows, r_: int, s_: int, j: int, key: str) -> BucketSnapshot:
        """Lane j of a gathered [R, S, 7, W] buffer as a BucketSnapshot."""
        return BucketSnapshot(
            key=key, algo=int(rows[r_, s_, 0, j]),
            limit=int(rows[r_, s_, 1, j]),
            remaining=int(rows[r_, s_, 2, j]),
            duration=int(rows[r_, s_, 3, j]),
            stamp=int(rows[r_, s_, 4, j]),
            expire_at=int(rows[r_, s_, 5, j]),
            status=int(rows[r_, s_, 6, j]))

    def _apply_rounds_scanned(self, windows, now_ms, responses) -> None:
        """Every scannable window in ceil(N / 32) sharded scan launches.

        With a Store, one read-through before the whole tail over the union
        of its keys and one write-through after it with each key's final
        row; each window's slots and fresh flags come from the union's
        lookup (a second lookup would strip a later window's first
        occurrence of its fresh flag), and a key's fresh flag goes to its
        first window only."""
        R, S = self.plan.n_regions, self.plan.n_shards
        w = self.min_width  # _split_scannable guarantees every window fits
        store_ctx = None
        slot_map = fresh_map = None
        if self.store is not None and windows:
            seen_items = {}
            for wk in windows:
                for item in wk:
                    seen_items.setdefault(item[1].hash_key(), item)
            _lanes, per_owner, slotmat, _wu = self._store_lookup_owners(
                list(seen_items.values()), unbounded=True)
            self._store_read_through_mesh(per_owner, slotmat, now_ms)
            slot_map, fresh_map = {}, {}
            for _o, _r, _s, _items, keys, slots, fresh in per_owner:
                for j, key in enumerate(keys):
                    slot_map[key] = slots[j]
                    if fresh[j]:
                        fresh_map[key] = True
            store_ctx = (per_owner, slotmat)

        def window_pre(lanes):
            if store_ctx is None:
                return None
            pre = {}
            for owner, items in enumerate(lanes):
                if not items:
                    continue
                ks = [it[1].hash_key() for it in items]
                pre[owner] = ([slot_map[k] for k in ks],
                              [fresh_map.pop(k, False) for k in ks])
            return pre

        for g0 in range(0, len(windows), self._MAX_SCAN):
            group = windows[g0:g0 + self._MAX_SCAN]
            if len(group) == 1:
                # a trailing singleton rides the one-window launch; inside a
                # Store tail it takes the union's resolved maps
                lanes = self._route_lanes(group[0])
                self._apply_round(group[0], now_ms, responses,
                                  pre=window_pre(lanes), lanes=lanes)
                continue
            k_pad = _bucket_pow2(len(group))
            packed = np.zeros((R, S, k_pad, 9, w), np.int64)
            packed[:, :, :, 0, :] = -1  # vacant lanes, pad windows too
            placed: List[Tuple[int, int, Optional[int], List[int]]] = []
            for k, wk in enumerate(group):
                lanes = self._route_lanes(wk)
                self._pack_lanes(lanes, w, packed, placed, k, pre=window_pre(lanes))
            t = time.perf_counter_ns()
            out = self._fetch_mesh(self._dispatch_mesh(packed, now_ms, scan=True))
            t2 = time.perf_counter_ns()
            self.stats["device_ns"] += t2 - t
            self._demux(out, placed, responses)
            self.stats["demux_ns"] += time.perf_counter_ns() - t2

        if store_ctx is not None:
            per_owner, slotmat = store_ctx
            self._store_write_through_mesh(per_owner, slotmat, now_ms)

    # -------------------------------------------------- staging dispatch

    def _dispatch_mesh(self, packed: np.ndarray, now_ms, scan: bool = False):
        """Launch one wide i64[R, S, 9, w] window (or an i64[R, S, K, 9, w]
        scan), shipped on the 4 B/lane lean wire when eligible. Returns the
        handle for _fetch_mesh. Caller holds the lock."""
        if self._staging != "wide" and self._lean_ok:
            ln = lean_window(packed, self.plan.capacity_per_shard)
            if ln is not None:
                self.stats["lean_windows"] += 1
                out = decide_sharded(LEAN, self.state, self._up(ln[0]), self._up(ln[1]),
                                     now_ms, scan=scan)
                return out, now_ms
        return decide_sharded(WIDE, self.state, self._up(packed), None, now_ms,
                              scan=scan), None

    @staticmethod
    def _fetch_mesh(handle) -> np.ndarray:
        """Wait for a launched window and return its wide i64 response rows,
        whichever format carried it."""
        out, lean_now = handle
        out = out.cpu().numpy()
        if lean_now is not None:
            return widen_compact_out(out, lean_now)
        return out

    def _apply_round(self, round_work: List[WorkItem], now_ms, responses,
                     pre=None, lanes=None) -> None:
        """One window, one sharded launch. `pre` (owner -> (slots, fresh))
        marks a singleton of _apply_rounds_scanned's Store tail, whose
        batched read- and write-through cover these keys (`lanes` carries
        the caller's routing)."""
        if self.store is not None and pre is None:
            return self._apply_round_store(round_work, now_ms, responses)
        R, S = self.plan.n_regions, self.plan.n_shards
        if lanes is None:
            lanes = self._route_lanes(round_work)
        w = bucket_width(max(len(l) for l in lanes), self.min_width, self.max_width)
        packed = np.zeros((R, S, 9, w), np.int64)
        packed[:, :, 0, :] = -1  # vacant lanes
        placed: List[Tuple[int, int, Optional[int], List[int]]] = []
        self._pack_lanes(lanes, w, packed, placed, None, pre=pre)
        t = time.perf_counter_ns()
        out = self._fetch_mesh(self._dispatch_mesh(packed, now_ms))
        t2 = time.perf_counter_ns()
        self.stats["device_ns"] += t2 - t
        self._demux(out, placed, responses)
        self.stats["demux_ns"] += time.perf_counter_ns() - t2

    def _gather(self, slotmat: np.ndarray) -> np.ndarray:
        """The rows at an i32[R, S, w] slot matrix, as i64[R, S, 7, w] on the
        host (one sharded gather)."""
        return gather_sharded(self.state, self._up(slotmat)).cpu().numpy()

    def _store_lookup_owners(self, work_items: List[WorkItem], unbounded: bool = False):
        """Route + each owner's lookup for the Store paths. Returns (lanes,
        per_owner rows (owner, r, s, items, keys, slots, fresh), slotmat
        [R, S, w], w). `unbounded` lifts the max_width clamp: the scan
        tail's union spans many windows and its slotmat feeds only the
        Store's gather and inject, never a decide window."""
        R, S = self.plan.n_regions, self.plan.n_shards
        lanes = self._route_lanes(work_items)
        mx = max(len(l) for l in lanes)
        cap = max(self.max_width, _bucket_pow2(mx)) if unbounded else self.max_width
        w = bucket_width(mx, self.min_width, cap)
        per_owner = []
        slotmat = np.full((R, S, w), -1, np.int32)
        t = time.perf_counter_ns()
        for owner, items in enumerate(lanes):
            if not items:
                continue
            r_, s_ = self.plan.owner_coords(owner)
            keys = [it[1].hash_key() for it in items]
            slots, fresh = self.directories[owner].lookup(keys)
            slotmat[r_, s_, :len(slots)] = slots
            per_owner.append((owner, r_, s_, items, keys, slots, list(fresh)))
        self.stats["lookup_ns"] += time.perf_counter_ns() - t
        return lanes, per_owner, slotmat, w

    def _store_read_through_mesh(self, per_owner, slotmat, now_ms) -> None:
        """Ask the Store for the rows the table cannot serve; inject those it
        returns (all seven fields as the Store gave them) and clear their
        fresh flags (per_owner's fresh lists change in place)."""
        R, S = self.plan.n_regions, self.plan.n_shards
        w = slotmat.shape[-1]
        t = time.perf_counter_ns()
        rows = self._gather(slotmat)
        inj_slot = np.full((R, S, w), -1, np.int32)
        inj_rows = np.zeros((R, S, 7, w), np.int64)
        inj_n = [0] * self.plan.n_owners
        for owner, r_, s_, items, keys, slots, fresh in per_owner:
            for j, (_i, r, _ge, _gi) in enumerate(items):
                algo = int(rows[r_, s_, 0, j])
                live = (not fresh[j] and algo >= 0
                        and now_ms <= int(rows[r_, s_, 5, j]))
                if live and algo != int(r.algorithm):
                    # an algorithm switch discards the old bucket everywhere
                    self.store.remove(keys[j])
                    live = False
                if live:
                    continue
                item = self.store.get(r)
                if item is None:
                    continue
                k = inj_n[owner]
                inj_n[owner] = k + 1
                inj_slot[r_, s_, k] = slots[j]
                inj_rows[r_, s_, :, k] = (
                    item.algo, item.limit, item.remaining, item.duration,
                    item.stamp, item.expire_at, item.status)
                fresh[j] = False  # the injected row is live now
        if any(inj_n):
            inject_sharded(self.state, self._up(inj_slot), self._up(inj_rows))
        self.stats["store_ns"] += time.perf_counter_ns() - t

    def _store_write_through_mesh(self, per_owner, slotmat, now_ms) -> None:
        """Report the rows after the decision; a bucket the decision cleared
        is removed from the Store and its owner's directory."""
        t = time.perf_counter_ns()
        rows = self._gather(slotmat)
        for owner, r_, s_, items, keys, slots, fresh in per_owner:
            for j, (_i, r, _ge, _gi) in enumerate(items):
                if int(rows[r_, s_, 0, j]) < 0:
                    # token RESET_REMAINING cleared the row
                    self.store.remove(keys[j])
                    self.directories[owner].drop(keys[j])
                    continue
                self.store.on_change(r, self._row_snapshot(rows, r_, s_, j, keys[j]))
        self.stats["store_ns"] += time.perf_counter_ns() - t

    def _apply_round_store(self, round_work: List[WorkItem], now_ms, responses) -> None:
        """A round with the Store: read-through before the launch,
        write-through after, through one sharded gather and at most one
        sharded inject before and one gather after."""
        R, S = self.plan.n_regions, self.plan.n_shards
        lanes, per_owner, slotmat, w = self._store_lookup_owners(round_work)
        self._store_read_through_mesh(per_owner, slotmat, now_ms)
        packed = np.zeros((R, S, 9, w), np.int64)
        packed[:, :, 0, :] = -1
        placed: List[Tuple[int, int, Optional[int], List[int]]] = []
        pre = {owner: (slots, fresh)
               for owner, _r, _s, _items, _keys, slots, fresh in per_owner}
        self._pack_lanes(lanes, w, packed, placed, None, pre=pre)
        t2 = time.perf_counter_ns()
        out = self._fetch_mesh(self._dispatch_mesh(packed, now_ms))
        t3 = time.perf_counter_ns()
        self.stats["device_ns"] += t3 - t2
        self._demux(out, placed, responses)
        self.stats["demux_ns"] += time.perf_counter_ns() - t3
        self._store_write_through_mesh(per_owner, slotmat, now_ms)

    def _build_global_config(self, now_ms: int) -> GlobalConfig:
        """The GLOBAL step's config as numpy arrays of [global_capacity]:
        each live key's latest request at its gidx, its owner and its slot
        there (looked up, owner by owner), the GLOBAL bit stripped from its
        behaviour, and its calendar fields when gregorian."""
        G = self.global_capacity
        slot = np.full((G,), -1, np.int32)
        owner = np.zeros((G,), np.int32)
        limit = np.zeros((G,), np.int64)
        duration = np.zeros((G,), np.int64)
        algorithm = np.zeros((G,), np.int32)
        behavior = np.zeros((G,), np.int32)
        greg_expire = np.zeros((G,), np.int64)
        greg_interval = np.zeros((G,), np.int64)
        fresh = np.zeros((G,), np.bool_)
        by_owner: Dict[int, List[Tuple[str, _GlobalEntry]]] = {}
        for key, e in self._globals.items():
            if e.req is not None:
                by_owner.setdefault(e.owner, []).append((key, e))
        local_now = _dt.datetime.fromtimestamp(now_ms / 1000.0)
        for own, entries in by_owner.items():
            slots, fr = self.directories[own].lookup([k for k, _ in entries])
            for (key, e), s_, f_ in zip(entries, slots, fr):
                g = e.gidx
                slot[g] = s_
                owner[g] = own
                limit[g] = e.req.limit
                duration[g] = e.req.duration
                algorithm[g] = int(e.req.algorithm)
                behavior[g] = int(e.req.behavior) & ~_GLOBAL
                fresh[g] = f_
                if int(e.req.behavior) & _GREG:
                    greg_expire[g] = gregorian_expiration(local_now, e.req.duration)
                    greg_interval[g] = gregorian_duration(local_now, e.req.duration)
        return GlobalConfig(slot=slot, owner=owner, limit=limit, duration=duration,
                            algorithm=algorithm, behavior=behavior,
                            greg_expire=greg_expire, greg_interval=greg_interval,
                            fresh=fresh)

    def _store_write_global(self, live, cfg: GlobalConfig) -> None:
        """Write through the rows a sync just rewrote: once per synced key
        that carried hits, through one sharded gather."""
        R, S = self.plan.n_regions, self.plan.n_shards
        lanes = [0] * self.plan.n_owners
        placed = []  # (key, req, r, s, lane)
        width = bucket_width(max(1, len(live)), self.min_width, self.global_capacity)
        slotmat = np.full((R, S, width), -1, np.int32)
        for key, e in live:
            g = e.gidx
            if cfg.slot[g] < 0:
                continue
            own = int(cfg.owner[g])
            r_, s_ = self.plan.owner_coords(own)
            k = lanes[own]
            lanes[own] = k + 1
            slotmat[r_, s_, k] = cfg.slot[g]
            placed.append((key, e.req, r_, s_, k))
        if not placed:
            return
        t = time.perf_counter_ns()
        rows = self._gather(slotmat)
        for key, req, r_, s_, k in placed:
            if int(rows[r_, s_, 0, k]) < 0:
                continue
            self.store.on_change(req, self._row_snapshot(rows, r_, s_, k, key))
        self.stats["store_ns"] += time.perf_counter_ns() - t

    def _place_delta(self) -> np.ndarray:
        """This host's queued hits enter at owner (0, 0); the sum makes the
        placement irrelevant."""
        R, S = self.plan.n_regions, self.plan.n_shards
        delta = np.zeros((R, S, self.global_capacity), np.int64)
        delta[0, 0, :] = self._gdelta
        return delta
