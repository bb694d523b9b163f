"""Single-table rate-limit engine: host batching over the decision kernel.

The counterpart of the JAX package's models/engine.py `Engine`, slimmed to
its request-object path. The engine owns:

- the key table, one i64[C, 8] tensor on the engine's device, updated IN
  PLACE by every window;
- the host key directory: the C++ one (native/), or the python one
  (models/keyspace.py) when GUBER_NO_NATIVE is set;
- the native fast window: validate, first-occurrence round split, lookup
  and pack in one C call; what it cannot take (invalid, gregorian and
  duplicate lanes) runs through the python pipeline after it;
- duplicate-key *rounds*: a window is split so each launch touches each
  slot at most once (occurrence k of a key goes to round k);
- the staging choice per window: lean i32[W] lane words when eligible,
  else compact i32[5, W], else wide i64[9, W] (ops/decide.py);
- the scan tail: the short trailing rounds run up to 32 windows per launch;
- the lone-request path: a key's row mirrored in the native directory
  answers single requests in C, and the next window that looks the key up
  injects the mirror's row back into the table first.

On CUDA every window is one host-to-device copy of its staging, one launch
of csrc/decide.cu and one copy of the response back. Mirror rows go in
through csrc/rows.cu's inject with no copy: the key directory writes them
into a page-locked i64[max_width, 8] buffer the engine allocates once
(ops/rows.py InjectStaging), and the kernel reads them there through its
mapped address; the buffer is handed to the directory again only after the
last inject that reads it has run (an event per inject), since a scan group
may look up, and inject, many windows before its one wait. seed_mirror's
one-slot gather reads its slot from, and writes its row to, two page-locked
host buffers the engine allocates once: no copy either way, one wait on the
stream. On the CPU the same path runs the plain PyTorch versions. The engine
is synchronous and thread-safe through one lock.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from gubernator_tpu_torch import native
from gubernator_tpu_torch.models.prep import (
    bucket_pow2 as _bucket_pow2,
    bucket_width as _bucket_width,
    preprocess,
)
from gubernator_tpu_torch.ops.decide import (
    compact_window,
    decide_packed,
    decide_packed_compact,
    decide_packed_lean,
    decide_scan_packed,
    decide_scan_packed_compact,
    decide_scan_packed_lean,
    lean_capacity_ok,
    lean_window,
    make_table,
    pack_window,
    staging_policy,
    widen_compact_out,
)
from gubernator_tpu_torch.ops.rows import (
    GATHER_FIELDS,
    InjectStaging,
    gather_rows,
    inject_rows,
    sync_stream,
)
from gubernator_tpu_torch.types import (
    SLOW_PATH_BEHAVIOR_MASK as _NATIVE_SINGLE_SLOW_MASK,
    Behavior,
    RateLimitReq,
    RateLimitResp,
)
from gubernator_tpu_torch.utils.interval import millisecond_now
from gubernator_tpu_torch.utils.platform import resolve_device

_GREG_MASK = int(Behavior.DURATION_IS_GREGORIAN)


class LoneBuffers(NamedTuple):
    """The lone path's page-locked gather operands on CUDA: the i32[1] slot
    and the i64[7, 1] row, numpy views of the same memory, and the card."""

    slot: torch.Tensor
    row: torch.Tensor
    slot_np: np.ndarray
    row_np: np.ndarray
    index: int


def _gather_rows(state: torch.Tensor, slot: torch.Tensor):
    """Fetch rows (7-column tuple, table row field order); slots clamp to
    [0, C-1] as the JAX package's gather does."""
    return tuple(gather_rows(state, slot))


class EngineStats:
    """Counters plus a cumulative per-stage wall-clock breakdown, as the JAX
    package's EngineStats keeps them.

    The stage clocks (nanoseconds) split a window's host path: validate and
    round split (`prep`), key-directory resolution (`lookup`), Store I/O
    (`store`, always 0: the port has no Store yet), staging-buffer fill
    (`pack`), kernel dispatch and readback (`device`) and response demux
    (`demux`). Lock waits are left out."""

    STAGES = ("prep", "lookup", "store", "pack", "device", "demux")

    def __init__(self):
        self.requests = 0
        self.batches = 0
        self.rounds = 0
        self.over_limit = 0
        self.errors = 0
        self.native_singles = 0  # lone requests decided in C (no launch)
        self.stage_ns = {s: 0 for s in self.STAGES}

    def as_dict(self) -> Dict[str, int]:
        d = dict(requests=self.requests, batches=self.batches,
                 rounds=self.rounds, over_limit=self.over_limit,
                 errors=self.errors, native_singles=self.native_singles)
        for s, ns in self.stage_ns.items():
            d[f"{s}_ns"] = ns
        return d


class Engine:
    """One device's authoritative rate-limit state + kernel."""

    # Multi-window groups ride one scan launch; cap the group so the staging
    # buffer stays small. Scan groups are always min_width wide.
    _MAX_SCAN = 32

    def __init__(
        self,
        capacity: int = 1 << 20,
        min_width: int = 64,
        max_width: int = 8192,
        device=None,
    ):
        self.device = resolve_device(device)
        self.capacity = capacity
        self.state = make_table(capacity, self.device)
        self.directory = native.make_key_directory(capacity)
        # the one-pass window prep calls the C++ directory directly; a
        # python-directory engine keeps the python pipeline
        self._prep_fast = (native.prep_pack_fast
                           if isinstance(self.directory, native.NativeKeyDirectory)
                           else None)
        self.min_width = min_width
        # one kernel round must never need more distinct slots than exist
        self.max_width = min(max_width, capacity)
        self.stats = EngineStats()
        self._lock = threading.Lock()
        # lean staging needs every slot to fit the 24-bit lane field
        self._lean_ok = lean_capacity_ok(capacity)
        # "auto" ships each window on the leanest eligible format; "wide"
        # pins the i64[9] format
        self._staging = staging_policy()
        # On CUDA, the lone path's page-locked slot and row, and the inject
        # staging, allocated once (a failed allocation raises). Every inject
        # fits the staging: the fast window looks up at most len(requests)
        # <= max_width keys and the python pipeline at most one window of
        # max_width, and a lookup emits at most one row per key.
        self._lone: Optional[LoneBuffers] = None
        self._inject: Optional[InjectStaging] = None
        if self.device.type == "cuda":
            slot = torch.empty(1, dtype=torch.int32, pin_memory=True)
            row = torch.empty((GATHER_FIELDS, 1), dtype=torch.int64, pin_memory=True)
            self._lone = LoneBuffers(slot, row, slot.numpy(), row.numpy()[:, 0],
                                     self.state.get_device())
            self._inject = InjectStaging.allocate(self.max_width, self.device)

    # ------------------------------------------------------------------ API

    def warmup(self) -> None:
        """Run every staging format once at every width bucket and scan
        depth the engine can dispatch, on all-padding windows, then the
        lone path's 1-slot gather and a dropped-lane inject (the table is
        not touched). On CUDA this builds and loads the kernels before the
        first request instead of inside it."""
        widths = []
        w = self.min_width
        while w < self.max_width:
            widths.append(w)
            w *= 2
        widths.append(self.max_width)
        both = self._staging != "wide"
        with self._lock:
            for width in widths:
                packed = np.zeros((9, width), np.int64)
                packed[0, :] = -1  # all padding lanes
                decide_packed(self.state, self._up(packed), 0)
                if both:
                    c = compact_window(packed)
                    decide_packed_compact(self.state, self._up(c), 0)
                    if self._lean_ok:
                        ln = lean_window(packed, self.capacity)
                        decide_packed_lean(self.state, self._up(ln[0]),
                                           self._up(ln[1]), 0)
            k = 2
            while k <= self._MAX_SCAN:
                stacked = np.zeros((k, 9, self.min_width), np.int64)
                stacked[:, 0, :] = -1
                decide_scan_packed(self.state, self._up(stacked), 0)
                if both:
                    decide_scan_packed_compact(
                        self.state, self._up(compact_window(stacked)), 0)
                    if self._lean_ok:
                        ln = lean_window(stacked, self.capacity)
                        decide_scan_packed_lean(self.state, self._up(ln[0]),
                                                self._up(ln[1]), 0)
                k *= 2
            self._gather_row(0)
            # one dropped lane, where a lookup writes its rows: builds the
            # inject, mutates nothing
            warm_inject = self._inject_rows_out()
            warm_inject = (np.zeros((1, 8), np.int64) if warm_inject is None
                           else warm_inject[:1])
            warm_inject[0] = [-1, 0, 0, 0, 0, 0, 0, 0]
            self._apply_inject_rows(warm_inject)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def key_count(self) -> int:
        """Live key-table occupancy."""
        return len(self.directory)

    def get_rate_limits(
        self, requests: Sequence[RateLimitReq], now_ms: Optional[int] = None
    ) -> List[RateLimitResp]:
        """Decide a batch. Exact per-key sequential semantics, any batch size."""
        if now_ms is None:
            now_ms = millisecond_now()
        if self._prep_fast is not None and 0 < len(requests) <= self.max_width:
            fast = self._fast_window(requests, now_ms)
            if fast is not None:
                return fast
        return self._slow_window(requests, now_ms)

    # -------------------------------------------------- staging dispatch

    def _up(self, a: np.ndarray) -> torch.Tensor:
        """One host array onto the engine's device (a synchronous copy from
        pageable memory, ordered before any later launch)."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _dispatch_staged(self, packed: np.ndarray, now_ms):
        """Decide one wide-format i64[9, W] window, shipped lean when
        eligible, compact otherwise, wide as the last resort. Returns a
        handle for _fetch_staged. Caller holds the engine lock."""
        if self._staging != "wide":
            if self._lean_ok:
                ln = lean_window(packed, self.capacity)
                if ln is not None:
                    out = decide_packed_lean(self.state, self._up(ln[0]),
                                             self._up(ln[1]), now_ms)
                    return out, now_ms
            c = compact_window(packed)
            if c is not None:
                return decide_packed_compact(self.state, self._up(c), now_ms), now_ms
        return decide_packed(self.state, self._up(packed), now_ms), None

    def _dispatch_scan_staged(self, stacked: np.ndarray, now_ms):
        """The scan launch of a wide i64[K, 9, W] stack, shipped lean or
        compact when eligible. Handle contract matches _dispatch_staged.
        Caller holds the engine lock."""
        if self._staging != "wide":
            if self._lean_ok:
                ln = lean_window(stacked, self.capacity)
                if ln is not None:
                    out = decide_scan_packed_lean(
                        self.state, self._up(ln[0]), self._up(ln[1]), now_ms)
                    return out, now_ms
            c = compact_window(stacked)
            if c is not None:
                return (decide_scan_packed_compact(self.state, self._up(c), now_ms),
                        now_ms)
        return decide_scan_packed(self.state, self._up(stacked), now_ms), None

    @staticmethod
    def _fetch_staged(handle) -> np.ndarray:
        """Wait for a dispatched window and return the wide i64 response
        rows regardless of which format carried it."""
        out, compact_now = handle
        out = out.cpu().numpy()
        if compact_now is not None:
            return widen_compact_out(out, compact_now)
        return out

    # ------------------------------------------------------------- windows

    def _slow_window(self, requests, now_ms,
                     count_batch: bool = True) -> List[RateLimitResp]:
        """The python pipeline: full validation, gregorian precompute, and
        duplicate-key round splitting (models/prep.py). `count_batch` is
        False when called as a fast window's leftover tail: the client
        batch was already counted there."""
        t0 = time.perf_counter_ns()
        responses, rounds, n_errors = preprocess(requests, now_ms)
        prep_ns = time.perf_counter_ns() - t0  # excludes the lock wait below
        with self._lock:
            self.stats.stage_ns["prep"] += prep_ns
            self.stats.requests += len(requests)
            self.stats.batches += 1 if count_batch else 0
            self.stats.errors += n_errors
            windows = []
            for round_work in rounds:
                self.stats.rounds += 1
                for start in range(0, len(round_work), self.max_width):
                    windows.append(round_work[start:start + self.max_width])
            head, tail = self._split_scannable(windows)
            for wk in head:
                self._apply_round(wk, now_ms, responses)
            if tail:
                self._apply_windows_scanned(tail, now_ms, responses)
        return responses  # type: ignore[return-value]

    def _fast_window(self, requests, now_ms) -> Optional[List[RateLimitResp]]:
        """Native one-pass window (native.prep_pack_fast). Lanes the C pass
        cannot take (invalid, gregorian, duplicate occurrences) come back
        as leftover item indices and run through the python pipeline AFTER
        this round, which keeps exact per-key sequential semantics. The
        lock is released between the round and the tail, as in the JAX
        package: another caller's window may interleave there. Returns None
        only for windows the native path cannot start (nothing mutated)."""
        w = _bucket_width(len(requests), self.min_width, self.max_width)
        packed = np.zeros((9, w), np.int64)
        with self._lock:
            t0 = time.perf_counter_ns()  # excludes the lock wait
            n0, lane_item, leftover, inject = self._prep_fast(
                self.directory, requests, packed, _GREG_MASK, self._inject_rows_out())
            if n0 == native.PREP_OVERCOMMIT:
                # mirror rows collected before the abort must still land
                self._apply_inject_rows(inject)
                raise RuntimeError(
                    f"key directory over-committed: >{self.capacity} "
                    "distinct keys in one lookup")
            if n0 < 0:
                return None
            stage = self.stats.stage_ns
            t1 = time.perf_counter_ns()
            stage["prep"] += t1 - t0
            self.stats.requests += n0
            self.stats.batches += 1
            self._apply_inject_rows(inject)
            responses: List[Optional[RateLimitResp]] = [None] * len(requests)
            if n0:
                self.stats.rounds += 1
                out = self._fetch_staged(self._dispatch_staged(packed, now_ms))
                t2 = time.perf_counter_ns()
                stage["device"] += t2 - t1
                status, limit, remaining, reset = out[:, :n0].tolist()
                over = 0
                for j, i in enumerate(lane_item.tolist()):
                    st = status[j]
                    if st == 1:
                        over += 1
                    responses[i] = RateLimitResp(
                        status=st, limit=limit[j], remaining=remaining[j],
                        reset_time=reset[j])
                self.stats.over_limit += over
                stage["demux"] += time.perf_counter_ns() - t2
        if len(leftover):
            idxs = leftover.tolist()
            tail = self._slow_window(
                [requests[i] for i in idxs], now_ms, count_batch=False)
            for i, resp in zip(idxs, tail):
                responses[i] = resp
        return responses  # type: ignore[return-value]

    # --------------------------------------------- native lone-request path

    def _inject_rows_out(self) -> Optional[np.ndarray]:
        """Where a lookup writes its dirty-mirror rows: the page-locked
        staging on CUDA, once no launched inject reads it any more; None
        (the binding allocates) on the CPU. Caller holds the engine lock."""
        return None if self._inject is None else self._inject.free()

    def _apply_inject_rows(self, inject) -> None:
        """Scatter reconciled mirror rows i64[m, 8] (slot, algo, limit,
        remaining, duration, stamp, expire_at, status) into the table BEFORE
        the window whose lookup surfaced them: the inject launches on the
        stream the decide launch follows on. On CUDA `inject` is always the
        first rows of the page-locked staging, where the lookup wrote them
        into _inject_rows_out(): the kernel reads them there, no copy up.
        Caller holds the engine lock."""
        if inject is None or len(inject) == 0:
            return
        if self._inject is None:
            inject_rows(self.state, self._up(inject))
        else:
            self._inject.launch(self.state, len(inject))

    def decide_native_single(self, req: RateLimitReq,
                             now_ms: int = 0) -> Optional[RateLimitResp]:
        """Decide a lone request against the key's row mirror entirely in C
        (keydir.cpp decide_one): no launch, no engine lock (the directory's
        mutex serializes against batch lookups). None = miss (cold or
        invalidated mirror, masked behavior, python directory): take the
        kernel path, then seed_mirror(). now_ms=0 reads the wall clock."""
        d = self.directory
        if not hasattr(d, "decide_one"):
            return None
        if int(req.behavior) & _NATIVE_SINGLE_SLOW_MASK:
            return None
        if not req.name or not req.unique_key:
            return None  # the kernel path produces the validation error
        out = d.decide_one(req.hash_key(), req.hits, req.limit,
                           req.duration, int(req.algorithm),
                           int(req.behavior), now_ms)
        if out is None:
            return None
        self.stats.requests += 1
        self.stats.native_singles += 1
        if out[0] == 1:
            self.stats.over_limit += 1
        return RateLimitResp(status=int(out[0]), limit=out[1],
                             remaining=out[2], reset_time=out[3])

    def seed_mirror(self, key: str) -> bool:
        """Copy a key's row from the table into its directory mirror (one
        1-slot gather), so later lone requests decide natively. False when
        the directory keeps no mirrors, the key is unknown or its row is
        vacant."""
        d = self.directory
        if not hasattr(d, "mirror_seed"):
            return False
        with self._lock:
            slot = d.peek_slot(key)
            if slot < 0:
                return False
            row = self._gather_row(slot)
            if row[0] < 0:
                return False  # vacant row: nothing to mirror
            d.mirror_seed(key, row)
        return True

    def _gather_row(self, slot: int) -> np.ndarray:
        """The 7 fields of the table row at `slot` (clamped), by one 1-slot
        gather. On CUDA the slot goes in and the row comes out through the
        page-locked lone buffers, with one wait on the current stream: the
        i64[7] returned IS the row buffer, valid until the next gather.
        Caller holds the engine lock."""
        lone = self._lone
        if lone is None:
            return gather_rows(self.state, self._up(np.array([slot], np.int32)))[:, 0].numpy()
        lone.slot_np[0] = slot
        gather_rows(self.state, lone.slot, lone.row)
        sync_stream(lone.index)
        return lone.row_np

    # ------------------------------------------------------------- internals

    def _split_scannable(self, windows):
        """Split the window list into a per-round head and a scannable tail.

        The tail is the maximal run of trailing windows no wider than
        min_width — round sizes only shrink, so the small windows the scan
        path exists for (duplicate-key rounds; a hot-key herd is d one-item
        rounds) always sit at the end. The capacity guard keeps a group's
        up-front directory lookups from recycling a slot an earlier window
        in the group already claimed."""
        if len(windows) <= 1:
            return windows, []
        split = len(windows)
        while split > 0 and len(windows[split - 1]) <= self.min_width:
            split -= 1
        tail = windows[split:]
        if len(tail) < 2 or sum(len(w) for w in tail) * 4 > self.capacity:
            return windows, []
        return windows[:split], tail

    def _lookup(self, round_work):
        keys = [item[1].hash_key() for item in round_work]
        slots, fresh, inj = self.directory.lookup_inject(keys, self._inject_rows_out())
        self._apply_inject_rows(inj)
        return slots, fresh

    def _demux(self, round_work, out, responses) -> None:
        status, limit, remaining, reset = out[:, :len(round_work)].tolist()
        for j, (i, _r, _ge, _gi) in enumerate(round_work):
            st = status[j]
            if st == 1:
                self.stats.over_limit += 1
            responses[i] = RateLimitResp(
                status=st, limit=limit[j], remaining=remaining[j],
                reset_time=reset[j])

    def _apply_windows_scanned(self, windows, now_ms, responses) -> None:
        """Retire every scannable window in ⌈N/32⌉ launches, window k+1 of
        a launch observing window k's writes."""
        stage = self.stats.stage_ns
        width = self.min_width  # _split_scannable guarantees every window fits
        for g0 in range(0, len(windows), self._MAX_SCAN):
            group = windows[g0:g0 + self._MAX_SCAN]
            if len(group) == 1:
                # a trailing singleton rides the single-window path
                self._apply_round(group[0], now_ms, responses)
                continue
            k = _bucket_pow2(len(group))
            stacked = np.zeros((k, 9, width), np.int64)
            stacked[:, 0, :] = -1  # pad windows are all padding lanes
            for gi, wk in enumerate(group):
                t = time.perf_counter_ns()
                slots, fresh = self._lookup(wk)
                t2 = time.perf_counter_ns()
                stage["lookup"] += t2 - t
                pack_window(wk, slots, fresh, width, out=stacked[gi])
                stage["pack"] += time.perf_counter_ns() - t2
            t = time.perf_counter_ns()
            out = self._fetch_staged(self._dispatch_scan_staged(stacked, now_ms))
            t2 = time.perf_counter_ns()
            stage["device"] += t2 - t
            for gi, wk in enumerate(group):
                self._demux(wk, out[gi], responses)
            stage["demux"] += time.perf_counter_ns() - t2

    def _apply_round(self, round_work, now_ms, responses) -> None:
        """One window, one launch. Caller holds the engine lock."""
        stage = self.stats.stage_ns
        t = time.perf_counter_ns()
        slots, fresh = self._lookup(round_work)
        t1 = time.perf_counter_ns()
        stage["lookup"] += t1 - t
        w = _bucket_width(len(round_work), self.min_width, self.max_width)
        packed = pack_window(round_work, slots, fresh, w)
        t2 = time.perf_counter_ns()
        stage["pack"] += t2 - t1
        out = self._fetch_staged(self._dispatch_staged(packed, now_ms))
        t3 = time.perf_counter_ns()
        stage["device"] += t3 - t2
        self._demux(round_work, out, responses)
        stage["demux"] += time.perf_counter_ns() - t3
