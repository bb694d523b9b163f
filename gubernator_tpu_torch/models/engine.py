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
  injects the mirror's row back into the table first;
- persistence (store.py): a Store read through before and written through
  after every window, a Loader restored at construction and saved by
  close(), and the streamed binary snapshot (snapshot_slabs), read from the
  table one slab of rows at a time.
- the JAX engine's observation hooks at the same sites: `metrics`,
  `hot_tracker`, `profiler` and `ledger`, and each launch noted in
  ops/decide.py kernel_telemetry.

On CUDA every window is one host-to-device copy of its staging, one launch
of csrc/decide.cu and one copy of the response back. get_rate_limits waits
for its response; the pipelined calls (launch_windows / collect_windows and
their columnar twins, driven by service/combiner.py) do not: each pipeline
slot stages through its own page-locked buffers (ops/staging.py), copies up
and back without blocking, and collect waits on the slot's event alone.
Mirror rows go in through csrc/rows.cu's inject with no copy: the key
directory writes them into a page-locked i64[max_width, 8] buffer the engine
allocates once, beside a device scratch of the same shape (ops/rows.py
InjectStaging); up to 448 of them go to the card in the launch's
parameters, more are read by the kernel there through their mapped address,
and from the library's copy_min up (a restore's chunks) one copy moves them
into the scratch and the kernel reads them there (the threshold measured on
an H100, PERF.md §6). After a mapped inject or a copy the buffer is handed
to the directory again only once the inject or the copy that reads it has
run (an event per such inject), since a scan group may look up, and inject,
many windows before its one wait. seed_mirror's one-slot gather, and the Store path's gathers, take
their slots from, and write their rows to, two page-locked host buffers the
engine allocates once (GatherBuffers): no copy either way, one wait on the
stream. A restore writes each chunk's rows into the same inject staging; a
snapshot copies each slab of rows into a page-locked buffer allocated at the
first snapshot (ops/rows.py SlabStaging) and waits on that buffer's event. On the CPU the same path runs the plain PyTorch
versions. The engine is thread-safe through one lock, which launches hold
and collects take only to add up their counters; a restore or a snapshot
takes it per chunk or slab, never across a yield.
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from gubernator_tpu_torch import native
from gubernator_tpu_torch.obs import witness
from gubernator_tpu_torch.obs.profile import Profiler
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
    kernel_fingerprint,
    kernel_telemetry,
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
    SlabStaging,
    gather_rows,
    gather_rows_pinned,
    inject_rows,
    sync_stream,
)
from gubernator_tpu_torch.ops.staging import WindowStaging
from gubernator_tpu_torch.store import BucketSnapshot, Loader, Store
from gubernator_tpu_torch.types import (
    SLOW_PATH_BEHAVIOR_MASK as _NATIVE_SINGLE_SLOW_MASK,
    Behavior,
    RateLimitReq,
    RateLimitResp,
)
from gubernator_tpu_torch.utils.interval import millisecond_now
from gubernator_tpu_torch.utils.platform import resolve_device

_GREG_MASK = int(Behavior.DURATION_IS_GREGORIAN)


class GatherBuffers(NamedTuple):
    """The page-locked gather operands on CUDA, for R = max_width slots: the
    i32[R] slots and the i64[7R] rows (a gather of m slots writes i64[7, m]
    into the first 7m), their numpy views, the first row's i64[7] view (the
    lone path's m = 1), and the card."""

    slot: torch.Tensor
    rows: torch.Tensor
    slot_np: np.ndarray
    rows_np: np.ndarray
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
    round split (`prep`), key-directory resolution (`lookup`), Store
    read-through and write-through (`store`: the rows' gathers, the Store's
    calls and the read-through's inject; 0 without a Store), staging-buffer
    fill (`pack`), kernel dispatch and readback (`device`) and response
    demux (`demux`). Lock waits are left out."""

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
        store: Optional[Store] = None,
        loader: Optional[Loader] = None,
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
        self.store = store
        self.loader = loader
        self.min_width = min_width
        # one kernel round must never need more distinct slots than exist
        self.max_width = min(max_width, capacity)
        self.stats = EngineStats()
        # The hooks the JAX package's Engine has, each None (or a disabled
        # profiler/ledger) until attached, so every observation site is one
        # attribute test: `metrics` (service/metrics.py: device and lane
        # histograms; set by the daemon and the cluster harness),
        # `hot_tracker` (service/leases.py HotKeyTracker: every staged
        # window's slots and hits, and the lone path's keys; set by
        # LeaseManager.arm), `profiler` (obs/profile.py: lock-wait, prep,
        # dispatch, readback and demux histograms; always present, taken by
        # the Instance) and `ledger` (obs/ledger.py DecisionLedger: each
        # window's slot, hits and response columns; set by the Instance).
        self.metrics = None
        self.hot_tracker = None
        self.profiler = Profiler()
        self.ledger = None
        self._lock = witness.make_lock("engine")
        # lean staging needs every slot to fit the 24-bit lane field
        self._lean_ok = lean_capacity_ok(capacity)
        # "auto" ships each window on the leanest eligible format; "wide"
        # pins the i64[9] format
        self._staging = staging_policy()
        # On CUDA, the page-locked gather buffers and the inject staging,
        # allocated once (a failed allocation raises). Every inject fits the
        # staging: the fast window looks up at most len(requests) <=
        # max_width keys and the python pipeline at most one window of
        # max_width, and a lookup emits at most one row per key.
        self._gather_buf: Optional[GatherBuffers] = None
        self._inject: Optional[InjectStaging] = None
        if self.device.type == "cuda":
            slot = torch.empty(self.max_width, dtype=torch.int32, pin_memory=True)
            rows = torch.empty(GATHER_FIELDS * self.max_width, dtype=torch.int64,
                               pin_memory=True)
            rows_np = rows.numpy()
            self._gather_buf = GatherBuffers(slot, rows, slot.numpy(), rows_np,
                                             rows_np[:GATHER_FIELDS], self.state.get_device())
            self._inject = InjectStaging.allocate(self.max_width, self.device)
        # the snapshot's page-locked slab on CUDA, allocated at the first
        # snapshot_slabs
        self._slab: Optional[SlabStaging] = None
        if loader is not None:
            if hasattr(loader, "load_slabs"):
                self.load_snapshot_slabs(loader.load_slabs())
            else:
                self.load_snapshot(loader.load())

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
        if (self._prep_fast is not None and self.store is None
                and 0 < len(requests) <= self.max_width):
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
        ht = self.hot_tracker
        if ht is not None:
            ht.feed_slots(packed[0], packed[1])
        w = packed.shape[1]
        t = time.perf_counter_ns()
        if self._staging != "wide":
            if self._lean_ok:
                ln = lean_window(packed, self.capacity)
                if ln is not None:
                    out = decide_packed_lean(self.state, self._up(ln[0]),
                                             self._up(ln[1]), now_ms)
                    kernel_telemetry.note("packed_lean", w,
                                          dur_ns=time.perf_counter_ns() - t)
                    return out, now_ms
            c = compact_window(packed)
            if c is not None:
                out = decide_packed_compact(self.state, self._up(c), now_ms)
                kernel_telemetry.note("packed_compact", w,
                                      dur_ns=time.perf_counter_ns() - t)
                return out, now_ms
        out = decide_packed(self.state, self._up(packed), now_ms)
        kernel_telemetry.note("packed_wide", w,
                              dur_ns=time.perf_counter_ns() - t)
        return out, None

    def _dispatch_scan_staged(self, stacked: np.ndarray, now_ms):
        """The scan launch of a wide i64[K, 9, W] stack, shipped lean or
        compact when eligible. Handle contract matches _dispatch_staged.
        Caller holds the engine lock."""
        ht = self.hot_tracker
        if ht is not None:
            ht.feed_slots(stacked[:, 0, :], stacked[:, 1, :])
        k, w = stacked.shape[0], stacked.shape[2]
        t = time.perf_counter_ns()
        if self._staging != "wide":
            if self._lean_ok:
                ln = lean_window(stacked, self.capacity)
                if ln is not None:
                    out = decide_scan_packed_lean(
                        self.state, self._up(ln[0]), self._up(ln[1]), now_ms)
                    kernel_telemetry.note("scan_lean", w, depth=k,
                                          dur_ns=time.perf_counter_ns() - t)
                    return out, now_ms
            c = compact_window(stacked)
            if c is not None:
                out = decide_scan_packed_compact(self.state, self._up(c), now_ms)
                kernel_telemetry.note("scan_compact", w, depth=k,
                                      dur_ns=time.perf_counter_ns() - t)
                return out, now_ms
        out = decide_scan_packed(self.state, self._up(stacked), now_ms)
        kernel_telemetry.note("scan_wide", w, depth=k,
                              dur_ns=time.perf_counter_ns() - t)
        return out, None

    def _obs_device(self, ns: int, lanes: int) -> None:
        """Feed one window's launch-and-readback wall time and live lane
        count into the daemon's histograms (no-op until a Metrics is
        attached)."""
        m = self.metrics
        if m is not None:
            m.engine_device_dispatch_ms.observe(ns / 1e6)
            m.engine_window_lanes.observe(lanes)

    def kernel_fingerprints(self) -> Dict[str, str]:
        """{kernel@width: digest} of the canonical decision launches (the
        wide window and the depth-2 scan at min_width), in the JAX
        package's keys. Every staging format runs from csrc/decide.cu, so
        the digest of its library (source and flags) names them all; the
        daemon compares it across boots (obs/profile.py check_recompile)."""
        fp = kernel_fingerprint()
        w = self.min_width
        return {f"packed_wide@{w}": fp, f"scan_wide@{w}": fp}

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
        prof = self.profiler
        prof.observe("prep", prep_ns)
        tq = time.perf_counter_ns() if prof.enabled else 0
        with self._lock:
            if tq:
                prof.lock_wait("slow_window", time.perf_counter_ns() - tq)
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
        prof = self.profiler
        tq = time.perf_counter_ns() if prof.enabled else 0
        with self._lock:
            t0 = time.perf_counter_ns()  # excludes the lock wait
            if tq:
                prof.lock_wait("fast_window", t0 - tq)
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
            prof.observe("prep", t1 - t0)
            self.stats.requests += n0
            self.stats.batches += 1
            self._apply_inject_rows(inject)
            responses: List[Optional[RateLimitResp]] = [None] * len(requests)
            if n0:
                self.stats.rounds += 1
                staged = self._dispatch_staged(packed, now_ms)
                td = time.perf_counter_ns()
                out = self._fetch_staged(staged)
                t2 = time.perf_counter_ns()
                stage["device"] += t2 - t1
                self._obs_device(t2 - t1, n0)
                prof.observe("dispatch", td - t1)
                prof.observe("readback", t2 - td)
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
                demux_ns = time.perf_counter_ns() - t2
                stage["demux"] += demux_ns
                prof.observe("demux", demux_ns)
                led = self.ledger
                if led is not None and led.enabled:
                    led.note_slots(packed, out, n0)
        if len(leftover):
            idxs = leftover.tolist()
            tail = self._slow_window(
                [requests[i] for i in idxs], now_ms, count_batch=False)
            for i, resp in zip(idxs, tail):
                responses[i] = resp
        return responses  # type: ignore[return-value]

    # ----------------------------------------------------- pipelined serving
    # The launch/collect split of the request-object path, as the JAX
    # package has it: service/combiner.py keeps up to `depth` window groups
    # in flight. Per-key sequential semantics survive because (a) launches
    # are serialized under the engine lock, so host prep order is launch
    # order, and (b) every launch updates the one table in place on one
    # stream, so the card applies the windows in that order. Leftover lanes
    # (duplicate occurrences, gregorian, invalid) retire AT LAUNCH, between
    # this group's launch and any later one, so a key's later arrivals
    # never overtake its packed first occurrence (tests/test_pipeline.py's
    # differentials, run through both packages by
    # tests/test_torch_pipeline.py). No launch waits on the card for its
    # own response: collect does, on the slot's event (ops/staging.py).

    def supports_pipeline(self) -> bool:
        """True when the non-blocking launch/collect split is available: the
        native one-pass prep and no Store (a Store's read-through and
        write-through are synchronous host calls around every window)."""
        return self._prep_fast is not None and self.store is None

    def _slot_staging(self, staging, kb: int, w: int) -> WindowStaging:
        """The pipeline slot's staging for a (kb, 9, w) group: from the
        slot's dict (keyed by shape), or allocated (and parked there)."""
        shape = (kb, 9, w)
        st = None if staging is None else staging.get(shape)
        if st is None:
            st = WindowStaging.allocate(kb, w, self.device)
            if staging is not None:
                staging[shape] = st
        return st

    def launch_windows(self, windows, now_ms: Optional[int] = None,
                       staging=None):
        """Launch 1..K request-object windows as ONE decide launch (K > 1
        rides the scan kernel) without waiting for the response.

        `windows` is a list of request lists, each 0 < len <= max_width;
        `staging`, when given, is a dict the engine parks the slot's staging
        in (ops/staging.py, keyed by shape): the combiner hands each
        pipeline slot its own dict, and a slot's buffers are refilled only
        once the card is done with its last launch. Returns an opaque handle
        for collect_windows, or None when the pipelined path cannot take the
        group at all (nothing mutated, nothing launched)."""
        if not self.supports_pipeline():
            return None
        k_req = len(windows)
        if not 0 < k_req <= self._MAX_SCAN:
            return None
        if any(not 0 < len(wk) <= self.max_width for wk in windows):
            return None
        if now_ms is None:
            now_ms = millisecond_now()
        w = max(_bucket_width(len(wk), self.min_width, self.max_width)
                for wk in windows)
        kb = _bucket_pow2(k_req) if k_req > 1 else 1
        st = self._slot_staging(staging, kb, w)
        buf = st.acquire()
        # Segmented group launch. A window whose prep yields LEFTOVERS cuts
        # the group: the segment so far launches and its tails retire before
        # any later window preps. Otherwise a key pending in window k's tail
        # could be overtaken by its next arrival packed into window k+1 of
        # the same launch. Distinct keys with hits=1 never cut: one scan
        # launch for the whole group.
        meta: List[Optional[tuple]] = [None] * k_req
        tails: List[Optional[list]] = [None] * k_req
        segments = []  # (slot handle, k_start, m) in launch order
        prof = self.profiler
        led = self.ledger
        if led is not None and not led.enabled:
            led = None
        stashes: List[Optional[tuple]] = [None] * k_req
        k = 0
        while k < k_req:
            seg_start = k
            tq = time.perf_counter_ns() if prof.enabled else 0
            with self._lock:
                t0 = time.perf_counter_ns()  # excludes the lock wait
                if tq:
                    prof.lock_wait("launch_windows", t0 - tq)
                total = 0
                rounds = 0
                cut = False
                while k < k_req and not cut:
                    wk = windows[k]
                    n0, lane_item, leftover, inject = self._prep_fast(
                        self.directory, wk, buf[k], _GREG_MASK,
                        self._inject_rows_out())
                    if n0 == native.PREP_OVERCOMMIT:
                        self._apply_inject_rows(inject)
                        raise RuntimeError(
                            f"key directory over-committed: "
                            f">{self.capacity} distinct keys in one lookup")
                    if n0 < 0:
                        # defensive: the size checks above rule this out;
                        # nothing was committed for THIS window, so it
                        # retires whole through the python tail
                        buf[k][0, :] = -1
                        meta[k] = (0, None,
                                   np.arange(len(wk), dtype=np.int32))
                        k += 1
                        cut = True
                        break
                    self._apply_inject_rows(inject)
                    if n0 == 0:
                        buf[k][0, :] = -1  # prep leaves the slot row zeroed
                    meta[k] = (n0, lane_item, leftover)
                    total += n0
                    rounds += 1 if n0 else 0
                    k += 1
                    cut = len(leftover) > 0
                m = k - seg_start
                t1 = time.perf_counter_ns()
                self.stats.stage_ns["prep"] += t1 - t0
                prof.observe("prep", t1 - t0)
                self.stats.requests += total
                self.stats.batches += m
                self.stats.rounds += rounds
                # a scan of m windows is padded to pow2(m): never with the
                # not-yet-prepped windows after a cut
                staged = self._dispatch_slot(st, seg_start, m, now_ms, m > 1)
                td = time.perf_counter_ns()
                self.stats.stage_ns["device"] += td - t1
                prof.observe("dispatch", td - t1)
                if led is not None:
                    # the slot's staging is refilled by its next launch;
                    # the collect pairs these copies with the responses
                    for kk in range(seg_start, k):
                        stashes[kk] = led.stash_columns(buf[kk], meta[kk][0])
            segments.append((staged, seg_start, m))
            # Leftover tails retire NOW, after this segment's launch and
            # before any later window preps, as the serial path orders them.
            # _slow_window waits for its own responses; rare path.
            for kk in range(seg_start, k):
                leftover = meta[kk][2]
                if leftover is not None and len(leftover):
                    idxs = leftover.tolist()
                    tails[kk] = self._slow_window(
                        [windows[kk][i] for i in idxs], now_ms,
                        count_batch=False)
        return (segments, windows, meta, tails, stashes)

    def collect_windows(self, handle):
        """Wait for a launched group's responses (in launch order) and
        demux: one response list per window, in launch order. Runs outside
        the engine lock (launch order is already fixed), so later launches
        proceed while this one drains."""
        segments, windows, meta, tails, stashes = handle
        led = self.ledger
        if led is not None and not led.enabled:
            led = None
        results: List[Optional[list]] = [None] * len(windows)
        over = 0
        lanes = 0
        t_fetch = 0
        t0 = time.perf_counter_ns()
        for staged, seg_start, m in segments:
            tf = time.perf_counter_ns()
            out = WindowStaging.fetch(staged)  # waits on this slot's event only
            t_fetch += time.perf_counter_ns() - tf
            scanned = staged[3]
            for k in range(seg_start, seg_start + m):
                wk = windows[k]
                n0, lane_item, leftover = meta[k]
                responses: List[Optional[RateLimitResp]] = [None] * len(wk)
                if n0:
                    rows = out[k - seg_start] if scanned else out
                    status, limit, remaining, reset = rows[:, :n0].tolist()
                    over += status.count(1)
                    if n0 == len(wk):
                        # nothing was skipped, so lanes are in request order
                        responses = [
                            RateLimitResp(st, li, re_, rs)
                            for st, li, re_, rs in zip(
                                status, limit, remaining, reset)
                        ]
                    else:
                        for j, i in enumerate(lane_item.tolist()):
                            responses[i] = RateLimitResp(
                                status[j], limit[j], remaining[j], reset[j])
                    lanes += n0
                    if led is not None:
                        led.note_slots_deferred(stashes[k], rows, n0)
                tail = tails[k]
                if tail is not None:
                    for i, resp in zip(leftover.tolist(), tail):
                        responses[i] = resp
                results[k] = responses
        t2 = time.perf_counter_ns()
        self._obs_device(t_fetch, lanes)
        prof = self.profiler
        prof.observe("readback", t_fetch)
        prof.observe("demux", t2 - t0 - t_fetch)
        with self._lock:  # concurrent completers: counters stay exact
            self.stats.over_limit += over
            self.stats.stage_ns["device"] += t_fetch
            self.stats.stage_ns["demux"] += t2 - t0 - t_fetch
        return results

    def launch_noop(self, width: Optional[int] = None):
        """Launch one all-padding window (every lane drops: the table is not
        touched) and return its handle: the combiner's depth probe times
        these. Each has a staging of its own, so probes in flight never
        wait on each other."""
        st = WindowStaging.allocate(1, width or self.min_width, self.device)
        st.acquire()[0, 0, :] = -1
        with self._lock:
            return self._dispatch_slot(st, 0, 1, 0, False)

    def collect_noop(self, handle) -> None:
        """Wait for a launch_noop's response."""
        WindowStaging.fetch(handle)

    def warmup_pipeline(self, max_group: int = 8) -> None:
        """Run the group-launch scan shapes (pow2 depths <= max_group at
        max_width) the pipelined combiner launches under bursts, every
        staging format, on all-padding windows (the table is not touched).
        Separate from warmup() so the extra boot cost is opt-in."""
        if not self.supports_pipeline():
            return
        both = self._staging != "wide"
        with self._lock:
            k = 2
            while k <= min(max_group, self._MAX_SCAN):
                stacked = np.zeros((k, 9, self.max_width), np.int64)
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
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def _dispatch_slot(self, st: WindowStaging, s: int, m: int, now_ms,
                       scan: bool):
        """Decide windows s..s+m of a slot's staging as one launch (a scan
        when `scan`, padded on the device to pow2(m) windows), shipped lean
        when eligible, compact otherwise, wide as the last resort: the
        _dispatch_staged choice, made on the same rows. The derived rows go
        into the slot's buffers at the same windows, the config table at
        s; the response is queued into the slot's response buffer. Returns
        the handle for WindowStaging.fetch. Caller holds the engine lock."""
        src = st.wide_np[s:s + m] if scan else st.wide_np[s]
        kb2 = _bucket_pow2(m) if scan else 0
        ht = self.hot_tracker
        if ht is not None:
            ht.feed_slots(src[..., 0, :], src[..., 1, :])
        form, depth = ("scan_", kb2) if scan else ("packed_", 1)
        w = src.shape[-1]
        t = time.perf_counter_ns()
        if self._staging != "wide":
            if self._lean_ok:
                ln = lean_window(src, self.capacity)
                if ln is not None:
                    st.np["lean"][s:s + m] = ln[0]
                    st.np["cfg"][s] = ln[1]
                    fn = decide_scan_packed_lean if scan else decide_packed_lean
                    out = fn(self.state, st.up("lean", s, m, kb2), st.up_cfg(s),
                             now_ms)
                    kernel_telemetry.note(form + "lean", w, depth=depth,
                                          dur_ns=time.perf_counter_ns() - t)
                    return st.keep(out, s, m, scan, now_ms)
            c = compact_window(src)
            if c is not None:
                st.np["compact"][s:s + m] = c
                fn = decide_scan_packed_compact if scan else decide_packed_compact
                out = fn(self.state, st.up("compact", s, m, kb2), now_ms)
                kernel_telemetry.note(form + "compact", w, depth=depth,
                                      dur_ns=time.perf_counter_ns() - t)
                return st.keep(out, s, m, scan, now_ms)
        fn = decide_scan_packed if scan else decide_packed
        out = fn(self.state, st.up("wide", s, m, kb2), now_ms)
        kernel_telemetry.note(form + "wide", w, depth=depth,
                              dur_ns=time.perf_counter_ns() - t)
        return st.keep(out, s, m, scan, None)

    # ------------------------------------------------------- columnar path

    def supports_columnar(self) -> bool:
        """True when the zero-object serving path is available: the native
        directory and no Store (its hooks need the request objects of every
        round)."""
        return self._prep_fast is not None and self.store is None

    def submit_columnar(self, n: int, keys, key_off, name_len, hits, limit,
                        duration, algorithm, behavior, slow_mask: int,
                        now_ms: Optional[int] = None):
        """Launch one columnar window: the wire columns (peerlink's
        pls_next_batch layout) go through the GIL-free C prep straight into
        the staging rows and onto the device, no RateLimitReq objects.

        Returns a handle for complete_columnar, or None when the columnar
        path cannot take the window at all (nothing mutated). The launch
        does not wait: callers may submit further windows before completing
        earlier ones. Items the C pass cannot take come back as `leftover`
        indices from complete_columnar: run them through the request-object
        path AFTER this round."""
        if not 0 < n <= self.max_width:
            return None
        if now_ms is None:
            now_ms = millisecond_now()
        st = WindowStaging.allocate(
            1, _bucket_width(n, self.min_width, self.max_width), self.device)
        packed = st.acquire()[0]
        prof = self.profiler
        tq = time.perf_counter_ns() if prof.enabled else 0
        with self._lock:
            t0 = time.perf_counter_ns()  # excludes the lock wait
            if tq:
                prof.lock_wait("submit_columnar", t0 - tq)
            n0, lane_item, leftover, inject = native.prep_pack_columnar(
                self.directory, n, keys, key_off, name_len, hits, limit,
                duration, algorithm, behavior, slow_mask, packed,
                self._inject_rows_out())
            if n0 == native.PREP_OVERCOMMIT:
                self._apply_inject_rows(inject)
                raise RuntimeError(
                    f"key directory over-committed: >{self.capacity} "
                    "distinct keys in one lookup")
            if n0 < 0:
                return None
            t1 = time.perf_counter_ns()
            self.stats.stage_ns["prep"] += t1 - t0
            prof.observe("prep", t1 - t0)
            self.stats.requests += n0
            self.stats.batches += 1
            self._apply_inject_rows(inject)
            handle = None
            stash = None
            if n0:
                self.stats.rounds += 1
                handle = self._dispatch_slot(st, 0, 1, now_ms, False)
                td = time.perf_counter_ns()
                self.stats.stage_ns["device"] += td - t1
                prof.observe("dispatch", td - t1)
                led = self.ledger
                if led is not None and led.enabled:
                    stash = led.stash_columns(packed, n0)
        return (handle, lane_item, leftover, n0, stash)

    def complete_columnar(self, handle, out_status, out_limit,
                          out_remaining, out_reset) -> np.ndarray:
        """Wait for a submitted window and scatter the four response rows
        into the caller's columns at the packed items' positions (outside
        the engine lock: launch order is already fixed). Returns the
        leftover item indices."""
        staged, lane_item, leftover, n0, stash = handle
        if n0:
            t0 = time.perf_counter_ns()
            rows = WindowStaging.fetch(staged)
            t1 = time.perf_counter_ns()
            led = self.ledger
            if led is not None and led.enabled:
                led.note_slots_deferred(stash, rows, n0)
            out_status[lane_item] = rows[0, :n0]
            out_limit[lane_item] = rows[1, :n0]
            out_remaining[lane_item] = rows[2, :n0]
            out_reset[lane_item] = rows[3, :n0]
            over = int(np.count_nonzero(rows[0, :n0] == 1))
            t2 = time.perf_counter_ns()
            self._obs_device(t1 - t0, n0)
            prof = self.profiler
            prof.observe("readback", t1 - t0)
            prof.observe("demux", t2 - t1)
            with self._lock:  # concurrent completers: counters stay exact
                self.stats.over_limit += over
                self.stats.stage_ns["device"] += t1 - t0
                self.stats.stage_ns["demux"] += t2 - t1
        return leftover

    # ------------------------------------------- pipelined columnar serving
    # The launch/collect split of the columnar path: the zero-object twin of
    # launch_windows/collect_windows, as the JAX package's peerlink service
    # drives it. Per-key wire order holds by the same argument, and a
    # window whose prep yields LEFTOVERS cuts the group: the caller must
    # collect and retire them through the request-object path before
    # launching any later sub-window.

    def launch_columnar_windows(self, windows, slow_mask: int,
                                now_ms: Optional[int] = None, staging=None):
        """Launch a PREFIX of 1..K columnar sub-windows as ONE decide launch
        (K > 1 rides the scan kernel) without waiting for the response.

        `windows` is a list of column tuples (n, keys, key_off, name_len,
        hits, limit, duration, algorithm, behavior) in the peerlink wire
        layout (see submit_columnar), each 0 < n <= max_width; `staging`
        follows the launch_windows contract. Windows prep in order under ONE
        lock hold; the first window whose prep yields leftovers is the LAST
        window launched (the group-cut barrier).

        Returns None when the path cannot take the FIRST window at all
        (nothing mutated: fall back to the object path); otherwise an opaque
        handle for collect_columnar_windows: handle[0] is the per-window
        meta list (len = windows CONSUMED, each meta's last element the
        leftover item indices) and handle[1] an over-commit error message
        or None. On over-commit the windows prepped before the failure still
        launch (their directory commits must reach the device); the failing
        window and everything after it are NOT consumed (the caller
        error-fills their items)."""
        if not self.supports_columnar():
            return None
        k_req = len(windows)
        if not 0 < k_req <= self._MAX_SCAN:
            return None
        if any(not 0 < wc[0] <= self.max_width for wc in windows):
            return None
        if now_ms is None:
            now_ms = millisecond_now()
        w = max(_bucket_width(wc[0], self.min_width, self.max_width)
                for wc in windows)
        kb = _bucket_pow2(k_req) if k_req > 1 else 1
        st = self._slot_staging(staging, kb, w)
        buf = st.acquire()
        metas: List[tuple] = []
        failed = None
        prof = self.profiler
        led = self.ledger
        if led is not None and not led.enabled:
            led = None
        stashes: List[Optional[tuple]] = []
        tq = time.perf_counter_ns() if prof.enabled else 0
        with self._lock:
            t0 = time.perf_counter_ns()  # excludes the lock wait
            if tq:
                prof.lock_wait("launch_columnar_windows", t0 - tq)
            total = 0
            rounds = 0
            for k, wc in enumerate(windows):
                (n, keys, key_off, name_len, hits, limit, duration,
                 algorithm, behavior) = wc
                n0, lane_item, leftover, inject = native.prep_pack_columnar(
                    self.directory, n, keys, key_off, name_len, hits,
                    limit, duration, algorithm, behavior, slow_mask,
                    buf[k], self._inject_rows_out())
                if n0 == native.PREP_OVERCOMMIT:
                    # earlier windows committed directory state and MUST
                    # still launch; this window and the rest are not
                    # consumed (the caller error-fills their items)
                    self._apply_inject_rows(inject)
                    buf[k][0, :] = -1  # partially-written row: all padding
                    failed = (f"key directory over-committed: "
                              f">{self.capacity} distinct keys in one "
                              "lookup")
                    break
                if n0 < 0:
                    if k == 0:
                        return None  # nothing mutated: object-path fallback
                    # defensive: the size checks rule this out; nothing was
                    # committed for THIS window, so it retires whole through
                    # the caller's leftover path, cutting the group here
                    buf[k][0, :] = -1
                    metas.append((0, None, np.arange(n, dtype=np.int32)))
                    break
                self._apply_inject_rows(inject)
                if n0 == 0:
                    buf[k][0, :] = -1  # prep leaves the slot row zeroed
                metas.append((n0, lane_item, leftover))
                total += n0
                rounds += 1 if n0 else 0
                if len(leftover):
                    break  # group-cut barrier: leftovers retire first
            m = len(metas)
            t1 = time.perf_counter_ns()
            self.stats.stage_ns["prep"] += t1 - t0
            prof.observe("prep", t1 - t0)
            self.stats.requests += total
            self.stats.batches += m
            self.stats.rounds += rounds
            staged = None
            if total:
                # only the m consumed windows launch, padded to pow2(m)
                staged = self._dispatch_slot(st, 0, m, now_ms, m > 1)
                td = time.perf_counter_ns()
                self.stats.stage_ns["device"] += td - t1
                prof.observe("dispatch", td - t1)
                if led is not None:
                    stashes = [led.stash_columns(buf[kk], metas[kk][0])
                               for kk in range(m)]
        return (metas, failed, staged, stashes)

    def collect_columnar_windows(self, handle, outs):
        """Wait for a launched columnar group's response (outside the engine
        lock: launch order is already fixed) and scatter each window's rows
        into the caller's column buffers. `outs` is one (status, limit,
        remaining, reset) array 4-tuple per CONSUMED window, each sized to
        that window's item count. Returns the per-window leftover index
        arrays: at most the LAST consumed window's is non-empty (the
        group-cut barrier)."""
        metas, _failed, staged, stashes = handle
        led = self.ledger
        if led is not None and not led.enabled:
            led = None
        t0 = time.perf_counter_ns()
        rows_all = WindowStaging.fetch(staged) if staged is not None else None
        t1 = time.perf_counter_ns()
        scanned = staged is not None and staged[3]
        over = 0
        lanes = 0
        leftovers = []
        for k, ((n0, lane_item, leftover), out) in enumerate(zip(metas, outs)):
            if n0:
                rows = rows_all[k] if scanned else rows_all
                st, li, re, rs = out
                st[lane_item] = rows[0, :n0]
                li[lane_item] = rows[1, :n0]
                re[lane_item] = rows[2, :n0]
                rs[lane_item] = rows[3, :n0]
                over += int(np.count_nonzero(rows[0, :n0] == 1))
                lanes += n0
                if led is not None and k < len(stashes):
                    led.note_slots_deferred(stashes[k], rows, n0)
            leftovers.append(leftover)
        t2 = time.perf_counter_ns()
        if lanes:
            self._obs_device(t1 - t0, lanes)
        prof = self.profiler
        prof.observe("readback", t1 - t0)
        prof.observe("demux", t2 - t1)
        with self._lock:  # concurrent completers: counters stay exact
            self.stats.over_limit += over
            self.stats.stage_ns["device"] += t1 - t0
            self.stats.stage_ns["demux"] += t2 - t1
        return leftovers

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
        invalidated mirror, masked behavior, python directory, a Store):
        take the kernel path, then seed_mirror(). now_ms=0 reads the wall
        clock."""
        d = self.directory
        if self.store is not None or not hasattr(d, "decide_one"):
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
        if self.hot_tracker is not None:
            # lone decisions stage no slot rows: the detector is fed by key
            self.hot_tracker.feed_key(req.hash_key(), req.hits)
        led = self.ledger
        if led is not None and led.enabled:
            led.record_key(req.hash_key(), req.hits, int(out[0]),
                           int(out[1]), int(out[3]))
        return RateLimitResp(status=int(out[0]), limit=out[1],
                             remaining=out[2], reset_time=out[3])

    def seed_mirror(self, key: str) -> bool:
        """Copy a key's row from the table into its directory mirror (one
        1-slot gather), so later lone requests decide natively. False when
        the engine has a Store, the directory keeps no mirrors, the key is
        unknown or its row is vacant."""
        d = self.directory
        if self.store is not None or not hasattr(d, "mirror_seed"):
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
        gather. On CUDA the slot goes in (by value) and the row comes out
        through the page-locked gather buffers, with one wait on the current
        stream: the i64[7] returned IS the first row of those buffers, valid
        until the next gather. Caller holds the engine lock."""
        g = self._gather_buf
        if g is None:
            return gather_rows(self.state, self._up(np.array([slot], np.int32)))[:, 0].numpy()
        g.slot_np[0] = slot
        gather_rows_pinned(self.state, g.slot, g.rows, 1)
        sync_stream(g.index)
        return g.row_np

    def _inject_host_rows(self, rows: np.ndarray) -> None:
        """Scatter host rows i64[m, 8] (the _apply_inject_rows layout) that
        lie outside the inject staging, such as a Store's or a mirror
        flush's: on CUDA copied into the staging and launched from there,
        max_width rows at a time; on the CPU the plain inject. Caller holds
        the engine lock."""
        if len(rows) == 0:
            return
        if self._inject is None:
            inject_rows(self.state, self._up(rows))
        else:
            self._inject.inject(self.state, rows)

    def _gather_slots(self, slots) -> np.ndarray:
        """The first 7 fields of the rows at `slots` (clamped), a new i64[7, m]
        on the host. On CUDA through the page-locked gather buffers, max_width
        slots a launch, one wait on the stream each; on the CPU one gather.
        Caller holds the engine lock."""
        g = self._gather_buf
        if g is None:
            return gather_rows(self.state, self._up(np.asarray(slots, np.int32))).cpu().numpy()
        slots = np.asarray(slots, np.int32)
        m, R = len(slots), len(g.slot_np)
        out = np.empty((GATHER_FIELDS, m), np.int64)
        for start in range(0, m, R):
            n = min(R, m - start)
            g.slot_np[:n] = slots[start:start + n]
            gather_rows_pinned(self.state, g.slot, g.rows, n)
            sync_stream(g.index)
            out[:, start:start + n] = g.rows_np[:GATHER_FIELDS * n].reshape(GATHER_FIELDS, n)
        return out

    def _flush_mirrors(self) -> None:
        """Inject every dirty lone-path mirror row, so the table holds the
        native decisions newer than its rows. Caller holds the engine
        lock."""
        flush = getattr(self.directory, "mirror_flush", None)
        if flush is None:
            return
        while True:
            inj = flush()
            if not len(inj):
                return
            self._inject_host_rows(inj)

    # ---------------------------------------------------- host-state reads

    def resolve_slots(self, slots) -> dict:
        """Map a small set of slots back to their hash-key strings, by one
        walk of the directory (the hot-key tracker's call, off the serving
        path). Slots without a live directory entry are absent."""
        want = set(int(s) for s in slots)
        if not want:
            return {}
        out: dict = {}
        if hasattr(self.directory, "items_raw"):
            blob, off, slots32 = self.directory.items_raw()
            sl = np.asarray(slots32, np.int64)
            off = np.asarray(off, np.int64)
            hit = np.nonzero(np.isin(
                sl, np.fromiter(want, np.int64, len(want))))[0]
            for i in hit:
                lo, hi = int(off[i]), int(off[i + 1])
                try:
                    out[int(sl[i])] = bytes(blob[lo:hi]).decode("utf-8")
                except UnicodeDecodeError:
                    continue
        else:  # python directory
            for key, s in self.directory.items():
                if int(s) in want:
                    out[int(s)] = key
        return out

    def _slots_of(self, keys):
        """[(key, slot)] for the keys the directory holds, recency
        untouched. Caller holds the engine lock."""
        d = self.directory
        peek = getattr(d, "peek_slot", None)
        table = None if peek is not None else dict(d.items())
        pairs = []
        for key in keys:
            slot = peek(key) if peek is not None else table.get(key, -1)
            if slot >= 0:
                pairs.append((key, int(slot)))
        return pairs

    def device_hit_counts(self, keys) -> dict:
        """Per-key lifetime attempt counters, row field 7 (the decide kernel
        adds every round's requested hits there). A debug surface: the rows
        are read by indexing the table, as the JAX package's is not jitted
        either (the gather kernel returns fields 0-6 only)."""
        with self._lock:
            pairs = self._slots_of(keys)
            if not pairs:
                return {}
            idx = torch.tensor([s for _, s in pairs], dtype=torch.int64,
                               device=self.device)
            rows = self.state[idx].cpu().numpy()
        return {key: int(rows[i, 7]) for i, (key, _) in enumerate(pairs)}

    def rows_for_keys(self, keys):
        """Point-read the named keys' live rows -> (found_keys,
        rows i64[len(found), 7]) in BucketSnapshot field order (the reshard
        exporter's settle read). Dirty lone-path mirrors are injected first,
        as snapshot_slabs does; absent, vacant and expired keys are not in
        found_keys."""
        now = millisecond_now()
        with self._lock:
            self._flush_mirrors()
            pairs = self._slots_of(keys)
            if not pairs:
                return [], np.zeros((0, 7), np.int64)
            rows = self._gather_slots([s for _, s in pairs]).T
        live = (rows[:, 0] >= 0) & (rows[:, 5] >= now)
        found = [key for (key, _), ok in zip(pairs, live) if ok]
        return found, np.ascontiguousarray(rows[live])

    # ------------------------------------------------------- persistence

    def _restore_rows(self, m: int) -> np.ndarray:
        """Where a restore chunk's m <= max_width inject rows go: the first
        m rows of the page-locked staging on CUDA (launched from there by
        _apply_inject_rows), a new array on the CPU. Caller holds the
        engine lock."""
        out = self._inject_rows_out()
        return np.empty((m, 8), np.int64) if out is None else out[:m]

    def load_snapshot(self, items) -> int:
        """Seed table rows from BucketSnapshots (a Loader's load()),
        consumed incrementally: one max_width chunk exists at a time. The
        engine lock is taken per chunk and never while pulling the source,
        which may be this engine's own snapshot_stream."""
        it_stream = iter(items)
        n = 0
        while True:
            chunk = list(itertools.islice(it_stream, self.max_width))
            if not chunk:
                break
            with self._lock:
                slots, _ = self.directory.lookup([it.key for it in chunk])
                rows = self._restore_rows(len(chunk))
                rows[:, 0] = slots
                rows[:, 1:] = [(it.algo, it.limit, it.remaining, it.duration,
                                it.stamp, it.expire_at, it.status) for it in chunk]
                self._apply_inject_rows(rows)
                n += len(chunk)
        return n

    def load_snapshot_slabs(self, slabs) -> int:
        """Binary restore: consume (key_blob, key_offsets i64[m+1],
        rows i64[m, 7]) chunks, snapshot_slabs' shape, with no per-row host
        objects, max_width rows an inject. Same locking as load_snapshot.
        The dirty-mirror rows a lookup_raw returns are dropped: the restored
        rows overwrite those keys."""
        lookup_raw = getattr(self.directory, "lookup_raw", None)
        n = 0
        for blob, off, rows in slabs:
            off = np.asarray(off, np.int64)
            rows = np.asarray(rows, np.int64)
            m = len(off) - 1
            for s in range(0, m, self.max_width):
                e = min(s + self.max_width, m)
                with self._lock:
                    if lookup_raw is not None:
                        slots, _fresh, _inj = lookup_raw(
                            bytes(blob[off[s]:off[e]]), off[s:e + 1] - off[s])
                    else:
                        keys = [blob[off[i]:off[i + 1]].decode("utf-8")
                                for i in range(s, e)]
                        slots, _ = self.directory.lookup(keys)
                    inject = self._restore_rows(e - s)
                    inject[:, 0] = slots
                    inject[:, 1:] = rows[s:e]
                    self._apply_inject_rows(inject)
                    n += e - s
        return n

    # 16 MiB of rows per slab: the streamed snapshot's host footprint per
    # step, and the page-locked slab's size on CUDA
    _SNAPSHOT_SLAB_ROWS = 1 << 18

    def _read_slab(self, start: int, rows: int) -> np.ndarray:
        """Table rows start..start+rows on the host: on CUDA through the
        page-locked slab (allocated at the first snapshot), a view valid
        until the next read; on the CPU a view of the table. Caller holds
        the engine lock and copies out what it keeps."""
        if self.device.type == "cpu":
            return self.state.narrow(0, start, rows).numpy()
        if self._slab is None or len(self._slab.rows_np) != rows:
            self._slab = SlabStaging.allocate(rows, self.device)
        return self._slab.read(self.state, start)

    def snapshot_slabs(self, include_expired: bool = False):
        """Stream live rows as binary slabs: yields (key_blob: bytes,
        key_offsets: i64[m+1], rows: i64[m, 7]) chunks in slot order, field
        order as BucketSnapshot (algo, limit, remaining, duration, stamp,
        expire_at, status), with no per-row host objects.

        The table is read in slabs of _SNAPSHOT_SLAB_ROWS rows, each
        filtered in numpy (vacant rows, and expired ones unless
        `include_expired`), so the extra host memory is one slab and its
        live subset whatever the table's size. The engine lock is taken per
        slab, never across a yield. Under live traffic each slab is
        consistent in itself, and an entry whose slot was recycled between
        the directory walk and its slab is checked (one batch peek a slab)
        and skipped."""
        now = millisecond_now()
        with self._lock:
            self._flush_mirrors()
            if hasattr(self.directory, "items_raw"):
                blob, off, slots32 = self.directory.items_raw()
            else:  # python directory: build the arena once
                entries = self.directory.items()
                keys_b = [k.encode("utf-8") for k, _ in entries]
                blob = b"".join(keys_b)
                off = np.zeros(len(keys_b) + 1, np.int64)
                if keys_b:
                    np.cumsum([len(b) for b in keys_b], out=off[1:])
                slots32 = np.fromiter((s for _, s in entries), np.int32,
                                      count=len(entries))
        n = len(slots32)
        if n == 0:
            return
        off = np.asarray(off, np.int64)
        lens = off[1:] - off[:-1]
        slots = slots32.astype(np.int64)
        order = np.argsort(slots, kind="stable")
        slots_sorted = slots[order]
        S = min(self._SNAPSHOT_SLAB_ROWS, self.capacity)
        batch_peek = getattr(self.directory, "peek_slots_raw", None)
        peek_one = getattr(self.directory, "peek_slot", None)
        blob_arr = np.frombuffer(blob, np.uint8)

        def gather_keys(sel):
            """The selected keys' bytes and offsets, without a python loop."""
            ln = lens[sel]
            sub_off = np.zeros(sel.size + 1, np.int64)
            np.cumsum(ln, out=sub_off[1:])
            total = int(sub_off[-1])
            # each key's start repeated over its length, plus the offset
            # within the key
            pos = np.repeat(off[sel] - sub_off[:-1], ln) + \
                np.arange(total, dtype=np.int64)
            return blob_arr[pos].tobytes(), sub_off

        for a in range(0, self.capacity, S):
            lo, hi = np.searchsorted(slots_sorted, (a, a + S))
            if lo == hi:
                continue  # no directory entries in this row range
            # the final partial slab is read from capacity - S, as the JAX
            # package's dynamic_slice clamps its start, and indexed relative
            # to that start
            cs = min(a, self.capacity - S)
            idx = order[lo:hi]  # entry indices, slot order
            ent_slots = slots_sorted[lo:hi]
            with self._lock:
                rows = self._read_slab(cs, S)[ent_slots - cs]  # a copy
            live = rows[:, 0] >= 0  # algo < 0 marks a vacant row
            if not include_expired:
                live &= rows[:, 5] >= now
            sel = idx[live]
            if sel.size == 0:
                continue
            ent_sel = ent_slots[live].astype(np.int32)
            sub_blob, sub_off = gather_keys(sel)
            # a slot recycled since the walk is not this key's row any more
            if batch_peek is not None:
                okm = batch_peek(sub_blob, sub_off) == ent_sel
            elif peek_one is not None:
                okm = np.fromiter(
                    (peek_one(sub_blob[sub_off[k]:sub_off[k + 1]]
                              .decode("utf-8")) == int(s)
                     for k, s in enumerate(ent_sel)), bool, count=sel.size)
            else:
                okm = np.ones(sel.size, bool)
            rows_live = rows[live]
            if not okm.all():
                keep = np.flatnonzero(okm)
                sub_blob, sub_off = gather_keys(sel[keep])
                rows_live = rows_live[keep]
            yield sub_blob, sub_off, np.ascontiguousarray(rows_live[:, :7])

    def snapshot_stream(self, include_expired: bool = False):
        """Live rows as BucketSnapshots: snapshot_slabs' walk, order and
        consistency, one object a row."""
        for blob, off, rows in self.snapshot_slabs(include_expired):
            for j in range(len(off) - 1):
                r = rows[j]
                yield BucketSnapshot(
                    key=blob[off[j]:off[j + 1]].decode("utf-8"),
                    algo=int(r[0]), limit=int(r[1]), remaining=int(r[2]),
                    duration=int(r[3]), stamp=int(r[4]),
                    expire_at=int(r[5]), status=int(r[6]))

    def snapshot(self, include_expired: bool = False) -> List[BucketSnapshot]:
        """snapshot_stream as a list (small tables, tests)."""
        return list(self.snapshot_stream(include_expired))

    def close(self) -> None:
        """Save the table through the Loader, as a daemon does at shutdown:
        the binary slab stream to a Loader that takes it, BucketSnapshots
        to any other."""
        if self.loader is not None:
            if hasattr(self.loader, "save_slabs"):
                self.loader.save_slabs(self.snapshot_slabs())
            else:
                self.loader.save(self.snapshot_stream())

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

    def _lookup(self, keys):
        """Slots and fresh flags of `keys`, the dirty-mirror rows the lookup
        surfaced injected first. A window's keys fit the inject staging; a
        Store's scanned-tail union may not, and its rows are copied in.
        Caller holds the engine lock."""
        if len(keys) <= self.max_width:
            slots, fresh, inj = self.directory.lookup_inject(
                keys, self._inject_rows_out())
            self._apply_inject_rows(inj)
        else:
            slots, fresh, inj = self.directory.lookup_inject(keys)
            self._inject_host_rows(inj)
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
        a launch observing window k's writes.

        With a Store, the tail takes one read-through before it and one
        write-through after it (each key's final row), over the union of
        its keys, resolved by one lookup: the first window alone is not a
        superset when round 0 was cut at max_width (rounds [64+2, 4, 4] put
        the 4 duplicated keys' first occurrences in a head chunk). Each
        window takes its slots from that lookup, and a key's fresh flag goes
        to its first window only: a second lookup would clear the flag of a
        key first seen in a later tail window, and the kernel would read a
        recycled slot's stale row as live."""
        stage = self.stats.stage_ns
        width = self.min_width  # _split_scannable guarantees every window fits
        union = None
        if self.store is not None and windows:
            seen_keys = {}
            for wk in windows:
                for item in wk:
                    seen_keys.setdefault(item[1].hash_key(), item)
            t = time.perf_counter_ns()
            ukeys = list(seen_keys)
            uslots, ufresh = self._lookup(ukeys)
            t2 = time.perf_counter_ns()
            stage["lookup"] += t2 - t
            uwork = list(seen_keys.values())
            ufresh = self._store_read_through(uwork, ukeys, uslots, ufresh, now_ms)
            stage["store"] += time.perf_counter_ns() - t2
            union = (uwork, ukeys, uslots)
            slot_map = dict(zip(ukeys, uslots))
            fresh_map = {k: f for k, f in zip(ukeys, ufresh) if f}

        def resolve(wk):
            keys = [item[1].hash_key() for item in wk]
            if union is None:
                return self._lookup(keys)
            return ([slot_map[k] for k in keys],
                    [fresh_map.pop(k, False) for k in keys])

        for g0 in range(0, len(windows), self._MAX_SCAN):
            group = windows[g0:g0 + self._MAX_SCAN]
            if len(group) == 1:
                # a trailing singleton rides the single-window path
                self._apply_round(group[0], now_ms, responses,
                                  skip_store=union is not None,
                                  resolved=None if union is None else resolve(group[0]))
                continue
            k = _bucket_pow2(len(group))
            stacked = np.zeros((k, 9, width), np.int64)
            stacked[:, 0, :] = -1  # pad windows are all padding lanes
            host_ns = 0
            for gi, wk in enumerate(group):
                t = time.perf_counter_ns()
                slots, fresh = resolve(wk)
                t2 = time.perf_counter_ns()
                stage["lookup"] += t2 - t
                pack_window(wk, slots, fresh, width, out=stacked[gi])
                t3 = time.perf_counter_ns()
                stage["pack"] += t3 - t2
                host_ns += t3 - t
            prof = self.profiler
            prof.observe("prep", host_ns)
            t = time.perf_counter_ns()
            staged = self._dispatch_scan_staged(stacked, now_ms)
            td = time.perf_counter_ns()
            out = self._fetch_staged(staged)
            t2 = time.perf_counter_ns()
            stage["device"] += t2 - t
            self._obs_device(t2 - t, sum(len(w) for w in group))
            prof.observe("dispatch", td - t)
            prof.observe("readback", t2 - td)
            led = self.ledger
            for gi, wk in enumerate(group):
                self._demux(wk, out[gi], responses)
                if led is not None and led.enabled:
                    led.note_slots(stacked[gi], out[gi], len(wk))
            demux_ns = time.perf_counter_ns() - t2
            stage["demux"] += demux_ns
            prof.observe("demux", demux_ns)
        if union is not None:
            t = time.perf_counter_ns()
            self._store_write_through(*union)
            stage["store"] += time.perf_counter_ns() - t

    def _apply_round(self, round_work, now_ms, responses,
                     skip_store: bool = False, resolved=None) -> None:
        """One window, one launch. `skip_store` marks a tail singleton of
        _apply_windows_scanned, whose read-through and write-through cover
        its keys already; `resolved` is that pass's (slots, fresh), so no
        second lookup clears a fresh flag. Caller holds the engine lock."""
        stage = self.stats.stage_ns
        t = time.perf_counter_ns()
        keys = [item[1].hash_key() for item in round_work]
        slots, fresh = self._lookup(keys) if resolved is None else resolved
        t1 = time.perf_counter_ns()
        lookup_ns = t1 - t
        stage["lookup"] += lookup_ns
        use_store = self.store is not None and not skip_store
        if use_store:
            fresh = self._store_read_through(round_work, keys, slots, fresh, now_ms)
            t2 = time.perf_counter_ns()
            stage["store"] += t2 - t1
            t1 = t2
        n = len(round_work)
        w = _bucket_width(n, self.min_width, self.max_width)
        packed = pack_window(round_work, slots, fresh, w)
        t2 = time.perf_counter_ns()
        stage["pack"] += t2 - t1
        # lookup and pack are host prep in the profiler's cycle taxonomy
        prof = self.profiler
        prof.observe("prep", lookup_ns + (t2 - t1))
        staged = self._dispatch_staged(packed, now_ms)
        td = time.perf_counter_ns()
        out = self._fetch_staged(staged)
        t3 = time.perf_counter_ns()
        stage["device"] += t3 - t2
        self._obs_device(t3 - t2, n)
        prof.observe("dispatch", td - t2)
        prof.observe("readback", t3 - td)
        self._demux(round_work, out, responses)
        t4 = time.perf_counter_ns()
        stage["demux"] += t4 - t3
        prof.observe("demux", t4 - t3)
        led = self.ledger
        if led is not None and led.enabled:
            led.note_slots(packed, out, n)
        if use_store:
            self._store_write_through(round_work, keys, slots)
            stage["store"] += time.perf_counter_ns() - t4

    def _store_read_through(self, round_work, keys, slots, fresh, now_ms):
        """Ask the Store for the rows the table cannot serve (fresh, vacant
        or expired, or of another algorithm, which the Store then removes)
        and inject what it returns before the window decides. Returns the
        fresh flags, cleared where a row was injected. Caller holds the
        engine lock."""
        cols = self._gather_slots(slots)
        algo_c, exp_c = cols[0].tolist(), cols[5].tolist()
        fresh = list(fresh)
        got = []
        for j, (_i, r, _ge, _gi) in enumerate(round_work):
            live = not fresh[j] and algo_c[j] >= 0 and now_ms <= exp_c[j]
            if live and algo_c[j] != int(r.algorithm):
                # an algorithm switch discards the old bucket everywhere
                self.store.remove(keys[j])
                live = False
            if live:
                continue
            item = self.store.get(r)
            if item is None:
                continue
            got.append((slots[j], item.algo, item.limit, item.remaining,
                        item.duration, item.stamp, item.expire_at, item.status))
            fresh[j] = False  # the injected row is live now
        if got:
            self._inject_host_rows(np.array(got, np.int64))
        return fresh

    def _store_write_through(self, round_work, keys, slots) -> None:
        """Report each key's row after the window to the Store; a row the
        window cleared (RESET_REMAINING) is removed from the Store and its
        key from the directory. Caller holds the engine lock."""
        cols = self._gather_slots(slots).tolist()
        for j, (_i, r, _ge, _gi) in enumerate(round_work):
            algo = cols[0][j]
            if algo < 0:
                self.store.remove(keys[j])
                self.directory.drop(keys[j])
                continue
            self.store.on_change(r, BucketSnapshot(
                key=keys[j], algo=algo, limit=cols[1][j],
                remaining=cols[2][j], duration=cols[3][j],
                stamp=cols[4][j], expire_at=cols[5][j], status=cols[6][j]))
