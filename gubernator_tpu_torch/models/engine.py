"""Single-table rate-limit engine: host batching over the decision kernel.

The counterpart of the JAX package's models/engine.py `Engine`, slimmed to
its request-object path. The engine owns:

- the key table, one i64[C, 8] tensor on the engine's device, updated IN
  PLACE by every window;
- the host key directory (models/keyspace.py);
- duplicate-key *rounds*: a window is split so each launch touches each
  slot at most once (occurrence k of a key goes to round k);
- the staging choice per window: lean i32[W] lane words when eligible,
  else compact i32[5, W], else wide i64[9, W] (ops/decide.py);
- the scan tail: the short trailing rounds run up to 32 windows per launch.

On CUDA every window is one host-to-device copy of its staging, one launch
of csrc/decide.cu and one copy of the response back. On the CPU the same
path runs the plain PyTorch version. The engine is synchronous and
thread-safe through one lock.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from gubernator_tpu_torch.models.keyspace import KeyDirectory
from gubernator_tpu_torch.models.prep import (
    bucket_pow2 as _bucket_pow2,
    bucket_width as _bucket_width,
    preprocess,
)
from gubernator_tpu_torch.ops.decide import (
    I64,
    TABLE_ROW_FIELDS,
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
from gubernator_tpu_torch.types import RateLimitReq, RateLimitResp
from gubernator_tpu_torch.utils.interval import millisecond_now
from gubernator_tpu_torch.utils.platform import resolve_device


def _inject_rows(state: torch.Tensor, slot, algo, limit, remaining, duration,
                 stamp, expire_at, status) -> None:
    """Scatter host-provided rows into the table IN PLACE (field 7 zeroed;
    padding lanes, slot -1, are dropped)."""
    slot = slot.to(I64)
    rows = torch.stack(
        [algo.to(I64), limit, remaining, duration, stamp, expire_at,
         status.to(I64), torch.zeros_like(limit)], dim=1)
    keep = (slot >= 0) & (slot < state.shape[-2])
    state.index_copy_(0, slot[keep], rows[keep])


def _gather_rows(state: torch.Tensor, slot):
    """Fetch rows (7-column tuple, table row field order); -1 lanes read
    row 0."""
    rows = state.index_select(0, slot.to(I64).clamp(min=0))
    return tuple(rows[:, i] for i in range(7))


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
        self.directory = KeyDirectory(capacity)
        self.min_width = min_width
        # one kernel round must never need more distinct slots than exist
        self.max_width = min(max_width, capacity)
        self._lock = threading.Lock()
        # lean staging needs every slot to fit the 24-bit lane field
        self._lean_ok = lean_capacity_ok(capacity)
        # "auto" ships each window on the leanest eligible format; "wide"
        # pins the i64[9] format
        self._staging = staging_policy()

    # ------------------------------------------------------------------ API

    def warmup(self) -> None:
        """Run every staging format once at every width bucket and scan
        depth the engine can dispatch, on all-padding windows (the table is
        not touched). On CUDA this builds and loads the kernel before the
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
        return self._slow_window(requests, now_ms)

    # -------------------------------------------------- staging dispatch

    def _up(self, a: np.ndarray) -> torch.Tensor:
        """One host array onto the engine's device."""
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

    def _apply_inject_rows(self, inject) -> None:
        """Scatter host rows i64[m, 8] (slot, algo, limit, remaining,
        duration, stamp, expire_at, status) into the table. The python
        directory returns none; the hook keeps the JAX engine's lookup
        contract. Caller holds the engine lock."""
        if inject is None or len(inject) == 0:
            return
        cols = [self._up(inject[:, f]) for f in range(TABLE_ROW_FIELDS)]
        _inject_rows(self.state, *cols)

    # ------------------------------------------------------------- internals

    def _slow_window(self, requests, now_ms) -> List[RateLimitResp]:
        """The python pipeline: full validation, gregorian precompute, and
        duplicate-key round splitting (models/prep.py)."""
        responses, rounds, _n_errors = preprocess(requests, now_ms)
        with self._lock:
            windows = []
            for round_work in rounds:
                for start in range(0, len(round_work), self.max_width):
                    windows.append(round_work[start:start + self.max_width])
            head, tail = self._split_scannable(windows)
            for wk in head:
                self._apply_round(wk, now_ms, responses)
            if tail:
                self._apply_windows_scanned(tail, now_ms, responses)
        return responses  # type: ignore[return-value]

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
        slots, fresh, inj = self.directory.lookup_inject(keys)
        self._apply_inject_rows(inj)
        return slots, fresh

    @staticmethod
    def _demux(round_work, out, responses) -> None:
        status, limit, remaining, reset = out[:, :len(round_work)].tolist()
        for j, (i, _r, _ge, _gi) in enumerate(round_work):
            responses[i] = RateLimitResp(
                status=status[j], limit=limit[j], remaining=remaining[j],
                reset_time=reset[j])

    def _apply_windows_scanned(self, windows, now_ms, responses) -> None:
        """Retire every scannable window in ⌈N/32⌉ launches, window k+1 of
        a launch observing window k's writes."""
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
                slots, fresh = self._lookup(wk)
                pack_window(wk, slots, fresh, width, out=stacked[gi])
            out = self._fetch_staged(self._dispatch_scan_staged(stacked, now_ms))
            for gi, wk in enumerate(group):
                self._demux(wk, out[gi], responses)

    def _apply_round(self, round_work, now_ms, responses) -> None:
        """One window, one launch. Caller holds the engine lock."""
        slots, fresh = self._lookup(round_work)
        w = _bucket_width(len(round_work), self.min_width, self.max_width)
        packed = pack_window(round_work, slots, fresh, w)
        out = self._fetch_staged(self._dispatch_staged(packed, now_ms))
        self._demux(round_work, out, responses)
