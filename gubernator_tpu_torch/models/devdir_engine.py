"""Engine with the device-resident key directory (GUBER_DEVICE_DIRECTORY).

The counterpart of the JAX package's models/devdir_engine.py DevDirEngine.
The standard Engine resolves key strings to table slots in the host C++
directory before every window. This engine ships an 8-byte fingerprint per
request instead and lets the card resolve, claim or evict the slot
(ops/devdir.py probe_assign_evict), then decide the window on those slots
(ops/decide.py decide_packed): the slot never goes to the host.

On CUDA one dispatch is one copy up of an i64[10, W] buffer (rows 1-7 of the
wide staging and, as row 9, the fingerprints), the probe kernel (which
writes the slot and fresh rows 0 and 8 of that staging on the card), the
wide decide kernel on the same stream, and one copy back of the response
rows with the retry flags. On the CPU the same dispatch runs the plain
versions.

Semantics are those of the host-directory Engine with two documented
deviations: eviction is aged (least recently used among a key's
PROBE_DEPTH candidates) rather than a global LRU, and two distinct keys with
equal 63-bit fingerprints alias to one bucket. In-batch claim conflicts
between distinct keys retry in a follow-up dispatch (at most
PROBE_RETRIES times; then an error response, never a wrong slot).

Not supported, as in the reference (the card keeps no key strings):
Store/Loader hooks and snapshots. The host directory the base Engine builds
stays empty, so the lone path always misses and seed_mirror returns False.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from gubernator_tpu_torch import native
from gubernator_tpu_torch.models.engine import Engine
from gubernator_tpu_torch.models.prep import bucket_width as _bucket_width
from gubernator_tpu_torch.ops.decide import WIDE, decide_cuda, decide_packed
from gubernator_tpu_torch.ops.devdir import (
    key_fingerprint,
    make_fingerprints,
    make_touch,
    probe_assign_evict,
    probe_cuda,
    refresh_vacancies,
)
from gubernator_tpu_torch.types import RateLimitResp

_SWEEP_EVERY = 256  # rounds between fingerprint vacancy sweeps
_UP_ROWS = 10  # the wide staging's 9 rows, then the fingerprints


def _python_fingerprints(keys) -> np.ndarray:
    return np.fromiter((key_fingerprint(k) for k in keys), np.int64, count=len(keys))


class DevDirEngine(Engine):
    """Engine with the on-device key directory (see the module docstring)."""

    PROBE_RETRIES = 3

    def __init__(self, capacity: int = 1 << 20, min_width: int = 64,
                 max_width: int = 8192, device=None, **kw):
        if kw.get("store") is not None or kw.get("loader") is not None:
            raise ValueError(
                "GUBER_DEVICE_DIRECTORY keeps no key strings on the host: "
                "Store/Loader persistence needs the host directory")
        kw.pop("store", None)
        kw.pop("loader", None)
        super().__init__(capacity=capacity, min_width=min_width,
                         max_width=max_width, device=device, **kw)
        # the host directory is unused; the python pipeline feeds windows
        self._prep_fast = None
        self.fps = make_fingerprints(capacity, self.device)
        self.touch = make_touch(capacity, self.device)
        self._rounds_since_sweep = 0
        self._probe_seq = 0  # per-dispatch eviction epoch (starts > 0)
        # the C fingerprints; the python function only under GUBER_NO_NATIVE
        # (a failed build raises, as the directory's does)
        if os.environ.get("GUBER_NO_NATIVE"):
            self._fingerprints = _python_fingerprints
        else:
            native.load_library()
            self._fingerprints = native.fingerprint_batch

    def key_count(self) -> int:
        """Occupied device-directory slots (nonzero fingerprints): one
        reduction on the device, for the scrape path, never the serving
        path."""
        with self._lock:
            return int(torch.count_nonzero(self.fps))

    # the surfaces that need key strings are refused
    def snapshot(self, include_expired: bool = False):
        raise RuntimeError(
            "DevDirEngine keeps no key strings; snapshots need the host "
            "directory engine")

    def supports_columnar(self) -> bool:
        return False

    def load_snapshot(self, items) -> int:
        items = list(items)
        if items:
            raise RuntimeError(
                "DevDirEngine cannot seed from snapshots (host directory "
                "unused); start it empty or use the host-directory engine")
        return 0

    def global_registry_size(self) -> int:
        return 0

    def warmup(self) -> None:
        """One all-padding dispatch per width bucket: on CUDA the probe and
        decide kernels are built and loaded before the first request. Each
        advances the epoch, as the reference's warmup does, so the touch
        stamps of both packages stay equal."""
        widths = []
        w = self.min_width
        while w < self.max_width:
            widths.append(w)
            w *= 2
        widths.append(self.max_width)
        with self._lock:
            for width in widths:
                self._dispatch(np.zeros((_UP_ROWS, width), np.int64), 0)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------- internals

    def _split_scannable(self, windows):
        # scan coalescing presumes host-resolved slots; every window rides
        # the probe + decide dispatch here
        return windows, []

    def _dispatch(self, up: np.ndarray, now_ms):
        """Probe and decide one window: `up` is i64[10, W], rows 1-7 the
        wide staging's requests and row 9 the fingerprints (0 = padding).
        Advances the epoch. Returns (i64[4, W] responses, bool[W] retry) on
        the host. Caller holds the engine lock."""
        self._probe_seq += 1
        seq = self._probe_seq
        w = up.shape[1]
        if self.device.type == "cpu":
            t = torch.from_numpy(up)
            packed, hashes = t[:9], t[9]
            _slot, _fresh, retry = probe_assign_evict(self.fps, self.touch, hashes, seq,
                                                      packed=packed)
            return decide_packed(self.state, packed, now_ms).numpy(), retry.numpy()
        t = torch.from_numpy(up).to(self.device)
        packed, hashes = t[:9], t[9]
        # the responses and the retry flags in one buffer: one copy back
        down = torch.empty(33 * w, dtype=torch.uint8, device=self.device)
        resp = down[:32 * w].view(torch.int64).view(4, w)
        retry = down[32 * w:].view(torch.bool)
        probe_cuda(self.fps, self.touch, hashes, seq, packed, out=(None, None, retry))
        decide_cuda(WIDE, self.state, packed, None, now_ms, out=resp)
        host = down.cpu().numpy()
        return host[:32 * w].view(np.int64).reshape(4, w), host[32 * w:].view(np.bool_)

    def _apply_round(self, round_work, now_ms, responses,
                     skip_store: bool = False, resolved=None) -> None:
        """Probe/retry dispatch of one window. Caller holds the engine
        lock."""
        stage = self.stats.stage_ns
        if self._rounds_since_sweep >= _SWEEP_EVERY:
            self._rounds_since_sweep = 0
            refresh_vacancies(self.fps, self.state, now_ms)
        work = list(round_work)
        for _attempt in range(self.PROBE_RETRIES + 1):
            n = len(work)
            w = _bucket_width(n, self.min_width, self.max_width)
            t0 = time.perf_counter_ns()
            up = np.zeros((_UP_ROWS, w), np.int64)
            if n:
                up[1:8, :n] = np.array(
                    [(r.hits, r.limit, r.duration, int(r.algorithm),
                      int(r.behavior), ge, gi)
                     for _i, r, ge, gi in work], np.int64).T
                up[9, :n] = self._fingerprints([it[1].hash_key() for it in work])
            t1 = time.perf_counter_ns()
            stage["pack"] += t1 - t0
            # a fresh epoch per dispatch: a retry can evict what the
            # previous attempt touched, so it terminates
            out, retry = self._dispatch(up, now_ms)
            t2 = time.perf_counter_ns()
            stage["device"] += t2 - t1
            self.stats.rounds += 1
            self._rounds_since_sweep += 1

            nxt = []
            status, limit, remaining, reset = out[:, :n].tolist()
            rt = retry[:n].tolist()
            for j, item in enumerate(work):
                if rt[j]:
                    nxt.append(item)
                    continue
                st = status[j]
                if st == 1:
                    self.stats.over_limit += 1
                responses[item[0]] = RateLimitResp(
                    status=st, limit=limit[j], remaining=remaining[j],
                    reset_time=reset[j])
            stage["demux"] += time.perf_counter_ns() - t2
            work = nxt
            if not work:
                return
        for item in work:  # bounded: never a wrong slot, an honest error
            self.stats.errors += 1
            responses[item[0]] = RateLimitResp(
                error="device directory contention: probe window "
                      "exhausted after retries")
