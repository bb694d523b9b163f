#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gubernator_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--windows 30] [--out results.json]

Run from the root of the repository. Phases, each fatal on failure:

1. print the card (nvidia-smi name and power limit) and build every native
   source, all compilers started together: the CUDA kernels from csrc/
   with nvcc and the key directory native/keydir.cpp with g++; each
   source's build time is printed;
2. hold the decide kernels to their plain PyTorch version on the card, on
   a 10,000,001-row table populated from --seed: the one-window kernel in
   the wide, compact, lean and interned formats at W in {64, 1024, 8192},
   the scan kernel at K in {2, 32}, W = 64, and on a herd group (32
   windows, one live lane each, one row). Responses and whole tables must
   be bit-equal (an interned case also to the compact kernel on the same
   window); each shape is timed against its plain version and its bound.
   Then the sweep, run once over the engine's three formats: the
   one-window kernel in blocks of 64 and 128 at each W, and the scan spread
   over 1, 2, 4 and 8 blocks at K = 32 (each variant held bit-equal first;
   the library keeps the winners as constants); then the edge lanes,
   bit-equal: clamped, wrapping and overflowing lanes, the lean sign bit,
   the interned config id 255, lanes past the table beside the lane that
   writes row C-1 (one window of 8192 lanes and scan groups, every format),
   herds on rows with a negative duration, and scans run in chunks or
   window by window;
3. the main path: Engine(device="cuda", capacity=10_000_001) on the native
   directory after warmup() takes --windows client batches of 8192
   requests over 1,000,000 Zipf(1.1) keys through the one-pass fast
   window; after each window the 16 hottest keys go through seed_mirror
   (the gather kernel in its pinned form) and three decide_native_single
   calls each (a miss becomes a one-request window), so the next window's
   lookups inject the dirty mirrors (the inject kernel, in its pinned form:
   the key directory writes the rows into the engine's page-locked
   staging). Engine(device="cpu") takes the same sequence; responses, lone
   responses, tables and EngineStats counters must be equal, every inject
   and gather launch must have gone through the pinned entry point, and
   every engine dispatch must have made exactly one decide launch.
   Prints decisions/s, the stage split, seed_mirror's time per call and
   the host time per Engine._apply_inject_rows that had rows; the host-stage
   split of seed_mirror over 10,000 calls; and the decide launches by
   format, form, width and K, with the live lanes per window and the
   longest per-row chain of each scan group. The first 16 scan groups of
   each format are captured (staging and the rows they touch) and replayed
   on a fresh table, kernel against plain version, bit-equal, then timed;
3b. the same engines on the python directory (GUBER_NO_NATIVE=1), 10
   windows, no lone requests;
4. the GLOBAL sync: the ring kernel against its plain version at
   L in {G, 4G}, timed; the raw stream handle of the shared launch path
   held equal to torch.cuda.current_stream's, on the default stream and a
   side stream; the host-stage split of the ring wrapper over 10,000
   calls; then sync steps over S = 8 shards of 1,250,000 rows with
   G = 1024 global keys, collectives="ring" on the card against "psum" on
   the CPU (each step's owner apply one sharded decide launch); mirrors
   and shard tables must be equal;
5. the row kernels against their plain versions on the card: inject at
   m in {1, 16, 64, 4096}, from rows on the card and from page-locked host
   rows (the engine's form, timed as a host round trip beside
   torch.from_numpy(a).to(dev) + index_copy_), and gather at m in {1, 64,
   8192} on a populated 10,000,001-row table (dropped, clamped and
   int32-overflowing lanes); the reuse check: 64 pinned injects from one
   reused InjectStaging, the host rewriting it between launches with no
   wait but the staging's own, behind a busy stream, must leave the table
   equal to the plain version's; the gather's pinned form at m in {1, 64}
   with the slots -1, C and C + 8; row_bump into a caller's out on an
   int32[10,000,000, 128] table (5.12 GB) against the plain version on a
   clone; then the probe's own loop (gubernator_tpu_torch.bench_rows);
6. the serving pipeline: Engine(device="cuda", capacity=10_000_001,
   widths 64-8192) after warmup() and warmup_pipeline(max_group=8), the
   combiner's depth probe over (1, 3, 6) printed; phase 3's first 24
   windows (196,608 requests) cut into client submissions of 1-512 requests
   (log-uniform, from --seed) and one of 10,000 (the combiner's serial
   path), now_ms + 1 every 64 submissions, from one async submitter through
   BackendCombiner at depth 3 and scan 8, the first 400 submissions under
   torch.profiler (the device's busy share); Engine(device="cpu") takes the
   stream through a depth-1 combiner: responses must be equal, and so must
   the table rows at every key the directory holds. Then direct
   launch_windows groups of distinct keys at (K, W) in {2, 8} x {64, 1024,
   8192}, each launched behind ~0.5 s of busy card (its slot's event must
   still be pending when the launch returns: no launch waits on the card),
   against the CPU twin. The stream runs again on fresh card engines at
   depth 1, 1 and 3 (in turns with the first). Then 8 windows as wire
   columns through launch_columnar_windows / collect_columnar_windows
   (depth 3 and 1 in turns, scan 8, everything collected on a cut,
   leftovers through get_rate_limits) against lock-step submit_columnar /
   complete_columnar on a CPU twin. Prints decisions/s of every run, host
   us per launch_windows and collect_windows, the combiner's stats, the
   decide launches by format, form, K and W with the scan launches by the
   path csrc/decide.cu takes (chunked or one launch a window), the slot
   refills and inject-staging frees that had to wait;
7. persistence: the link's page-locked copy rates (1 GiB each way); a
   binary snapshot file of 10,000,000 buckets (in the shape of
   tests/test_snapshot_scale.py's, made from --seed, every 16th expired)
   in a temporary directory, restored by Engine(device="cuda",
   capacity=10_000_001).load_snapshot_slabs (every chunk's inject through
   the pinned entry point) and by a CPU twin (tables equal); the card
   engine's snapshot_slabs streamed into a second file (each slab one
   copy into a page-locked buffer, timed against the slab's bytes over the
   measured card-to-host rate), equal slab for slab to the twin's stream;
   that file restored into a fresh card engine through Engine(loader=...),
   rows equal at every live key. Prints restore and snapshot seconds and
   rows/s, the file sizes and each stage. Then the Store path: phase 3's
   first 8 windows through an engine with a MockStore (both Stores holding
   the 100,000 hottest keys' buckets at the start) against a CPU twin with
   its own: answers, Store contents and calls, and rows at every key
   equal, injects and gathers launched on the card; and rows_for_keys,
   device_hit_counts and resolve_slots at 1,000 keys against the twin;
8. the device directory: (8a) the probe kernel (csrc/devdir.cu) against
   its plain version on fingerprint and stamp columns of 10,000,001
   positions made from --seed (about half occupied, a region filled
   solid, half of it stamped this batch) at W in {64, 1024, 8192}, lanes
   of matches, new keys, keys based in the solid region and distinct keys
   of one base, and padding; with and without eviction, and at 5 and 16
   positions; slot, fresh, retry, both columns and the staging's rows 0
   and 8 bit-equal; the vacancy sweep at 10,000,001 positions; each timed
   against its plain version and its bound; (8b) DevDirEngine(device=
   "cuda", capacity=10_000_001, widths 64-8192) after warmup() on phase
   3's first 24 windows against a DevDirEngine(device="cpu") twin
   (responses, columns, table and EngineStats equal) and the host-directory
   Engine on the card (responses equal but where the device directory
   answers with its contention error); (8c) DevDirEngine(capacity=65,536)
   on 320 windows of 256 requests of the same stream against its CPU twin,
   sweeps on the path, then capacity 8,192 on 80 such windows, full, so
   that claims evict; (8d) phase 3's first 8 windows as
   wire columns through native.prep_pack_interned and
   decide_packed_interned on the card (the leftovers through an Engine
   whose dispatches ship interned when eligible, so the interned scan
   runs too), against a CPU twin and against prep_pack_columnar with the
   compact kernel on a second card table: answers and tables equal;
9. the sharded engine, 8 owners x 1,250,000 rows (10,000,000, 640 MB):
   (9a) the sharded decide (csrc/decide.cu, one launch for every owner)
   against its plain version on make_sharded_table's table populated from
   --seed, wide and lean, at W in {64, 1024, 8192} an owner and the scan
   at K in {2, 32}, W = 64, every window of every owner with a lane past
   the owner's table beside a lane that writes the owner's row C-1 (even
   owners; odd owners in odd windows of a scan), some lean windows with
   the sign bit set, at R x S = 1 x 8 (timed, beside the same window as 8
   launches of the single-table kernel on the owners' views) and 2 x 4;
   the sharded gather and inject (csrc/rows.cu) at m in {1, 64, 4096} an
   owner (padding, past-table lanes, row C-1, values past int32), timed
   beside one indexing of the flattened table and index_copy_; (9b)
   ShardedEngine(device="cuda", n_shards=8, capacity_per_shard=1_250_000)
   after warmup() and a CPU twin on phase 3's first 24 windows with
   Behavior.GLOBAL on every 8th of the 4,096 hottest keys, global_sync()
   after every window: responses, tables, mirrors, registries and
   counters equal after every window; (9c) the Store path on 8 windows
   (both Stores holding the 100,000 hottest keys' buckets); (9d) 8
   windows as wire columns through submit_columnar / complete_columnar,
   then BackendCombiner depth 3 on the card against depth 1 on the CPU
   twin. Prints decisions/s, the stage split, the GLOBAL sync ms a step,
   mirror answers and registry fallbacks, and the sharded launches by
   shape.

Device times come from torch.profiler, for the kernels and for each
library call they are compared with; where the profiler gives none the
record holds null, never a host-clock time, except for the kernels timed
through kernel_ms (the sweep and phase 9's), which then take CUDA events
around back-to-back calls and say so (`ms_source`). Every line with a time ends
with the card and its power limit as nvidia-smi gives them.

Kernel launch counts are set to 0 just before each main path (phases 3,
3b, 4, the bench_rows loop, each run of phase 6, phase 7's restores and
Store path, phase 8b-8d, and 9b-9d) and read just after; every kernel
must have launched (each decide form and format on phases 3-8 together,
the interned ones on 8d), inject and gather on phase 3, both through their
pinned entry points only, the probe and the sweep on 8b-8c, the sharded
decide's four forms on 9b-9d and the sharded gather and inject on 9c. The last two lines are the
{"kernels": [...]} record and the contract line {"ok": true, "device":
{...}}. The script imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime as dt
import gc
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from gubernator_tpu_torch import bench_rows
from gubernator_tpu_torch.models.engine import Engine, EngineStats
from gubernator_tpu_torch.models.devdir_engine import DevDirEngine
from gubernator_tpu_torch.ops import _build, _launch, decide as dk, devdir as ddk, ring as rk, rows as rowk
from gubernator_tpu_torch.parallel import MeshPlan, make_global_sync, make_sharded_table, shard_of_key
from gubernator_tpu_torch.parallel.global_sync import GlobalConfig, GlobalMirror, _psum
from gubernator_tpu_torch.store import BinarySnapshotLoader, BucketSnapshot, MockStore
from gubernator_tpu_torch.types import Behavior, RateLimitReq
from gubernator_tpu_torch.utils.gregorian import gregorian_duration, gregorian_expiration

NOW = 1_700_000_000_000
CAPACITY = 10_000_001  # the north star's 10M keys; fits the 24-bit lean slot
WINDOW = 8192  # requests per client batch, the engine's max_width
N_KEYS = 1_000_000  # distinct keys of the main-path stream
LONE_KEYS = 16  # hottest keys of each window sent as lone requests
PYTHON_DIR_WINDOWS = 10  # phase 3b
INJECT_M = (1, 16, 64, 4096)  # phase 3 injects at most LONE_KEYS rows
GATHER_M = (1, 64, 8192)  # phase 3 gathers 1 slot per seed_mirror
PINNED_M = (1, 64)  # the pinned form: the lone path's 1 slot, and 64
GLOBAL_SHARDS, GLOBAL_ROWS, GLOBAL_KEYS = 8, 1_250_000, 1024
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# Peak scalar rate used for integer work: the card's 67 TFLOP/s of float32
# outside the tensor cores, with each int64 operation counted as two
# 32-bit operations.
SCALAR_OPS_PER_S = 67e12
DECIDE_OPS_PER_LANE = 2 * 100  # ~100 int64 operations in the lattice
RESET = int(Behavior.RESET_REMAINING)
GREG = int(Behavior.DURATION_IS_GREGORIAN)
FORMATS = {"wide": dk.WIDE, "compact": dk.COMPACT, "lean": dk.LEAN, "interned": dk.INTERNED}
ENGINE_FORMATS = ("wide", "compact", "lean")  # what the Engine ships; the sweep's
STAGE_BYTES = {"wide": 72, "compact": 20, "lean": 4, "interned": 8}
RESP_BYTES = {"wide": 32, "compact": 16, "lean": 16, "interned": 16}
CFG_BYTES = {"wide": 0, "compact": 0, "lean": dk.LEAN_MAX_CFG * 32,
             "interned": dk.INTERN_MAX_CFG * 16}
REPLACES = {"decide_wide": "gubernator_tpu/ops/decide.py:464",
            "decide_compact": "gubernator_tpu/ops/decide.py:536",
            "decide_lean": "gubernator_tpu/ops/decide.py:844",
            "decide_scan_wide": "gubernator_tpu/ops/decide.py:495",
            "decide_scan_compact": "gubernator_tpu/ops/decide.py:575",
            "decide_scan_lean": "gubernator_tpu/ops/decide.py:872",
            "decide_interned": "gubernator_tpu/ops/decide.py:650",
            "decide_scan_interned": "gubernator_tpu/ops/decide.py:675",
            "probe_assign_evict": "gubernator_tpu/ops/devdir.py:131",
            "probe_assign": "gubernator_tpu/ops/devdir.py:83",
            "refresh_vacancies": "gubernator_tpu/ops/devdir.py:196",
            "ring_all_reduce": "gubernator_tpu/ops/ring.py:39",
            "inject_rows": "gubernator_tpu/models/engine.py:74",
            "gather_rows": "gubernator_tpu/models/engine.py:86",
            "row_bump": "scripts/bench_pallas_rows.py:36",
            "decide_sharded_wide": "gubernator_tpu/parallel/sharded.py:95",
            "decide_sharded_scan_wide": "gubernator_tpu/parallel/sharded.py:126",
            "decide_sharded_lean": "gubernator_tpu/parallel/sharded.py:158",
            "decide_sharded_scan_lean": "gubernator_tpu/parallel/sharded.py:190",
            "gather_sharded": "gubernator_tpu/parallel/sharded.py:216",
            "inject_sharded": "gubernator_tpu/parallel/sharded.py:243"}
SOURCES = {**{name: "gubernator_tpu_torch/csrc/decide.cu" for name in dk.launch_counts},
           "gather_sharded": "gubernator_tpu_torch/csrc/rows.cu",
           "inject_sharded": "gubernator_tpu_torch/csrc/rows.cu",
           "ring_all_reduce": "gubernator_tpu_torch/csrc/ring.cu",
           "inject_rows": "gubernator_tpu_torch/csrc/rows.cu",
           "gather_rows": "gubernator_tpu_torch/csrc/rows.cu",
           "row_bump": "gubernator_tpu_torch/csrc/rows.cu",
           **{name: "gubernator_tpu_torch/csrc/devdir.cu" for name in ddk.launch_counts}}
# the shape and form the row entries of the kernels line are timed at: the
# main path's own (phase 3 injects up to LONE_KEYS rows and gathers 1 slot,
# both from page-locked host memory); row_bump's is the probe's BATCH
ROW_MAIN_M = {"inject_rows": LONE_KEYS, "gather_rows": 1}
ROW_MAIN_FORM = {"inject_rows": "pinned", "gather_rows": "pinned", "row_bump": "device"}
REUSE_INJECTS = 64  # pinned injects from one staging buffer in the reuse check


SMI = "card not read yet"  # main() sets it: nvidia-smi's name, power limit


def log(*a):
    print(*a, flush=True)


def tlog(*a):
    """log() for a line that carries a time: the card and its power limit
    go with it, as nvidia-smi gives them."""
    log(*a, f"[{SMI}]")


def fms(v, digits=5):
    """A device time for the log: null where the profiler gave none."""
    return "null" if v is None else f"{v:.{digits}f}"


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) if a.numel() else 0


def event_ms(fn, iters):
    """Mean device-timeline milliseconds per call over `iters` back-to-back
    calls (CUDA events), after one warm call."""
    fn(0)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for i in range(iters):
        fn(i)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def profiled_ms(fn, iters, kernel_substr=None, per_call=False):
    """Mean device milliseconds from torch.profiler over `iters` calls: per
    launch of the kernels whose name holds `kernel_substr` (per call of
    them when `per_call`: a wrapper that launches several), or, when it is
    None, per call of everything the call ran on the device (kernels and
    copies: a library call's device time). A trace that shows no device
    time is taken once more (the profiler now and then records none). None,
    logged, when the profiler fails or neither trace shows device time: the
    caller records null, never a host-clock time in its place."""
    from torch.profiler import ProfilerActivity, profile

    for _attempt in range(2):
        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for i in range(iters):
                    fn(i)
                torch.cuda.synchronize()
        except RuntimeError as e:
            log(f"  profiler failed ({e}): device ms recorded as null")
            return None
        total_us, count = 0.0, 0
        seen = []
        for e in prof.key_averages():
            if e.self_device_time_total > 0:
                seen.append(e.key[:60])
            if kernel_substr is None or kernel_substr in e.key:
                total_us += e.self_device_time_total
                count += e.count
        if kernel_substr is None or per_call:
            count = iters
        if count and total_us > 0:
            return total_us / count / 1e3
        log(f"  the trace shows no device time for {kernel_substr or 'the call'} "
            f"(device time under {seen[:3]})")
    log("  device ms recorded as null")
    return None


def host_us(fn, iters):
    """Mean host-clock microseconds per call over `iters` calls, after one
    warm call; for calls that end with their result on the host."""
    fn(0)
    t = time.perf_counter_ns()
    for i in range(iters):
        fn(i)
    return (time.perf_counter_ns() - t) / iters / 1e3


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ----------------------------------------------------------------- phase 2

def populate_table(rows: int, seed: int, device) -> torch.Tensor:
    """i64[rows, 8] made on the card from `seed`: ~30% vacant, 40% token,
    30% leaky rows, drained to full, about half expired at NOW, sticky
    OVER_LIMIT on some, nonzero hit counters."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def ri(lo, hi):
        return torch.randint(lo, hi, (rows,), generator=g, device=device, dtype=torch.int64)

    pick = ri(0, 10)
    algo = torch.where(pick < 3, -1, torch.where(pick < 7, 0, 1))
    limit = torch.tensor([1, 5, 10, 100, 1000], device=device)[ri(0, 5)]
    dur = torch.tensor([1000, 60_000, 3_600_000], device=device)[ri(0, 3)]
    stamp = NOW - ri(0, 1 << 40) % (2 * dur)
    t = torch.stack([algo, limit, ri(0, 1 << 40) % (limit + 1), dur, stamp,
                     stamp + dur, ri(0, 2), ri(0, 1_000_000)], dim=1)
    return t.contiguous()


def stimulus(rng, table, width, fmt, *, slots=None, live=0.9):
    """One wide i64[9, width] window over distinct slots of `table`, with
    padding lanes at random positions, eligible for `fmt`. Requests mostly
    match the row (so existing, vacant and expired rows all occur); some
    change the limit or duration, peek, over-ask, reset, are fresh, and on
    the wide format run on a gregorian calendar."""
    C = table.shape[0]
    n = max(1, int(width * live))
    s = rng.choice(C if slots is None else slots, n, replace=False)
    rows = table[torch.from_numpy(s).to(table.device)].cpu().numpy()
    p = np.zeros((9, width), np.int64)
    lanes = rng.permutation(width)[:n]  # padding lanes land anywhere
    p[0, :] = -1
    p[0, lanes] = s
    limits = np.array([1, 5, 10, 100, 1000])
    durs = np.array([1000, 60_000, 3_600_000])
    keep = rng.random(n) < 0.7
    p[2, lanes] = np.where(keep, rows[:, 1], rng.choice(limits, n))
    p[3, lanes] = np.where(rng.random(n) < 0.7, rows[:, 3], rng.choice(durs, n))
    p[4, lanes] = np.where((rng.random(n) < 0.8) & (rows[:, 0] >= 0), rows[:, 0],
                           rng.integers(0, 2, n))
    p[5, lanes] = np.where(rng.random(n) < 0.05, RESET, 0)
    p[8, lanes] = rng.random(n) < 0.1
    if fmt == "lean":
        p[1, lanes] = 1
    else:
        p[1, lanes] = rng.choice([0, 1, 1, 1, 1, 2, 5, 2000], n)
    if fmt == "wide":
        g = rng.random(n) < 0.1
        local = dt.datetime.fromtimestamp(NOW / 1000.0)
        codes = rng.integers(0, 3, n)
        p[3, lanes] = np.where(g, codes, p[3, lanes])
        p[5, lanes] |= np.where(g, GREG, 0)
        p[6, lanes] = np.where(g, [gregorian_expiration(local, int(c)) for c in codes], 0)
        p[7, lanes] = np.where(g, [gregorian_duration(local, int(c)) for c in codes], 0)
    return p


def staged(fmt, wide, capacity, device):
    """The wide host window as the device tensors of `fmt` (lean and
    interned: the staging and the config table; else cfg None)."""
    if fmt == "wide":
        return torch.from_numpy(wide).to(device), None
    if fmt == "compact":
        c = dk.compact_window(wide)
        check(c is not None, "compact stimulus not eligible")
        return torch.from_numpy(c).to(device), None
    if fmt == "interned":
        iw = dk.intern_window(wide)
        check(iw is not None, "interned stimulus not eligible")
        return torch.from_numpy(iw[0]).to(device), torch.from_numpy(iw[1]).to(device)
    ln = dk.lean_window(wide, capacity)
    check(ln is not None, "lean stimulus not eligible")
    return torch.from_numpy(ln[0]).to(device), torch.from_numpy(ln[1]).to(device)


def decide_times(run_k, run_p, iters=64):
    """A decide kernel's numbers on one stimulus set: device ms per launch
    (torch.profiler, null where it gives none), ms per wrapper call (CUDA
    events, back to back) and the plain version's ms per call."""
    call_ms = event_ms(run_k, iters)
    return dict(ms=profiled_ms(run_k, 32, "decide_kernel"), call_ms=call_ms,
                plain_ms=event_ms(run_p, 8))


def decide_bound(fmt, wide, rows):
    """The decide bound of one staging (wide i64[.., 9, W] on the host) that
    touches `rows` distinct rows: each row read and written once, the
    staging read and the responses written once; the lattice's operations
    for each live lane."""
    lanes = wide[..., 0, :].size
    live = int((wide[..., 0, :] >= 0).sum())
    n_bytes = rows * 128 + lanes * (STAGE_BYTES[fmt] + RESP_BYTES[fmt]) + CFG_BYTES[fmt]
    b_ms, b_by = bound_ms(n_bytes, live * DECIDE_OPS_PER_LANE)
    return dict(live_lanes=live, rows=rows, bytes=n_bytes, bound_ms=b_ms, bound_by=b_by)


def touched_rows(wide, C):
    """Distinct table rows a staging touches (slots past the table read C-1)."""
    s = wide[..., 0, :]
    return int(np.unique(np.minimum(s[s >= 0], C - 1)).size)


def herd(rng, table, fmt, k=32, width=64):
    """A hot-key herd as the engine's scan tail sends it: k windows of
    `width` lanes, one live lane each at a random position, all on one row
    with the same request."""
    one = stimulus(rng, table, width, fmt, live=1.0 / width)
    col = one[:, one[0] >= 0][:, 0]
    wide = np.zeros((k, 9, width), np.int64)
    wide[:, 0, :] = -1
    for w in range(k):
        wide[w, :, rng.integers(width)] = col
    wide[1:, 8, :] = 0  # only the first visit may find the slot fresh
    return wide


def phase_decide(seed, dev, results):
    log("== phase 2: decide kernels vs their plain version, "
        f"table {CAPACITY} rows ({CAPACITY * 64 / 1e6:.0f} MB)")
    rng = np.random.default_rng(seed)
    kern = populate_table(CAPACITY, seed, dev)
    plain = kern.clone()
    shapes = [(fmt, w, 0, "windows") for fmt in FORMATS for w in (64, 1024, WINDOW)]
    shapes += [(fmt, 64, k, "windows") for fmt in FORMATS for k in (2, 32)]
    shapes += [(fmt, 64, 32, "herd") for fmt in FORMATS]
    errs = {}

    def make(fmt, width, k, kind):
        if kind == "herd":
            return herd(rng, kern, fmt)
        if k:
            pool = rng.choice(CAPACITY, 256, replace=False)  # windows overlap
            return np.stack([stimulus(rng, kern, width, fmt, slots=pool) for _ in range(k)])
        return stimulus(rng, kern, width, fmt)

    for fmt, width, k, kind in shapes:
        f = FORMATS[fmt]
        scan = k > 0
        wide = make(fmt, width, k, kind)
        packed, cfg = staged(fmt, wide, CAPACITY, dev)
        hold(f, kern, plain, packed, cfg, scan, f"{fmt} W={width} K={k} {kind}", errs, wide)

        # timing: 16 distinct stimuli, cycled, so rows come cold from HBM
        stims = [staged(fmt, make(fmt, width, k, kind), CAPACITY, dev) for _ in range(16)]

        def run_k(i):
            pk, cf = stims[i % 16]
            dk.decide_cuda(f, kern, pk, cf, NOW, scan)

        def run_p(i):
            pk, cf = stims[i % 16]
            dk.decide_plain(f, plain, pk, cf, NOW, scan)

        t = decide_times(run_k, run_p)
        plain.copy_(kern)  # the timing runs mutated the two tables differently
        rec = dict(kernel=dk._COUNT_NAMES[f, scan], fmt=fmt, width=width, scan_k=k, kind=kind,
                   **decide_bound(fmt, wide, touched_rows(wide, CAPACITY)), **t)
        results["decide_shapes"].append(rec)
        tlog(f"  {fmt:7s} W={width:5d} K={k:2d} {kind:7s}: bit-equal; kernel {fms(t['ms'])} ms "
             f"on the device, {t['call_ms']:.4f} ms per wrapper call; plain "
             f"{t['plain_ms']:.4f} ms; bound {rec['bound_ms']:.6f} ms ({rec['bound_by']})")
    results["decide_sweep"] = sweep(rng, kern, plain, dev, errs)
    edge_cases(kern, plain, dev, errs)  # last: its rows leave the compact range
    del kern, plain
    torch.cuda.empty_cache()
    return errs


def hold(f, kern, plain, packed, cfg, scan, what, errs, wide=None):
    """One decide through the kernel and the plain version: bit-equal
    responses and tables, or the run fails. An interned staging (`wide` its
    wide window) is also held to the compact kernel on the same window,
    from the same table."""
    twin = kern.clone() if f == dk.INTERNED else None
    out_k = dk.decide_cuda(f, kern, packed, cfg, NOW, scan)
    out_p = dk.decide_plain(f, plain, packed, cfg, NOW, scan)
    torch.cuda.synchronize()
    name = dk._COUNT_NAMES[f, scan]
    errs[name] = max(errs.get(name, 0), max_abs_err(out_k, out_p), max_abs_err(kern, plain))
    check(torch.equal(out_k, out_p), f"{what}: responses differ")
    check(torch.equal(kern, plain), f"{what}: tables differ")
    if twin is not None:
        c = dk.compact_window(wide)
        check(c is not None, f"{what}: not compact-eligible")
        out_c = dk.decide_cuda(dk.COMPACT, twin, torch.from_numpy(c).to(kern.device), None,
                               NOW, scan)
        check(torch.equal(out_k, out_c) and torch.equal(kern, twin),
              f"{what}: the interned kernel and the compact kernel differ")
        del twin


def last_row_window(rng, kern, fmt, width, writer=True):
    """A window whose lane 5 writes row C-1 (a live token bucket) and whose
    lanes past the table (slots C, C + 1, C + 7, in other blocks of the
    window kernel) read it; the other lanes random. The readers must see
    row C-1 as it stood before the window."""
    C = kern.shape[0]
    wide = stimulus(rng, kern, width, fmt)
    wide[0, wide[0] == C - 1] = -1
    req = [1, 10, 60_000, 0, 0, 0, 0, 0]  # hits, limit, duration, algo, ...
    edge = [(width - 1, C), (width // 2 + 3, C + 1), (100 % width, C + 7)]
    for lane, s in [(5, C - 1)] * writer + edge:
        wide[0, lane] = s
        wide[1:, lane] = req
    return wide


def edge_cases(kern, plain, dev, errs):
    """The lanes tests/test_torch_decide.py holds the plain version to on the
    CPU, now kernel against plain on the card: a slot past the table (the
    gather clamps, the store drops), int64 wraparound, negative durations,
    a sticky status past i32, algorithm 7, padding between live lanes; a
    lean window of 128 configs, whose ids set the lane word's sign bit; an
    interned window of 256 configs (id 255) with lanes past the table beside
    lanes on its last rows; and lanes past the table beside the lane that
    writes row C-1, in one window of 8192 lanes and in scan groups (K = 4,
    W = 64; one window without the writer), every format; a wide scan group
    of token and leaky herds on live rows with a negative duration; and
    scans the engine never sends: lean K = 40 at W = 64, compact K = 32 and
    interned K = 33 at W = 256 (chunks of whole windows), wide K = 3 at
    W = 8192 (a window a launch). Every interned case is also held to the compact
    kernel on the same window."""
    C = kern.shape[0]
    big = np.iinfo(np.int64).max
    for r, v in {0: [0, 10, 4, 5, big - 3, NOW + 1000, 0, 0],
                 3: [0, 10, 4, 60_000, NOW - 5, NOW + 60_000, (1 << 33) + 5, 3],
                 C - 1: [0, 10, 4, 60_000, NOW - 5, NOW + 60_000, 1, 3]}.items():
        kern[r] = plain[r] = torch.tensor(v, device=dev)
    wide = np.zeros((9, 9), np.int64)
    wide[0] = [C + 5, 0, 1, 2, -1, 3, 4, -1, 5]
    wide[1] = [1, 1, 3, 0, 9, 1, 1, 9, 2]
    wide[2] = [10, big, 7, 5, 9, 10, 10, 9, 3]
    wide[3] = [60_000, big, -7_001, 60_000, 9, 60_000, 1000, 9, -1]
    wide[4] = [0, 0, 1, 0, 0, 0, 7, 0, 1]
    lean = np.zeros((9, dk.LEAN_MAX_CFG), np.int64)
    lean[0] = np.arange(dk.LEAN_MAX_CFG) + (C - dk.LEAN_MAX_CFG - 1)
    lean[0, -3:] = -1
    lean[1] = 1
    lean[2] = np.arange(dk.LEAN_MAX_CFG) + 1
    lean[3] = 60_000
    # interned: 256 configs (the last id 255), lanes clamped past the table
    # beside lanes on its last rows
    interned = np.zeros((9, dk.INTERN_MAX_CFG), np.int64)
    interned[0] = np.arange(dk.INTERN_MAX_CFG) + (C - dk.INTERN_MAX_CFG - 1)
    interned[0, -3:] = [C + 5, -1, C]
    interned[1] = np.arange(dk.INTERN_MAX_CFG) % 4
    interned[2] = np.arange(dk.INTERN_MAX_CFG) + 1
    interned[3] = 60_000
    interned[4] = np.arange(dk.INTERN_MAX_CFG) % 2
    for fmt, p in (("wide", wide), ("lean", lean), ("interned", interned)):
        packed, cfg = staged(fmt, p, C, dev)
        if fmt == "lean":
            check(bool((packed < 0).any()), "lean edge window sets no sign bit")
        if fmt == "interned":
            check(int(((packed[1] >> 23) & 0xFF).max()) == 255, "no interned config id 255")
        hold(FORMATS[fmt], kern, plain, packed, cfg, False, f"{fmt} edge lanes", errs, p)
    rng = np.random.default_rng(99)
    row = torch.tensor([0, 10, 4, 60_000, NOW - 5, NOW + 60_000, 0, 3], device=dev)
    for fmt in FORMATS:
        kern[C - 1] = plain[C - 1] = row
        wide = last_row_window(rng, kern, fmt, WINDOW)
        packed, cfg = staged(fmt, wide, C, dev)
        hold(FORMATS[fmt], kern, plain, packed, cfg, False,
             f"{fmt} row C-1 written beside lanes past the table", errs, wide)
        kern[C - 1] = plain[C - 1] = row
        pool = rng.choice(C - 1, 256, replace=False)
        group = np.stack([last_row_window(rng, kern, fmt, 64, writer=w != 2)
                          for w in range(4)])
        for w in range(4):  # the random lanes of the group overlap
            live = (group[w, 0] >= 0) & (group[w, 0] < C - 1)
            group[w, 0, live] = rng.choice(pool, int(live.sum()), replace=False)
        packed, cfg = staged(fmt, group, C, dev)
        hold(FORMATS[fmt], kern, plain, packed, cfg, True,
             f"{fmt} scan, row C-1 written beside lanes past the table", errs, group)
    # a herd on live rows whose duration is negative: the first deduct leaves
    # each row expired, so the scan's run of plain requests must stop there
    rows = rng.choice(C - 1, 2, replace=False)
    group = np.zeros((6, 9, 64), np.int64)
    group[:, 0, :] = -1
    for i, (r, algo) in enumerate(zip(rows.tolist(), (0, 1))):
        kern[r] = plain[r] = torch.tensor([algo, 5, 4, -7_001, NOW - 5, NOW + 60_000, 0, 3],
                                          device=dev)
        group[:, :, 10 + i] = [r, 1, 5, -7_001, algo, 0, 0, 0, 0]
    packed, cfg = staged("wide", group, C, dev)
    hold(dk.WIDE, kern, plain, packed, cfg, True, "wide scan, herds with a negative duration", errs)
    # scans the engine never sends, which the kernel runs in chunks of whole
    # windows (more than 32 windows; a staging past shared memory) or as one
    # window launch a window (a window past shared memory); windows share rows
    for fmt, k, width in (("lean", 40, 64), ("compact", 32, 256), ("wide", 3, WINDOW),
                          ("interned", 33, 256)):
        pool = rng.choice(C - 1, 2 * width, replace=False)
        group = np.stack([stimulus(rng, kern, width, fmt, slots=pool) for _ in range(k)])
        packed, cfg = staged(fmt, group, C, dev)
        hold(FORMATS[fmt], kern, plain, packed, cfg, True, f"{fmt} scan K={k} W={width}", errs,
             group)
    log("  edge lanes (clamp, wraparound, negative durations, i32 status, "
        "algorithm 7, lean sign bit, interned config id 255; row C-1 written beside "
        "lanes past the table, "
        "one window and scan; herds on a negative duration; scans in chunks and "
        "window by window): bit-equal")


SWEEP_THREADS = (64, 128)  # the one-window kernel's block sizes
SWEEP_SPREAD = (1, 2, 4, 8)  # blocks a scan group's rows are spread over


def sweep(rng, kern, plain, dev, errs):
    """The block-size sweep of the one-window kernel (blocks of 64 and 128
    at W = 64, 1024 and 8192) and the scan's spread (1, 2 and 4 blocks at
    K = 32, W = 64), every format: device ms per launch, each variant first
    held bit-equal to the plain version. The library's constants are what
    the sweep chose; it is restored after."""
    lib = dk._load()
    recs = []
    cases = [("window", t, w) for t in SWEEP_THREADS for w in (64, 1024, WINDOW)]
    cases += [("scan", n, 64) for n in SWEEP_SPREAD]
    try:
        for what, v, width in cases:
            check(lib.decide_tune(v if what == "window" else 0,
                                  v if what == "scan" else 0) == 0, "decide_tune refused")
            for fmt in ENGINE_FORMATS:
                f = FORMATS[fmt]
                scan = what == "scan"

                def make():
                    if not scan:
                        return stimulus(rng, kern, width, fmt)
                    pool = rng.choice(CAPACITY, 256, replace=False)
                    return np.stack([stimulus(rng, kern, width, fmt, slots=pool)
                                     for _ in range(32)])

                packed, cfg = staged(fmt, make(), CAPACITY, dev)
                hold(f, kern, plain, packed, cfg, scan, f"sweep {what} {v} {fmt}", errs)
                stims = [staged(fmt, make(), CAPACITY, dev) for _ in range(16)]
                ms = profiled_ms(lambda i: dk.decide_cuda(f, kern, *stims[i % 16], NOW, scan),
                                 32, "decide_kernel")
                plain.copy_(kern)
                recs.append(dict(form=what, value=v, width=width, fmt=fmt, ms=ms))
                tlog(f"  sweep: {what} kernel, {'threads' if what == 'window' else 'blocks'} "
                     f"{v:3d}, {fmt:7s} W={width:5d}{' K=32' if scan else ''}: "
                     f"{fms(ms)} ms on the device")
    finally:
        lib.decide_tune(0, 0)
    for what, unit in (("window", "threads"), ("scan", "blocks")):
        best = {}
        for r in recs:
            if r["form"] == what and r["ms"] is not None:
                key = f"{r['fmt']} W={r['width']}"
                best[key] = min(best.get(key, (float("inf"), 0)), (r["ms"], r["value"]))
        tlog(f"  sweep: fastest {what} kernel {unit} by shape: "
             + ", ".join(f"{k} {v[1]}" for k, v in best.items()))
    return recs


# ----------------------------------------------------------------- phase 3

def request_stream(seed, n_windows, width=None):
    """Client batches of `width` requests over N_KEYS Zipf(1.1) keys: 80%
    token / 20% leaky keys with per-key limits and durations. Batches come
    from three kinds of client, in turn: of every ten batches six send
    hits = 1 only (the lean format), three send hits of 2-5 on a tenth of
    their requests (compact), and one also puts a tenth on a gregorian
    calendar (wide) — about 1% of all requests. Returns the batches and
    each key's (algorithm, limit, duration)."""
    width, n_keys = width or WINDOW, N_KEYS
    rng = np.random.default_rng(seed + 1)
    p = 1.0 / np.arange(1, n_keys + 1, dtype=np.float64) ** 1.1
    p /= p.sum()
    key_algo = (rng.random(n_keys) < 0.2).astype(np.int64)
    key_limit = rng.choice([10, 100, 1000, 10_000], n_keys)
    key_dur = rng.choice([1000, 60_000, 3_600_000], n_keys)
    batches = []
    for i in range(n_windows):
        keys = rng.choice(n_keys, width, p=p)
        kind = i % 10
        hits = np.where((kind < 6) | (rng.random(width) < 0.9), 1,
                        rng.integers(2, 6, width))
        greg = (kind == 9) & (rng.random(width) < 0.1)
        codes = rng.integers(0, 3, width)
        batch = []
        for j, k in enumerate(keys.tolist()):
            batch.append(RateLimitReq(
                name="api", unique_key=f"k{k}", hits=int(hits[j]),
                limit=int(key_limit[k]),
                duration=int(codes[j]) if greg[j] else int(key_dur[k]),
                algorithm=int(key_algo[k]), behavior=GREG if greg[j] else 0))
        batches.append((keys, batch))
    return batches, (key_algo, key_limit, key_dur)


def lone_requests(keys, key_cfg):
    """One hits = 1 request for each of the LONE_KEYS hottest keys of a
    window, on the key's own configuration."""
    algo, limit, dur = key_cfg
    uniq, counts = np.unique(keys, return_counts=True)
    hot = uniq[np.argsort(-counts, kind="stable")[:LONE_KEYS]]
    return [RateLimitReq(name="api", unique_key=f"k{k}", hits=1, limit=int(limit[k]),
                         duration=int(dur[k]), algorithm=int(algo[k]))
            for k in hot.tolist()]


def resp_tuples(rs):
    return [(r.status, r.limit, r.remaining, r.reset_time, r.error) for r in rs]


def drive_engines(gpu, cpu, batches, key_cfg, lone, spent):
    """Run every window through the card engine and its CPU twin, then (when
    `lone`) the window's hottest keys through seed_mirror and three
    decide_native_single calls each, a miss going through get_rate_limits
    as a one-request window. Everything must be equal. Returns the
    measurements of the card engine."""
    m = dict(gpu_s=0.0, cpu_s=0.0, busy_us=0.0, traced_s=0.0, n_req=0, lone_s=0.0,
             lone_calls=0, lone_native=0, lone_miss=0, seeded=0, seed_s=0.0,
             seed_calls=0)
    for i, (keys, batch) in enumerate(batches):
        now = NOW + i * 50
        trace = i < 2  # the first two windows also run under the profiler
        if trace:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
        t = time.perf_counter()
        got = gpu.get_rate_limits(batch, now_ms=now)
        elapsed = time.perf_counter() - t
        if trace:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            m["busy_us"] += sum(e.self_device_time_total for e in prof.key_averages())
            m["traced_s"] += elapsed
        else:
            m["gpu_s"] += elapsed
            m["n_req"] += len(batch)
        t = time.perf_counter()
        want = cpu.get_rate_limits(batch, now_ms=now)
        m["cpu_s"] += time.perf_counter() - t
        check(resp_tuples(got) == resp_tuples(want),
              f"window {i}: card and CPU engines answer differently")
        if not lone:
            continue
        for req in lone_requests(keys, key_cfg):
            key = req.hash_key()
            t = time.perf_counter()
            seeded = gpu.seed_mirror(key)
            m["seed_s"] += time.perf_counter() - t
            m["seed_calls"] += 1
            check(seeded == cpu.seed_mirror(key), f"window {i}: seed_mirror({key}) differs")
            m["seeded"] += seeded
            for j in range(3):
                t_ms = now + 1 + j
                t = time.perf_counter()
                g = gpu.decide_native_single(req, now_ms=t_ms)
                if g is None:
                    g = gpu.get_rate_limits([req], now_ms=t_ms)[0]
                    m["lone_miss"] += 1
                else:
                    m["lone_native"] += 1
                m["lone_s"] += time.perf_counter() - t
                m["lone_calls"] += 1
                w = cpu.decide_native_single(req, now_ms=t_ms)
                if w is None:
                    w = cpu.get_rate_limits([req], now_ms=t_ms)[0]
                check(resp_tuples([g]) == resp_tuples([w]),
                      f"window {i}: lone request for {key} answered differently")
    check(torch.equal(gpu.state.cpu(), cpu.state), "engine tables differ")
    gs, cs = gpu.stats.as_dict(), cpu.stats.as_dict()
    for c in ("requests", "batches", "rounds", "over_limit", "errors", "native_singles"):
        check(gs[c] == cs[c], f"EngineStats.{c} differs: card {gs[c]}, CPU {cs[c]}")
    m.update(spent)
    return m


def timed_hooks(gpu):
    """Host clock around the card engine's device round trips: staging
    upload + launch (dispatch) and wait + readback (fetch)."""
    spent = {"dispatch_s": 0.0, "fetch_s": 0.0}
    for hook, name in (("_dispatch_staged", "dispatch_s"),
                       ("_dispatch_scan_staged", "dispatch_s"), ("_fetch_staged", "fetch_s")):
        def timed(*a, _fn=getattr(gpu, hook), _name=name):
            t0 = time.perf_counter()
            out = _fn(*a)
            spent[_name] += time.perf_counter() - t0
            return out

        setattr(gpu, hook, timed)
    return spent


CAPTURE_GROUPS = 16  # scan groups of phase 3 kept for the replay, per format


def record_launches(gpu):
    """Wrap the card engine's two dispatches (around them, not on the
    wrapper's path): each launch's launch_counts key, width and K, and for
    a scan the live lanes of each real window and the longest per-row
    chain (the most windows that touch one row). Each dispatch must have
    made exactly one decide launch. The first CAPTURE_GROUPS scan groups of
    each format are kept: the wide staging, the rows it touches as they
    stood before the launch, now and the format."""
    mix = {"launches": [], "captured": []}
    C = gpu.capacity

    def launched(before):
        keys = [k for k, v in dk.launch_counts.items() if v != before[k]]
        check(len(keys) == 1 and dk.launch_counts[keys[0]] == before[keys[0]] + 1,
              f"an engine dispatch made decide launches {keys}, not one")
        return keys[0]

    def one(packed, now_ms, _fn=gpu._dispatch_staged):
        before = dict(dk.launch_counts)
        out = _fn(packed, now_ms)
        mix["launches"].append(dict(key=launched(before), width=packed.shape[-1], k=0))
        return out

    def scan(stacked, now_ms, _fn=gpu._dispatch_scan_staged):
        s = stacked[:, 0, :]
        live = (s >= 0).sum(1)
        _, per_row = np.unique(np.minimum(s[s >= 0], C - 1), return_counts=True)
        kept = [g["fmt"] for g in mix["captured"]]
        want = any(kept.count(f) < CAPTURE_GROUPS for f in ENGINE_FORMATS)
        if want:  # the rows as they stand before the launch
            slots = np.unique(np.minimum(s[s >= 0], C - 1))
            rows = gpu.state[torch.from_numpy(slots).to(gpu.state.device)].cpu()
        before = dict(dk.launch_counts)
        out = _fn(stacked, now_ms)
        key = launched(before)
        fmt = key.rsplit("_", 1)[1]
        mix["launches"].append(dict(key=key, width=s.shape[-1], k=s.shape[0],
                                    live=live[live > 0].tolist(),
                                    chain=int(per_row.max()) if per_row.size else 0))
        if want and kept.count(fmt) < CAPTURE_GROUPS:
            mix["captured"].append(dict(stacked=stacked.copy(), slots=slots, rows=rows,
                                        now=now_ms, fmt=fmt))
        return out

    gpu._dispatch_staged = one
    gpu._dispatch_scan_staged = scan
    return mix


def launch_histogram(launches):
    """The decide launches by format, scan or not, width and K; for the
    scans the live lanes per window and the longest per-row chain."""
    by_shape = {}
    for r in launches:
        k = f"{r['key']} W={r['width']}" + (f" K={r['k']}" if r["k"] else "")
        by_shape[k] = by_shape.get(k, 0) + 1
    scans = [r for r in launches if r["k"]]
    live = np.array([n for r in scans for n in r["live"]], np.int64)
    chain = np.array([r["chain"] for r in scans], np.int64)
    windows = np.array([len(r["live"]) for r in scans], np.int64)

    def dist(a, edges):
        return {f"{lo}-{hi}": int(((a >= lo) & (a <= hi)).sum()) for lo, hi in edges}

    hist = dict(launches=len(launches), by_shape=dict(sorted(by_shape.items())),
                scan_launches=len(scans),
                scan_real_windows=dist(windows, [(1, 2), (3, 4), (5, 8), (9, 16), (17, 32)]),
                scan_live_per_window=dist(live, [(1, 1), (2, 4), (5, 16), (17, 64)]),
                scan_live_mean=float(live.mean()) if live.size else None,
                scan_longest_chain=dist(chain, [(1, 1), (2, 4), (5, 8), (9, 16), (17, 32)]),
                scan_chain_mean=float(chain.mean()) if chain.size else None)
    tlog(f"  decide launches by shape: {json.dumps(hist['by_shape'])}")
    tlog(f"  scan launches {len(scans)}: real windows per group {hist['scan_real_windows']}; "
         f"live lanes per window {hist['scan_live_per_window']} (mean "
         f"{hist['scan_live_mean']}); longest per-row chain {hist['scan_longest_chain']} "
         f"(mean {hist['scan_chain_mean']})")
    return hist


def replay_groups(groups, dev, results, errs):
    """The captured scan groups against a fresh 10,000,001-row table: each
    group's rows written as they stood, then kernel against plain version,
    bit-equal; then each format's groups timed, cycled."""
    kern = dk.make_table(CAPACITY, dev)
    plain = kern.clone()
    runs = {fmt: [] for fmt in FORMATS}
    for i, g in enumerate(groups):
        slots = torch.from_numpy(g["slots"]).to(dev)
        kern[slots] = plain[slots] = g["rows"].to(dev)
        packed, cfg = staged(g["fmt"], g["stacked"], CAPACITY, dev)
        hold(FORMATS[g["fmt"]], kern, plain, packed, cfg, True, f"captured scan group {i}", errs)
        runs[g["fmt"]].append((packed, cfg, g["now"], g))
    recs = []
    for fmt, sel in runs.items():
        if not sel:
            continue
        f, n = FORMATS[fmt], len(sel)

        def run_k(i):
            pk, cf, now, _ = sel[i % n]
            dk.decide_cuda(f, kern, pk, cf, now, True)

        def run_p(i):
            pk, cf, now, _ = sel[i % n]
            dk.decide_plain(f, plain, pk, cf, now, True)

        t = decide_times(run_k, run_p)
        bounds = [decide_bound(fmt, g["stacked"], len(g["slots"])) for *_, g in sel]
        rec = dict(kernel=dk._COUNT_NAMES[f, True], fmt=fmt, groups=n,
                   k=sorted({g["stacked"].shape[0] for *_, g in sel}),
                   live_lanes=float(np.mean([b["live_lanes"] for b in bounds])),
                   bound_ms=float(np.mean([b["bound_ms"] for b in bounds])),
                   bound_by=bounds[0]["bound_by"], **t)
        recs.append(rec)
        tlog(f"  captured {fmt:7s} scan groups ({n}, K in {rec['k']}, {rec['live_lanes']:.1f} "
             f"live lanes a group): bit-equal; kernel {fms(t['ms'])} ms on the device, "
             f"{t['call_ms']:.4f} ms per wrapper call; plain {t['plain_ms']:.4f} ms; mean bound "
             f"{rec['bound_ms']:.6f} ms")
    results["decide_captured"] = recs
    del kern, plain
    torch.cuda.empty_cache()


def phase_engine(seed, n_windows, dev, results):
    log(f"== phase 3: main path, Engine(capacity={CAPACITY}) on the native directory, "
        f"{dev} vs cpu, {n_windows} windows of {WINDOW} requests, then the "
        f"{LONE_KEYS} hottest keys of each window as lone requests")
    t = time.perf_counter()
    batches, key_cfg = request_stream(seed, n_windows)
    tlog(f"  stream built in {time.perf_counter() - t:.1f} s")
    os.environ.pop("GUBER_NO_NATIVE", None)
    t = time.perf_counter()
    gpu = Engine(device=dev, capacity=CAPACITY, min_width=64, max_width=WINDOW)
    cpu = Engine(device="cpu", capacity=CAPACITY, min_width=64, max_width=WINDOW)
    check(gpu._prep_fast is not None and cpu._prep_fast is not None,
          "the engines did not take the native fast window")
    gpu.warmup()
    tlog(f"  engines built and warmed in {time.perf_counter() - t:.2f} s")
    # fast windows taken, their wall time, and the share of it in the
    # leftover tail (the python pipeline after round 0)
    fast = {"taken": 0, "s": 0.0, "tail_requests": 0, "tail_s": 0.0}

    def counted(*a, _fn=gpu._fast_window):
        t0 = time.perf_counter()
        out = _fn(*a)
        fast["s"] += time.perf_counter() - t0
        fast["taken"] += out is not None
        return out

    def tail(requests, now_ms, count_batch=True, _fn=gpu._slow_window):
        t0 = time.perf_counter()
        out = _fn(requests, now_ms, count_batch)
        if not count_batch:
            fast["tail_s"] += time.perf_counter() - t0
            fast["tail_requests"] += len(requests)
        return out

    # host time of the injects that had rows (the others return at once)
    injected = {"calls": 0, "rows": 0, "s": 0.0}

    def timed_inject(inject, _fn=gpu._apply_inject_rows):
        if inject is None or len(inject) == 0:
            return _fn(inject)
        t0 = time.perf_counter()
        out = _fn(inject)
        injected["s"] += time.perf_counter() - t0
        injected["calls"] += 1
        injected["rows"] += len(inject)
        return out

    gpu._fast_window = counted
    gpu._slow_window = tail
    gpu._apply_inject_rows = timed_inject
    spent = timed_hooks(gpu)
    mix = record_launches(gpu)
    dk.reset_launch_counts()
    rowk.reset_launch_counts()
    m = drive_engines(gpu, cpu, batches, key_cfg, True, spent)
    launches = {**dk.launch_counts, **rowk.launch_counts}
    check(len(mix["launches"]) == sum(dk.launch_counts.values()),
          f"{sum(dk.launch_counts.values())} decide launches, {len(mix['launches'])} "
          "engine dispatches")
    pinned = dict(rowk.pinned_counts)
    check(fast["taken"] > 0, "no window took the fast path")
    check(launches["inject_rows"] > 0 and launches["gather_rows"] > 0,
          f"the lone path launched no row kernel: {launches}")
    for name in ("inject_rows", "gather_rows"):
        check(pinned[name] == launches[name],
              f"{name}: {launches[name]} launches, {pinned[name]} through the pinned entry point")
    check(injected["calls"] == launches["inject_rows"],
          f"{injected['calls']} injects with rows, {launches['inject_rows']} inject launches")
    stats = gpu.stats.as_dict()
    stage_s = {s: stats[f"{s}_ns"] / 1e9 for s in gpu.stats.STAGES}
    rate = m["n_req"] / m["gpu_s"]
    busy = m["busy_us"] / 1e6 / m["traced_s"] if m["traced_s"] else None
    total = WINDOW * n_windows
    results["engine"] = dict(
        m, requests=total, windows=n_windows, decisions_per_s=rate,
        cpu_decisions_per_s=total / m["cpu_s"], device_busy_share=busy,
        fast_windows=fast["taken"], fast_window_s=fast["s"],
        tail_requests=fast["tail_requests"], tail_s=fast["tail_s"], stats=stats,
        stage_s=stage_s,
        lone_per_s=m["lone_calls"] / m["lone_s"] if m["lone_s"] else None,
        launches_per_window={k: v / n_windows for k, v in launches.items()},
        keys=gpu.key_count(), launches=launches, pinned_launches=pinned,
        inject_calls=injected["calls"], inject_rows=injected["rows"],
        inject_apply_us=injected["s"] / injected["calls"] * 1e6)
    seed_calls = m["seed_calls"]
    results["engine"]["seed_mirror_us"] = m["seed_s"] / seed_calls * 1e6
    tlog(f"  equal responses, lone responses, tables and stats; card engine {rate:,.0f} "
         f"decisions/s ({m['n_req']} requests in {m['gpu_s']:.2f} s, the 2 traced windows "
         f"left out; CPU twin {total / m['cpu_s']:,.0f}/s); device busy {busy} of the "
         f"traced windows' wall time")
    tlog(f"  {fast['taken']} fast windows taken in {fast['s']:.2f} s; their leftover "
         f"tail (duplicate, gregorian, invalid lanes through the python pipeline): "
         f"{fast['tail_requests']} of {total} requests, {fast['tail_s']:.2f} s")
    tlog(f"  stage seconds (card engine, all windows and lone misses): "
         + ", ".join(f"{s} {v:.3f}" for s, v in stage_s.items())
         + f"; dispatch {m['dispatch_s']:.3f} s, fetch {m['fetch_s']:.3f} s")
    tlog(f"  lone path: {m['lone_calls']} calls in {m['lone_s']:.3f} s ({m['lone_native']} "
         f"native, {m['lone_miss']} misses as one-request windows); seed_mirror "
         f"{seed_calls} calls ({m['seeded']} seeded) in {m['seed_s']:.3f} s, "
         f"{m['seed_s'] / seed_calls * 1e6:.1f} us per call through the pinned gather; "
         f"native_singles {stats['native_singles']}; {gpu.key_count()} keys; "
         f"launches {launches}")
    tlog(f"  injects: {injected['calls']} Engine._apply_inject_rows calls with rows "
         f"({injected['rows']} rows), {injected['s'] / injected['calls'] * 1e6:.2f} us per "
         f"call on the host clock; pinned launches {pinned}")
    # the lone path's host split, after every check above: it re-seeds
    # mirrors from the table and so leaves the two engines apart
    hot = [r.hash_key() for r in lone_requests(batches[-1][0], key_cfg)]
    results["host_split_seed_mirror"] = split_seed_mirror(
        gpu, [k for k in hot if gpu.directory.peek_slot(k) >= 0])
    results["decide_launch_mix"] = launch_histogram(mix["launches"])
    del gpu, cpu
    torch.cuda.empty_cache()
    return launches, mix["captured"]


def phase_engine_python(seed, n_windows, dev, results):
    log(f"== phase 3b: Engine on the python directory (GUBER_NO_NATIVE=1), "
        f"{dev} vs cpu, {n_windows} windows")
    batches, key_cfg = request_stream(seed, n_windows)
    os.environ["GUBER_NO_NATIVE"] = "1"
    try:
        gpu = Engine(device=dev, capacity=CAPACITY, min_width=64, max_width=WINDOW)
        cpu = Engine(device="cpu", capacity=CAPACITY, min_width=64, max_width=WINDOW)
    finally:
        del os.environ["GUBER_NO_NATIVE"]
    check(gpu._prep_fast is None, "GUBER_NO_NATIVE did not pick the python directory")
    gpu.warmup()
    spent = timed_hooks(gpu)
    dk.reset_launch_counts()
    rowk.reset_launch_counts()
    m = drive_engines(gpu, cpu, batches, key_cfg, False, spent)
    launches = {**dk.launch_counts, **rowk.launch_counts}
    rate = m["n_req"] / m["gpu_s"]
    results["engine_python"] = dict(m, windows=n_windows, decisions_per_s=rate,
                                    stats=gpu.stats.as_dict(), launches=launches)
    tlog(f"  equal responses, tables and stats; card engine {rate:,.0f} decisions/s; "
         f"launches {launches}")
    del gpu, cpu
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------- host-stage split

HOST_SPLIT_CALLS = 10_000
RING_STAGES = ("checks", "lookups", "allocation", "stream_device", "ctypes_call")
SEED_STAGES = ("lock_peek", "slot_write", "gather_wrapper", "wait_read", "mirror_seed")


def log_split(what, us):
    tlog(f"  host split, {what}: " + ", ".join(f"{k} {v:.2f}" for k, v in us.items())
         + f"; {sum(us.values()):.2f} us per call in all")


def split_ring(x):
    """Host microseconds per ring wrapper call, by stage (RING_STAGES), over
    HOST_SPLIT_CALLS calls of the sequence ring_all_reduce_cuda runs; then
    whole wrapper calls beside torch.sum(x, 0), both on the host clock."""
    k = rk._load()
    launch, pc = k.ring_all_reduce_launch, time.perf_counter_ns
    ns = dict.fromkeys(RING_STAGES, 0)
    for i in range(HOST_SPLIT_CALLS):
        if i % 1000 == 0:
            torch.cuda.synchronize()  # the launch queue never fills
        t0 = pc()
        index = _launch.cuda_index(x, "x")
        _launch.check(x, "x", torch.int64, (None, None), index)
        S, L = x.shape
        t1 = pc()
        kk = rk._kernels or rk._load()
        if S > kk.max_shards:
            raise SystemExit("ring split: too many shards")
        t2 = pc()
        out = torch.empty_like(x)
        t3 = pc()
        stream = kk.stream(index)
        t4 = pc()
        err = launch(index, x.data_ptr(), out.data_ptr(), S, L, stream)
        t5 = pc()
        check(err == 0, f"ring split: launch error {err}")
        for stage, a, b in zip(RING_STAGES, (t0, t1, t2, t3, t4), (t1, t2, t3, t4, t5)):
            ns[stage] += b - a
    split = {"stages_us": {st: v / HOST_SPLIT_CALLS / 1e3 for st, v in ns.items()}}
    torch.cuda.synchronize()
    # whole calls on the host clock (no wait): the wrapper and its yardstick
    split["wrapper_us"] = host_us(lambda i: rk.ring_all_reduce_cuda(x), HOST_SPLIT_CALLS)
    split["torch_sum_us"] = host_us(lambda i: torch.sum(x, 0), HOST_SPLIT_CALLS)
    torch.cuda.synchronize()
    log_split(f"ring_all_reduce_cuda S={x.shape[0]} L={x.shape[1]}", split["stages_us"])
    tlog(f"  host clock per call, no wait: ring_all_reduce_cuda {split['wrapper_us']:.2f} us, "
         f"torch.sum(x, 0) {split['torch_sum_us']:.2f} us")
    return split


def check_raw_stream(dev):
    """The launch path's stream lookup (ops/_launch.py, a private torch
    function) must give what torch.cuda.current_stream gives, on the
    default stream and inside a side-stream context."""
    raw = rk._load().stream
    for st in (torch.cuda.current_stream(dev), torch.cuda.Stream(dev)):
        with torch.cuda.stream(st):
            check(raw(dev.index) == torch.cuda.current_stream(dev).cuda_stream,
                  "the raw stream lookup differs from torch.cuda.current_stream")
    log("  the launch path's raw stream handle equals torch.cuda.current_stream's, "
        "default and side stream")


def split_seed_mirror(gpu, keys):
    """Host microseconds per Engine.seed_mirror, by stage (SEED_STAGES),
    over HOST_SPLIT_CALLS calls cycling over `keys`, of the sequence it
    runs: the slot written into the page-locked buffer, the pinned gather,
    one wait on the stream and the row read from the buffer (wait_read holds
    the kernel), the mirror written. Then whole seed_mirror calls."""
    check(len(keys) > 0, "host split: no seeded key to gather")
    d, state, lone = gpu.directory, gpu.state, gpu._lone
    pc = time.perf_counter_ns
    ns = dict.fromkeys(SEED_STAGES, 0)
    for i in range(HOST_SPLIT_CALLS):
        key = keys[i % len(keys)]
        t0 = pc()
        with gpu._lock:
            slot = d.peek_slot(key)
            t1 = pc()
            lone.slot_np[0] = slot
            t2 = pc()
            rowk.gather_rows_cuda(state, lone.slot, lone.row)
            t3 = pc()
            rowk.sync_stream(lone.index)
            row = lone.row_np
            t4 = pc()
            check(row[0] >= 0, f"host split: {key} has a vacant row")
            d.mirror_seed(key, row)
        t5 = pc()
        for stage, a, b in zip(SEED_STAGES, (t0, t1, t2, t3, t4), (t1, t2, t3, t4, t5)):
            ns[stage] += b - a
    split = {"stages_us": {st: v / HOST_SPLIT_CALLS / 1e3 for st, v in ns.items()}}
    split["seed_mirror_us"] = host_us(lambda i: gpu.seed_mirror(keys[i % len(keys)]),
                                      HOST_SPLIT_CALLS)
    log_split("seed_mirror", split["stages_us"])
    tlog(f"  host clock per call: Engine.seed_mirror {split['seed_mirror_us']:.2f} us "
         f"over {HOST_SPLIT_CALLS} calls")
    return split


# ----------------------------------------------------------------- phase 4

def phase_global(seed, dev, results):
    S, C, G = GLOBAL_SHARDS, GLOBAL_ROWS, GLOBAL_KEYS
    log(f"== phase 4: GLOBAL sync, S={S} shards x {C} rows, G={G}")
    rng = np.random.default_rng(seed + 2)
    ring_rec = {}
    for L in (G, 4 * G):
        x = torch.from_numpy(rng.integers(-2**62, 2**62, (S, L), dtype=np.int64)).to(dev)
        got, want = rk.ring_all_reduce_cuda(x), rk.ring_all_reduce_plain(x)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"ring L={L}: kernel and plain version differ")
        check(torch.equal(got, _psum(x)), f"ring L={L}: ring and psum differ")
        call_ms = event_ms(lambda i: rk.ring_all_reduce_cuda(x), 200)
        ms = profiled_ms(lambda i: rk.ring_all_reduce_cuda(x), 200, "ring_kernel")
        plain_ms = event_ms(lambda i: rk.ring_all_reduce_plain(x), 50)
        lib_ms = event_ms(lambda i: torch.sum(x, 0), 200)
        lib_dev_ms = profiled_ms(lambda i: torch.sum(x, 0), 200)
        b_ms, b_by = bound_ms(2 * S * L * 8, 2 * (S - 1) * L)
        ring_rec[L] = dict(L=L, S=S, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                           library_ms=lib_ms, library_device_ms=lib_dev_ms, bound_ms=b_ms,
                           bound_by=b_by, max_abs_err=max_abs_err(got, want))
        tlog(f"  ring L={L}: bit-equal; kernel {fms(ms)} ms on the device, {call_ms:.4f} ms "
             f"per wrapper call; plain {plain_ms:.4f} ms; torch.sum {lib_ms:.4f} ms per "
             f"call, {fms(lib_dev_ms)} ms on the device; bound {b_ms:.6f} ms ({b_by})")
    results["ring"] = list(ring_rec.values())
    check_raw_stream(dev)
    results["host_split_ring"] = split_ring(x)

    plan = MeshPlan(n_shards=S, capacity_per_shard=C)
    card = make_sharded_table(plan, dev)
    card.copy_(populate_table(S * C, seed + 3, dev).view(1, S, C, 8))
    host = card.to("cpu", copy=True)
    keys = [f"global_{i}" for i in range(G)]
    owner = np.array([shard_of_key(k, S) for k in keys], np.int32)
    slot = np.full(G, -1, np.int32)
    for s in range(S):
        mine = np.flatnonzero(owner == s)
        slot[mine] = rng.choice(C, len(mine), replace=False)
    slot[rng.random(G) < 0.05] = -1  # not registered yet
    greg = rng.random(G) < 0.05
    dur = np.where(greg, rng.integers(0, 3, G), rng.choice([1000, 60_000], G)).astype(np.int64)
    local = dt.datetime.fromtimestamp(NOW / 1000.0)
    cfg_np = dict(
        slot=slot, owner=owner, limit=rng.choice([10, 100, 10_000], G).astype(np.int64),
        duration=dur, algorithm=(rng.random(G) < 0.2).astype(np.int32),
        behavior=np.where(greg, GREG, 0).astype(np.int32),
        greg_expire=np.array([gregorian_expiration(local, int(c)) if g else 0
                              for g, c in zip(greg, dur)], np.int64),
        greg_interval=np.array([gregorian_duration(local, int(c)) if g else 0
                                for g, c in zip(greg, dur)], np.int64),
        fresh=np.ones(G, np.bool_))
    ring_sync = make_global_sync(plan, collectives="ring", device=dev)
    psum_sync = make_global_sync(plan, collectives="psum", device="cpu")
    dk.reset_launch_counts()
    rk.reset_launch_counts()
    t_ring = 0.0
    steps = 5
    for step in range(steps):
        now = NOW + step * 1000
        delta = rng.integers(0, 5, (1, S, G)).astype(np.int64)
        cfg_d = GlobalConfig(**{k: torch.from_numpy(v).to(dev) for k, v in cfg_np.items()})
        cfg_h = GlobalConfig(**{k: torch.from_numpy(v) for k, v in cfg_np.items()})
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, m_card, _ = ring_sync(card, torch.from_numpy(delta).to(dev), cfg_d, now)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t
        t_ring += step_s
        if not step:  # the first step may pay the libraries' first loads
            first_ms = step_s * 1e3
        _, m_host, _ = psum_sync(host, torch.from_numpy(delta), cfg_h, now)
        for f in m_card._fields:
            check(torch.equal(getattr(m_card, f).cpu(), getattr(m_host, f)),
                  f"sync step {step}: mirror.{f} differs")
        check(torch.equal(card.cpu(), host), f"sync step {step}: shard tables differ")
        cfg_np["fresh"] = np.zeros(G, np.bool_)
    launches = {**dk.launch_counts, **rk.launch_counts}
    # step_ms: the mean of all steps, as before; steady_step_ms leaves the first out
    step_ms = t_ring / steps * 1e3
    steady_ms = (t_ring * 1e3 - first_ms) / (steps - 1)
    results["global"] = dict(S=S, C=C, G=G, steps=steps, step_ms=step_ms,
                             steady_step_ms=steady_ms, first_step_ms=first_ms,
                             launches=launches)
    tlog(f"  {steps} sync steps: equal mirrors and shard tables; ring step {step_ms:.3f} ms "
         f"(steps 1-{steps}; steps 2-{steps} {steady_ms:.3f} ms, the first {first_ms:.3f} ms); "
         f"launches {launches}")
    del card, host
    torch.cuda.empty_cache()
    return launches, ring_rec[4 * G]


# ----------------------------------------------------------------- phase 5

def inject_stimulus(rng, C, m, device):
    """i64[m, 8] inject rows over distinct slots; about one lane in eight
    is dropped (-1, C, C + 5) and algo/status overflow int32 on some."""
    rows = rng.integers(-(1 << 40), 1 << 40, (m, 8), dtype=np.int64)
    rows[:, 0] = rng.choice(C, m, replace=False)
    bad = rng.random(m) < 0.125
    rows[bad, 0] = rng.choice([-1, C, C + 5], int(bad.sum()))
    rows[:, 1] = np.where(rng.random(m) < 0.8, rng.integers(0, 2, m), rows[:, 1])
    rows[:, 7] = np.where(rng.random(m) < 0.8, rng.integers(0, 2, m), rows[:, 7])
    return torch.from_numpy(rows).to(device)


def gather_stimulus(rng, C, m, device):
    """i32[m] slots, some below 0 or at and past C (they clamp)."""
    s = rng.integers(0, C, m).astype(np.int32)
    bad = rng.random(m) < 0.125
    s[bad] = rng.choice([-1, -9, C, C + 3], int(bad.sum()))
    return torch.from_numpy(s).to(device)


def in_turns(measure, run_a, run_b):
    """measure(run_a) and measure(run_b) taken in turns a, b, b, a; the mean
    of each pair, so neither side gains from going first."""
    a0, b0, b1, a1 = measure(run_a), measure(run_b), measure(run_b), measure(run_a)
    return (a0 + a1) / 2, (b0 + b1) / 2


def timed_kernel(run_k, run_p, run_lib, kernel_name, iters=64, flush=None):
    """Device ms (profiler) of the kernel and of the library call, each
    session after flush() when given; call ms of both (CUDA events, back to
    back) in turns; the plain version's ms."""
    def profiled(run, name):
        if flush is not None:
            flush()
        return profiled_ms(run, 32, name)

    call_ms, library_ms = in_turns(lambda f: event_ms(f, iters), run_k, run_lib)
    return dict(ms=profiled(run_k, kernel_name), call_ms=call_ms,
                plain_ms=event_ms(run_p, 8), library_ms=library_ms,
                library_device_ms=profiled(run_lib, None))


def index_copy_rows(st, C):
    """The yardstick's operands for inject rows `st` (i64[m, 8], on the card):
    the kept slots and the rows as the inject writes them, for one
    index_copy_."""
    keep = (st[:, 0] >= 0) & (st[:, 0] < C)
    r = torch.cat([st[:, 1:2].to(torch.int32).to(torch.int64), st[:, 2:7],
                   st[:, 7:8].to(torch.int32).to(torch.int64), torch.zeros_like(st[:, :1])], 1)
    return st[keep, 0].contiguous(), r[keep].contiguous()


def pinned_inject(rng, kern, plain, dev):
    """The inject's pinned form, as the engine runs it: the rows in the
    page-locked staging (rowk.InjectStaging), read by the kernel through
    their mapped address. An unpinned host inject is refused; bit-equal to
    inject_rows_plain at every m of INJECT_M (dropped and int32-overflowing
    lanes); then timed: device ms per launch (torch.profiler) and, on the
    host clock, ms per round trip from a numpy i64[m, 8] to the rows in the
    table (copied into the staging, launched, one wait on the stream) as
    call_ms, beside the plain version and the yardstick
    torch.from_numpy(a).to(dev) followed by index_copy_ of the prepared rows,
    with the same wait. Returns records and the largest difference."""
    C, index = kern.shape[0], kern.get_device()
    staging = rowk.InjectStaging.allocate(max(INJECT_M), dev)
    try:  # pageable host memory has no device address
        rowk.inject_rows_cuda(kern, torch.zeros((1, rowk.ROW_FIELDS), dtype=torch.int64))
    except ValueError as e:
        check("page-locked" in str(e), f"unpinned inject: wrong refusal {e}")
    else:
        check(False, "pinned inject took an unpinned host inject")
    recs, err = [], 0
    for m in INJECT_M:
        host = [inject_stimulus(rng, C, m, "cpu").numpy() for _ in range(16)]
        on_card = [torch.from_numpy(a).to(dev) for a in host]
        plain.copy_(kern)
        for a, d in zip(host[:4], on_card[:4]):
            staging.free()[:m] = a
            staging.launch(kern, m)
            rowk.inject_rows_plain(plain, d)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(kern, plain))
        check(torch.equal(kern, plain), f"pinned inject m={m}: tables differ")
        lib_in = [index_copy_rows(d, C) for d in on_card]

        def run_k(i):
            staging.launch(kern, m)

        def round_trip(i):
            staging.inject(kern, host[i % 16])
            rowk.sync_stream(index)

        def run_lib(i):
            torch.from_numpy(host[i % 16]).to(dev)
            plain.index_copy_(0, *lib_in[i % 16])
            rowk.sync_stream(index)

        def run_p(i):
            rowk.inject_rows_plain(plain, torch.from_numpy(host[i % 16]).to(dev))
            rowk.sync_stream(index)

        b_ms, b_by = bound_ms(m * 128, 0)
        call_us, lib_us = in_turns(lambda f: host_us(f, 2000), round_trip, run_lib)
        recs.append(dict(
            kernel="inject_rows", form="pinned", m=m, ms=profiled_ms(run_k, 32, "inject_kernel"),
            call_ms=call_us / 1e3, plain_ms=host_us(run_p, 200) / 1e3,
            library_ms=lib_us / 1e3, library_device_ms=profiled_ms(run_lib, 32),
            library="torch.from_numpy(a).to(dev) + index_copy_", bound_ms=b_ms, bound_by=b_by,
            bytes=m * 128))
    plain.copy_(kern)
    return recs, err, staging


def inject_reuse(rng, kern, plain, staging, dev):
    """REUSE_INJECTS pinned injects of LONE_KEYS rows from one staging
    buffer, back to back behind a stream kept busy for about a millisecond:
    before each, the host writes new rows into staging.free() (which waits
    on the staging's event for the inject before) and launches, with no wait
    of its own. The table must equal the plain version's after the same
    injects in order. The same sequence with the rows written straight into
    the buffer, skipping free()'s wait, is logged beside it: it shows
    whether the hazard the wait guards against occurs on this card."""
    C, m = kern.shape[0], LONE_KEYS
    seq = [inject_stimulus(rng, C, m, "cpu").numpy() for _ in range(REUSE_INJECTS)]
    plain.copy_(kern)
    unguarded = kern.clone()
    for guarded in (True, False):
        table = kern if guarded else unguarded
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000)  # the injects queue behind ~1 ms of work
        for a in seq:
            buf = staging.free() if guarded else staging.rows_np
            buf[:m] = a
            if guarded:
                staging.launch(table, m)
            else:
                rowk.inject_rows_pinned(table, staging.rows, m, None)
        torch.cuda.synchronize()
    for a in seq:
        rowk.inject_rows_plain(plain, torch.from_numpy(a).to(dev))
    torch.cuda.synchronize()
    err = max_abs_err(kern, plain)
    check(torch.equal(kern, plain), "inject reuse: the staging was rewritten under a "
          "launched inject (tables differ)")
    hazard = not torch.equal(unguarded, plain)
    del unguarded
    log(f"  inject reuse: {REUSE_INJECTS} pinned injects of {m} rows from one staging, "
        f"behind a busy stream: table equal to the plain version's; without the "
        f"staging's wait the table {'differs' if hazard else 'is equal too'}")
    return err, hazard


def pinned_gather(rng, kern, dev):
    """The gather's pinned form (slots and rows in page-locked host memory,
    read and written by the kernel through their mapped addresses), as
    Engine.seed_mirror runs it: an unpinned slot or out is refused; bit-equal
    to gather_rows_plain at m = 1 (the slots -1, C, C + 8 and random ones,
    one call each) and m = 64 (the three clamped slots among random ones);
    then timed: device ms per launch (torch.profiler), and, on the host
    clock, ms per whole round trip (launch, one wait on the stream, the rows
    read) as call_ms, beside the plain version and the yardstick
    state[slot, :7].tolist() doing the same work on the same clock, each
    with its readback. Returns records and the largest difference."""
    C, index = kern.shape[0], kern.get_device()
    recs, err = [], 0
    for m in PINNED_M:
        if m == 1:
            vals = [np.array([v], np.int32) for v in (-1, C, C + 8)]
            vals += [rng.integers(0, C, 1).astype(np.int32) for _ in range(13)]
        else:
            first = rng.integers(0, C, m).astype(np.int32)
            first[:3] = [-1, C, C + 8]
            vals = [first] + [gather_stimulus(rng, C, m, "cpu").numpy() for _ in range(15)]
        slots = [torch.from_numpy(v).pin_memory() for v in vals]
        out = torch.empty((rowk.GATHER_FIELDS, m), dtype=torch.int64, pin_memory=True)
        out_np = out.numpy()
        for bad, what in ((torch.from_numpy(vals[0].copy()), "slots"),
                          (torch.empty((rowk.GATHER_FIELDS, m), dtype=torch.int64), "out")):
            try:  # pageable host memory has no device address
                rowk.gather_rows_cuda(kern, *((bad, out) if what == "slots" else (slots[0], bad)))
            except ValueError as e:
                check("page-locked" in str(e), f"unpinned {what}: wrong refusal {e}")
            else:
                check(False, f"pinned gather m={m} took an unpinned {what}")
        for s in slots:
            rowk.gather_rows_cuda(kern, s, out)
            rowk.sync_stream(index)
            want = rowk.gather_rows_plain(kern, s.to(dev)).cpu()
            err = max(err, max_abs_err(out, want))
            check(torch.equal(out, want), f"pinned gather m={m} slots {s.tolist()[:4]}: differs")
        idx = [torch.from_numpy(v.astype(np.int64).clip(0, C - 1)).to(dev) for v in vals]
        if m == 1:  # the lone path's own yardstick: an int index, one readback
            ints = [int(i.item()) for i in idx]
            run_lib = lambda i: kern[ints[i % 16], :7].tolist()  # noqa: E731
        else:
            run_lib = lambda i: kern[idx[i % 16], :7].tolist()  # noqa: E731

        def run_k(i):
            rowk.gather_rows_cuda(kern, slots[i % 16], out)

        def round_trip(i):
            rowk.gather_rows_cuda(kern, slots[i % 16], out)
            rowk.sync_stream(index)
            return out_np.tolist()

        b_ms, b_by = bound_ms(m * (4 + 56 + 56), 0)
        call_us, lib_us = in_turns(lambda f: host_us(f, 2000), round_trip, run_lib)
        recs.append(dict(
            kernel="gather_rows", form="pinned", m=m, ms=profiled_ms(run_k, 32, "gather_kernel"),
            call_ms=call_us / 1e3,
            plain_ms=host_us(lambda i: rowk.gather_rows_plain(kern, idx[i % 16]).tolist(),
                             200) / 1e3,
            library_ms=lib_us / 1e3, library_device_ms=profiled_ms(run_lib, 32),
            library="state[slot, :7].tolist()", bound_ms=b_ms, bound_by=b_by, bytes=m * 116))
    return recs, err


def phase_rows(seed, dev, results):
    log(f"== phase 5: row kernels vs their plain versions on the card, table "
        f"{CAPACITY} rows; row_bump on int32[{bench_rows.CAP}, 128] "
        f"({bench_rows.CAP * 512 / 1e9:.2f} GB)")
    rng = np.random.default_rng(seed + 4)
    kern = populate_table(CAPACITY, seed + 5, dev)
    plain = kern.clone()
    C = CAPACITY
    recs, errs = [], {"inject_rows": 0, "gather_rows": 0, "row_bump": 0}
    for m in INJECT_M:
        stims = [inject_stimulus(rng, C, m, dev) for _ in range(16)]
        plain.copy_(kern)  # the timing runs below mutate the two tables differently
        rowk.inject_rows_cuda(kern, stims[0])
        rowk.inject_rows_plain(plain, stims[0])
        torch.cuda.synchronize()
        errs["inject_rows"] = max(errs["inject_rows"], max_abs_err(kern, plain))
        check(torch.equal(kern, plain), f"inject m={m}: tables differ")
        # the yardstick: one index_copy_ of the prepared rows at the kept slots
        lib_in = [index_copy_rows(st, C) for st in stims]
        t = timed_kernel(lambda i: rowk.inject_rows_cuda(kern, stims[i % 16]),
                         lambda i: rowk.inject_rows_plain(plain, stims[i % 16]),
                         lambda i: plain.index_copy_(0, *lib_in[i % 16]),
                         "inject_kernel")
        b_ms, b_by = bound_ms(m * 128, 0)
        recs.append(dict(kernel="inject_rows", form="device", m=m, library="index_copy_",
                         bound_ms=b_ms, bound_by=b_by, bytes=m * 128, **t))
    pinned, errs["inject_rows_pinned"], staging = pinned_inject(rng, kern, plain, dev)
    recs += pinned
    errs["inject_reuse"], results["inject_reuse_hazard"] = inject_reuse(
        rng, kern, plain, staging, dev)
    errs["inject_rows"] = max(errs["inject_rows"], errs["inject_rows_pinned"],
                              errs["inject_reuse"])
    del staging
    plain.copy_(kern)
    for m in GATHER_M:
        stims = [gather_stimulus(rng, C, m, dev) for _ in range(16)]
        got, want = rowk.gather_rows_cuda(kern, stims[0]), rowk.gather_rows_plain(kern, stims[0])
        torch.cuda.synchronize()
        errs["gather_rows"] = max(errs["gather_rows"], max_abs_err(got, want))
        check(torch.equal(got, want), f"gather m={m}: rows differ")
        lib_idx = [s.to(torch.int64).clamp(0, C - 1) for s in stims]
        t = timed_kernel(lambda i: rowk.gather_rows_cuda(kern, stims[i % 16]),
                         lambda i: rowk.gather_rows_plain(kern, stims[i % 16]),
                         lambda i: torch.index_select(kern, 0, lib_idx[i % 16]),
                         "gather_kernel")
        b_ms, b_by = bound_ms(m * (4 + 56 + 56), 0)
        recs.append(dict(kernel="gather_rows", form="device", m=m, library="index_select",
                         bound_ms=b_ms, bound_by=b_by, bytes=m * 116, **t))
    pinned, errs["gather_rows_pinned"] = pinned_gather(rng, kern, dev)
    recs += pinned
    errs["gather_rows"] = max(errs["gather_rows"], errs["gather_rows_pinned"])
    del kern, plain
    torch.cuda.empty_cache()

    N, B = bench_rows.CAP, bench_rows.BATCH
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 6)
    kern = torch.randint(-(1 << 31), (1 << 31) - 1, (N, 128), generator=g, device=dev,
                         dtype=torch.int32)
    srng = np.random.RandomState(5)
    sets = [torch.from_numpy(srng.choice(N, B, replace=False).astype(np.int32)).to(dev)
            for _ in range(16)]
    kern[sets[0][:4].to(torch.int64)] = torch.iinfo(torch.int32).max  # the +1 wraps
    plain = kern.clone()
    out = torch.full((1,), -7, dtype=torch.int32, device=dev)  # the caller's out
    for j, s in enumerate(sets[:4]):
        out_k = rowk.row_bump_cuda(kern, s, out if j % 2 else None)
        out_p = rowk.row_bump_plain(plain, s)
        torch.cuda.synchronize()
        check(out_k is out if j % 2 else out_k is not out, "row_bump: out not used as given")
        errs["row_bump"] = max(errs["row_bump"], max_abs_err(kern, plain),
                               max_abs_err(out_k, out_p))
        check(torch.equal(out_k, out_p), "row_bump: outputs differ")
        check(torch.equal(kern, plain), "row_bump: tables differ")
    ones = torch.ones((B, 128), dtype=torch.int32, device=dev)
    idx = [s.to(torch.int64) for s in sets]
    # 16 slot sets cycled: 64 MB of rows, more than the 50 MB L2; and 128 MB
    # written before each profiled session, so that neither session finds
    # rows the other left in L2
    scratch = torch.empty(32 << 20, dtype=torch.int32, device=dev)
    t = timed_kernel(lambda i: rowk.row_bump_cuda(kern, sets[i % 16], out),
                     lambda i: rowk.row_bump_plain(plain, sets[i % 16], out),
                     lambda i: kern.index_add_(0, idx[i % 16], ones), "row_bump_kernel",
                     flush=lambda: scratch.fill_(0))
    n_bytes = B * 512 * 2 + B * 4 + 4
    b_ms, b_by = bound_ms(n_bytes, B * 128)
    recs.append(dict(kernel="row_bump", form="device", m=B, library="index_add_",
                     bound_ms=b_ms, bound_by=b_by, bytes=n_bytes, **t))
    del kern, plain, ones, idx, sets, out, scratch
    torch.cuda.empty_cache()
    for r in recs:
        if r["form"] == "pinned":
            how = ("per round trip on the host clock (rows in or out of page-locked memory, "
                   f"launch, wait); plain {r['plain_ms']:.4f} ms, yardstick {r['library']} "
                   f"{r['library_ms']:.4f} ms, the same")
        else:
            how = (f"per wrapper call; plain {r['plain_ms']:.4f} ms; library {r['library']} "
                   f"{r['library_ms']:.4f} ms per call")
        tlog(f"  {r['kernel']:11s} ({r['form']}) m={r['m']:5d}: bit-equal; kernel {fms(r['ms'])} ms on "
             f"the device, {r['call_ms']:.4f} ms {how}, {fms(r['library_device_ms'])} ms on "
             f"the device; bound {r['bound_ms']:.6f} ms ({r['bound_by']})")

    log(f"  bench_rows (python3 -m gubernator_tpu_torch.bench_rows): {B} rows per call")
    rowk.reset_launch_counts()
    probe = bench_rows.run(dev)
    launches = dict(rowk.launch_counts)
    tlog(f"  {json.dumps(probe)}")
    torch.cuda.empty_cache()
    results["rows"] = recs
    results["bench_rows"] = probe
    return errs, recs, launches["row_bump"]


# ----------------------------------------------------------------- phase 6

PIPE_WINDOWS = 24  # phase 3's windows the serving stream takes: 196,608 requests
COL_WINDOWS = 8  # of them again, as wire columns
PIPE_DEPTH, PIPE_SCAN = 3, 8
BIG_SUBMISSION = 10_000  # over max_width: the combiner's serial path
SUBS_PER_MS = 64  # submissions sharing one now_ms
MAX_SUBMISSION = 512
TRACED_SUBS = 400  # the first submissions of the depth-3 run, under the profiler
COL_SLOW = GREG | int(Behavior.GLOBAL) | int(Behavior.MULTI_REGION)
# direct group launches held against the CPU twin: (K, W) of distinct-key windows
GROUP_SHAPES = ((2, 64), (8, 64), (2, 1024), (8, 1024), (2, 8192), (8, 8192))
SLEEP_CYCLES = 1_000_000_000  # ~0.5 s of busy card queued before a group launch


def serving_stream(seed):
    """Phase 3's first PIPE_WINDOWS windows, flat, cut into client
    submissions of 1-512 requests (log-uniform, from the seed) with one of
    BIG_SUBMISSION requests half way."""
    batches, _ = request_stream(seed, PIPE_WINDOWS)
    flat = [r for _, batch in batches for r in batch]
    rng = np.random.default_rng(seed + 6)
    subs, pos, big = [], 0, len(flat) // 2
    while pos < len(flat):
        if big is not None and pos >= big:
            n, big = BIG_SUBMISSION, None
        else:
            n = int(np.exp(rng.uniform(0.0, np.log(MAX_SUBMISSION + 1))))
        subs.append(flat[pos:pos + n])
        pos += n
    return flat, subs


def sub_now(i):
    return NOW + i // SUBS_PER_MS


def timed_methods(eng, names):
    """Host clock around engine methods (instance attributes, so the
    combiner calls the wrappers): {name: [calls, ns]}."""
    spent = {n: [0, 0] for n in names}
    for n in names:
        def timed(*a, _fn=getattr(eng, n), _n=n, **kw):
            t0 = time.perf_counter_ns()
            out = _fn(*a, **kw)
            rec = spent[_n]
            rec[0] += 1
            rec[1] += time.perf_counter_ns() - t0
            return out

        setattr(eng, n, timed)
    return spent


class TimedLock:
    """The engine lock with its waits added up by thread name (the combiner's
    worker launches, its drainer collects)."""

    def __init__(self, inner):
        self.inner = inner
        self.wait_ns = {}

    def __enter__(self):
        t0 = time.perf_counter_ns()
        self.inner.acquire()
        name = threading.current_thread().name
        self.wait_ns[name] = self.wait_ns.get(name, 0) + time.perf_counter_ns() - t0
        return self

    def __exit__(self, *exc):
        self.inner.release()


def timed_fetch():
    """Host clock around WindowStaging.fetch (the wait on a slot's event and
    the copy out of its response), for every engine; undo() restores it."""
    from gubernator_tpu_torch.ops.staging import WindowStaging

    spent = {"calls": 0, "ns": 0}
    orig = WindowStaging.fetch

    def fetch(handle):
        t0 = time.perf_counter_ns()
        out = orig(handle)
        spent["calls"] += 1
        spent["ns"] += time.perf_counter_ns() - t0
        return out

    WindowStaging.fetch = staticmethod(fetch)
    spent["undo"] = lambda: setattr(WindowStaging, "fetch", staticmethod(orig))
    return spent


def drive_combiner(eng, subs, depth, traced=0):
    """One async submitter through BackendCombiner(eng, depth, PIPE_SCAN):
    the first `traced` submissions under torch.profiler (drained before the
    rest go in), the rest timed on the host clock up to the last response.
    Returns the responses as tuples and the measurements."""
    from gubernator_tpu_torch.service.combiner import BackendCombiner

    c = BackendCombiner(eng, depth=depth, scan=PIPE_SCAN)
    check(c.pipelined == (depth > 1), f"the depth-{depth} combiner's pipeline is "
          f"{'on' if c.pipelined else 'off'}")
    m = dict(traced_s=0.0, busy_us=0.0)
    got = []
    try:
        if traced:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                futs = [c.submit_async(s, sub_now(i)) for i, s in enumerate(subs[:traced])]
                got += [f.result(timeout=600) for f in futs]
                torch.cuda.synchronize()
                m["traced_s"] = time.perf_counter() - t
            m["busy_us"] = sum(e.self_device_time_total for e in prof.key_averages())
        t = time.perf_counter()
        futs = [c.submit_async(s, sub_now(i)) for i, s in enumerate(subs[traced:], traced)]
        got += [f.result(timeout=600) for f in futs]
        m["s"] = time.perf_counter() - t
        m["n_req"] = sum(len(s) for s in subs[traced:])
        m["stats"] = c.stats
        m["slot_waits"] = sum(st.waits for slot in c._staging for st in slot.values())
    finally:
        c.close()
    return [resp_tuples(rs) for rs in got], m


def rows_by_key(eng):
    """(keys sorted, their table rows) over every key the directory holds."""
    items = sorted(eng.directory.items())
    slots = torch.tensor([s for _, s in items], dtype=torch.int64)
    return [k for k, _ in items], eng.state[slots.to(eng.state.device)].cpu()


def chunk_paths(index, shapes):
    """Scan launches by the path csrc/decide.cu takes (scan_chunk's rule):
    {"chunked": n, "per_window": n} and the same by 'name K=.. W=..'."""
    paths, by_shape = {"chunked": 0, "per_window": 0}, {}
    for (name, k, w), n in sorted(shapes.items()):
        if "_scan_" not in name:
            continue
        kc = dk.scan_chunk(index, FORMATS[name.rsplit("_", 1)[1]], k, w)
        path = "chunked" if kc else "per_window"
        paths[path] += n
        by_shape[f"{name} K={k} W={w}"] = f"{n} {path}" + (f" (chunks of {kc})" if kc else "")
    return paths, by_shape


def shapes_line(shapes):
    return {f"{name} K={k} W={w}": n for (name, k, w), n in sorted(shapes.items())}


def distinct_group(flat, cursor, k, w):
    """K windows of w requests in stream order from flat[cursor:], each
    with distinct keys and no gregorian lane (nothing cuts the group;
    hot keys recur across its windows). Returns the windows and the
    cursor after them."""
    wins = []
    for _ in range(k):
        seen, win = set(), []
        while len(win) < w:
            r = flat[cursor % len(flat)]
            cursor += 1
            key = r.hash_key()
            if key not in seen and not r.behavior & GREG:
                seen.add(key)
                win.append(r)
        wins.append(win)
    return wins, cursor


def group_checks(gpu, cpu, flat, now):
    """Direct launch_windows / collect_windows of distinct-key groups at
    every GROUP_SHAPES (K, W) on the card engine and its CPU twin, equal
    answers. Each card launch goes in behind SLEEP_CYCLES of busy card:
    its slot's event must still be pending when launch_windows returns (the
    launch did not wait on the card). Returns the launch shapes, counted
    between a reset and a read."""
    dk.reset_launch_counts()
    cursor, waited = 0, 0
    for i, (k, w) in enumerate(GROUP_SHAPES):
        wins, cursor = distinct_group(flat, cursor, k, w)
        torch.cuda._sleep(SLEEP_CYCLES)
        h = gpu.launch_windows(wins, now_ms=now + i, staging={})
        check(h is not None and len(h[0]) == 1, f"group K={k} W={w} was not one launch")
        waited += h[0][0][0][0].done.query()
        got = gpu.collect_windows(h)
        want = cpu.collect_windows(cpu.launch_windows(wins, now_ms=now + i, staging={}))
        check([resp_tuples(r) for r in got] == [resp_tuples(r) for r in want],
              f"group K={k} W={w}: card and CPU engines answer differently")
    check(waited == 0, f"{waited} of {len(GROUP_SHAPES)} group launches returned after "
          "the card had finished them: launch_windows waited on the card")
    return dict(dk.launch_shapes)


def columnar_cols(reqs):
    """The peerlink wire layout of one sub-window, as a launch tuple."""
    names = [r.name.encode() for r in reqs]
    ukeys = [r.unique_key.encode() for r in reqs]
    off = np.zeros(len(reqs) + 1, np.int32)
    np.cumsum([len(a) + len(b) for a, b in zip(names, ukeys)], out=off[1:])
    return (len(reqs), b"".join(a + b for a, b in zip(names, ukeys)), off,
            np.array([len(a) for a in names], np.int32),
            np.array([r.hits for r in reqs], np.int64),
            np.array([r.limit for r in reqs], np.int64),
            np.array([r.duration for r in reqs], np.int64),
            np.array([int(r.algorithm) for r in reqs], np.int32),
            np.array([int(r.behavior) for r in reqs], np.int32))


def columnar_loop(eng, reqs, now, depth):
    """The peerlink loop: sub-windows by bucket_splits, scan groups of
    PIPE_SCAN launched with `depth` in flight, collected in launch order;
    on a cut, everything in flight is collected and the leftovers retire
    through get_rate_limits, in order. depth 0: lock-step submit_columnar /
    complete_columnar. Returns the four response columns and the host
    seconds."""
    import collections

    from gubernator_tpu_torch.models.prep import bucket_pow2, bucket_splits, bucket_width

    n = len(reqs)
    outs = (np.zeros(n, np.int32), np.zeros(n, np.int64), np.zeros(n, np.int64),
            np.zeros(n, np.int64))
    spans, s0 = [], 0
    for ln in bucket_splits(n, eng.min_width, eng.max_width):
        spans.append((s0, s0 + ln))
        s0 += ln
    cols = [columnar_cols(reqs[a:b]) for a, b in spans]

    def retire(a, left):
        if len(left):
            idx = (a + left).tolist()
            for i, r in zip(idx, eng.get_rate_limits([reqs[i] for i in idx], now_ms=now)):
                outs[0][i], outs[1][i], outs[2][i], outs[3][i] = (
                    r.status, r.limit, r.remaining, r.reset_time)

    slots = [dict() for _ in range(depth + 2)] if depth else []
    widths = {bucket_width(b - a, eng.min_width, eng.max_width) for a, b in spans}
    for slot in slots:  # set-up: every slot's page-locked staging, every shape
        for k in {bucket_pow2(k) for k in range(1, PIPE_SCAN + 1)}:
            for w in widths:
                eng._slot_staging(slot, k, w)
    t = time.perf_counter()
    if depth == 0:
        for (a, b), c in zip(spans, cols):
            h = eng.submit_columnar(*c, COL_SLOW, now_ms=now)
            check(h is not None, "submit_columnar refused a window")
            retire(a, eng.complete_columnar(h, *(o[a:b] for o in outs)))
        return outs, time.perf_counter() - t
    inflight = collections.deque()
    wi = seq = 0

    def drain_one():
        h, gspans = inflight.popleft()
        gouts = [tuple(o[a:b] for o in outs) for a, b in gspans]
        for (a, _b), left in zip(gspans, eng.collect_columnar_windows(h, gouts)):
            retire(a, left)

    while wi < len(spans) or inflight:
        barrier = False
        while wi < len(spans) and len(inflight) < depth:
            group = cols[wi:wi + PIPE_SCAN]
            h = eng.launch_columnar_windows(group, COL_SLOW, now_ms=now,
                                            staging=slots[seq % len(slots)])
            check(h is not None and h[1] is None, f"launch_columnar_windows: {h and h[1]}")
            seq += 1
            consumed = len(h[0])
            inflight.append((h, spans[wi:wi + consumed]))
            wi += consumed
            if consumed < len(group) or len(h[0][-1][-1]):  # a cut: barrier
                barrier = True
                break
        if barrier or wi >= len(spans):
            while inflight:
                drain_one()
        elif inflight:
            drain_one()
    return outs, time.perf_counter() - t


def phase_pipeline(seed, dev, results):
    log(f"== phase 6: the serving pipeline, Engine(capacity={CAPACITY}, widths 64-{WINDOW}) "
        f"behind BackendCombiner: {PIPE_WINDOWS} windows of phase 3's stream as client "
        f"submissions, depth {PIPE_DEPTH} scan {PIPE_SCAN} and depth 1 on the card, depth 1 "
        f"on the CPU twin; then {COL_WINDOWS} windows as wire columns")
    flat, subs = serving_stream(seed)
    check(len(flat) == PIPE_WINDOWS * WINDOW and sum(map(len, subs)) == len(flat),
          "the serving stream lost requests")
    tlog(f"  {len(subs)} submissions of 1-{MAX_SUBMISSION} requests and one of "
         f"{BIG_SUBMISSION}, {len(flat)} requests, now_ms + 1 every {SUBS_PER_MS}")
    os.environ.pop("GUBER_NO_NATIVE", None)
    out = results["pipeline"] = {}
    launches = dict.fromkeys([*dk.launch_counts, *rowk.launch_counts], 0)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    # 1. build and warm the card engine; the depth probe
    t = time.perf_counter()
    gpu = Engine(device=dev, capacity=CAPACITY, min_width=64, max_width=WINDOW)
    gpu.warmup()
    gpu.warmup_pipeline(max_group=PIPE_SCAN)
    from gubernator_tpu_torch.service.combiner import BackendCombiner

    probe = BackendCombiner(gpu, depth="auto", scan=PIPE_SCAN)
    try:
        picked = probe.autotune(depths=(1, 3, 6))
    finally:
        probe.close()
    check(gpu.key_count() == 0, "the depth probe touched the table")
    out["autotune_depth"] = picked
    tlog(f"  engine built, warmed (warmup + warmup_pipeline) and probed in "
         f"{time.perf_counter() - t:.2f} s; autotune over (1, 3, 6) picked depth {picked}")

    # 2. the stream at depth 3, its first TRACED_SUBS submissions traced
    spent = timed_methods(gpu, ("launch_windows", "collect_windows"))
    tails = {"calls": 0, "requests": 0, "ns": 0}

    def tail(requests, now_ms, count_batch=True, _fn=gpu._slow_window):
        t0 = time.perf_counter_ns()
        resp = _fn(requests, now_ms, count_batch)
        if not count_batch:  # a leftover tail
            tails["calls"] += 1
            tails["requests"] += len(requests)
            tails["ns"] += time.perf_counter_ns() - t0
        return resp

    gpu._slow_window = tail
    gpu._inject.waits = 0
    lock = gpu._lock = TimedLock(gpu._lock)
    fetched = timed_fetch()
    dk.reset_launch_counts()
    rowk.reset_launch_counts()
    try:
        got3, m3 = drive_combiner(gpu, subs, PIPE_DEPTH, traced=TRACED_SUBS)
    finally:
        fetched.pop("undo")()
    # the combiner's calls only: the group checks below call the engine too
    lock_wait_s = {k: v / 1e9 for k, v in lock.wait_ns.items()}
    calls = {n: list(v) for n, v in spent.items()}
    tails3, inject_waits = dict(tails), gpu._inject.waits
    add(dk.launch_counts)
    add(rowk.launch_counts)
    shapes3 = dict(dk.launch_shapes)
    index = gpu.state.get_device()
    paths3, path_shapes3 = chunk_paths(index, shapes3)
    st = m3["stats"]
    check(st["pipelined_windows"] > 0 and st["group_launches"] > 0,
          f"the depth-{PIPE_DEPTH} run launched nothing pipelined: {st}")

    # 3. the CPU twin at depth 1: equal answers
    cpu = Engine(device="cpu", capacity=CAPACITY, min_width=64, max_width=WINDOW)
    want, mc = drive_combiner(cpu, subs, 1)
    check(got3 == want, f"depth {PIPE_DEPTH} on the card and depth 1 on the CPU answer "
          "differently")
    group_shapes = group_checks(gpu, cpu, flat, sub_now(len(subs)) + 1)
    group_paths, group_path_shapes = chunk_paths(index, group_shapes)
    gk, gr = rows_by_key(gpu)
    ck, cr = rows_by_key(cpu)
    check(gk == ck and torch.equal(gr, cr), "the card and CPU tables differ at the "
          "directory's keys")
    rate3 = m3["n_req"] / m3["s"]
    busy = m3["busy_us"] / 1e6 / m3["traced_s"] if m3["traced_s"] else None
    launch_us = calls["launch_windows"][1] / max(calls["launch_windows"][0], 1) / 1e3
    collect_us = calls["collect_windows"][1] / max(calls["collect_windows"][0], 1) / 1e3
    del gpu
    torch.cuda.empty_cache()

    # the timing pairs, in turns: the same stream at depth 1, 1 and PIPE_DEPTH,
    # each on a fresh card engine warmed as the first
    rates = {PIPE_DEPTH: [m3["n_req"] / m3["s"]], 1: []}
    for depth in (1, 1, PIPE_DEPTH):
        eng = Engine(device=dev, capacity=CAPACITY, min_width=64, max_width=WINDOW)
        eng.warmup()
        eng.warmup_pipeline(max_group=PIPE_SCAN)
        dk.reset_launch_counts()
        rowk.reset_launch_counts()
        got, m = drive_combiner(eng, subs, depth, traced=TRACED_SUBS)
        add(dk.launch_counts)
        add(rowk.launch_counts)
        check(got == want, f"depth {depth} on the card and depth 1 on the CPU answer "
              "differently")
        rates[depth].append(m["n_req"] / m["s"])
        del eng
        torch.cuda.empty_cache()
    rate3, rate1 = float(np.mean(rates[PIPE_DEPTH])), float(np.mean(rates[1]))
    launch_tail_free_us = ((calls["launch_windows"][1] - tails3["ns"])
                           / max(calls["launch_windows"][0], 1) / 1e3)
    out.update(
        submissions=len(subs), requests=len(flat), decisions_per_s_depth3=rate3,
        decisions_per_s_depth1=rate1, decisions_per_s_runs=rates,
        cpu_twin_decisions_per_s=mc["n_req"] / mc["s"],
        device_busy_share=busy, traced_submissions=TRACED_SUBS, stats=st,
        launch_windows_us=launch_us, launch_windows_tail_free_us=launch_tail_free_us,
        collect_windows_us=collect_us, fetch_calls=fetched["calls"],
        fetch_us=fetched["ns"] / max(fetched["calls"], 1) / 1e3, lock_wait_s=lock_wait_s,
        launch_windows_calls=calls["launch_windows"][0],
        tail_retires=tails3, inject_waits=inject_waits, slot_waits=m3["slot_waits"],
        decide_shapes=shapes_line(shapes3), scan_paths=paths3,
        scan_path_shapes=path_shapes3, group_check_shapes=shapes_line(group_shapes),
        group_check_paths=group_paths, group_check_path_shapes=group_path_shapes,
        keys=len(gk))
    tlog(f"  equal answers (4 card runs, depth 1 CPU) and equal rows at all {len(gk)} keys; "
         f"object path, runs in turns ({PIPE_DEPTH}, 1, 1, {PIPE_DEPTH}): depth {PIPE_DEPTH} "
         + ", ".join(f"{r:,.0f}" for r in rates[PIPE_DEPTH]) + " decisions/s, depth 1 "
         + ", ".join(f"{r:,.0f}" for r in rates[1]) + f" decisions/s (CPU twin "
         f"{mc['n_req'] / mc['s']:,.0f}/s); {m3['n_req']} requests timed a run, the first "
         f"{TRACED_SUBS} submissions traced apart")
    tlog(f"  device busy {busy} of the traced stretch's wall time ({m3['traced_s']:.3f} s)")
    tlog(f"  host us per launch_windows {launch_us:.1f} ({calls['launch_windows'][0]} calls, "
         f"leftover tails included: {tails3['calls']} tails, {tails3['requests']} requests, "
         f"{tails3['ns'] / 1e9:.3f} s; {launch_tail_free_us:.1f} without them), per "
         f"collect_windows {collect_us:.1f} (first depth-{PIPE_DEPTH} run), of which the "
         f"slot's event wait and copy-out {fetched['ns'] / max(fetched['calls'], 1) / 1e3:.1f} "
         f"({fetched['calls']} fetches); engine-lock waits by thread (s) "
         f"{json.dumps(lock_wait_s)}")
    tlog(f"  combiner stats {json.dumps(st)}; slot refills that waited {m3['slot_waits']}; "
         f"windows that waited on the inject staging {inject_waits}")
    tlog(f"  decide launches by format, form, K and W (depth {PIPE_DEPTH} run): "
         f"{json.dumps(shapes_line(shapes3))}")
    tlog(f"  scan launches by path (depth {PIPE_DEPTH} run): {json.dumps(paths3)} "
         f"{json.dumps(path_shapes3)}")
    tlog(f"  group checks (distinct keys, launch behind a busy card, each still pending "
         f"when launch_windows returned; equal to the CPU twin): {json.dumps(group_paths)} "
         f"{json.dumps(group_path_shapes)}")

    # 4. columnar: COL_WINDOWS windows as wire columns, depth 3 and 1 on the card
    # against lock-step submit_columnar / complete_columnar on the CPU
    reqs = flat[:COL_WINDOWS * WINDOW]
    col_now = NOW + 10_000
    twin = Engine(device="cpu", capacity=CAPACITY, min_width=64, max_width=WINDOW)
    want_cols, twin_s = columnar_loop(twin, reqs, col_now, 0)
    tk, tr = rows_by_key(twin)
    col = {PIPE_DEPTH: [], 1: []}
    for depth in (PIPE_DEPTH, 1, 1, PIPE_DEPTH):
        eng = Engine(device=dev, capacity=CAPACITY, min_width=64, max_width=WINDOW)
        eng.warmup()
        dk.reset_launch_counts()
        rowk.reset_launch_counts()
        got_cols, secs = columnar_loop(eng, reqs, col_now, depth)
        add(dk.launch_counts)
        add(rowk.launch_counts)
        for g, w_ in zip(got_cols, want_cols):
            check(np.array_equal(g, w_), f"columnar depth {depth}: card and CPU twin "
                  "answer differently")
        ek, er = rows_by_key(eng)
        check(ek == tk and torch.equal(er, tr), f"columnar depth {depth}: tables differ")
        col[depth].append(len(reqs) / secs)
        del eng
        torch.cuda.empty_cache()
    out.update(columnar_requests=len(reqs),
               columnar_decisions_per_s_depth3=float(np.mean(col[PIPE_DEPTH])),
               columnar_decisions_per_s_depth1=float(np.mean(col[1])),
               columnar_decisions_per_s_runs=col,
               columnar_cpu_twin_decisions_per_s=len(reqs) / twin_s, launches=launches)
    tlog(f"  columnar ({len(reqs)} requests), runs in turns ({PIPE_DEPTH}, 1, 1, "
         f"{PIPE_DEPTH}), staging allocated before the clock: equal answers and rows; depth "
         f"{PIPE_DEPTH} " + ", ".join(f"{r:,.0f}" for r in col[PIPE_DEPTH])
         + " decisions/s, depth 1 " + ", ".join(f"{r:,.0f}" for r in col[1])
         + f" decisions/s (CPU twin lock-step {len(reqs) / twin_s:,.0f}/s); phase 6 "
         f"launches {launches}")
    del cpu, twin
    return launches


# ----------------------------------------------------------------- phase 7

SNAP_KEYS = 10_000_000  # buckets in phase 7a's snapshot file
SNAP_NOW = 4_000_000_000_000  # tests/test_snapshot_scale.py's far-future epoch
SNAP_EXPIRED_EVERY = 16  # every 16th bucket of the file expired long ago
SNAP_FILE_ROWS = 1 << 18  # rows per chunk of the stimulus file
STORE_WINDOWS = 8  # phase 3's windows the Store path takes: 65,536 requests
STORE_HELD = 100_000  # the hottest keys, whose buckets the Stores hold at the start
HOST_READ_KEYS = 1000  # keys of phase 7c's host-state reads
LINK_BYTES = 1 << 30  # each page-locked copy the link's rates are read from


class Timed:
    """Host seconds spent in wrapped callables and iterators, by name."""

    def __init__(self):
        self.s, self.n, self.each = {}, {}, {}

    def _add(self, name, d, keep):
        self.s[name] = self.s.get(name, 0.0) + d
        self.n[name] = self.n.get(name, 0) + 1
        if keep:
            self.each.setdefault(name, []).append(d)

    def wrap(self, name, fn, keep=False):
        def timed(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self._add(name, time.perf_counter() - t, keep)

        return timed

    def iterate(self, name, items):
        """`items`, with the time each next() takes added to `name`."""
        it = iter(items)
        while True:
            t = time.perf_counter()
            try:
                x = next(it)
            except StopIteration:
                self._add(name, time.perf_counter() - t, False)
                return
            self._add(name, time.perf_counter() - t, False)
            yield x


def link_rates(dev):
    """The page-locked host <-> card copy rates in bytes/s, each the best of
    three copies of LINK_BYTES timed with CUDA events."""
    host = torch.empty(LINK_BYTES, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(LINK_BYTES, dtype=torch.uint8, device=dev)
    rates = {}
    for name, dst, src in (("h2d", card, host), ("d2h", host, card)):
        best = None
        for _ in range(3):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            dst.copy_(src, non_blocking=True)
            e1.record()
            e1.synchronize()
            ms = e0.elapsed_time(e1)
            best = ms if best is None else min(best, ms)
        rates[name] = LINK_BYTES / (best / 1e3)
    del host, card
    torch.cuda.empty_cache()
    tlog(f"  link, page-locked, {LINK_BYTES:,} bytes a copy (best of 3, CUDA events): "
         f"host to card {rates['h2d'] / 1e9:.3f} GB/s, card to host "
         f"{rates['d2h'] / 1e9:.3f} GB/s")
    return rates


def synthetic_slabs(seed, n, chunk):
    """n buckets in tests/test_snapshot_scale.py _synthetic's shape, made in
    numpy from `seed`: keys ss_<i>, token or leaky, limit 1000, remaining
    and status drawn, duration one hour, stamp SNAP_NOW - 1000, expiry
    SNAP_NOW but every SNAP_EXPIRED_EVERY-th long ago; as (key_blob,
    offsets, rows) chunks of `chunk` rows, the binary Loader's shape."""
    rng = np.random.default_rng(seed + 7)
    for a in range(0, n, chunk):
        i = np.arange(a, min(a + chunk, n), dtype=np.int64)
        m = len(i)
        blob = "".join(map("ss_{}".format, range(a, a + m))).encode()
        lens = np.full(m, 4, np.int64)  # "ss_" and the first digit
        for p in range(1, 10):
            lens += i >= 10 ** p
        off = np.zeros(m + 1, np.int64)
        np.cumsum(lens, out=off[1:])
        rows = np.empty((m, 7), np.int64)
        rows[:, 0] = rng.integers(0, 2, m)
        rows[:, 1] = 1000
        rows[:, 2] = rng.integers(4, 1001, m)
        rows[:, 3] = 3_600_000
        rows[:, 4] = SNAP_NOW - 1000
        rows[:, 5] = np.where(i % SNAP_EXPIRED_EVERY == 0, 1000, SNAP_NOW)
        rows[:, 6] = rng.random(m) < 1 / 997
        yield blob, off, rows


def check_row_launches(what, want_injects):
    """The row kernels a persistence run launched: every inject through the
    pinned entry point (the engine's inject staging), `want_injects` of
    them when given, and no gather."""
    launches, pinned = dict(rowk.launch_counts), dict(rowk.pinned_counts)
    check(launches["inject_rows"] > 0 and pinned["inject_rows"] == launches["inject_rows"],
          f"{what}: {launches['inject_rows']} inject launches, {pinned['inject_rows']} "
          "through the pinned entry point")
    if want_injects is not None:
        check(launches["inject_rows"] == want_injects,
              f"{what}: {launches['inject_rows']} inject launches for {want_injects} chunks")
    check(launches["gather_rows"] == 0, f"{what} gathered rows")
    return launches


def persistence_at_scale(seed, dev, rates, tmp, results):
    """Phase 7a: restore SNAP_KEYS buckets from a binary snapshot file on
    the card and on the CPU (equal tables), snapshot the card engine into a
    second file (equal, slab for slab, to the CPU twin's stream), restore
    that file into a fresh card engine (equal rows at every live key).
    Returns the inject launches of the two card restores."""
    first, second = os.path.join(tmp, "stimulus.snap"), os.path.join(tmp, "card.snap")
    t = time.perf_counter()
    BinarySnapshotLoader(first).save_slabs(synthetic_slabs(seed, SNAP_KEYS, SNAP_FILE_ROWS))
    gen_s = time.perf_counter() - t
    size = os.path.getsize(first)
    n_live = SNAP_KEYS - (SNAP_KEYS + SNAP_EXPIRED_EVERY - 1) // SNAP_EXPIRED_EVERY
    tlog(f"  stimulus: {SNAP_KEYS:,} buckets ({SNAP_KEYS - n_live:,} expired) in a "
        f"{size:,}-byte file, made and written in {gen_s:.2f} s")

    # restore on the card
    gpu = Engine(device=dev, capacity=CAPACITY, min_width=64, max_width=WINDOW)
    tr = Timed()
    gpu.directory.lookup_raw = tr.wrap("lookup_raw", gpu.directory.lookup_raw)
    gpu._apply_inject_rows = tr.wrap("inject", gpu._apply_inject_rows)
    chunks = sum(-(-min(SNAP_FILE_ROWS, SNAP_KEYS - a) // WINDOW)
                 for a in range(0, SNAP_KEYS, SNAP_FILE_ROWS))
    torch.cuda.synchronize()
    rowk.reset_launch_counts()
    t = time.perf_counter()
    n = gpu.load_snapshot_slabs(tr.iterate("file_read", BinarySnapshotLoader(first).load_slabs()))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    launches = check_row_launches("the card restore", chunks)
    check(n == SNAP_KEYS and gpu.key_count() == SNAP_KEYS,
          f"the card restore took {n} rows, {gpu.key_count()} keys")
    rest_s = restore_s - tr.s["lookup_raw"] - tr.s["inject"] - tr.s["file_read"]
    tlog(f"  restore on the card (load_snapshot_slabs): {restore_s:.3f} s, "
         f"{SNAP_KEYS / restore_s:,.0f} rows/s; {chunks} chunks of <= {WINDOW} rows, "
         f"{launches['inject_rows']} inject launches, all pinned")
    tlog(f"  restore split: file read {tr.s['file_read']:.3f} s, lookup_raw "
         f"{tr.s['lookup_raw']:.3f} s ({tr.s['lookup_raw'] / chunks * 1e6:.1f} us a chunk), "
         f"inject {tr.s['inject']:.3f} s ({tr.s['inject'] / chunks * 1e6:.1f} us a chunk on "
         f"the host clock), the rest (slicing, staging fill, lock) {rest_s:.3f} s")

    # the CPU twin
    cpu = Engine(device="cpu", capacity=CAPACITY, min_width=64, max_width=WINDOW)
    t = time.perf_counter()
    cpu.load_snapshot_slabs(BinarySnapshotLoader(first).load_slabs())
    twin_restore_s = time.perf_counter() - t
    check(torch.equal(gpu.state.cpu(), cpu.state), "the restored tables differ")
    tlog(f"  the card's table equals the CPU twin's ({twin_restore_s:.3f} s to restore on the CPU)")

    # snapshot on the card, streamed into the second file
    ts = Timed()
    gpu._read_slab = ts.wrap("slab", gpu._read_slab, keep=True)
    gpu.directory.items_raw = ts.wrap("items_raw", gpu.directory.items_raw)
    gpu.directory.peek_slots_raw = ts.wrap("peek_slots_raw", gpu.directory.peek_slots_raw)
    t = time.perf_counter()
    BinarySnapshotLoader(second).save_slabs(ts.iterate("stream", gpu.snapshot_slabs()))
    snap_s = time.perf_counter() - t
    split = dict(ts.s)  # the checks below peek through the same wrapper
    write_s = snap_s - split["stream"]
    filter_s = split["stream"] - split["slab"] - split["items_raw"] - split["peek_slots_raw"]
    S = len(gpu._slab.rows_np)
    check(gpu._slab.reads == ts.n["slab"] > 0,
          f"{ts.n['slab']} slab reads, {gpu._slab.reads} through the page-locked slab")
    slab_ms = [d * 1e3 for d in ts.each["slab"]]
    steady = slab_ms[1:] or slab_ms
    slab_bound = 8 * rowk.ROW_FIELDS * S / rates["d2h"] * 1e3
    # the copy alone on the device timeline: 20 slabs back to back
    slab_dev_ms = event_ms(lambda i: gpu._slab.rows.copy_(
        gpu.state.narrow(0, i * S % (CAPACITY - S), S), non_blocking=True), 20)
    size2 = os.path.getsize(second)
    tlog(f"  snapshot on the card (snapshot_slabs into save_slabs): {snap_s:.3f} s, "
         f"{n_live / snap_s:,.0f} rows/s, a {size2:,}-byte file")
    tlog(f"  snapshot split: items_raw {split['items_raw']:.3f} s; {ts.n['slab']} slab copies of "
         f"{S:,} rows, {split['slab']:.3f} s ({np.mean(steady):.4f} ms a slab after the "
         f"first on the host clock, copy and wait, {slab_ms[0]:.4f} ms the first with its "
         f"allocation; the copy alone {slab_dev_ms:.4f} ms on the device timeline, 20 back "
         f"to back; bound {slab_bound:.4f} ms at the measured card-to-host rate); "
         f"peek_slots_raw "
         f"{split['peek_slots_raw']:.3f} s; argsort, numpy filter and key gather "
         f"{filter_s:.3f} s; file write {write_s:.3f} s")

    # the CPU twin's stream equals the card's, as save_slabs wrote it
    n_slabs = n_rows = 0
    for twin, card in itertools.zip_longest(cpu.snapshot_slabs(),
                                            BinarySnapshotLoader(second).load_slabs()):
        check(twin is not None and card is not None,
              f"the card's and the twin's snapshots differ in length at slab {n_slabs}")
        check(bytes(twin[0]) == bytes(card[0]) and np.array_equal(twin[1], card[1])
              and np.array_equal(twin[2], card[2]), f"snapshot slab {n_slabs} differs")
        n_slabs += 1
        n_rows += len(card[1]) - 1
    check(n_rows == n_live, f"the snapshot holds {n_rows} rows, {n_live} live")
    log(f"  the CPU twin's slab stream equals the card's: {n_slabs} slabs, {n_rows:,} rows")
    del cpu

    # re-restore the card's file into a fresh card engine
    rowk.reset_launch_counts()
    t = time.perf_counter()
    gpu2 = Engine(device=dev, capacity=CAPACITY, min_width=64, max_width=WINDOW,
                  loader=BinarySnapshotLoader(second))
    torch.cuda.synchronize()
    rerestore_s = time.perf_counter() - t
    again = check_row_launches("the re-restore", None)
    blob, off, slots2 = gpu2.directory.items_raw()
    slots1 = gpu.directory.peek_slots_raw(blob, off)
    check(len(slots2) == n_live and bool((slots1 >= 0).all()),
          f"the re-restored engine holds {len(slots2)} keys, "
          f"{int((slots1 < 0).sum())} unknown to the first")
    rows1 = gpu.state[torch.from_numpy(slots1.astype(np.int64)).to(dev)]
    rows2 = gpu2.state[torch.from_numpy(slots2.astype(np.int64)).to(dev)]
    check(torch.equal(rows1, rows2), "the re-restored rows differ from the first engine's")
    tlog(f"  re-restore of the card's file (Engine(loader=...)): {rerestore_s:.3f} s with the "
         f"table's allocation, {n_live / rerestore_s:,.0f} rows/s; rows equal at all "
         f"{n_live:,} live keys; {again['inject_rows']} inject launches, all pinned")
    results["persistence"] = dict(
        keys=SNAP_KEYS, live=n_live, file_bytes=size, snapshot_bytes=size2,
        stimulus_s=gen_s, restore_s=restore_s, restore_rows_per_s=SNAP_KEYS / restore_s,
        restore_split_s=dict(tr.s), restore_chunks=chunks, twin_restore_s=twin_restore_s,
        snapshot_s=snap_s, snapshot_rows_per_s=n_live / snap_s,
        snapshot_split_s=dict(split, filter=filter_s, write=write_s),
        slab_rows=S, slab_reads=ts.n["slab"], slab_ms=slab_ms,
        slab_steady_ms=float(np.mean(steady)), slab_device_ms=slab_dev_ms,
        slab_bound_ms=slab_bound,
        rerestore_s=rerestore_s, link_bytes_per_s=rates,
        inject_launches=launches["inject_rows"] + again["inject_rows"])
    del gpu, gpu2, rows1, rows2
    gc.collect()
    torch.cuda.empty_cache()
    return launches["inject_rows"] + again["inject_rows"]


def held_buckets(seed, key_cfg):
    """The buckets a Store holds for the STORE_HELD hottest keys of phase 3's
    stream (Zipf rank k is key k) before 7b: drawn from `seed`, on each
    key's own configuration, one in 50 on the other algorithm, some
    expired."""
    algo, limit, dur = key_cfg
    rng = np.random.default_rng(seed + 9)
    k = np.arange(STORE_HELD)
    flip = rng.random(STORE_HELD) < 0.02
    remaining = rng.integers(0, limit[k] + 1)
    stamp = SNAP_NOW - rng.integers(0, 2 * dur[k])
    return [BucketSnapshot(key=f"api_k{i}", algo=int(algo[i] ^ f), limit=int(limit[i]),
                           remaining=int(r), duration=int(dur[i]), stamp=int(st),
                           expire_at=int(st + dur[i]), status=int(r == 0))
            for i, f, r, st in zip(k.tolist(), flip.tolist(), remaining.tolist(),
                                   stamp.tolist())]


def store_path(seed, dev, results):
    """Phase 7b: phase 3's first STORE_WINDOWS windows through a card engine
    with a MockStore and a CPU twin with its own, both holding the same
    buckets at the start; the clock is SNAP_NOW + 50 ms a window, so the
    rows are live for 7c's reads. Returns the engines and the launches."""
    batches, key_cfg = request_stream(seed, STORE_WINDOWS)
    held = held_buckets(seed, key_cfg)
    stores = (MockStore(), MockStore())
    for st in stores:
        st.data.update((b.key, dataclasses.replace(b)) for b in held)
    gpu = Engine(device=dev, capacity=CAPACITY, store=stores[0], min_width=64,
                 max_width=WINDOW)
    cpu = Engine(device="cpu", capacity=CAPACITY, store=stores[1], min_width=64,
                 max_width=WINDOW)
    dk.reset_launch_counts()
    rowk.reset_launch_counts()
    gpu_s = cpu_s = 0.0
    for i, (_keys, batch) in enumerate(batches):
        now = SNAP_NOW + i * 50
        t = time.perf_counter()
        got = gpu.get_rate_limits(batch, now_ms=now)
        gpu_s += time.perf_counter() - t
        t = time.perf_counter()
        want = cpu.get_rate_limits(batch, now_ms=now)
        cpu_s += time.perf_counter() - t
        check(resp_tuples(got) == resp_tuples(want),
              f"Store window {i}: card and CPU engines answer differently")
    launches = {**dk.launch_counts, **rowk.launch_counts}
    pinned = dict(rowk.pinned_counts)
    check(launches["inject_rows"] > 0 and pinned["inject_rows"] == launches["inject_rows"],
          f"the Store path's injects: {launches['inject_rows']}, pinned {pinned['inject_rows']}")
    check(launches["gather_rows"] > 0, "the Store path gathered no rows")
    check(sum(dk.launch_counts.values()) > 0, "the Store path launched no decide")
    check({k: dataclasses.astuple(v) for k, v in stores[0].data.items()}
          == {k: dataclasses.astuple(v) for k, v in stores[1].data.items()},
          "the Stores' contents differ")
    check(stores[0].called == stores[1].called,
          f"Store calls differ: card {stores[0].called}, CPU {stores[1].called}")
    keys_g, rows_g = rows_by_key(gpu)
    keys_c, rows_c = rows_by_key(cpu)
    check(keys_g == keys_c and torch.equal(rows_g, rows_c), "the Store path's rows differ")
    n_req = sum(len(b) for _, b in batches)
    stage_s = {s: ns / 1e9 for s, ns in gpu.stats.stage_ns.items()}
    tlog(f"  Store path: {n_req:,} requests in {gpu_s:.3f} s, {n_req / gpu_s:,.0f} "
         f"decisions/s (CPU twin {n_req / cpu_s:,.0f}/s); answers, Store contents, "
         f"Store calls {stores[0].called} and rows at all {len(keys_g):,} keys equal")
    tlog(f"  Store path stage seconds: " + ", ".join(f"{s} {v:.3f}" for s, v in stage_s.items())
         + f"; launches {launches} (injects all pinned, gathers on the card)")
    results["store_path"] = dict(requests=n_req, decisions_per_s=n_req / gpu_s,
                                 cpu_decisions_per_s=n_req / cpu_s, stage_s=stage_s,
                                 store_calls=dict(stores[0].called), keys=len(keys_g),
                                 launches=dict(launches))
    return gpu, cpu, launches


def host_reads(gpu, cpu, results):
    """Phase 7c: rows_for_keys, device_hit_counts and resolve_slots at
    HOST_READ_KEYS keys (a few of them absent) on 7b's engines."""
    keys = [k for k, _ in sorted(gpu.directory.items())[:HOST_READ_KEYS - 10]]
    keys += [f"api_absent{i}" for i in range(10)]
    out = {}
    t = time.perf_counter()
    found, rows = gpu.rows_for_keys(keys)
    out["rows_for_keys_ms"] = (time.perf_counter() - t) * 1e3
    want_found, want_rows = cpu.rows_for_keys(keys)
    check(found == want_found and len(found) > 0 and np.array_equal(rows, want_rows),
          f"rows_for_keys differs ({len(found)} found on the card, {len(want_found)} on the CPU)")
    t = time.perf_counter()
    hits = gpu.device_hit_counts(keys)
    out["device_hit_counts_ms"] = (time.perf_counter() - t) * 1e3
    check(hits == cpu.device_hit_counts(keys) and len(hits) == HOST_READ_KEYS - 10,
          "device_hit_counts differs")
    slots = [gpu.directory.peek_slot(k) for k in keys]
    t = time.perf_counter()
    names = gpu.resolve_slots(slots)
    out["resolve_slots_ms"] = (time.perf_counter() - t) * 1e3
    check(names == cpu.resolve_slots(slots) and len(names) == HOST_READ_KEYS - 10,
          "resolve_slots differs")
    tlog(f"  host-state reads at {HOST_READ_KEYS} keys equal the twin's ({len(found)} live "
         f"rows): rows_for_keys {out['rows_for_keys_ms']:.3f} ms, device_hit_counts "
         f"{out['device_hit_counts_ms']:.3f} ms, resolve_slots {out['resolve_slots_ms']:.3f} ms")
    results["host_reads"] = out


def phase_persistence(seed, dev, results):
    log(f"== phase 7: persistence at {SNAP_KEYS:,} keys on Engine(capacity={CAPACITY}): "
        "binary restore, streamed snapshot and re-restore against a CPU twin; the Store "
        f"path on {STORE_WINDOWS} windows of phase 3's stream; the host-state reads")
    t0 = time.perf_counter()
    rates = link_rates(dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_snap_")
    try:
        restore_injects = persistence_at_scale(seed, dev, rates, tmp, results)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gpu, cpu, launches = store_path(seed, dev, results)
    host_reads(gpu, cpu, results)
    del gpu, cpu
    gc.collect()
    torch.cuda.empty_cache()
    launches["inject_rows"] += restore_injects
    tlog(f"  phase 7 in {time.perf_counter() - t0:.1f} s")
    return launches

# ----------------------------------------------------------------- phase 8

PROBE_W = (64, 1024, WINDOW)  # 8a's probe widths: the engine's buckets
PROBE_SMALL_C = (5, 16)  # wrapped and repeated candidates
SOLID = 4096  # 8a's region filled solid, its first half stamped this batch
DEVDIR_WINDOWS = PIPE_WINDOWS  # 8b: phase 3's first 24 windows, 196,608 requests
PRESSURE_WIDTH = 256  # 8c's windows
# 8c's (positions, windows): the 65,536 the device directory was sized at,
# about a third full on this stream, and 8,192, full, where claims evict
PRESSURE_RUNS = ((65_536, 320), (8_192, 80))
INTERNED_WINDOWS = 8  # 8d: phase 3's first 8 windows as wire columns
CONTENTION = "device directory contention: probe window exhausted after retries"


def devdir_columns(seed, C, now, dev):
    """fps and touch i64[C] made on the card from `seed`: about half the
    positions occupied, each by a key whose probe window holds it (so a
    probe of that key matches), stamps below `now`, and a region of SOLID positions
    (fewer when C is smaller) every one occupied, its first half stamped
    `now`. Returns fps, touch and the region's positions (host)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    def keys_at(pos):
        # a key whose probe starts 0-3 positions before `pos`, as a probe
        # would have placed it
        back = torch.randint(0, 4, pos.shape, generator=g, device=dev)
        span = torch.randint(1, 1 << 38, pos.shape, generator=g, device=dev)
        return (pos - back) % C + C * span

    occ = torch.rand(C, generator=g, device=dev) < 0.5
    fps = keys_at(torch.arange(C, device=dev)) * occ
    touch = torch.randint(0, now, (C,), generator=g, device=dev)
    n = min(C, SOLID)
    lo = int(torch.randint(0, C, (1,), generator=g, device=dev))
    solid = (lo + torch.arange(n, device=dev)) % C
    fps[solid] = keys_at(solid)
    touch[solid[: n // 2]] = now
    return fps, touch, solid.cpu().numpy()


def probe_hashes(rng, fps, solid, W):
    """i64[W] probe hashes on the card: a fifth each of matches of occupied
    positions, new keys (first empties), keys based in the solid region
    (evictions; no victim where all 16 candidates lie in its stamped half),
    distinct keys of one base (in-batch contention), and padding or new
    keys."""
    C = fps.shape[0]
    kind = rng.integers(0, 5, W)
    pos = torch.from_numpy(rng.integers(0, C, 4 * W)).to(fps.device)
    live = fps[pos].cpu().numpy()
    live = live[live != 0]
    h = rng.integers(1, 1 << 62, W)
    span = 1 << 38  # C * span stays below 2^63 at C = 10,000,001
    for k, vals in ((0, lambda n: rng.choice(live, n)),
                    (2, lambda n: rng.choice(solid, n) + C * rng.integers(1, span, n)),
                    (3, lambda n: int(rng.integers(0, C)) + C * rng.integers(1, span, n))):
        m = kind == k
        if m.any() and (k != 0 or live.size):
            h[m] = vals(int(m.sum()))
    h[(kind == 4) & (rng.random(W) < 0.5)] = 0
    return torch.from_numpy(h.astype(np.int64)).to(fps.device)


def probe_bound(fps_before, h, won, evict, staged):
    """The probe's bound for one call, as it is timed: the hashes read, the
    outputs written (slot, fresh and retry, and the staging's rows 0 and 8
    when `staged`), the 16 candidate fingerprints of each active lane and a
    fingerprint a winner; with eviction also the 16 candidate stamps of each
    lane with no match and no empty, a stamp a match and a stamp a winner
    (this call's data, not the most it could need; the kernel's own scratch
    is not counted). Bytes bind."""
    C, W = fps_before.shape[0], h.shape[0]
    cand = fps_before[ddk._candidates(C, h)]
    active = h != 0
    matched = ((cand == h[:, None]) & active[:, None]).any(1)
    victim = active & ~matched & ~(cand == 0).any(1)
    n_bytes = (W * (8 + 4 + 1 + 1 + (16 if staged else 0)) + int(active.sum()) * 128
               + int(won) * 8)
    if evict:
        n_bytes += int(victim.sum()) * 128 + int(matched.sum()) * 8 + int(won) * 8
    b_ms, b_by = bound_ms(n_bytes, int(active.sum()) * ddk.PROBE_DEPTH * 4)
    return dict(bytes=n_bytes, bound_ms=b_ms, bound_by=b_by, active=int(active.sum()),
                matched=int(matched.sum()), victim_lanes=int(victim.sum()))


def hold_probe(fk, tk, fp, tp, h, seq, evict, what, errs):
    """One probe through the kernel (with a staging) and the plain version
    on twin columns: slot, fresh, retry, both columns and the staging's
    rows 0 and 8 bit-equal, or the run fails. Returns the winners."""
    name = "probe_assign_evict" if evict else "probe_assign"
    W = h.shape[0]
    if evict:
        pk = torch.zeros((9, W), dtype=torch.int64, device=h.device)
        got = ddk.probe_cuda(fk, tk, h, seq, pk)
        want = ddk.probe_assign_evict_plain(fp, tp, h, seq)
        check(torch.equal(pk[0], want[0].long()) and torch.equal(pk[8], want[1].long()),
              f"{what}: the staging's slot and fresh rows differ")
    else:
        got = ddk.probe_cuda(fk, None, h, seq)[:2]
        want = ddk.probe_assign_plain(fp, h)
    torch.cuda.synchronize()
    errs[name] = max(errs.get(name, 0), max_abs_err(fk, fp),
                     *(max_abs_err(a, b) for a, b in zip(got, want)),
                     max_abs_err(tk, tp) if evict else 0)
    for a, b, field in zip(got, want, ("slot", "fresh", "retry")):
        check(torch.equal(a, b), f"{what}: {field} differs")
    check(torch.equal(fk, fp), f"{what}: fingerprints differ")
    check(not evict or torch.equal(tk, tp), f"{what}: stamps differ")
    return int(want[1].sum())


def devdir_kernels(seed, dev, errs, results):
    """8a: the probe (with and without eviction) and the sweep against their
    plain versions, bit-equal, then timed."""
    rng = np.random.default_rng(seed + 8)
    recs = []
    seq = 1000
    for C in (CAPACITY, *PROBE_SMALL_C):
        fk, tk, solid = devdir_columns(seed, C, seq + 1, dev)
        fp, tp = fk.clone(), tk.clone()
        for W in PROBE_W if C == CAPACITY else (64, 1024):
            for evict in (True, False):
                name = "probe_assign_evict" if evict else "probe_assign"
                seq += 1
                h = probe_hashes(rng, fk, solid, W)
                before = fk.clone() if C == CAPACITY else None
                won = hold_probe(fk, tk, fp, tp, h, seq, evict,
                                 f"{name} C={C} W={W}", errs)
                if C != CAPACITY:
                    continue
                bound = probe_bound(before, h, won, evict, staged=evict)  # as run_k runs
                del before
                hs = [probe_hashes(rng, fk, solid, W) for _ in range(16)]
                pk = torch.zeros((9, W), dtype=torch.int64, device=dev)
                base = seq

                def run_k(i):
                    if evict:
                        ddk.probe_cuda(fk, tk, hs[i % 16], base + 1 + i, pk)
                    else:
                        ddk.probe_cuda(fk, None, hs[i % 16], 0)

                def run_p(i):
                    if evict:
                        ddk.probe_assign_evict_plain(fp, tp, hs[i % 16], base + 1 + i)
                    else:
                        ddk.probe_assign_plain(fp, hs[i % 16])

                call_ms = event_ms(run_k, 64)
                ms = profiled_ms(run_k, 32, "probe_", per_call=True)
                plain_ms = event_ms(run_p, 8)
                seq = base + 200
                fp.copy_(fk)  # the timing runs moved the two apart
                tp.copy_(tk)
                rec = dict(kernel=name, C=C, W=W, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                           winners=won, **bound)
                recs.append(rec)
                tlog(f"  {name:18s} C={C} W={W:5d}: bit-equal ({bound['active']} active, "
                     f"{bound['matched']} matched, {won} claims won, {bound['victim_lanes']} "
                     f"lanes with neither match nor empty); kernel {fms(ms)} ms on the device (3 "
                     f"launches), {call_ms:.4f} ms per wrapper call; plain {plain_ms:.4f} ms; "
                     f"bound {bound['bound_ms']:.6f} ms ({bound['bound_by']})")
        log(f"  probe at C={C}: every width bit-equal, with and without eviction")
        del fk, tk, fp, tp
    # the sweep, on a populated table
    table = populate_table(CAPACITY, seed, dev)
    fk, _tk, _solid = devdir_columns(seed + 1, CAPACITY, NOW, dev)
    fp = fk.clone()
    ddk.refresh_cuda(fk, table, NOW)
    ddk.refresh_vacancies_plain(fp, table, NOW)
    torch.cuda.synchronize()
    errs["refresh_vacancies"] = max_abs_err(fk, fp)
    check(torch.equal(fk, fp), "refresh_vacancies: fingerprints differ")
    cleared = int((fp == 0).sum())
    # every timed sweep writes the fingerprint of each dead row again
    dead = int(((table[:, dk.ROW_ALGO] < 0) | (NOW > table[:, dk.ROW_EXPIRE])).sum())
    ms, ms_source = kernel_ms(lambda i: ddk.refresh_cuda(fk, table, NOW), 16, "refresh_kernel")
    call_ms = event_ms(lambda i: ddk.refresh_cuda(fk, table, NOW), 32)
    plain_ms = event_ms(lambda i: ddk.refresh_vacancies_plain(fp, table, NOW), 8)
    # both 32-byte sectors of each 64-byte row are read; fps is only written
    n_bytes = CAPACITY * 64 + dead * 8
    b_ms, b_by = bound_ms(n_bytes, CAPACITY * 4)
    recs.append(dict(kernel="refresh_vacancies", C=CAPACITY, W=None, ms=ms, ms_source=ms_source,
                     call_ms=call_ms,
                     plain_ms=plain_ms, bytes=n_bytes, bound_ms=b_ms, bound_by=b_by,
                     cleared=cleared, dead_rows=dead))
    tlog(f"  refresh_vacancies C={CAPACITY}: bit-equal ({cleared} fingerprints 0 after, "
         f"{dead} rows vacant or expired); "
         f"kernel {fms(ms)} ms on the device ({ms_source}), {call_ms:.4f} ms per wrapper "
         f"call; plain {plain_ms:.4f} ms; bound {b_ms:.6f} ms ({b_by})")
    lib_ms = profiled_ms(lambda i: torch.count_nonzero(fk), 16)
    lib_call = event_ms(lambda i: torch.count_nonzero(fk), 32)
    results["key_count_library"] = dict(call="torch.count_nonzero", C=CAPACITY, ms=lib_ms,
                                        call_ms=lib_call)
    tlog(f"  key_count's torch.count_nonzero over {CAPACITY} fingerprints: {fms(lib_ms)} ms "
         f"on the device, {lib_call:.4f} ms per call")
    del table, fk, fp
    torch.cuda.empty_cache()
    return recs


def counted_dispatch(eng, tally, twin=False):
    """Wrap a DevDirEngine's dispatch: retry lanes (and, on the CPU twin,
    evictions: fresh claims of positions whose fingerprint was not 0)."""
    def dispatch(up, now_ms, _fn=eng._dispatch):
        before = eng.fps.clone() if twin else None
        out, retry = _fn(up, now_ms)
        tally["dispatches"] += 1
        tally["retry_lanes"] += int(retry.sum())
        if twin:
            fresh = up[8] != 0
            slots = torch.from_numpy(up[0][fresh])
            tally["evictions"] += int((before[slots] != 0).sum())
        return out, retry

    eng._dispatch = dispatch


def devdir_engine(seed, dev, results):
    """8b: DevDirEngine at full width on phase 3's first windows, against a
    CPU twin and the host-directory Engine on the card."""
    batches, _ = request_stream(seed, DEVDIR_WINDOWS)
    gpu = DevDirEngine(device=dev, capacity=CAPACITY, min_width=64, max_width=WINDOW)
    cpu = DevDirEngine(device="cpu", capacity=CAPACITY, min_width=64, max_width=WINDOW)
    host = Engine(device=dev, capacity=CAPACITY, min_width=64, max_width=WINDOW)
    for e in (gpu, cpu, host):
        e.warmup()
    tally = {"dispatches": 0, "retry_lanes": 0, "evictions": 0}
    counted_dispatch(gpu, tally)
    secs = {"card": 0.0, "cpu": 0.0, "host_directory": 0.0}
    contention = 0
    for i, (_keys, batch) in enumerate(batches):
        now = NOW + i * 50
        got = {}
        for name, e in (("card", gpu), ("cpu", cpu), ("host_directory", host)):
            t = time.perf_counter()
            got[name] = resp_tuples(e.get_rate_limits(batch, now_ms=now))
            secs[name] += time.perf_counter() - t
        check(got["card"] == got["cpu"], f"8b window {i}: card and CPU twin answer differently")
        for a, b in zip(got["card"], got["host_directory"]):
            if a[4] == CONTENTION:
                contention += 1
            else:
                check(a == b, f"8b window {i}: the device and host directories answer "
                              f"differently: {a} against {b}")
    check(torch.equal(gpu.fps.cpu(), cpu.fps) and torch.equal(gpu.touch.cpu(), cpu.touch),
          "8b: the directories' columns differ")
    check(torch.equal(gpu.state.cpu(), cpu.state), "8b: the tables differ")
    gs, cs = gpu.stats.as_dict(), cpu.stats.as_dict()
    for c in ("requests", "batches", "rounds", "over_limit", "errors"):
        check(gs[c] == cs[c], f"8b: EngineStats.{c} differs: card {gs[c]}, CPU {cs[c]}")
    n = sum(len(b) for _, b in batches)
    rates = {k: n / v for k, v in secs.items()}
    stage_s = {s: ns / 1e9 for s, ns in gpu.stats.stage_ns.items()}
    rec = dict(requests=n, windows=len(batches), decisions_per_s=rates, seconds=secs,
               stage_s=stage_s, rounds=gs["rounds"], exhausted=gs["errors"],
               contention_answers=contention, keys=gpu.key_count(), **tally)
    results["devdir_engine"] = rec
    tlog(f"  8b: {n:,} requests: DevDirEngine on the card {rates['card']:,.0f} decisions/s, "
         f"its CPU twin {rates['cpu']:,.0f}/s, the host-directory Engine on the card "
         f"{rates['host_directory']:,.0f}/s; responses, columns, table and stats equal to "
         f"the twin's; equal to the host directory's on every lane but the {contention} "
         f"answered with the contention error")
    tlog(f"  8b: {gs['rounds']} rounds in {tally['dispatches']} dispatches, "
         f"{tally['retry_lanes']} retry lanes, {gs['errors']} lanes exhausted; "
         f"{rec['keys']:,} fingerprints held; stage seconds "
         + ", ".join(f"{s} {v:.3f}" for s, v in stage_s.items()))
    del gpu, cpu, host
    gc.collect()
    torch.cuda.empty_cache()


def devdir_pressure(seed, dev, capacity, n_windows, results):
    """8c: a small DevDirEngine on the card against its CPU twin on windows
    of PRESSURE_WIDTH requests, evictions and sweeps included."""
    batches, _ = request_stream(seed, n_windows, PRESSURE_WIDTH)
    gpu = DevDirEngine(device=dev, capacity=capacity, min_width=64, max_width=PRESSURE_WIDTH)
    cpu = DevDirEngine(device="cpu", capacity=capacity, min_width=64, max_width=PRESSURE_WIDTH)
    gpu.warmup()
    cpu.warmup()
    tally = {"dispatches": 0, "retry_lanes": 0, "evictions": 0}
    twin_tally = dict(tally)
    counted_dispatch(gpu, tally)
    counted_dispatch(cpu, twin_tally, twin=True)
    sweeps0 = ddk.launch_counts["refresh_vacancies"]
    gpu_s = 0.0
    for i, (_keys, batch) in enumerate(batches):
        now = NOW + i * 50
        t = time.perf_counter()
        got = gpu.get_rate_limits(batch, now_ms=now)
        gpu_s += time.perf_counter() - t
        check(resp_tuples(got) == resp_tuples(cpu.get_rate_limits(batch, now_ms=now)),
              f"8c window {i}: card and CPU twin answer differently")
    check(torch.equal(gpu.fps.cpu(), cpu.fps) and torch.equal(gpu.touch.cpu(), cpu.touch),
          "8c: the directories' columns differ")
    check(torch.equal(gpu.state.cpu(), cpu.state), "8c: the tables differ")
    sweeps = ddk.launch_counts["refresh_vacancies"] - sweeps0
    rounds, exhausted = gpu.stats.rounds, gpu.stats.errors
    check(rounds == cpu.stats.rounds and exhausted == cpu.stats.errors,
          "8c: the rounds or the exhausted lanes differ")
    check(tally["retry_lanes"] == twin_tally["retry_lanes"], "8c: the retry lanes differ")
    check(sweeps > 0, "8c: no sweep ran")
    n = sum(len(b) for _, b in batches)
    rec = dict(requests=n, windows=len(batches), capacity=capacity, rounds=rounds,
               evictions=twin_tally["evictions"], retry_lanes=tally["retry_lanes"],
               exhausted=exhausted, sweeps=sweeps, decisions_per_s=n / gpu_s)
    results.setdefault("devdir_pressure", []).append(rec)
    tlog(f"  8c: {n:,} requests at {capacity} positions, bit-equal to the twin: "
         f"{rounds} rounds, {rec['evictions']} evictions, {rec['retry_lanes']} retry lanes, "
         f"{exhausted} lanes exhausted, {sweeps} sweeps; {rec['decisions_per_s']:,.0f} "
         f"decisions/s on the card")
    del gpu, cpu


class InternedEngine(Engine):
    """The Engine with its one-window and scan dispatches shipping the
    interned format whenever a window is eligible (the Engine of either
    package ships lean, compact or wide; nothing there ships interned).
    8d's leftover tails run through it."""

    def _dispatch_staged(self, packed, now_ms):
        iw = dk.intern_window(packed)
        if iw is None:
            return super()._dispatch_staged(packed, now_ms)
        return dk.decide_packed_interned(self.state, self._up(iw[0]), self._up(iw[1]),
                                         now_ms), now_ms

    def _dispatch_scan_staged(self, stacked, now_ms):
        iw = dk.intern_window(stacked)
        if iw is None:
            return super()._dispatch_scan_staged(stacked, now_ms)
        return dk.decide_scan_packed_interned(self.state, self._up(iw[0]), self._up(iw[1]),
                                              now_ms), now_ms


def prepped_window(eng, reqs, now, istate, tally):
    """One window of wire columns: round 0 through the native prep (interned
    when `istate` is given, re-prepped through prep_pack_columnar on a
    config overflow; else columnar with the compact kernel), its injects
    first; the leftovers through get_rate_limits, in order. Returns the
    answers as response tuples."""
    from gubernator_tpu_torch import native
    from gubernator_tpu_torch.models.prep import bucket_width

    n = len(reqs)
    cols = columnar_cols(reqs)
    W = bucket_width(n, eng.min_width, eng.max_width)
    out_rows = None
    with eng._lock:
        if istate is not None:
            iw = np.empty((2, W), np.int32)
            n0, lane, left, inj = native.prep_pack_interned(
                eng.directory, *cols, COL_SLOW, iw, istate, inject=eng._inject_rows_out())
            check(n0 >= 0 or n0 == native.PREP_CFG_OVERFLOW,
                  f"prep_pack_interned refused a window: {n0}")
            if n0 == native.PREP_CFG_OVERFLOW:
                tally["overflows"] += 1
            else:
                eng._apply_inject_rows(inj)
                out = dk.decide_packed_interned(eng.state, eng._up(iw), eng._up(istate.cfg), now)
                out_rows = dk.widen_compact_out(out.cpu().numpy(), now)
        if out_rows is None:
            packed = np.zeros((9, W), np.int64)
            n0, lane, left, inj = native.prep_pack_columnar(
                eng.directory, *cols, COL_SLOW, packed, eng._inject_rows_out())
            check(n0 >= 0, f"prep_pack_columnar refused a window: {n0}")
            eng._apply_inject_rows(inj)
            if istate is not None:
                out_rows = eng._fetch_staged(eng._dispatch_staged(packed, now))
            else:
                c = dk.compact_window(packed)
                check(c is not None, "8d: a columnar window is not compact-eligible")
                out_rows = dk.widen_compact_out(
                    dk.decide_packed_compact(eng.state, eng._up(c), now).cpu().numpy(), now)
    answers = [None] * n
    for j, i in enumerate(lane.tolist()):
        answers[i] = (int(out_rows[0, j]), int(out_rows[1, j]), int(out_rows[2, j]),
                      int(out_rows[3, j]), "")
    tally["lanes"] += n0
    tally["leftover"] += len(left)
    if len(left):
        idx = left.tolist()
        for i, r in zip(idx, eng.get_rate_limits([reqs[i] for i in idx], now_ms=now)):
            answers[i] = resp_tuples([r])[0]
    return answers


def devdir_interned(seed, dev, results):
    """8d: phase 3's first windows as wire columns through the interned prep
    and kernel on the card, against a CPU twin and the columnar prep with
    the compact kernel on a second card table."""
    from gubernator_tpu_torch import native

    batches, _ = request_stream(seed, INTERNED_WINDOWS)
    card = InternedEngine(device=dev, capacity=CAPACITY, min_width=64, max_width=WINDOW)
    twin = InternedEngine(device="cpu", capacity=CAPACITY, min_width=64, max_width=WINDOW)
    compact = Engine(device=dev, capacity=CAPACITY, min_width=64, max_width=WINDOW)
    states = (native.InternPrepState(), native.InternPrepState())
    tallies = [{"lanes": 0, "leftover": 0, "overflows": 0} for _ in range(3)]
    secs = [0.0, 0.0, 0.0]
    for i, (_keys, batch) in enumerate(batches):
        now = NOW + i * 50
        got = []
        for k, (eng, st) in enumerate(((card, states[0]), (twin, states[1]), (compact, None))):
            t = time.perf_counter()
            got.append(prepped_window(eng, batch, now, st, tallies[k]))
            secs[k] += time.perf_counter() - t
        check(got[0] == got[1], f"8d window {i}: the card's interned path and its twin differ")
        check(got[0] == got[2], f"8d window {i}: the interned and the compact paths differ")
    check(torch.equal(card.state, compact.state), "8d: the interned and compact tables differ")
    check(torch.equal(card.state.cpu(), twin.state), "8d: the card's and the twin's tables differ")
    check(all((t["lanes"], t["leftover"]) == (tallies[2]["lanes"], tallies[2]["leftover"])
              for t in tallies), f"8d: the preps packed different lanes: {tallies}")
    n = sum(len(b) for _, b in batches)
    rec = dict(requests=n, windows=len(batches), interned_lanes=tallies[0]["lanes"],
               leftover=tallies[0]["leftover"], overflows=tallies[0]["overflows"],
               n_cfg=states[0].n_cfg, decisions_per_s=[n / s for s in secs])
    results["devdir_interned"] = rec
    tlog(f"  8d: {n:,} requests as wire columns, {rec['interned_lanes']:,} through "
         f"prep_pack_interned and decide_packed_interned ({rec['n_cfg']} configs, "
         f"{rec['overflows']} overflows), {rec['leftover']:,} leftovers through the interned "
         f"engine tail; answers and tables equal to the CPU twin's and to the columnar + "
         f"compact path's; decisions/s card {rec['decisions_per_s'][0]:,.0f}, twin "
         f"{rec['decisions_per_s'][1]:,.0f}, compact path {rec['decisions_per_s'][2]:,.0f}")
    del card, twin, compact


def phase_devdir(seed, dev, results):
    log(f"== phase 8: the device directory: probe and sweep kernels vs their plain "
        f"versions at C={CAPACITY}, then DevDirEngine(capacity={CAPACITY}) on "
        f"{DEVDIR_WINDOWS} windows, eviction pressure at "
        f"{' and '.join(str(c) for c, _ in PRESSURE_RUNS)} positions, and the interned "
        f"path on {INTERNED_WINDOWS} windows")
    t0 = time.perf_counter()
    errs = {}
    recs = devdir_kernels(seed, dev, errs, results)
    results["devdir_kernels"] = recs
    dk.reset_launch_counts()
    ddk.reset_launch_counts()
    rowk.reset_launch_counts()
    devdir_engine(seed, dev, results)
    for capacity, n_windows in PRESSURE_RUNS:
        devdir_pressure(seed, dev, capacity, n_windows, results)
    devdir_interned(seed, dev, results)
    launches = {**dk.launch_counts, **ddk.launch_counts, **rowk.launch_counts}
    for name in ("probe_assign_evict", "refresh_vacancies", "decide_interned",
                 "decide_scan_interned"):
        check(launches[name] > 0, f"phase 8 launched no {name}")
    results["devdir_launches"] = launches
    gc.collect()
    torch.cuda.empty_cache()
    tlog(f"  phase 8 launches {launches}; phase 8 in {time.perf_counter() - t0:.1f} s")
    return launches, errs, recs


# ----------------------------------------------------------------- phase 9

SHARDS, SHARD_ROWS = 8, 1_250_000  # the sharded engine's 8 x 1,250,000 = 10,000,000 rows
SHARD_GEOMS = ((1, SHARDS), (2, SHARDS // 2))  # (R, S): 9a holds the decide at both
SHARD_W = (64, 1024, WINDOW)  # 9a's one-window widths, per owner
SHARD_K = (2, 32)  # 9a's scan depths at W = 64
SHARD_M = (1, 64, 4096)  # 9a's gather and inject lanes, per owner
GLOBAL_HOT, GLOBAL_EVERY = 4096, 8  # 9b's GLOBAL keys: every 8th of the 4,096 hottest
SHARDED_WINDOWS = 24  # 9b: phase 3's first 24 windows, 196,608 requests
SHARDED_STORE_WINDOWS = STORE_WINDOWS  # 9c
SHARDED_COL_WINDOWS = 8  # 9d
SHARDED_KERNELS = ("decide_sharded_wide", "decide_sharded_scan_wide", "decide_sharded_lean",
                   "decide_sharded_scan_lean", "gather_sharded", "inject_sharded")


def kernel_ms(fn, iters, kernel_substr, per_call=False):
    """A kernel's device ms per launch: torch.profiler's, or, where its trace
    shows no device time for the kernel, CUDA events around `iters` calls
    back to back. Returns (ms, source) and logs the source it fell back to."""
    ms = profiled_ms(fn, iters, kernel_substr, per_call)
    if ms is not None:
        return ms, "torch.profiler"
    log(f"  {kernel_substr}: device ms from CUDA events instead (the profiler recorded none)")
    return event_ms(fn, iters), "cuda events"


def sharded_table(R, S, seed, dev):
    """The sharded engine's i64[R, S, 1,250,000, 8] table (make_sharded_table,
    as ShardedEngine makes it), populated from `seed` by populate_table."""
    t = make_sharded_table(MeshPlan(n_shards=S, capacity_per_shard=SHARD_ROWS,
                                    n_regions=R), dev)
    t.copy_(populate_table(R * S * SHARD_ROWS, seed, dev).view(R, S, SHARD_ROWS, 8))
    return t


def shard_edges(wide, C):
    """The edge lanes in every window of every owner of a wide staging
    [R, S, (K,) 9, W]: lane 0 reads past the owner's own table (slot C + o),
    lane 1 writes the owner's row C-1 in the same window in even owners (and
    in odd windows of a scan in odd owners), both on a live lane's request;
    the last lane is padding."""
    S = wide.shape[1]
    for idx in np.ndindex(*wide.shape[:-2]):
        w = wide[idx]
        o, k = idx[0] * S + idx[1], idx[2] if len(idx) > 2 else 0
        src = w[1:, np.flatnonzero(w[0] >= 0)[-1]].copy()
        w[:, 0] = [C + o, *src]
        if o % 2 == 0 or k % 2 == 1:
            w[:, 1] = [C - 1, *src]
        w[0, -1] = -1
        w[1:, -1] = 0
    return wide


def shard_stimulus(rng, kern, fmt, W, K=0):
    """A wide staging [R, S, (K,) 9, W] of phase 2's stimulus for each owner
    (its rows, the slots below C-1; a scan's windows overlap on a pool of
    256 rows) with shard_edges' lanes."""
    R, S, C = kern.shape[:3]
    per = []
    for r in range(R):
        for s in range(S):
            if K:
                pool = rng.choice(C - 1, 256, replace=False)
                per.append(np.stack([stimulus(rng, kern[r, s], W, fmt, slots=pool)
                                     for _ in range(K)]))
            else:
                per.append(stimulus(rng, kern[r, s], W, fmt, slots=C - 1))
    wide = np.stack(per).reshape(R, S, *per[0].shape)
    if fmt == "lean":
        # rows that wide windows wrote carry calendar durations; a lean
        # window keeps to the configurations lean_window can intern
        d = wide[..., 3, :]
        wide[..., 3, :] = np.where(np.isin(d, (1000, 60_000, 3_600_000)), d, 60_000)
    return shard_edges(wide, C)


def blank_windows(wide, K):
    """Windows with no live lane, which the plain version answers without a
    call: owner 3's window (a scan: its window 1) all padding, and in a
    scan every window of owner 5."""
    S = wide.shape[1]
    blank = [divmod(3, S) + ((1,) if K else ())] + ([divmod(5, S)] if K else [])
    for idx in blank:
        wide[idx + (Ellipsis, 0, slice(None))] = -1
        wide[idx + (Ellipsis, slice(1, None), slice(None))] = 0
    return wide


def lean_signed(lanes, cfg):
    """A lean staging with every config id moved up by 64 (mod 128), so that
    ids from 64 set the lane word's sign bit; the config table rolled to
    match. Padding words stay."""
    u = lanes.view(np.uint32)
    pad = (u & dk._LEAN_SLOT_MASK) == dk._LEAN_PAD
    ids = ((u >> dk._LEAN_CFG_SHIFT) + 64) % dk.LEAN_MAX_CFG
    moved = (u & ((1 << dk._LEAN_CFG_SHIFT) - 1)) | (ids << dk._LEAN_CFG_SHIFT)
    return np.where(pad, u, moved).astype(np.uint32).view(np.int32), np.roll(cfg, 64, axis=0)


def shard_staged(fmt, wide, C, dev, signed=False):
    if fmt == "wide":
        return torch.from_numpy(wide).to(dev), None
    ln = dk.lean_window(wide, C)
    check(ln is not None, "sharded lean stimulus not eligible")
    lanes, cfg = lean_signed(*ln) if signed else ln
    return torch.from_numpy(lanes).to(dev), torch.from_numpy(cfg).to(dev)


def hold_sharded(f, kern, plain, packed, cfg, scan, what, errs):
    """One sharded decide through the kernel and the plain version: equal
    responses and whole tables, or the run fails."""
    out_k = dk.decide_sharded_cuda(f, kern, packed, cfg, NOW, scan)
    out_p = dk.decide_sharded_plain(f, plain, packed, cfg, NOW, scan)
    torch.cuda.synchronize()
    name = dk._SHARDED_COUNT_NAMES[f, scan]
    errs[name] = max(errs.get(name, 0), max_abs_err(out_k, out_p), max_abs_err(kern, plain))
    check(torch.equal(out_k, out_p), f"{what}: responses differ")
    check(torch.equal(kern, plain), f"{what}: tables differ")


def shard_rows_touched(wide, C):
    R, S = wide.shape[:2]
    return sum(touched_rows(wide[r, s], C) for r in range(R) for s in range(S))


def sharded_decide(seed, dev, errs, results):
    """9a, the sharded decide: every shape at R = 1, S = 8 held and timed (the
    kernel, its plain version, the R*S launches of the single-table kernel
    on the owners' views); the edge cases at R = 2, S = 4 too."""
    rng = np.random.default_rng(seed + 10)
    recs = []
    for R, S in SHARD_GEOMS:
        kern = sharded_table(R, S, seed + 11, dev)
        plain = kern.clone()
        C, n = SHARD_ROWS, R * S
        timed = (R, S) == SHARD_GEOMS[0]
        for fmt in ("wide", "lean"):
            f = FORMATS[fmt]
            for W, K in [(w, 0) for w in SHARD_W] + [(64, k) for k in SHARD_K]:
                scan = K > 0
                wide = shard_stimulus(rng, kern, fmt, W, K)
                packed, cfg = shard_staged(fmt, wide, C, dev, signed=(W == 1024 or K == 2))
                what = f"sharded {fmt} R={R} S={S} W={W} K={K}"
                hold_sharded(f, kern, plain, packed, cfg, scan, what, errs)
                if W == 64:
                    blank = blank_windows(shard_stimulus(rng, kern, fmt, W, K), K)
                    hold_sharded(f, kern, plain, *shard_staged(fmt, blank, C, dev), scan,
                                 what + " with padded owner windows", errs)
                if not timed:
                    continue
                stims = [shard_staged(fmt, shard_stimulus(rng, kern, fmt, W, K), C, dev)
                         for _ in range(16)]
                views = [(pk.view(n, *pk.shape[2:]), cf) for pk, cf in stims]
                tables = kern.view(n, C, 8)

                def run_k(i):
                    pk, cf = stims[i % 16]
                    dk.decide_sharded_cuda(f, kern, pk, cf, NOW, scan)

                def run_p(i):
                    pk, cf = stims[i % 16]
                    dk.decide_sharded_plain(f, plain, pk, cf, NOW, scan)

                def run_loop(i):
                    pk, cf = views[i % 16]
                    for o in range(n):
                        dk.decide_cuda(f, tables[o], pk[o], cf, NOW, scan)

                call_ms = event_ms(run_k, 64)
                ms, src = kernel_ms(run_k, 32, "decide_kernel")
                plain_ms = event_ms(run_p, 2 if K == 32 else 8)  # K = 32: ~1 s a call
                loop_call_ms = event_ms(run_loop, 32)
                loop_ms = profiled_ms(run_loop, 16, "decide_kernel", per_call=True)
                plain.copy_(kern)  # the timing runs moved the two tables apart
                rec = dict(kernel=dk._SHARDED_COUNT_NAMES[f, scan], fmt=fmt, R=R, S=S, C=C,
                           width=W, scan_k=K, ms=ms, ms_source=src, call_ms=call_ms,
                           plain_ms=plain_ms, loop_ms=loop_ms, loop_call_ms=loop_call_ms,
                           **decide_bound(fmt, wide, shard_rows_touched(wide, C)))
                recs.append(rec)
                tlog(f"  {what}: bit-equal; kernel {fms(ms)} ms on the device ({src}), "
                     f"{call_ms:.4f} ms per wrapper call; {n} single-table launches "
                     f"{fms(loop_ms)} ms on the device, {loop_call_ms:.4f} ms per {n} calls; "
                     f"plain {plain_ms:.4f} ms; bound {rec['bound_ms']:.6f} ms "
                     f"({rec['bound_by']})")
        if not timed:
            log(f"  sharded decide at R={R} S={S}: every shape bit-equal")
        del kern, plain
        torch.cuda.empty_cache()
    return recs


def sharded_rows_stimulus(rng, R, S, C, m, dev):
    """Per owner m distinct slots below C-1 (padding -1 and past-table lanes
    C, C + 3 among them; the owner's row C-1 written by lane 3 in even
    owners), and i64[R, S, 7, m] rows with values past int32 in every field."""
    slot = np.stack([rng.choice(C - 1, m, replace=False) for _ in range(R * S)])
    slot = slot.reshape(R, S, m).astype(np.int32)
    if m >= 4:
        slot[..., :3] = (-1, C, C + 3)
        slot[:, ::2, 3] = C - 1
    rows = rng.integers(-(1 << 40), 1 << 40, (R, S, 7, m), dtype=np.int64)
    return torch.from_numpy(slot).to(dev), torch.from_numpy(rows).to(dev)


def sharded_rows(seed, dev, errs, results):
    """9a, the sharded gather and inject at m lanes an owner: held against
    their plain versions (the gather also on clamped lanes), then timed
    beside the library call: one indexing of the flattened table with each
    owner's base offset for the gather, index_copy_ for the inject."""
    rng = np.random.default_rng(seed + 12)
    R, S = SHARD_GEOMS[0]
    C, n = SHARD_ROWS, R * S
    kern = sharded_table(R, S, seed + 13, dev)
    plain = kern.clone()
    flat = kern.view(n * C, 8)
    base = (torch.arange(n, device=dev, dtype=torch.int64) * C).view(R, S, 1)
    recs = []
    for m in SHARD_M:
        slot, rows = sharded_rows_stimulus(rng, R, S, C, m, dev)
        got, want = rowk.gather_sharded_cuda(kern, slot), rowk.gather_sharded_plain(plain, slot)
        torch.cuda.synchronize()
        errs["gather_sharded"] = max(errs.get("gather_sharded", 0), max_abs_err(got, want))
        check(torch.equal(got, want), f"gather_sharded m={m}: rows differ")
        rowk.inject_sharded_cuda(kern, slot, rows)
        rowk.inject_sharded_plain(plain, slot, rows)
        torch.cuda.synchronize()
        errs["inject_sharded"] = max(errs.get("inject_sharded", 0), max_abs_err(kern, plain))
        check(torch.equal(kern, plain), f"inject_sharded m={m}: tables differ")
        idx = (slot.to(torch.int64).clamp(0, C - 1) + base).view(-1)
        keep = ((slot >= 0) & (slot < C)).view(-1)
        idx_keep = (slot.to(torch.int64) + base).view(-1)[keep]
        rows8 = torch.cat([rows.transpose(2, 3).reshape(-1, 7),
                           rows.new_zeros((n * m, 1))], dim=1)[keep]
        for name, kname, run_k, run_p, run_lib, n_bytes in (
                ("gather_sharded", "gather_kernel",
                 lambda i: rowk.gather_sharded_cuda(kern, slot),
                 lambda i: rowk.gather_sharded_plain(plain, slot),
                 lambda i: flat[idx], n * m * (4 + 56 + 56)),
                ("inject_sharded", "inject_sharded_kernel",
                 lambda i: rowk.inject_sharded_cuda(kern, slot, rows),
                 lambda i: rowk.inject_sharded_plain(plain, slot, rows),
                 lambda i: flat.index_copy_(0, idx_keep, rows8),
                 n * m * 4 + int(keep.sum()) * (56 + 64))):
            call_ms, lib_call = in_turns(lambda f: event_ms(f, 64), run_k, run_lib)
            ms, src = kernel_ms(run_k, 32, kname)
            plain_ms = event_ms(run_p, 8)
            lib_ms = profiled_ms(run_lib, 32)
            b_ms, b_by = bound_ms(n_bytes, 0)
            rec = dict(kernel=name, R=R, S=S, C=C, m=m, ms=ms, ms_source=src, call_ms=call_ms,
                       plain_ms=plain_ms, library_ms=lib_call, library_device_ms=lib_ms,
                       bytes=n_bytes, bound_ms=b_ms, bound_by=b_by)
            recs.append(rec)
            tlog(f"  {name} R={R} S={S} m={m}: bit-equal; kernel {fms(ms)} ms on the device "
                 f"({src}), {call_ms:.4f} ms per wrapper call; plain {plain_ms:.4f} ms; library "
                 f"{'indexing' if name == 'gather_sharded' else 'index_copy_'} {lib_call:.4f} "
                 f"ms per call, {fms(lib_ms)} ms on the device; bound {b_ms:.6f} ms ({b_by})")
        torch.cuda.synchronize()
        plain.copy_(kern)
    del kern, plain, flat
    torch.cuda.empty_cache()
    return recs


def global_stream(seed, n_windows):
    """Phase 3's first windows with Behavior.GLOBAL on the keys of every
    GLOBAL_EVERY-th Zipf rank among the GLOBAL_HOT hottest (Zipf rank k is
    key k). Returns the batches, the key configs and the GLOBAL request
    count."""
    batches, key_cfg = request_stream(seed, n_windows)
    hot = np.zeros(N_KEYS, np.bool_)
    hot[:GLOBAL_HOT:GLOBAL_EVERY] = True
    n_global = 0
    for keys, batch in batches:
        for k, r in zip(keys.tolist(), batch):
            if hot[k]:
                r.behavior |= int(Behavior.GLOBAL)
                n_global += 1
    return batches, key_cfg, n_global


def sharded_state_equal(gpu, cpu, what, counters=True):
    """Tables, GLOBAL mirrors and registries, and (when `counters`) the
    counters of a card ShardedEngine and its CPU twin, or the run fails."""
    check(torch.equal(gpu.state.cpu(), cpu.state), f"{what}: tables differ")
    for f in GlobalMirror._fields:
        check(np.array_equal(getattr(gpu._mirror, f), getattr(cpu._mirror, f)),
              f"{what}: mirror.{f} differs")
    reg = lambda e: [(k, v.gidx, v.owner, v.seen, v.last_ms) for k, v in e._globals.items()]
    check(reg(gpu) == reg(cpu) and gpu._gfree == cpu._gfree and gpu._gnext == cpu._gnext
          and np.array_equal(gpu._gdelta, cpu._gdelta), f"{what}: GLOBAL registries differ")
    if counters:
        c = lambda e: {k: v for k, v in e.stats.items() if not k.endswith("_ns")}
        check(c(gpu) == c(cpu), f"{what}: counters differ: card {c(gpu)}, CPU {c(cpu)}")


def sharded_launches():
    return {**{k: dk.launch_counts[k] for k in dk.launch_counts if "sharded" in k},
            "gather_sharded": rowk.launch_counts["gather_sharded"],
            "inject_sharded": rowk.launch_counts["inject_sharded"]}


def sharded_shapes():
    return {f"{name} K={k} W={w}": c for (name, k, w), c in sorted(dk.launch_shapes.items())
            if "sharded" in name}


def sharded_engines(dev, store=None, twin_store=None):
    # imported here: ab_rows.py runs this file's phase 4 against parent trees
    from gubernator_tpu_torch.parallel.sharded import ShardedEngine

    kw = dict(n_shards=SHARDS, capacity_per_shard=SHARD_ROWS, min_width=64, max_width=WINDOW)
    return (ShardedEngine(device=dev, store=store, **kw),
            ShardedEngine(device="cpu", store=twin_store, **kw))


def sharded_engine_run(seed, dev, results):
    """9b: the card engine after warmup() and its CPU twin on phase 3's first
    24 windows with the GLOBAL keys, global_sync() after every window; all
    state equal after every window."""
    batches, _cfg, n_global = global_stream(seed, SHARDED_WINDOWS)
    gpu, cpu = sharded_engines(dev)
    t = time.perf_counter()
    gpu.warmup()
    warm_s = time.perf_counter() - t
    dk.reset_launch_counts()
    rowk.reset_launch_counts()
    gpu_s = cpu_s = sync_s = 0.0
    n_req = broadcast = 0
    for i, (_keys, batch) in enumerate(batches):
        now = NOW + i * 50
        t = time.perf_counter()
        got = gpu.get_rate_limits(batch, now_ms=now)
        gpu_s += time.perf_counter() - t
        n_req += len(batch)
        t = time.perf_counter()
        want = cpu.get_rate_limits(batch, now_ms=now)
        cpu_s += time.perf_counter() - t
        check(resp_tuples(got) == resp_tuples(want),
              f"sharded window {i}: card and CPU engines answer differently")
        t = time.perf_counter()
        b = gpu.global_sync(now_ms=now + 25)
        torch.cuda.synchronize()
        sync_s += time.perf_counter() - t
        check(b == cpu.global_sync(now_ms=now + 25), f"sharded window {i}: broadcasts differ")
        broadcast += b
        sharded_state_equal(gpu, cpu, f"sharded window {i}")
    launches, shapes = sharded_launches(), sharded_shapes()
    st = gpu.stats
    stage_s = {s: st[f"{s}_ns"] / 1e9 for s in EngineStats.STAGES}
    out = dict(requests=n_req, global_requests=n_global, warmup_s=warm_s,
               decisions_per_s=n_req / gpu_s, cpu_decisions_per_s=n_req / cpu_s,
               sync_ms=sync_s / len(batches) * 1e3, keys_broadcast=broadcast,
               mirror_answers=st["global_mirror_answers"],
               registry_fallbacks=st["global_registry_fallbacks"],
               global_evictions=st["global_evictions"], registry=gpu.global_registry_size(),
               lean_windows=st["lean_windows"], rounds=st["rounds"], stage_s=stage_s,
               launches=launches, shapes=shapes)
    results["sharded_engine"] = out
    tlog(f"  9b: {n_req:,} requests ({n_global:,} GLOBAL) in {gpu_s:.3f} s, "
         f"{n_req / gpu_s:,.0f} decisions/s (CPU twin {n_req / cpu_s:,.0f}/s), warmup "
         f"{warm_s:.1f} s; responses, tables, mirrors, registries and counters equal after "
         f"every window")
    tlog(f"  9b GLOBAL: sync {out['sync_ms']:.3f} ms a step (host clock, with the mirror's "
         f"read back), {broadcast} keys broadcast, {out['mirror_answers']:,} mirror answers, "
         f"{out['registry_fallbacks']} registry fallbacks, {out['global_evictions']} "
         f"evictions, registry {out['registry']}")
    tlog("  9b stage seconds: " + ", ".join(f"{s} {v:.3f}" for s, v in stage_s.items())
         + f"; {st['rounds']} rounds, {st['lean_windows']} lean windows")
    log(f"  9b launches {launches}; by shape {shapes}")
    del gpu, cpu
    gc.collect()
    return launches


def sharded_store_run(seed, dev, results):
    """9c: the Store path on phase 3's first 8 windows (both Stores holding the
    100,000 hottest keys' buckets), through the sharded gather and inject."""
    batches, key_cfg = request_stream(seed, SHARDED_STORE_WINDOWS)
    held = held_buckets(seed, key_cfg)
    stores = (MockStore(), MockStore())
    for st in stores:
        st.data.update((b.key, dataclasses.replace(b)) for b in held)
    gpu, cpu = sharded_engines(dev, *stores)
    dk.reset_launch_counts()
    rowk.reset_launch_counts()
    gpu_s = 0.0
    for i, (_keys, batch) in enumerate(batches):
        now = SNAP_NOW + i * 50
        t = time.perf_counter()
        got = gpu.get_rate_limits(batch, now_ms=now)
        gpu_s += time.perf_counter() - t
        want = cpu.get_rate_limits(batch, now_ms=now)
        check(resp_tuples(got) == resp_tuples(want),
              f"sharded Store window {i}: card and CPU engines answer differently")
    launches = sharded_launches()
    sharded_state_equal(gpu, cpu, "sharded Store path")
    check({k: dataclasses.astuple(v) for k, v in stores[0].data.items()}
          == {k: dataclasses.astuple(v) for k, v in stores[1].data.items()},
          "the sharded Stores' contents differ")
    check(stores[0].called == stores[1].called,
          f"sharded Store calls differ: card {stores[0].called}, CPU {stores[1].called}")
    check(launches["gather_sharded"] > 0 and launches["inject_sharded"] > 0,
          f"the sharded Store path's row launches: {launches}")
    n_req = sum(len(b) for _, b in batches)
    stage_s = {s: gpu.stats[f"{s}_ns"] / 1e9 for s in EngineStats.STAGES}
    results["sharded_store"] = dict(requests=n_req, decisions_per_s=n_req / gpu_s,
                                    stage_s=stage_s, store_calls=dict(stores[0].called),
                                    launches=launches)
    tlog(f"  9c Store path: {n_req:,} requests, {n_req / gpu_s:,.0f} decisions/s; answers, "
         f"tables, Store contents and calls {stores[0].called} equal; launches {launches}")
    del gpu, cpu
    gc.collect()
    return launches


def sharded_columnar_run(seed, dev, results):
    """9d: 8 windows as wire columns through submit_columnar /
    complete_columnar on the card and the CPU twin, then the same windows'
    requests cut into submissions through BackendCombiner at depth 3 on the
    card against depth 1 on the CPU twin."""
    from gubernator_tpu_torch.service.combiner import BackendCombiner

    batches, _ = request_stream(seed, SHARDED_COL_WINDOWS)
    gpu, cpu = sharded_engines(dev)
    dk.reset_launch_counts()
    rowk.reset_launch_counts()
    col_s = 0.0
    for i, (_keys, batch) in enumerate(batches):
        now = NOW + i * 50
        cols = columnar_cols(batch)
        answers = []
        for eng in (gpu, cpu):
            n = len(batch)
            outs = (np.zeros(n, np.int32), np.zeros(n, np.int64), np.zeros(n, np.int64),
                    np.zeros(n, np.int64))
            t = time.perf_counter()
            h = eng.submit_columnar(*cols, COL_SLOW, now_ms=now)
            check(h is not None, "submit_columnar refused a sharded window")
            left = eng.complete_columnar(h, *outs).tolist()
            for j, r in zip(left, eng.get_rate_limits([batch[j] for j in left], now_ms=now)):
                for o, v in zip(outs, (r.status, r.limit, r.remaining, r.reset_time)):
                    o[j] = v
            if eng is gpu:  # leftovers included
                col_s += time.perf_counter() - t
            answers.append([o.tolist() for o in outs])
        check(answers[0] == answers[1], f"sharded columnar window {i}: answers differ")
    sharded_state_equal(gpu, cpu, "sharded columnar path")
    col_launches = sharded_launches()
    dk.reset_launch_counts()
    rowk.reset_launch_counts()
    # the combiner over fresh engines: submissions of 1-512 requests
    flat = [r for _, b in batches for r in b]
    rng = np.random.default_rng(seed + 14)
    subs, pos = [], 0
    while pos < len(flat):
        n = int(np.exp(rng.uniform(0.0, np.log(MAX_SUBMISSION + 1))))
        subs.append(flat[pos:pos + n])
        pos += n
    gpu, cpu = sharded_engines(dev)
    got = []
    for eng, depth in ((gpu, PIPE_DEPTH), (cpu, 1)):
        c = BackendCombiner(eng, depth=depth, scan=PIPE_SCAN)
        check(c.pipelined == (depth > 1), "the sharded combiner's pipeline is "
              f"{'on' if c.pipelined else 'off'} at depth {depth}")
        try:
            t = time.perf_counter()
            futs = [c.submit_async(s, sub_now(i)) for i, s in enumerate(subs)]
            got.append([resp_tuples(f.result(timeout=600)) for f in futs])
            if eng is gpu:
                comb_s = time.perf_counter() - t
                comb_stats = c.stats
        finally:
            c.close()
    check(got[0] == got[1], "the sharded combiner at depth 3 and its CPU twin answer differently")
    check(comb_stats["pipelined_windows"] > 0, "the sharded combiner pipelined nothing")
    # depth 3 and depth 1 merge submissions into different windows: the
    # window counters differ, the answers and the state may not
    sharded_state_equal(gpu, cpu, "sharded combiner", counters=False)
    comb_launches = sharded_launches()
    launches = {k: v + comb_launches[k] for k, v in col_launches.items()}
    n_req = len(flat)
    results["sharded_columnar"] = dict(requests=n_req, columnar_decisions_per_s=n_req / col_s,
                                       combiner_decisions_per_s=n_req / comb_s,
                                       combiner=dict(comb_stats), launches=launches,
                                       columnar_launches=col_launches,
                                       combiner_launches=comb_launches)
    tlog(f"  9d: {n_req:,} requests as wire columns, {n_req / col_s:,.0f} decisions/s; the "
         f"same through BackendCombiner depth {PIPE_DEPTH} scan {PIPE_SCAN}: "
         f"{n_req / comb_s:,.0f} decisions/s ({len(subs)} submissions, "
         f"{comb_stats['pipelined_windows']} pipelined windows); answers and state equal to "
         f"the CPU twins; launches {launches}")
    del gpu, cpu
    gc.collect()
    return launches


def phase_sharded(seed, dev, results):
    log(f"== phase 9: the sharded engine, {SHARDS} x {SHARD_ROWS:,} rows "
        f"({SHARDS * SHARD_ROWS * 64 / 1e6:.0f} MB): the sharded kernels vs their plain "
        f"versions; ShardedEngine on {SHARDED_WINDOWS} windows with GLOBAL keys, the Store "
        f"path, the columnar path and the combiner, each against a CPU twin")
    t0 = time.perf_counter()
    errs = {}
    recs = sharded_decide(seed, dev, errs, results) + sharded_rows(seed, dev, errs, results)
    results["sharded_kernels"] = recs
    launches = dict.fromkeys(SHARDED_KERNELS, 0)
    for run in (sharded_engine_run, sharded_store_run, sharded_columnar_run):
        for k, v in run(seed, dev, results).items():
            launches[k] += v
    torch.cuda.empty_cache()
    tlog(f"  phase 9 in {time.perf_counter() - t0:.1f} s; engine-path launches {launches}")
    return launches, errs, recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--windows", type=int, default=30)
    ap.add_argument("--out", help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    global SMI
    smi = SMI = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    log("== phase 1: build the CUDA kernels and the key directory")
    t = time.perf_counter()
    build_logs = _build.build()
    build_s = time.perf_counter() - t
    for name, (text, secs) in sorted(build_logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  [{name}] {line.strip()}")
        tlog(f"  built {_build.source_path(name).name} in {secs:.1f} s")
    tlog(f"  built {sorted(build_logs) or 'nothing (cached)'} in {build_s:.1f} s in all")

    results = {"card": smi, "device": torch.cuda.get_device_name(0),
               "torch": torch.__version__, "seed": args.seed, "build_s": build_s,
               "build_each_s": {k: v[1] for k, v in build_logs.items()},
               "decide_shapes": []}
    decide_errs = phase_decide(args.seed, dev, results)
    eng_launches, captured = phase_engine(args.seed, args.windows, dev, results)
    check(len(captured) > 0, "phase 3 made no scan launch to capture")
    replay_groups(captured, dev, results, decide_errs)
    py_launches = phase_engine_python(args.seed, PYTHON_DIR_WINDOWS, dev, results)
    glob_launches, ring_main = phase_global(args.seed, dev, results)
    row_errs, row_recs, bump_launches = phase_rows(args.seed, dev, results)
    pipe_launches = phase_pipeline(args.seed, dev, results)
    persist_launches = phase_persistence(args.seed, dev, results)
    devdir_launches, devdir_errs, devdir_recs = phase_devdir(args.seed, dev, results)
    shard_launches, shard_errs, shard_recs = phase_sharded(args.seed, dev, results)

    kernels = []
    for name in dk.launch_counts:
        if name in SHARDED_KERNELS:
            continue
        scan = "_scan_" in name
        main_shape = next(r for r in results["decide_shapes"]
                          if r["kernel"] == name and r["kind"] == "windows"
                          and r["width"] == (64 if scan else WINDOW)
                          and r["scan_k"] == (32 if scan else 0))
        n = (eng_launches[name] + py_launches[name] + glob_launches[name]
             + pipe_launches[name] + persist_launches[name] + devdir_launches[name])
        check(n > 0, f"{name} was never launched on the main path")
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=n, max_abs_err=decide_errs[name], ms=main_shape["ms"],
            plain_ms=main_shape["plain_ms"], bound_ms=main_shape["bound_ms"],
            bound_by=main_shape["bound_by"], library_ms=None, library_device_ms=None,
            call_ms=main_shape["call_ms"], shape="K=32, W=64" if scan else f"W={WINDOW}"))
    n = glob_launches["ring_all_reduce"]
    check(n > 0, "ring_all_reduce was never launched on the GLOBAL sync path")
    kernels.append(dict(
        name="ring_all_reduce", route="cuda", source=SOURCES["ring_all_reduce"],
        replaces=REPLACES["ring_all_reduce"], launches=n,
        max_abs_err=ring_main["max_abs_err"], ms=ring_main["ms"],
        plain_ms=ring_main["plain_ms"], bound_ms=ring_main["bound_ms"],
        bound_by=ring_main["bound_by"], library_ms=ring_main["library_ms"],
        library_device_ms=ring_main["library_device_ms"], call_ms=ring_main["call_ms"],
        shape=f"S={GLOBAL_SHARDS}, L={ring_main['L']}"))
    for name in ("inject_rows", "gather_rows", "row_bump"):
        n = (bump_launches if name == "row_bump"
             else eng_launches[name] + pipe_launches[name] + persist_launches[name])
        check(n > 0, f"{name} was never launched on its main path")
        r = next(r for r in row_recs if r["kernel"] == name
                 and r["m"] == ROW_MAIN_M.get(name, r["m"])
                 and r["form"] == ROW_MAIN_FORM[name])
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=n, max_abs_err=row_errs[name], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
            library_device_ms=r["library_device_ms"], call_ms=r["call_ms"],
            shape=f"m={r['m']}, {r['form']}"))
    # the probe as the device-directory engine runs it (eviction on, W = 8192)
    # and the sweep; probe_assign (eviction off) runs on no engine's path and
    # is timed in phase 8a only
    for name in ("probe_assign_evict", "refresh_vacancies"):
        n = devdir_launches[name]
        check(n > 0, f"{name} was never launched on the device directory's path")
        r = next(r for r in devdir_recs if r["kernel"] == name and r["W"] in (None, WINDOW))
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=n, max_abs_err=devdir_errs[name], ms=r["ms"],
            ms_source=r.get("ms_source", "torch.profiler" if r["ms"] is not None else None),
            plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
            library_device_ms=None, call_ms=r["call_ms"],
            shape=f"C={r['C']}" + (f", W={r['W']}" if r["W"] else "")))
    # the sharded kernels at the sharded engine's main shapes: the decide at
    # W = 8192 an owner (K = 32, W = 64 for the scan), the gather and the
    # inject at m = 64 an owner
    for name in SHARDED_KERNELS:
        n = shard_launches[name]
        check(n > 0, f"{name} was never launched on the sharded engine's path")
        scan = "_scan_" in name
        r = next(r for r in shard_recs if r["kernel"] == name and (
            r.get("m") == 64 if "m" in r else
            (r["width"], r["scan_k"]) == ((64, 32) if scan else (WINDOW, 0))))
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=n, max_abs_err=shard_errs[name],
            ms=r["ms"], ms_source=r["ms_source"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r.get("library_ms"),
            library_device_ms=r.get("library_device_ms"), call_ms=r["call_ms"],
            loop_ms=r.get("loop_ms"), loop_call_ms=r.get("loop_call_ms"),
            shape=(f"R=1, S={SHARDS}, C={SHARD_ROWS}, "
                   + (f"m={r['m']}" if "m" in r else
                      ("K=32, W=64" if scan else f"W={WINDOW}")) + " an owner")))
    results["kernels"] = kernels
    results["total_s"] = time.perf_counter() - t_start
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    tlog(f"total {results['total_s']:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
