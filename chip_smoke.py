#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gubernator_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--windows 100] [--out results.json]

Run from the root of the repository. Phases, each fatal on failure:

1. print the card (nvidia-smi name and power limit) and build every native
   source, all compilers started together: the CUDA kernels from csrc/
   with nvcc and the key directory native/keydir.cpp with g++; each
   source's build time is printed;
2. hold the decide kernel to its plain PyTorch version on the card, on a
   10,000,001-row table populated from --seed: the wide, compact and lean
   formats at W in {64, 1024, 8192} and the scan at K in {2, 32}, W = 64.
   Responses and whole tables must be bit-equal; each shape is timed
   against its plain version and its memory bound;
3. the main path: Engine(device="cuda", capacity=10_000_001) on the native
   directory after warmup() takes --windows client batches of 8192
   requests over 1,000,000 Zipf(1.1) keys through the one-pass fast
   window; after each window the 16 hottest keys go through seed_mirror
   (the gather kernel in its pinned form) and three decide_native_single
   calls each (a miss becomes a one-request window), so the next window's
   lookups inject the dirty mirrors (the inject kernel, in its pinned form:
   the key directory writes the rows into the engine's page-locked
   staging). Engine(device="cpu") takes the same sequence; responses, lone
   responses, tables and EngineStats counters must be equal, and every
   inject and gather launch must have gone through the pinned entry point.
   Prints decisions/s, the stage split, seed_mirror's time per call and
   the host time per Engine._apply_inject_rows that had rows; then the
   host-stage split of seed_mirror over 10,000 calls;
3b. the same engines on the python directory (GUBER_NO_NATIVE=1), 20
   windows, no lone requests;
4. the GLOBAL sync: the ring kernel against its plain version at
   L in {G, 4G}, timed; the raw stream handle of the shared launch path
   held equal to torch.cuda.current_stream's, on the default stream and a
   side stream; the host-stage split of the ring wrapper over 10,000
   calls; then sync steps over S = 8 shards of 1,250,000 rows with
   G = 1024 global keys, collectives="ring" on the card against "psum" on
   the CPU; mirrors and shard tables must be equal;
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
   clone; then the probe's own loop (gubernator_tpu_torch.bench_rows).

Device times come from torch.profiler, for the kernels and for each
library call they are compared with; where the profiler gives none the
record holds null, never a host-clock time. Every line with a time ends
with the card and its power limit as nvidia-smi gives them.

Kernel launch counts are set to 0 just before each main path (phases 3,
3b, 4 and the bench_rows loop) and read just after; every kernel must have
launched, inject and gather on phase 3, both through their pinned entry
points only. The last two lines are the
{"kernels": [...]} record and the contract line {"ok": true, "device":
{...}}. The script imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import datetime as dt
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from gubernator_tpu_torch import bench_rows
from gubernator_tpu_torch.models.engine import Engine
from gubernator_tpu_torch.ops import _build, _launch, decide as dk, ring as rk, rows as rowk
from gubernator_tpu_torch.parallel import MeshPlan, make_global_sync, make_sharded_table, shard_of_key
from gubernator_tpu_torch.parallel.global_sync import GlobalConfig, _psum
from gubernator_tpu_torch.types import Behavior, RateLimitReq
from gubernator_tpu_torch.utils.gregorian import gregorian_duration, gregorian_expiration

NOW = 1_700_000_000_000
CAPACITY = 10_000_001  # the north star's 10M keys; fits the 24-bit lean slot
WINDOW = 8192  # requests per client batch, the engine's max_width
N_KEYS = 1_000_000  # distinct keys of the main-path stream
LONE_KEYS = 16  # hottest keys of each window sent as lone requests
PYTHON_DIR_WINDOWS = 20  # phase 3b
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
FORMATS = {"wide": dk.WIDE, "compact": dk.COMPACT, "lean": dk.LEAN}
STAGE_BYTES = {"wide": 72, "compact": 20, "lean": 4}
RESP_BYTES = {"wide": 32, "compact": 16, "lean": 16}
REPLACES = {"decide_wide": "gubernator_tpu/ops/decide.py:464",
            "decide_compact": "gubernator_tpu/ops/decide.py:536",
            "decide_lean": "gubernator_tpu/ops/decide.py:844",
            "ring_all_reduce": "gubernator_tpu/ops/ring.py:39",
            "inject_rows": "gubernator_tpu/models/engine.py:74",
            "gather_rows": "gubernator_tpu/models/engine.py:86",
            "row_bump": "scripts/bench_pallas_rows.py:36"}
SOURCES = {"decide_wide": "gubernator_tpu_torch/csrc/decide.cu",
           "decide_compact": "gubernator_tpu_torch/csrc/decide.cu",
           "decide_lean": "gubernator_tpu_torch/csrc/decide.cu",
           "ring_all_reduce": "gubernator_tpu_torch/csrc/ring.cu",
           "inject_rows": "gubernator_tpu_torch/csrc/rows.cu",
           "gather_rows": "gubernator_tpu_torch/csrc/rows.cu",
           "row_bump": "gubernator_tpu_torch/csrc/rows.cu"}
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


def profiled_ms(fn, iters, kernel_substr=None):
    """Mean device milliseconds from torch.profiler over `iters` calls: per
    launch of the kernels whose name holds `kernel_substr`, or, when it is
    None, per call of everything the call ran on the device (kernels and
    copies: a library call's device time). None, logged, when the profiler
    fails or its trace shows no device time: the caller records null, never
    a host-clock time in its place."""
    from torch.profiler import ProfilerActivity, profile

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
    for e in prof.key_averages():
        if kernel_substr is None or kernel_substr in e.key:
            total_us += e.self_device_time_total
            count += e.count
    if kernel_substr is None:
        count = iters
    if not count or total_us <= 0:
        log(f"  the trace shows no device time for {kernel_substr or 'the call'}: "
            "device ms recorded as null")
        return None
    return total_us / count / 1e3


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
    """The wide host window as the device tensors of `fmt` (lean: the lane
    words and the config table; else cfg None)."""
    if fmt == "wide":
        return torch.from_numpy(wide).to(device), None
    if fmt == "compact":
        c = dk.compact_window(wide)
        check(c is not None, "compact stimulus not eligible")
        return torch.from_numpy(c).to(device), None
    ln = dk.lean_window(wide, capacity)
    check(ln is not None, "lean stimulus not eligible")
    return torch.from_numpy(ln[0]).to(device), torch.from_numpy(ln[1]).to(device)


def phase_decide(seed, dev, results):
    log("== phase 2: decide kernel vs its plain version, "
        f"table {CAPACITY} rows ({CAPACITY * 64 / 1e6:.0f} MB)")
    rng = np.random.default_rng(seed)
    kern = populate_table(CAPACITY, seed, dev)
    plain = kern.clone()
    shapes = [(fmt, w, 0) for fmt in FORMATS for w in (64, 1024, WINDOW)]
    shapes += [(fmt, 64, k) for fmt in FORMATS for k in (2, 32)]
    errs = {}
    for fmt, width, k in shapes:
        f = FORMATS[fmt]
        scan = k > 0
        if scan:
            pool = rng.choice(CAPACITY, 256, replace=False)  # windows overlap
            wide = np.stack([stimulus(rng, kern, width, fmt, slots=pool) for _ in range(k)])
        else:
            wide = stimulus(rng, kern, width, fmt)
        packed, cfg = staged(fmt, wide, CAPACITY, dev)
        out_k = dk.decide_cuda(f, kern, packed, cfg, NOW, scan)
        out_p = dk.decide_plain(f, plain, packed, cfg, NOW, scan)
        torch.cuda.synchronize()
        name = dk._FORMAT_NAMES[f]
        err = max(max_abs_err(out_k, out_p), max_abs_err(kern, plain))
        errs[name] = max(errs.get(name, 0), err)
        check(torch.equal(out_k, out_p), f"{fmt} W={width} K={k}: responses differ")
        check(torch.equal(kern, plain), f"{fmt} W={width} K={k}: tables differ")

        # timing: 16 distinct stimuli, cycled, so rows come cold from HBM
        stims = []
        for _ in range(16):
            if scan:
                pool = rng.choice(CAPACITY, 256, replace=False)
                w_ = np.stack([stimulus(rng, kern, width, fmt, slots=pool) for _ in range(k)])
            else:
                w_ = stimulus(rng, kern, width, fmt)
            stims.append(staged(fmt, w_, CAPACITY, dev))
        live = int((wide[..., 0, :] >= 0).sum())

        def run_k(i):
            pk, cf = stims[i % 16]
            dk.decide_cuda(f, kern, pk, cf, NOW, scan)

        def run_p(i):
            pk, cf = stims[i % 16]
            dk.decide_plain(f, plain, pk, cf, NOW, scan)

        call_ms = event_ms(run_k, 64)
        ms = profiled_ms(run_k, 32, "decide_kernel")
        plain_ms = event_ms(run_p, 8)
        plain.copy_(kern)  # the timing runs mutated the two tables differently
        lanes = width * max(k, 1)
        n_bytes = live * 128 + lanes * (STAGE_BYTES[fmt] + RESP_BYTES[fmt]) + (
            dk.LEAN_MAX_CFG * 32 if fmt == "lean" else 0)
        b_ms, b_by = bound_ms(n_bytes, live * DECIDE_OPS_PER_LANE)
        rec = dict(kernel=name, fmt=fmt, width=width, scan_k=k, live_lanes=live,
                   ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by, bytes=n_bytes)
        results["decide_shapes"].append(rec)
        tlog(f"  {fmt:7s} W={width:5d} K={k:2d}: bit-equal; kernel {fms(ms)} ms on the "
             f"device, {call_ms:.4f} ms per wrapper call; plain {plain_ms:.4f} ms; "
             f"bound {b_ms:.6f} ms ({b_by})")
    edge_cases(kern, plain, dev, errs)
    del kern, plain
    torch.cuda.empty_cache()
    return errs


def edge_cases(kern, plain, dev, errs):
    """The lanes tests/test_torch_decide.py holds the plain version to on the
    CPU, now kernel against plain on the card: a slot past the table (the
    gather clamps, the store drops), int64 wraparound, negative durations,
    a sticky status past i32, algorithm 7, padding between live lanes; and
    a lean window of 128 configs, whose ids set the lane word's sign bit."""
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
    for fmt, p in (("wide", wide), ("lean", lean)):
        packed, cfg = staged(fmt, p, C, dev)
        if fmt == "lean":
            check(bool((packed < 0).any()), "lean edge window sets no sign bit")
        f = FORMATS[fmt]
        out_k = dk.decide_cuda(f, kern, packed, cfg, NOW)
        out_p = dk.decide_plain(f, plain, packed, cfg, NOW)
        torch.cuda.synchronize()
        name = dk._FORMAT_NAMES[f]
        errs[name] = max(errs[name], max_abs_err(out_k, out_p), max_abs_err(kern, plain))
        check(torch.equal(out_k, out_p), f"{fmt} edge lanes: responses differ")
        check(torch.equal(kern, plain), f"{fmt} edge lanes: tables differ")
    log("  edge lanes (clamp, wraparound, negative durations, i32 status, "
        "algorithm 7, lean sign bit): bit-equal")


# ----------------------------------------------------------------- phase 3

def request_stream(seed, n_windows):
    """Client batches of WINDOW requests over N_KEYS Zipf(1.1) keys: 80%
    token / 20% leaky keys with per-key limits and durations. Batches come
    from three kinds of client, in turn: of every ten batches six send
    hits = 1 only (the lean format), three send hits of 2-5 on a tenth of
    their requests (compact), and one also puts a tenth on a gregorian
    calendar (wide) — about 1% of all requests. Returns the batches and
    each key's (algorithm, limit, duration)."""
    width, n_keys = WINDOW, N_KEYS
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
    dk.reset_launch_counts()
    rowk.reset_launch_counts()
    m = drive_engines(gpu, cpu, batches, key_cfg, True, spent)
    launches = {**dk.launch_counts, **rowk.launch_counts}
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
    del gpu, cpu
    torch.cuda.empty_cache()
    return launches


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
        t_ring += time.perf_counter() - t
        _, m_host, _ = psum_sync(host, torch.from_numpy(delta), cfg_h, now)
        for f in m_card._fields:
            check(torch.equal(getattr(m_card, f).cpu(), getattr(m_host, f)),
                  f"sync step {step}: mirror.{f} differs")
        check(torch.equal(card.cpu(), host), f"sync step {step}: shard tables differ")
        cfg_np["fresh"] = np.zeros(G, np.bool_)
    launches = {**dk.launch_counts, **rk.launch_counts}
    results["global"] = dict(S=S, C=C, G=G, steps=steps, step_ms=t_ring / steps * 1e3,
                             launches=launches)
    tlog(f"  {steps} sync steps: equal mirrors and shard tables; ring step "
         f"{t_ring / steps * 1e3:.3f} ms; launches {launches}")
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--windows", type=int, default=100)
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
    eng_launches = phase_engine(args.seed, args.windows, dev, results)
    py_launches = phase_engine_python(args.seed, PYTHON_DIR_WINDOWS, dev, results)
    glob_launches, ring_main = phase_global(args.seed, dev, results)
    row_errs, row_recs, bump_launches = phase_rows(args.seed, dev, results)

    kernels = []
    for name in ("decide_wide", "decide_compact", "decide_lean"):
        main_shape = next(r for r in results["decide_shapes"]
                          if r["kernel"] == name and r["width"] == WINDOW)
        n = eng_launches[name] + py_launches[name] + glob_launches[name]
        check(n > 0, f"{name} was never launched on the main path")
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=n, max_abs_err=decide_errs[name], ms=main_shape["ms"],
            plain_ms=main_shape["plain_ms"], bound_ms=main_shape["bound_ms"],
            bound_by=main_shape["bound_by"], library_ms=None, library_device_ms=None,
            call_ms=main_shape["call_ms"], shape=f"W={WINDOW}"))
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
        n = bump_launches if name == "row_bump" else eng_launches[name]
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
