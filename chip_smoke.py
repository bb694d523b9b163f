#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gubernator_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--windows 100] [--out results.json]

Run from the root of the repository. Phases, each fatal on failure:

1. print the card (nvidia-smi name and power limit) and build the CUDA
   kernels from csrc/ with nvcc (both sources compile in parallel);
2. hold the decide kernel to its plain PyTorch version on the card, on a
   10,000,001-row table populated from --seed: the wide, compact and lean
   formats at W in {64, 1024, 8192} and the scan at K in {2, 32}, W = 64.
   Responses and whole tables must be bit-equal; each shape is timed
   against its plain version and its memory bound;
3. the main path: Engine(device="cuda", capacity=10_000_001) after
   warmup() takes --windows client batches of 8192 requests over 1,000,000
   Zipf(1.1) keys, and Engine(device="cpu") takes the same stream; the
   responses and the tables must be equal;
4. the GLOBAL sync: the ring kernel against its plain version at
   L in {G, 4G}, then sync steps over S = 8 shards of 1,250,000 rows with
   G = 1024 global keys, collectives="ring" on the card against "psum" on
   the CPU; mirrors and shard tables must be equal.

Kernel launch counts are set to 0 just before each main path (phases 3
and 4) and read just after; every kernel must have launched. The last
two lines are the {"kernels": [...]} record and the contract line
{"ok": true, "device": {...}}. The script imports nothing of JAX.
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

from gubernator_tpu_torch.models.engine import Engine
from gubernator_tpu_torch.ops import _build, decide as dk, ring as rk
from gubernator_tpu_torch.parallel import MeshPlan, make_global_sync, make_sharded_table, shard_of_key
from gubernator_tpu_torch.parallel.global_sync import GlobalConfig, _psum
from gubernator_tpu_torch.types import Behavior, RateLimitReq
from gubernator_tpu_torch.utils.gregorian import gregorian_duration, gregorian_expiration

NOW = 1_700_000_000_000
CAPACITY = 10_000_001  # the north star's 10M keys; fits the 24-bit lean slot
WINDOW = 8192  # requests per client batch, the engine's max_width
N_KEYS = 1_000_000  # distinct keys of the main-path stream
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
            "ring_all_reduce": "gubernator_tpu/ops/ring.py:39"}
SOURCES = {"decide_wide": "gubernator_tpu_torch/csrc/decide.cu",
           "decide_compact": "gubernator_tpu_torch/csrc/decide.cu",
           "decide_lean": "gubernator_tpu_torch/csrc/decide.cu",
           "ring_all_reduce": "gubernator_tpu_torch/csrc/ring.cu"}


def log(*a):
    print(*a, flush=True)


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


def profiled_kernel_ms(fn, iters, kernel_substr):
    """Mean device time of the named CUDA kernel per launch, from
    torch.profiler; None when the trace shows no device time for it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
    except RuntimeError as e:  # a trace is extra detail; the timing above stands
        log(f"  profiler unavailable: {e}")
        return None
    total_us, count = 0.0, 0
    for e in prof.key_averages():
        if kernel_substr in e.key:
            total_us += e.device_time_total
            count += e.count
    return total_us / count / 1e3 if count and total_us > 0 else None


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
        dev_ms = profiled_kernel_ms(run_k, 32, "decide_kernel")
        ms = dev_ms if dev_ms is not None else call_ms
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
        log(f"  {fmt:7s} W={width:5d} K={k:2d}: bit-equal; kernel {ms:.5f} ms on the "
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
    calendar (wide) — about 1% of all requests."""
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
        batches.append(batch)
    return batches


def phase_engine(seed, n_windows, dev, results):
    log(f"== phase 3: main path, Engine(capacity={CAPACITY}) on {dev} vs cpu, "
        f"{n_windows} windows of {WINDOW} requests")
    t = time.perf_counter()
    batches = request_stream(seed, n_windows)
    log(f"  stream built in {time.perf_counter() - t:.1f} s")
    gpu = Engine(device=dev, capacity=CAPACITY, min_width=64, max_width=WINDOW)
    cpu = Engine(device="cpu", capacity=CAPACITY, min_width=64, max_width=WINDOW)
    t = time.perf_counter()
    gpu.warmup()
    log(f"  warmup {time.perf_counter() - t:.2f} s")
    # host clock around the engine's device round trips: staging upload +
    # launch (dispatch) and wait + readback (fetch)
    spent = {"dispatch": 0.0, "fetch": 0.0}
    for hook, name in (("_dispatch_staged", "dispatch"),
                       ("_dispatch_scan_staged", "dispatch"), ("_fetch_staged", "fetch")):
        def timed(*a, _fn=getattr(gpu, hook), _name=name):
            t0 = time.perf_counter()
            out = _fn(*a)
            spent[_name] += time.perf_counter() - t0
            return out

        setattr(gpu, hook, timed)
    dk.reset_launch_counts()
    gpu_s = cpu_s = busy_us = traced_s = 0.0
    n_req = 0
    for i, batch in enumerate(batches):
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
            busy_us += sum(e.self_device_time_total for e in prof.key_averages())
            traced_s += elapsed
        else:
            gpu_s += elapsed
            n_req += len(batch)
        t = time.perf_counter()
        want = cpu.get_rate_limits(batch, now_ms=now)
        cpu_s += time.perf_counter() - t
        check([(r.status, r.limit, r.remaining, r.reset_time, r.error) for r in got]
              == [(r.status, r.limit, r.remaining, r.reset_time, r.error) for r in want],
              f"window {i}: card and CPU engines answer differently")
    launches = dict(dk.launch_counts)
    check(torch.equal(gpu.state.cpu(), cpu.state), "engine tables differ")
    total = WINDOW * len(batches)
    rate = n_req / gpu_s
    busy = busy_us / 1e6 / traced_s if traced_s else None
    results["engine"] = dict(
        requests=total, windows=n_windows, timed_requests=n_req, gpu_s=gpu_s,
        cpu_s=cpu_s, decisions_per_s=rate, cpu_decisions_per_s=total / cpu_s,
        device_busy_share=busy, dispatch_s=spent["dispatch"], fetch_s=spent["fetch"],
        launches_per_window=sum(launches.values()) / n_windows,
        keys=gpu.key_count(), launches=launches)
    log(f"  equal responses and tables; card engine {rate:,.0f} decisions/s "
        f"({n_req} requests in {gpu_s:.2f} s, the 2 traced windows left out; CPU twin "
        f"{total / cpu_s:,.0f}/s); device busy {busy} of the traced windows' wall "
        f"time; dispatch {spent['dispatch']:.2f} s, fetch {spent['fetch']:.2f} s of all "
        f"windows; {gpu.key_count()} keys; launches {launches}")
    del gpu, cpu
    torch.cuda.empty_cache()
    return launches


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
        dev_ms = profiled_kernel_ms(lambda i: rk.ring_all_reduce_cuda(x), 50, "ring_kernel")
        ms = dev_ms if dev_ms is not None else call_ms
        plain_ms = event_ms(lambda i: rk.ring_all_reduce_plain(x), 50)
        lib_ms = event_ms(lambda i: torch.sum(x, 0), 200)
        b_ms, b_by = bound_ms(2 * S * L * 8, 2 * (S - 1) * L)
        ring_rec[L] = dict(L=L, S=S, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                           library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                           max_abs_err=max_abs_err(got, want))
        log(f"  ring L={L}: bit-equal; kernel {ms:.5f} ms on the device, {call_ms:.4f} ms "
            f"per wrapper call; plain {plain_ms:.4f} ms; torch.sum {lib_ms:.4f} ms; "
            f"bound {b_ms:.6f} ms ({b_by})")
    results["ring"] = list(ring_rec.values())

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
    log(f"  {steps} sync steps: equal mirrors and shard tables; ring step "
        f"{t_ring / steps * 1e3:.3f} ms; launches {launches}")
    del card, host
    torch.cuda.empty_cache()
    return launches, ring_rec[4 * G]


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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    log("== phase 1: build the CUDA kernels")
    t = time.perf_counter()
    build_logs = _build.build()
    build_s = time.perf_counter() - t
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  [{name}] {line.strip()}")
    log(f"  built {sorted(build_logs) or 'nothing (cached)'} in {build_s:.1f} s")

    results = {"card": smi, "device": torch.cuda.get_device_name(0),
               "torch": torch.__version__, "seed": args.seed,
               "build_s": build_s, "decide_shapes": []}
    decide_errs = phase_decide(args.seed, dev, results)
    eng_launches = phase_engine(args.seed, args.windows, dev, results)
    glob_launches, ring_main = phase_global(args.seed, dev, results)

    kernels = []
    for name in ("decide_wide", "decide_compact", "decide_lean"):
        main_shape = next(r for r in results["decide_shapes"]
                          if r["kernel"] == name and r["width"] == WINDOW)
        n = eng_launches[name] + glob_launches[name]
        check(n > 0, f"{name} was never launched on the main path")
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=n, max_abs_err=decide_errs[name], ms=main_shape["ms"],
            plain_ms=main_shape["plain_ms"], bound_ms=main_shape["bound_ms"],
            bound_by=main_shape["bound_by"], library_ms=None,
            call_ms=main_shape["call_ms"], shape=f"W={WINDOW}"))
    n = glob_launches["ring_all_reduce"]
    check(n > 0, "ring_all_reduce was never launched on the GLOBAL sync path")
    kernels.append(dict(
        name="ring_all_reduce", route="cuda", source=SOURCES["ring_all_reduce"],
        replaces=REPLACES["ring_all_reduce"], launches=n,
        max_abs_err=ring_main["max_abs_err"], ms=ring_main["ms"],
        plain_ms=ring_main["plain_ms"], bound_ms=ring_main["bound_ms"],
        bound_by=ring_main["bound_by"], library_ms=ring_main["library_ms"],
        call_ms=ring_main["call_ms"], shape=f"S={GLOBAL_SHARDS}, L={ring_main['L']}"))
    results["kernels"] = kernels
    results["total_s"] = time.perf_counter() - t_start
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    log(f"total {results['total_s']:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
