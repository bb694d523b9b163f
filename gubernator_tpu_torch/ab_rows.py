"""A/B of the decide, row and inject wrappers and the main path between checkouts, on one card.

    python3 -m gubernator_tpu_torch.ab_rows TREE [TREE ...] [--windows 100]

Each TREE is the root of a checkout of this repository (a `git archive` of
a commit, say); give them in the order to run, for example parent,
change, change, parent. For each TREE a child process, started in TREE,
imports and builds TREE's gubernator_tpu_torch, and
measures it with the helpers of the chip_smoke.py that sits beside this
file's package, so every tree is read on one yardstick:

- row_bump_cuda at B = 8192 on an int32[10,000,000, 128] table and the
  device-operand inject_rows_cuda at m = 1 and 16 on a 10,000,001-row
  table, each through chip_smoke.timed_kernel against its library call
  (index_add_ with 128 MB written before each profiled session, and
  index_copy_), with the stimuli of chip_smoke's phase 5; each tree's
  wrapper is called as its own main path calls it (a caller's `out` where
  row_bump_cuda takes one); then the tree's own bench_rows loop;
- decide_cuda at chip_smoke's phase-2 shapes (one window of W = 64, 1024
  and 8192; scans of K = 2 and 32 windows of 64; the herd group), every
  format, 16 stimuli cycled on a 10,000,001-row table: device ms per
  launch (torch.profiler) and ms per wrapper call (CUDA events); then the
  scan groups that TREE's Engine launches on the first 20 windows of
  phase 3's stream, captured with the rows they touch and replayed on a
  fresh table, timed the same way per format; and whether TREE's kernel
  answers chip_smoke's row C-1 edge window (lanes past the table beside
  the lane that writes row C-1, 8192 lanes) as its plain version does;
- chip_smoke's phase-3 stream (--windows client batches and their lone
  requests) through TREE's Engine on the card, without the CPU twin:
  host microseconds per Engine._apply_inject_rows call that had rows,
  seed_mirror microseconds, decisions per second, the row launches (by
  form where the tree counts them) and the waits on the inject staging;
  then chip_smoke's
  phase 4 (the GLOBAL sync on the ring), for its ms per sync step (the
  mean of all steps, of all but the first, and the first alone);
- cold rows: the sharded gather and inject (gather_sharded_cuda,
  inject_sharded_cuda) at m = 1, 64 and 4096 an owner on chip_smoke's
  8 x 1,250,000-row sharded table, and the single-table gather_rows_cuda
  at m = 1 and 64 on a 10,000,001-row table, device operands, each over 16
  stimuli cycled with the L2 flushed before every launch
  (chip_smoke.l2_flush), device ms per launch from torch.profiler, beside
  the library calls of phase 9a timed the same way and, where the tree has
  one, the empty kernel on the kernels' grid (rows.floor_cuda); then the
  pinned gather and the pinned inject as the tree's engine calls them, at
  chip_smoke's PINNED_GATHER_M and PINNED_INJECT_M (the by-value class
  edges), cold the same way, also as host round trips (the gather: launch,
  one wait, the rows read; the inject: rows copied into the staging,
  launch, one wait), beside their library calls (state[slot, :7].tolist();
  torch.from_numpy(a).to(dev) + index_copy_) timed both ways and, where the
  tree has one, the empty kernel on the launch's grid with its parameter
  block (rows.pinned_floor_cuda); where the tree's inject has a copy form
  (rows.copy_min), the mapped and copy forms at every m through the
  library's entry point (chip_smoke.inject_form), cold, and the copy up
  alone (one page-locked copy_ of the m rows into the staging's scratch);
- probe: the device directory's probe (probe_cuda) with and without
  eviction at C = 10,000,001 and W = 64, 1024 and 8192 on phase 8a's
  columns and hashes (16 sets cycled), as the engine calls it (eviction:
  the staging and a caller's retry; without: the caller's three outputs):
  device ms per call, cold (torch.profiler, L2 flushed before every
  call, every kernel the call launches summed) and the device span of a
  call (its first kernel's start to its last kernel's end, the gaps between
  launches counted), beside, where the tree has
  them, the empty cooperative kernel on the probe's grid, the same with its
  two grid barriers, and the grid's blocks; ms per wrapper call (CUDA
  events); and host microseconds per probe_cuda call (2,000 calls) beside
  the same ctypes call of the entry point alone with its operands ready,
  the difference being the wrapper's checks and operand reads;
- the Store path: chip_smoke's phase-7b stream (STORE_WINDOWS windows
  through TREE's Engine with a MockStore holding phase 7's buckets, no
  CPU twin): decisions per second and host microseconds per
  Engine._gather_slots call with the slots per call (the Store path's
  read- and write-through gathers); then rows_for_keys at phase 7c's
  HOST_READ_KEYS keys (the reshard exporter's read) and _gather_slots
  alone at m = 64, 1024 and WINDOW random slots, host microseconds per
  call, the median of 7 runs of 50 calls (rows_for_keys: 20) each.

- mesh: chip_smoke's 15a all-reduce on one card (n = 2, 4 and 8 entries
  that all name cuda:0, L = 1024 and 4096, values over the whole int64
  range) through the tree's ring_all_reduce_mesh_cuda, held bit-equal to
  its plain version, with its launches a call, then timed by
  chip_smoke.mesh_ring_times (device ms a launch of the kernels whose name
  holds "ring_", the tree's hops or its one launch, and a call, that times
  the launches; an all-reduce's span, CUDA events, also with every call
  queued behind a busy stream; a call and the plain version's, host
  clock); then chip_smoke's 15c on a mesh engine of the tree (eight
  entries of 1,250,000 rows on cuda:0, collectives="ring"): five ring
  steps against the psum twin, equal after each, the first and the steady
  step's ms of both.

--parts picks some of these (decide, rows, engine, cold_rows, store,
probe, mesh; all by default). Prints the card's line (nvidia-smi name, power limit), then one
JSON line per tree. Needs one card.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    """This checkout's chip_smoke.py, loaded by path (its imports of the
    package resolve to the tree first on sys.path)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(cs, dev):
    """row_bump and the device-operand inject, timed as phase 5 times them."""
    from gubernator_tpu_torch import bench_rows
    from gubernator_tpu_torch.ops import rows as rowk

    recs = []
    rng = np.random.default_rng(4)
    kern = cs.populate_table(cs.CAPACITY, 5, dev)
    plain = kern.clone()
    for m in (1, 16):
        stims = [cs.inject_stimulus(rng, cs.CAPACITY, m, dev) for _ in range(16)]
        lib_in = [cs.index_copy_rows(st, cs.CAPACITY) for st in stims]
        t = cs.timed_kernel(lambda i: rowk.inject_rows_cuda(kern, stims[i % 16]),
                            lambda i: rowk.inject_rows_plain(plain, stims[i % 16]),
                            lambda i: plain.index_copy_(0, *lib_in[i % 16]), "inject_kernel")
        recs.append(dict(kernel="inject_rows", m=m, library="index_copy_", **t))
    del kern, plain
    torch.cuda.empty_cache()

    N, B = bench_rows.CAP, bench_rows.BATCH
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    kern = torch.randint(-(1 << 31), (1 << 31) - 1, (N, 128), generator=g, device=dev,
                         dtype=torch.int32)
    srng = np.random.RandomState(5)
    sets = [torch.from_numpy(srng.choice(N, B, replace=False).astype(np.int32)).to(dev)
            for _ in range(16)]
    plain = kern.clone()
    out = torch.empty(1, dtype=torch.int32, device=dev)
    if "out" in inspect.signature(rowk.row_bump_cuda).parameters:
        bump = lambda i: rowk.row_bump_cuda(kern, sets[i % 16], out)  # noqa: E731
    else:
        bump = lambda i: rowk.row_bump_cuda(kern, sets[i % 16])  # noqa: E731
    ones = torch.ones((B, 128), dtype=torch.int32, device=dev)
    idx = [s.to(torch.int64) for s in sets]
    scratch = torch.empty(32 << 20, dtype=torch.int32, device=dev)
    t = cs.timed_kernel(bump, lambda i: rowk.row_bump_plain(plain, sets[i % 16]),
                        lambda i: kern.index_add_(0, idx[i % 16], ones), "row_bump_kernel",
                        flush=lambda: scratch.fill_(0))
    recs.append(dict(kernel="row_bump", m=B, library="index_add_", **t))
    del kern, plain, ones, idx, sets, scratch
    torch.cuda.empty_cache()
    probe = bench_rows.run(dev)
    torch.cuda.empty_cache()
    return recs, probe


CAPTURE_WINDOWS = 20  # phase-3 windows whose scan groups are replayed


def _decide(cs, dev):
    """The tree's decide_cuda on one yardstick: phase 2's shapes, the
    captured scan groups and the row C-1 edge window."""
    from gubernator_tpu_torch.models.engine import Engine
    dk = importlib.import_module("gubernator_tpu_torch.ops.decide")

    rng = np.random.default_rng(7)
    kern = cs.populate_table(cs.CAPACITY, 0, dev)
    recs = []

    def timed(f, stims, scan):
        def run(i):
            pk, cf, now = stims[i % len(stims)]
            dk.decide_cuda(f, kern, pk, cf, now, scan)
        return dict(ms=cs.profiled_ms(run, 32, "decide_kernel"), call_ms=cs.event_ms(run, 64))

    shapes = [(fmt, w, 0, "windows") for fmt in cs.FORMATS for w in (64, 1024, cs.WINDOW)]
    shapes += [(fmt, 64, k, "windows") for fmt in cs.FORMATS for k in (2, 32)]
    shapes += [(fmt, 64, 32, "herd") for fmt in cs.FORMATS]
    for fmt, width, k, kind in shapes:
        def make():
            if kind == "herd":
                return cs.herd(rng, kern, fmt)
            if k:
                pool = rng.choice(cs.CAPACITY, 256, replace=False)
                return np.stack([cs.stimulus(rng, kern, width, fmt, slots=pool) for _ in range(k)])
            return cs.stimulus(rng, kern, width, fmt)
        stims = [(*cs.staged(fmt, make(), cs.CAPACITY, dev), cs.NOW) for _ in range(16)]
        recs.append(dict(fmt=fmt, width=width, k=k, kind=kind,
                         **timed(cs.FORMATS[fmt], stims, k > 0)))

    # the row C-1 edge window, kernel against plain version
    edge = {}
    row = torch.tensor([0, 10, 4, 60_000, cs.NOW - 5, cs.NOW + 60_000, 0, 3], device=dev)
    for fmt in ("wide", "lean"):
        same = True
        for _ in range(8):
            kern[-1] = row
            pk, cf = cs.staged(fmt, cs.last_row_window(rng, kern, fmt, cs.WINDOW), cs.CAPACITY, dev)
            plain = kern.clone()
            out_k = dk.decide_cuda(cs.FORMATS[fmt], kern, pk, cf, cs.NOW)
            out_p = dk.decide_plain(cs.FORMATS[fmt], plain, pk, cf, cs.NOW)
            same = same and torch.equal(out_k, out_p) and torch.equal(kern, plain)
            del plain
        edge[fmt] = same
    del kern
    torch.cuda.empty_cache()

    # the scan groups of the first phase-3 windows, as the tree's Engine sends them
    batches, _ = cs.request_stream(0, CAPTURE_WINDOWS)
    os.environ.pop("GUBER_NO_NATIVE", None)
    gpu = Engine(device=dev, capacity=cs.CAPACITY, min_width=64, max_width=cs.WINDOW)
    gpu.warmup()
    mix = cs.record_launches(gpu)
    for i, (_, batch) in enumerate(batches):
        gpu.get_rate_limits(batch, now_ms=cs.NOW + i * 50)
    del gpu
    torch.cuda.empty_cache()
    kern = dk.make_table(cs.CAPACITY, dev)
    captured = []
    for fmt in cs.FORMATS:
        sel = [g for g in mix["captured"] if g["fmt"] == fmt]
        if not sel:
            continue
        stims = []
        for g in sel:
            kern[torch.from_numpy(g["slots"]).to(dev)] = g["rows"].to(dev)
            stims.append((*cs.staged(fmt, g["stacked"], cs.CAPACITY, dev), g["now"]))
        captured.append(dict(fmt=fmt, groups=len(sel), **timed(cs.FORMATS[fmt], stims, True)))
    del kern
    torch.cuda.empty_cache()
    return dict(shapes=recs, captured=captured, edge_c1_equal=edge)


def _engine(cs, dev, windows):
    """Phase 3's stream through the tree's Engine on the card."""
    from gubernator_tpu_torch.models.engine import Engine
    from gubernator_tpu_torch.ops import rows as rowk

    batches, key_cfg = cs.request_stream(0, windows)
    os.environ.pop("GUBER_NO_NATIVE", None)
    gpu = Engine(device=dev, capacity=cs.CAPACITY, min_width=64, max_width=cs.WINDOW)
    gpu.warmup()
    inj = {"calls": 0, "rows": 0, "s": 0.0}

    def timed(inject, _fn=gpu._apply_inject_rows):
        if inject is None or len(inject) == 0:
            return _fn(inject)
        t0 = time.perf_counter()
        out = _fn(inject)
        inj["s"] += time.perf_counter() - t0
        inj["calls"] += 1
        inj["rows"] += len(inject)
        return out

    gpu._apply_inject_rows = timed
    rowk.reset_launch_counts()
    waits0 = gpu._inject.waits
    gpu_s = seed_s = 0.0
    n_req = seeds = 0
    for i, (keys, batch) in enumerate(batches):
        now = cs.NOW + i * 50
        t = time.perf_counter()
        gpu.get_rate_limits(batch, now_ms=now)
        gpu_s += time.perf_counter() - t
        n_req += len(batch)
        for req in cs.lone_requests(keys, key_cfg):
            t = time.perf_counter()
            gpu.seed_mirror(req.hash_key())
            seed_s += time.perf_counter() - t
            seeds += 1
            for j in range(3):
                if gpu.decide_native_single(req, now_ms=now + 1 + j) is None:
                    gpu.get_rate_limits([req], now_ms=now + 1 + j)
    torch.cuda.synchronize()
    waits = gpu._inject.waits - waits0
    del gpu
    torch.cuda.empty_cache()
    return dict(row_launches=dict(rowk.launch_counts), inject_staging_waits=waits,
                inject_calls=inj["calls"], inject_rows=inj["rows"],
                inject_apply_us=inj["s"] / max(inj["calls"], 1) * 1e6,
                seed_mirror_us=seed_s / max(seeds, 1) * 1e6, decisions_per_s=n_req / gpu_s)


def _cold_rows(cs, dev):
    """The sharded row kernels and the single-table gather, L2 flushed
    before every launch."""
    from gubernator_tpu_torch.ops import rows as rowk

    flush = cs.l2_flush(dev)
    recs = []
    rng = np.random.default_rng(12)
    R, S = cs.SHARD_GEOMS[0]
    kern = cs.sharded_table(R, S, 13, dev)
    plain = kern.clone()
    for m in cs.SHARD_M:
        stims = [cs.sharded_rows_stimulus(rng, R, S, cs.SHARD_ROWS, m, dev)
                 for _ in range(cs.ROW_STIMULI)]
        floor = (cs.profiled_ms(lambda i: rowk.floor_cuda(0, m, R * S), 32, "empty_kernel")
                 if hasattr(rowk, "floor_cuda") else None)
        for name, kname, run_k, _run_p, run_lib, _b in cs.sharded_row_runs(kern, plain, stims):
            recs.append(dict(kernel=name, m=m, floor_ms=floor,
                             ms=cs.profiled_ms(run_k, 32, kname, flush_each=flush),
                             library_device_ms=cs.profiled_ms(run_lib, 32, flush_each=flush)))
    del kern, plain
    torch.cuda.empty_cache()

    C = cs.CAPACITY
    kern = cs.populate_table(C, 5, dev)
    for m in (1, 64):
        stims = [cs.gather_stimulus(rng, C, m, dev) for _ in range(cs.ROW_STIMULI)]
        floor = (cs.profiled_ms(lambda i: rowk.floor_cuda(0, m, 1), 32, "empty_kernel")
                 if hasattr(rowk, "floor_cuda") else None)
        recs.append(dict(kernel="gather_rows", form="device", m=m, floor_ms=floor, ms=cs.profiled_ms(
            lambda i: rowk.gather_rows_cuda(kern, stims[i % len(stims)]), 32, "gather_kernel",
            flush_each=flush)))
    recs += _pinned_gather(cs, rowk, kern, rng, flush)
    recs += _pinned_inject(cs, rowk, kern, rng, flush)
    del kern
    torch.cuda.empty_cache()
    return recs


def _pinned_floor(cs, rowk, name, m):
    """Device ms of the empty kernel on the pinned launch's grid (and with
    its parameter block), where the tree has one."""
    if not hasattr(rowk, "pinned_floor_cuda"):
        return None
    return cs.profiled_ms(lambda i: rowk.pinned_floor_cuda(0, name, m), 32, "empty")


def _pinned_gather(cs, rowk, kern, rng, flush):
    """The pinned gather as the tree's engine calls it (gather_rows_pinned
    where the tree has it, else gather_rows_cuda on page-locked operands)
    at the class edges, cold: device ms per launch, the round trip
    (launch, one wait, the rows read) on the host clock, the library call
    state[slot, :7].tolist() timed the same ways, the floor."""
    C = kern.shape[0]
    k = cs.ROW_STIMULI
    recs = []
    for m in cs.PINNED_GATHER_M:
        vals = [cs.gather_stimulus(rng, C, m, "cpu").numpy() for _ in range(k)]
        slots = [torch.from_numpy(v).pin_memory() for v in vals]
        out = torch.empty((rowk.GATHER_FIELDS, m), dtype=torch.int64, pin_memory=True)
        out_np = out.numpy()
        if hasattr(rowk, "gather_rows_pinned"):
            def launch(i):
                rowk.gather_rows_pinned(kern, slots[i % k], out, m)
        else:
            def launch(i):
                rowk.gather_rows_cuda(kern, slots[i % k], out)

        def round_trip(i):
            launch(i)
            rowk.sync_stream(0)
            return out_np.tolist()

        idx = [torch.from_numpy(v.astype(np.int64).clip(0, C - 1)).to(kern.device) for v in vals]
        if m == 1:
            ints = [int(i.item()) for i in idx]
            run_lib = lambda i: kern[ints[i % k], :7].tolist()  # noqa: E731
        else:
            run_lib = lambda i: kern[idx[i % k], :7].tolist()  # noqa: E731
        lib = dict(library_device_ms=cs.profiled_ms(run_lib, 32, flush_each=flush),
                   library_round_trip_ms=cs.host_us(run_lib, 2000) / 1e3)
        recs.append(dict(kernel="gather_rows", form="pinned", m=m,
                         floor_ms=_pinned_floor(cs, rowk, "gather_rows", m),
                         ms=cs.profiled_ms(launch, 32, "gather_kernel", flush_each=flush),
                         round_trip_ms=cs.host_us(round_trip, 2000) / 1e3, **lib))
    return recs


def _pinned_inject(cs, rowk, kern, rng, flush):
    """The pinned inject as the tree's engine calls it (InjectStaging) at
    the class edges, cold: device ms per launch of rows already in the
    staging (all it runs on the device, a copy up included), the round trip (rows copied in, launched, one wait) on the host
    clock, the library call torch.from_numpy(a).to(dev) + index_copy_ timed
    the same ways, the floor; where the tree has the copy form, both the
    mapped and the copy form at every m, and the copy up alone."""
    C, dev = kern.shape[0], kern.device
    k = cs.ROW_STIMULI
    staging = rowk.InjectStaging.allocate(max(cs.PINNED_INJECT_M), dev)
    plain = torch.empty_like(kern)
    forms = hasattr(rowk, "copy_min")
    recs = []
    for m in cs.PINNED_INJECT_M:
        host = [cs.inject_stimulus(rng, C, m, "cpu").numpy() for _ in range(k)]
        lib_in = [cs.index_copy_rows(torch.from_numpy(a).to(dev), C) for a in host]

        def run_lib(i):
            torch.from_numpy(host[i % k]).to(dev)
            plain.index_copy_(0, *lib_in[i % k])
            rowk.sync_stream(0)

        def launch(i):
            staging.launch(kern, m)

        def round_trip(i):
            staging.inject(kern, host[i % k])
            rowk.sync_stream(0)

        lib = dict(library_device_ms=cs.profiled_ms(run_lib, 32, flush_each=flush),
                   library_round_trip_ms=cs.host_us(run_lib, 2000) / 1e3)
        staging.free()[:m] = host[0]
        rec = dict(kernel="inject_rows", form="pinned", m=m,
                   floor_ms=_pinned_floor(cs, rowk, "inject_rows", m),
                   ms=cs.profiled_ms(launch, 32, flush_each=flush),
                   round_trip_ms=cs.host_us(round_trip, 2000) / 1e3, **lib)
        if forms:
            rec["picks"] = rowk.pinned_form("inject_rows", m)
            for form in ("mapped", "copy"):
                rec[f"{form}_ms"] = cs.profiled_ms(
                    lambda i: cs.inject_form(kern, staging, m, form), 32, flush_each=flush)
            rec["copy_up_ms"] = cs.profiled_ms(
                lambda i: staging.scratch[:m].copy_(staging.rows[:m], non_blocking=True), 32,
                flush_each=flush)
            torch.cuda.synchronize()
        recs.append(rec)
    del plain
    return recs


def _median_us(cs, fn, calls=50, runs=7):
    """Median over `runs` runs of the mean host microseconds of `calls` calls."""
    return float(np.median([cs.host_us(fn, calls) for _ in range(runs)]))


def _store(cs, dev):
    """The Store path and the host reads through the tree's Engine."""
    import dataclasses

    from gubernator_tpu_torch.models.engine import Engine
    from gubernator_tpu_torch.store import MockStore

    batches, key_cfg = cs.request_stream(0, cs.STORE_WINDOWS)
    store = MockStore()
    store.data.update((b.key, dataclasses.replace(b)) for b in cs.held_buckets(0, key_cfg))
    os.environ.pop("GUBER_NO_NATIVE", None)
    gpu = Engine(device=dev, capacity=cs.CAPACITY, store=store, min_width=64,
                 max_width=cs.WINDOW)
    gpu.warmup()
    calls = []

    def timed(slots, _fn=gpu._gather_slots):
        t0 = time.perf_counter()
        out = _fn(slots)
        calls.append((len(slots), time.perf_counter() - t0))
        return out

    gpu._gather_slots = timed
    n_req, t = 0, time.perf_counter()
    for i, (_keys, batch) in enumerate(batches):
        gpu.get_rate_limits(batch, now_ms=cs.SNAP_NOW + i * 50)
        n_req += len(batch)
    store_s = time.perf_counter() - t
    del gpu._gather_slots
    keys = [k for k, _ in sorted(gpu.directory.items())[:cs.HOST_READ_KEYS]]
    rng = np.random.default_rng(14)
    alone = {}
    for m in (64, 1024, cs.WINDOW):
        sets = [rng.integers(0, cs.CAPACITY, m).astype(np.int32) for _ in range(16)]
        alone[m] = _median_us(cs, lambda i: gpu._gather_slots(sets[i % 16]))
    rec = dict(decisions_per_s=n_req / store_s, gather_calls=len(calls),
               gather_slots=sum(n for n, _ in calls),
               gather_us=sum(s for _, s in calls) / max(len(calls), 1) * 1e6,
               rows_for_keys_keys=len(keys),
               rows_for_keys_us=_median_us(cs, lambda i: gpu.rows_for_keys(keys), calls=20),
               gather_slots_alone_us=alone)
    del gpu
    torch.cuda.empty_cache()
    return rec


def _span_ms(fn, iters, substr, flush):
    """Mean device milliseconds from the start of a call's first kernel whose
    name holds `substr` to the end of its last (torch.profiler's kernel
    timestamps), over `iters` calls, the L2 flushed before each: the span
    counts the gaps between a call's launches, which the sum of their
    device times leaves out. None when the trace does not split evenly."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            flush()
            fn(i)
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events()
                 if substr in e.name and e.device_type == DeviceType.CUDA),
                key=lambda e: e.time_range.start)
    if not ev or len(ev) % iters:
        return None
    n = len(ev) // iters
    return float(np.mean([ev[k * n + n - 1].time_range.end - ev[k * n].time_range.start
                          for k in range(iters)])) / 1e3


def _probe(cs, dev):
    """The tree's probe_cuda at phase 8a's widths, cold, with its floor,
    wrapper call and host split."""
    from gubernator_tpu_torch.ops import devdir as ddk

    C = cs.CAPACITY
    flush = cs.l2_flush(dev)
    fk, tk, solid = cs.devdir_columns(3, C, 1001, dev)
    rng = np.random.default_rng(15)
    k = ddk._kernels or ddk._load()
    recs = []
    for W in cs.PROBE_W:
        hs = [cs.probe_hashes(rng, fk, solid, W) for _ in range(16)]
        pk = torch.zeros((9, W), dtype=torch.int64, device=dev)
        slot = torch.empty(W, dtype=torch.int32, device=dev)
        fresh, retry = (torch.empty(W, dtype=torch.bool, device=dev) for _ in range(2))
        sc = ddk._probe_scratch(0, C, W, fk)
        for evict in (True, False):
            seq = [2000]

            def run_k(i):
                seq[0] += 1
                if evict:
                    ddk.probe_cuda(fk, tk, hs[i % 16], seq[0], pk, (None, None, retry))
                else:
                    ddk.probe_cuda(fk, None, hs[i % 16], 0, None, (slot, fresh, retry))

            ptrs = [h.data_ptr() for h in hs]
            fixed = (fk.data_ptr(), tk.data_ptr() if evict else None, C)
            outs = ((sc.lanes.data_ptr(), None, None, retry.data_ptr(), pk.data_ptr())
                    if evict else (sc.lanes.data_ptr(), slot.data_ptr(), fresh.data_ptr(),
                                   retry.data_ptr(), None))
            stream = k.stream(0)

            def entry(i):  # the ctypes call alone, its operands ready
                sc.tag += 1
                seq[0] += 1
                k.devdir_probe_launch(0, *fixed, ptrs[i % 16], W, seq[0], int(evict),
                                      sc.claims.data_ptr(), sc.tag, *outs, stream)

            rec = dict(kernel="probe_assign_evict" if evict else "probe_assign", C=C, W=W,
                       ms=cs.profiled_ms(run_k, 32, "probe_", per_call=True, flush_each=flush),
                       span_ms=_span_ms(run_k, 32, "probe_", flush),
                       call_ms=cs.event_ms(run_k, 64))
            if hasattr(ddk, "probe_floor_cuda"):
                grid = ddk.probe_grid(0, W, evict)
                rec.update(grid=grid[0] if isinstance(grid, tuple) else grid,
                           threads=grid[1] if isinstance(grid, tuple) else 256,
                           floor_ms=cs.profiled_ms(
                               lambda i: ddk.probe_floor_cuda(0, W, evict), 32, "_empty",
                               flush_each=flush),
                           barrier_ms=cs.profiled_ms(
                               lambda i: ddk.probe_floor_cuda(0, W, evict, True), 32, "_empty",
                               flush_each=flush))
            torch.cuda.synchronize()
            call_us = _median_us(cs, run_k, calls=2000, runs=3)
            torch.cuda.synchronize()
            entry_us = _median_us(cs, entry, calls=2000, runs=3)
            torch.cuda.synchronize()
            rec.update(host_call_us=call_us, host_entry_us=entry_us,
                       host_checks_us=call_us - entry_us)
            recs.append(rec)
    del fk, tk, flush
    torch.cuda.empty_cache()
    return recs


def _mesh(cs, dev):
    """The tree's cross-card all-reduce on one card (15a's shapes) and 15c's
    steps on a mesh engine of the tree."""
    from gubernator_tpu_torch.ops import ring as rk
    from gubernator_tpu_torch.parallel import make_mesh
    from gubernator_tpu_torch.parallel.sharded import ShardedEngine

    rng = np.random.default_rng(40)
    lo, hi = np.iinfo(np.int64).min, np.iinfo(np.int64).max
    recs = []
    for n in cs.MESH_N:
        streams = rk.entry_streams([dev.index] * n)
        for L in cs.MESH_L:
            xs = [torch.from_numpy(rng.integers(lo, hi, L, dtype=np.int64, endpoint=True)).to(dev)
                  for _ in range(n)]
            torch.cuda.synchronize()
            before = rk.launch_counts["ring_all_reduce_mesh"]
            got = rk.ring_all_reduce_mesh_cuda(xs)
            launches = rk.launch_counts["ring_all_reduce_mesh"] - before
            torch.cuda.synchronize()
            want = rk.ring_all_reduce_mesh_plain(xs)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise SystemExit(f"ab_rows: the mesh all-reduce at n={n} L={L} differs from "
                                 "its plain version")
            recs.append(dict(n=n, L=L, launches=launches,
                             **cs.mesh_ring_times(xs, streams, "ring_", launches)))
            del xs, got, want
    mesh = make_mesh(n_shards=cs.SHARDS, devices=[dev] * cs.SHARDS)
    me = ShardedEngine(mesh=mesh, collectives="ring", capacity_per_shard=cs.SHARD_ROWS,
                       min_width=64, max_width=cs.WINDOW)
    me.warmup()
    glob = {}
    cs.mesh_global(0, me, glob, "", count_check=False)
    g = glob["mesh_global"]
    del me
    torch.cuda.empty_cache()
    return dict(ring=recs, step={k: g[k] for k in (
        "step_ms", "steady_step_ms", "first_step_ms", "psum_steady_step_ms",
        "psum_first_step_ms", "launches")})


PARTS = ("decide", "rows", "engine", "cold_rows", "store", "probe", "mesh")


def child(tree: str, windows: int, parts=PARTS) -> int:
    """Measure the tree this process runs in (its root is sys.path[0])."""
    from gubernator_tpu_torch.ops import _build, rows as rowk

    if not os.path.abspath(rowk.__file__).startswith(tree + os.sep):
        raise SystemExit(f"ab_rows: imported {rowk.__file__}, not the tree {tree}")
    cs = _smoke()
    dev = torch.device("cuda", 0)
    cs.SMI = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True, text=True,
                            check=True).stdout.strip().splitlines()[0]
    _build.build()
    rec = dict(tree=tree, card=cs.SMI)
    if "decide" in parts:
        rec["decide"] = _decide(cs, dev)
    if "rows" in parts:
        rec["rows"], rec["bench_rows"] = _rows(cs, dev)
    if "engine" in parts:
        engine = _engine(cs, dev, windows)
        glob = {}
        cs.phase_global(0, dev, glob)
        for k in ("step_ms", "steady_step_ms", "first_step_ms"):
            engine[f"global_{k}"] = glob["global"][k]
        rec["engine"] = engine
    if "cold_rows" in parts:
        rec["cold_rows"] = _cold_rows(cs, dev)
    if "store" in parts:
        rec["store"] = _store(cs, dev)
    if "probe" in parts:
        rec["probe"] = _probe(cs, dev)
    if "mesh" in parts:
        rec["mesh"] = _mesh(cs, dev)
    print(json.dumps(rec), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="checkout roots, in the order to run")
    ap.add_argument("--windows", type=int, default=100)
    ap.add_argument("--parts", nargs="+", choices=PARTS, default=list(PARTS))
    args = ap.parse_args(argv)
    trees = [os.path.abspath(t) for t in args.trees]
    if not torch.cuda.is_available():
        print("ab_rows: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for tree in trees:
        # this file by path, so that the child's package is the tree's
        code = ("import importlib.util as u, sys; s = u.spec_from_file_location("
                f"'ab_rows', {os.path.abspath(__file__)!r}); m = u.module_from_spec(s); "
                f"s.loader.exec_module(m); sys.exit(m.child({tree!r}, {args.windows}, "
                f"{tuple(args.parts)!r}))")
        r = subprocess.run([sys.executable, "-c", code], cwd=tree)
        if r.returncode:
            print(f"ab_rows: {tree} failed with exit code {r.returncode}", file=sys.stderr)
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
