"""A/B of the row wrappers and the main path's inject between checkouts, on one card.

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
- chip_smoke's phase-3 stream (--windows client batches and their lone
  requests) through TREE's Engine on the card, without the CPU twin:
  host microseconds per Engine._apply_inject_rows call that had rows,
  seed_mirror microseconds, decisions per second.

Prints the card's line (nvidia-smi name, power limit), then one JSON line
per tree. Needs one card.
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


def _engine(cs, dev, windows):
    """Phase 3's stream through the tree's Engine on the card."""
    from gubernator_tpu_torch.models.engine import Engine

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
    del gpu
    torch.cuda.empty_cache()
    return dict(inject_calls=inj["calls"], inject_rows=inj["rows"],
                inject_apply_us=inj["s"] / max(inj["calls"], 1) * 1e6,
                seed_mirror_us=seed_s / max(seeds, 1) * 1e6, decisions_per_s=n_req / gpu_s)


def child(tree: str, windows: int) -> int:
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
    recs, probe = _rows(cs, dev)
    rec = dict(tree=tree, card=cs.SMI, rows=recs, bench_rows=probe,
               engine=_engine(cs, dev, windows))
    print(json.dumps(rec), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="checkout roots, in the order to run")
    ap.add_argument("--windows", type=int, default=100)
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
                f"s.loader.exec_module(m); sys.exit(m.child({tree!r}, {args.windows}))")
        r = subprocess.run([sys.executable, "-c", code], cwd=tree)
        if r.returncode:
            print(f"ab_rows: {tree} failed with exit code {r.returncode}", file=sys.stderr)
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
