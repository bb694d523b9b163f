"""The traced run's reduction: torch.profiler over the measured window,
exported as a Chrome trace and read back.

- busy_s: the union of the device's kernels, copies and sets inside the
  window span;
- device_ops: device seconds by operation name;
- idle_gaps: the window's device-idle time, each gap named by what the
  host was doing when it opened: the benchmark's innermost span and the
  CUDA runtime call then running ("python" when none ran).
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from bisect import bisect_right

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "portbench.window"


def spans(traced: bool):
    """A context manager a name: torch.profiler's record_function in a
    traced run (the spans the reduction names gaps by), else nothing."""
    if not traced:
        return lambda name: contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function


def profile():
    import torch
    from torch.profiler import ProfilerActivity

    return torch.profiler.profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def reduce(prof) -> dict:
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return reduce_events(events)


def _intervals(evs):
    return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   e["name"]) for e in evs)


def reduce_events(events) -> dict:
    spans = [e for e in events if e.get("ph") == "X"]
    win = [e for e in spans if e.get("name") == WINDOW]
    if not win:
        return {}
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = [iv for iv in _intervals(e for e in spans
                                   if e.get("cat") in DEVICE_CATS)
           if iv[1] > w0 and iv[0] < w1]
    ops = {}
    for a, b, name in dev:
        ops[name] = ops.get(name, 0.0) + (min(b, w1) - max(a, w0)) / 1e6
    # union of the device intervals, and the gaps between them
    busy = 0.0
    gaps = []
    cur = w0
    for a, b, _ in dev:
        a, b = max(a, w0), min(b, w1)
        if a > cur:
            gaps.append((cur, a - cur))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if w1 > cur:
        gaps.append((cur, w1 - cur))
    host = _intervals(e for e in spans if e.get("cat") == "user_annotation"
                      and e["name"].startswith("portbench.")
                      and e["name"] not in (WINDOW, "portbench.pull"))
    pulls = _intervals(e for e in spans if e.get("name") == "portbench.pull")
    runtime = _intervals(e for e in spans if e.get("cat") == "cuda_runtime")
    named = {}
    for t, dur in gaps:
        label = (_at(host, t) or _at(pulls, t) or WINDOW) + "/" + \
            (_at(runtime, t) or "python")
        named[label] = named.get(label, 0.0) + dur / 1e6
    return {
        "busy_s": busy / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "device_ops": ops,
        "idle_gaps": named,
    }


def _at(ivs, t):
    """The name of the interval in ivs (sorted, not nested) covering t."""
    i = bisect_right(ivs, (t, float("inf"), "")) - 1
    if i >= 0 and ivs[i][0] <= t < ivs[i][1]:
        return ivs[i][2]
    return None


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
