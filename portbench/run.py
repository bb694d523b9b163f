"""Run one cell of BENCHMARK.json once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (timed as setup_s, from the start of this script to the first
timed pull): the configuration's fleet and the traffic pool from the seed,
the system built and its keys restored through the program's restore path,
warm pulls through the timed path. The window: closed loop from one thread,
the next pull handed over as soon as the last is answered, for --seconds.
Then the program is freed and its answers to a sample of keys are compared
with the plain reference. The last line of standard output is one JSON
object; the numbers compared, each with its limit, are the last lines of
standard error and the result's last key.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from portbench import cell as cells  # noqa: E402
from portbench import check, generator, trace  # noqa: E402

WARM_PULLS = 4
# top-level module names that the process must not hold: the JAX package
# and JAX itself (compared whole: gubernator_tpu_torch is the port)
FORBIDDEN = ("jax", "jaxlib", "flax", "gubernator_tpu")
THREADS = 2


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class GcClock:
    """Collections by generation, and their seconds, while installed
    (gc.callbacks): the window's share of the interpreter's collector."""

    def __init__(self):
        self.count = [0, 0, 0]
        self.seconds = 0.0
        self._t = 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.count[info["generation"]] += 1
            self.seconds += time.perf_counter() - self._t

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "--id=0"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def run(args, device: str, overrides=None, control: bool = False) -> dict:
    """One run; returns the result object. `overrides` replaces
    configuration keys, and the mix's pool_items (the tests run a tiny
    fleet on the CPU); `control`
    adds, under "control", the same comparison made of the reference with
    exact per-key order broken, put in the program's place."""
    import torch

    bench = cells.load_benchmark()
    cell, entry, cfg, mix = cells.find(bench, args.workload)
    over = dict(overrides or {})
    pool_items = int(over.pop("pool_items", mix["pool_items"]))
    cfg = {**cfg, **over}
    traced = bool(args.trace)
    torch.set_num_threads(THREADS)

    marks = [("start", T0), ("imports", time.perf_counter())]
    fleet = generator.make_fleet(cfg, args.seed)
    pull = int(cfg["pull_items"])
    n_items = pull * -(-pool_items // pull)
    pool = generator.make_pool(mix, cfg, args.seed, n_items, fleet)
    served = check.Served(
        check.choose_sample(pool.ids, fleet.n, pull, int(cfg["run_items"]),
                            generator.sample_stream(args.seed))[pool.ids],
        pull)
    marks.append(("fleet and pool", time.perf_counter()))
    wall0 = int(time.time() * 1000)
    rows0 = generator.initial_rows(fleet, args.seed, wall0)
    system = cells.system(cfg["system"]).System(cfg, fleet, rows0, device,
                                               traced)
    marks.append(("restore and warm-up", time.perf_counter()))
    base = (wall0, time.perf_counter())

    def clock() -> int:
        return base[0] + int((time.perf_counter() - base[1]) * 1000)

    state = SimpleNamespace(pulls=0, decisions=0, errors=0, pull_ms=[],
                            pull_end=[])

    def one_pull(timed: bool):
        start = (state.pulls * pull) % len(pool.ids)
        t = clock()
        with span("portbench.fill"):
            got = system.fill(pool, start, start + pull)
        system.clock = t
        t0 = time.perf_counter()
        with span("portbench.pull"):
            system.serve(got)
        t1 = time.perf_counter()
        state.errors += served.record(start, got, t, system.b)
        state.pulls += 1
        if timed:
            state.pull_ms.append((t1 - t0) * 1e3)
            state.pull_end.append(t1)
            state.decisions += got
        return t1

    span = trace.spans(False)
    for _ in range(WARM_PULLS):
        one_pull(False)
    if device != "cpu":
        torch.cuda.synchronize()
    stage0 = system.stage_ns()
    left0 = system.leftover_items
    errors0 = state.errors
    prof = None
    if traced:
        span = trace.spans(True)
        prof = trace.profile()
        prof.__enter__()
    gc.collect()
    gc.freeze()
    t_first = time.perf_counter()
    setup_s = t_first - T0
    marks.append(("warm pulls", t_first))
    print("setup " + ", ".join(f"{n} {b - a:.3f} s" for (_, a), (n, b)
                               in zip(marks, marks[1:])), file=sys.stderr)
    deadline = t_first + args.seconds
    with GcClock() as gcc, span(trace.WINDOW):
        while one_pull(True) < deadline:
            pass
    t_end = time.perf_counter()
    if prof is not None:
        prof.__exit__(None, None, None)
    window_s = t_end - t_first
    ends = np.asarray(state.pull_end) - t_first
    quarters = [int(np.count_nonzero((ends >= window_s * q / 4)
                                     & (ends < window_s * (q + 1) / 4)))
                for q in range(4)]
    print(f"pulls by quarter of the window {quarters}; gc collections "
          f"by generation {gcc.count}, {gcc.seconds:.4f} s", file=sys.stderr)
    stage1 = system.stage_ns()
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        raise SystemExit(3)
    peak = (torch.cuda.max_memory_allocated(torch.device(device))
            if device != "cpu" else 0)
    run_data = SimpleNamespace(
        decisions=state.decisions, window_s=window_s, pull_ms=state.pull_ms,
        stage_ns={k: stage1[k] - stage0.get(k, 0) for k in stage1},
        leftover_items=system.leftover_items - left0,
        trace=trace.reduce(prof) if prof is not None else None)
    system.close()
    del system
    gc.unfreeze()
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()

    checks = check.compare(served, pool, fleet, rows0,
                           cells.reference(cfg["reference"]))
    correct = check.holds(checks)
    lost = (check.compare(served, pool, fleet, rows0,
                          cells.reference(cfg["reference"]),
                          lost_updates=True) if control else None)
    metrics = {}
    kinds = "per_layer" if traced else "end_to_end"
    for m in cells.metrics_of(bench, args.workload, kinds):
        if m["name"] == "decisions_per_s":
            v = state.decisions / window_s
        elif m["name"] == "setup_s":
            v = setup_s
        else:
            v = cells.reader(m["name"])(run_data)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device != "cpu"
                    else "cpu"),
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": state.decisions,
              "failed": state.errors - errors0, "metrics": metrics,
              "device": dev}
    if run_data.trace:
        dev["busy_s"] = run_data.trace["busy_s"]
        dev["window_s"] = run_data.trace["window_s"]
        result["breakdown"] = {
            "device_ops": trace.top(run_data.trace["device_ops"]),
            "idle_gaps": trace.top(run_data.trace["idle_gaps"])}
    if lost is not None:
        result["control"] = lost
    result["checks"] = checks
    return result


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def emit(result: dict, out=None) -> None:
    out = out or sys.stdout
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['rule']} {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result), file=out, flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    bench = cells.load_benchmark()
    chips = int(cells.find(bench, args.workload)[0]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"cards {chips} x {torch.cuda.get_device_name(0)}; cpus "
          f"{sorted(os.sched_getaffinity(0))}", flush=True)
    result = run(args, "cuda:0")
    print(f"card {card_line()}", flush=True)
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
