"""Tiny runs of a cell on the CPU with the kernels' plain versions: the
result line, the check, the faults it must catch, the control."""

import io
import json
import subprocess
import sys

import pytest

from portbench import cell, faults, peaks, trace
from portbench import run as runner

TINY = {"keys": 20_000, "capacity": 20_001, "pool_items": 1 << 20}


def tiny(workload="owner_10m.zipf", seed=11, seconds=1.0, trace_on=0,
         control=False):
    args = runner.parse(["--workload", workload, "--seed", str(seed),
                         "--seconds", str(seconds), "--trace", str(trace_on)])
    return runner.run(args, "cpu", TINY, control=control)


def test_tiny_run_meets_the_contract(capsys):
    r = tiny(seed=2 ** 33 + 1)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    bench = cell.load_benchmark()
    assert set(r["metrics"]) == {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        got = r["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and got["value"] > 0
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    assert list(r)[-1] == "checks"
    assert r["checks"]["mismatched_answers"]["value"] == 0
    out = io.StringIO()
    runner.emit(r, out)
    last = out.getvalue().strip().splitlines()[-1]
    assert json.loads(last)["correct"] is True
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-3:] == [
        f"check {k} {c['value']} limit {c['rule']} {c['limit']}"
        for k, c in r["checks"].items()]


@pytest.mark.parametrize("mix", sorted(
    p.stem for p in (cell.HERE / "traffic").glob("*.json")))
def test_every_mix_runs_tiny_and_correct(mix, monkeypatch):
    """Each traffic file as a cell of owner_10m, in BENCHMARK.json or not
    (a later PR adds a cell by an entry alone)."""
    bench = cell.load_benchmark()
    name = f"owner_10m.{mix}"
    if name not in {w["name"] for w in bench["workloads"]}:
        bench["workloads"].append({"name": name, "config": "owner_10m",
                                   "traffic": mix, "chips": 1, "why": mix})
    monkeypatch.setattr(cell, "load_benchmark", lambda: bench)
    r = tiny(name, seed=51)
    assert r["correct"] is True and r["attempted"] > 0
    assert r["checks"]["compared_answers"]["value"] >= 1000


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_planted_fault_is_not_correct(fault):
    with faults.FAULTS[fault]():
        r = tiny(seed=21)
    assert r["correct"] is False
    assert r["checks"]["mismatched_answers"]["value"] > 0


def test_an_entry_point_past_the_wrappers_stops_the_run(monkeypatch):
    """A service that decides through an engine entry point the harness
    does not wrap would decide at its own clock: the run stops."""
    from portbench.systems import owner

    monkeypatch.setattr(owner.System, "_wrap", lambda self, eng: None)
    with pytest.raises(RuntimeError, match="wrapped columnar entry"):
        tiny(seed=23)


def test_the_control_fails_the_check():
    r = tiny("owner_10m.zipf", seed=31, control=True)
    assert r["correct"] is True
    assert r["control"]["mismatched_answers"]["value"] > 0


def test_traced_run_reports_per_layer_metrics():
    r = tiny(seed=41, trace_on=1)
    bench = cell.load_benchmark()
    names = {m["name"] for m in cell.metrics_of(bench, "owner_10m.zipf",
                                                "per_layer")}
    # host readings are there; a CPU run has no device trace to read
    assert {"pull_p95_ms", "prep_ns_per_decision",
            "roundtrip_ns_per_decision", "leftover_share"} <= set(r["metrics"])
    assert set(r["metrics"]) <= names
    assert r["correct"] is True


def test_no_card_no_result():
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "owner_10m.zipf", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=cell.ROOT, capture_output=True,
                       text=True, timeout=120,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_bytes_per_lane_and_roofline():
    assert peaks.bytes_per_lane() == 232
    # 1e6 lanes in the time 232 MB take at 3.35 TB/s: the whole roofline
    assert peaks.roofline_share(10 ** 6, 232e6 / 3.35e12) == pytest.approx(100)
    read = cell.reader("kernels_roofline")
    from types import SimpleNamespace as NS
    assert read(NS(trace=None, decisions=10)) is None
    run = NS(decisions=1000, trace={"device_ops": {
        "void decide_kernel_window<1>": 1e-5, "Memcpy HtoD": 1.0}})
    assert read(run) == pytest.approx(100 * 1000 * 232 / 3.35e12 / 1e-5)


def test_trace_reduction_busy_and_gaps():
    ev = [
        {"ph": "X", "name": trace.WINDOW, "cat": "user_annotation",
         "ts": 0, "dur": 100},
        {"ph": "X", "name": "portbench.submit", "cat": "user_annotation",
         "ts": 0, "dur": 30},
        {"ph": "X", "name": "cudaLaunchKernel", "cat": "cuda_runtime",
         "ts": 5, "dur": 2},
        {"ph": "X", "name": "k", "cat": "kernel", "ts": 10, "dur": 10},
        {"ph": "X", "name": "k", "cat": "kernel", "ts": 15, "dur": 10},
        {"ph": "X", "name": "m", "cat": "gpu_memcpy", "ts": 50, "dur": 10},
    ]
    r = trace.reduce_events(ev)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(25e-6)
    assert r["device_ops"] == {"k": pytest.approx(20e-6),
                               "m": pytest.approx(10e-6)}
    assert r["idle_gaps"]["portbench.submit/python"] == pytest.approx(35e-6)
    assert r["idle_gaps"]["portbench.window/python"] == pytest.approx(40e-6)
