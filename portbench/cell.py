"""Finding a cell's parts by the names BENCHMARK.json gives them."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def find(bench: dict, workload: str):
    """(cell, configuration entry, configuration, traffic mix)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(ROOT / entry["file"]) as f:
        cfg = json.load(f)
    with open(HERE / "traffic" / f"{cell['traffic']}.json") as f:
        mix = json.load(f)
    return cell, entry, cfg, mix


def metrics_of(bench: dict, workload: str, kind: str) -> list:
    """The cell's metrics of one kind ("end_to_end" or "per_layer")."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def reader(metric: str):
    """metrics/<metric>.py's read(run) -> float or None."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def system(name: str):
    return importlib.import_module(f"portbench.systems.{name}")


def reference(name: str):
    return importlib.import_module(f"portbench.references.{name}")
