"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names; the reference loads nothing of the port."""

import ast
import subprocess
import sys

from portbench import cell
from portbench.run import FORBIDDEN

CODE = """
import sys
sys.path.insert(0, ".")
from portbench import run as r
args = r.parse(["--workload", "owner_10m.zipf", "--seed", "3", "--seconds",
                "0.5", "--trace", "0"])
r.run(args, "cpu", {"keys": 20000, "capacity": 20001, "pool_items": 1 << 20})
print(sorted({m.split(".")[0] for m in sys.modules}))
"""


def test_a_run_loads_no_jax_and_not_the_jax_package():
    p = subprocess.run([sys.executable, "-c", CODE], cwd=cell.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    top = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "gubernator_tpu_torch" in top
    assert not top & set(FORBIDDEN)


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_neither_jax_nor_the_jax_package():
    for path in (cell.HERE).rglob("*.py"):
        assert not _imports(path) & set(FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_port():
    for path in (cell.HERE / "references").glob("*.py"):
        assert _imports(path) <= {"__future__", "bisect", "numpy"}, path
