"""Build the package's native sources and load them through ctypes.

Two kinds of source, each compiled on its own into a shared library with a
plain C interface:

- the CUDA kernels, csrc/<name>.cu (SOURCES), by nvcc for Hopper, with no
  PyTorch headers, so a build takes seconds:

      nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
           -Xcompiler -fPIC -o _build/lib<name>_<digest>.so csrc/<name>.cu

- the host key directory, native/keydir.cpp (NATIVE), by g++ against the
  running interpreter's Python.h (its one-pass window prep reads request
  objects; the symbols resolve from the interpreter at load time):

      g++ -O2 -shared -fPIC -std=c++17 -I<python include> \
          -o _build/libkeydir_<digest>.so native/keydir.cpp

The library name carries a digest of the source and the flags, so an edited
source rebuilds and an unchanged one is reused. A build writes a temporary
file and renames it into place, so processes that build at once never load a
half-written library. Builds happen at first use (or up front through
build()), never at import: the package imports on machines without nvcc or a
card. The output directory, _build/, is listed in .gitignore.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sysconfig
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("decide", "devdir", "ring", "rows")  # csrc/<name>.cu
NATIVE = ("keydir",)  # native/<name>.cpp
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX = "g++"

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME (default /usr/local/cuda), else from PATH."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.access(cand, os.X_OK):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels are built from csrc/ at first use")
    return found


def source_path(name: str) -> Path:
    if name in NATIVE:
        return _PKG / "native" / f"{name}.cpp"
    return CSRC / f"{name}.cu"


def _flags(name: str) -> Tuple[str, ...]:
    if name in NATIVE:
        return ("-O2", "-shared", "-fPIC", "-std=c++17",
                f"-I{sysconfig.get_paths()['include']}")
    return NVCC_FLAGS


def library_path(name: str) -> Path:
    src = source_path(name).read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(names: Sequence[str] = SOURCES + NATIVE) -> Dict[str, Tuple[str, float]]:
    """Compile every named source whose library is missing, all compilers
    started together. Returns {name: (compiler output, seconds until that
    compiler exited)} for what was built (ptxas prints registers and spills
    per kernel). Raises RuntimeError with the compiler's output when a
    build fails."""
    with _lock:
        return _build_locked(names)


def _build_locked(names: Sequence[str]) -> Dict[str, Tuple[str, float]]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    t0 = time.perf_counter()
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        compiler = GXX if name in NATIVE else nvcc_path()
        cmd = [compiler, *_flags(name), "-o", str(tmp), str(source_path(name))]
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot start {compiler} for {name}: {e}") from e
        jobs.append((name, so, tmp, proc))
    def finish(job):  # each compiler's own exit time, not its turn in a queue
        out, _ = job[3].communicate()
        return out, time.perf_counter() - t0

    with ThreadPoolExecutor(max(len(jobs), 1)) as pool:
        done = list(pool.map(finish, jobs))
    logs = {}
    failed = []
    for (name, so, tmp, proc), (out, secs) in zip(jobs, done):
        logs[name] = (out, secs)
        if proc.returncode != 0:
            failed.append(f"{proc.args[0]} failed for {source_path(name).name} "
                          f"(exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `name`, building it first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _build_locked([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
