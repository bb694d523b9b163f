"""The plain versions of the row kernels (ops/rows.py) against the JAX
package, bit for bit, and their CUDA wrappers' contracts.

- inject_rows and gather_rows against the JAX engine's `_inject_rows` and
  `_gather_rows` (models/engine.py:74, :86), fed with `_apply_inject_rows`'s
  column casts (:1123-:1143: slot, algo and status through int32), on lanes
  below 0, at and past C, and with algo/status beyond int32.
- gather_rows into a caller-given `out` (the form the engine's lone path
  uses on the card, there with page-locked buffers) against the same JAX
  function at the clamped slots.
- the shared launch path's checks (ops/_launch.py), which run before any
  library is loaded: they refuse CPU tables and a wrong card, dtype, shape
  or contiguity; its page-lock predicate refuses ordinary CPU tensors.
- row_bump against a numpy statement of the row-access probe of
  scripts/bench_pallas_rows.py (`t[s] += 1` on distinct rows, out =
  `s[0]`) on a 4096 x 128 table. The Pallas kernel itself cannot run here:
  it is defined inside that script's main() at CAP = 10M rows with TPU
  memory spaces (ANY, SMEM, DMA semaphores) and no interpret switch. The
  kernel in csrc/rows.cu is held to the plain version on the card by
  chip_smoke.py.

Integers throughout: the tolerance is zero.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu_torch import bench_rows
from gubernator_tpu_torch.ops import _launch, rows


def _jax_inject(table, inject):
    """The JAX package's _apply_inject_rows column casts into _inject_rows."""
    from gubernator_tpu.models import engine as jeng_mod

    def col(f, dt=np.int64):
        return jnp.asarray(inject[:, f].astype(dt))

    return np.asarray(jeng_mod._inject_rows(
        jnp.asarray(table), col(0, np.int32), col(1, np.int32), col(2), col(3),
        col(4), col(5), col(6), col(7, np.int32)))


@pytest.mark.parametrize("C,m", [(64, 1), (64, 17), (4096, 64), (4096, 1000)])
def test_inject_rows_matches_jax(C, m):
    rng = np.random.RandomState(C + m)
    table = rng.randint(-(1 << 40), 1 << 40, (C, 8)).astype(np.int64)
    inject = rng.randint(-(1 << 62), 1 << 62, (m, 8)).astype(np.int64)
    # distinct slots, some dropped: -1, -7, C, C + 9
    pool = np.concatenate([np.arange(C), [-1, -7, C, C + 9]])
    inject[:, 0] = rng.choice(pool, m, replace=False)
    inject[:m // 2, 1] = rng.randint(0, 2, m // 2)  # mostly real algo codes
    want = _jax_inject(table, inject)
    got = torch.from_numpy(table.copy())
    rows.inject_rows(got, torch.from_numpy(inject))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("C,m", [(64, 1), (64, 50), (4096, 4096)])
def test_gather_rows_matches_jax(C, m):
    from gubernator_tpu.models import engine as jeng_mod

    rng = np.random.RandomState(C * 3 + m)
    table = rng.randint(-(1 << 40), 1 << 40, (C, 8)).astype(np.int64)
    slot = rng.randint(-3, C + 5, m).astype(np.int32)
    slot[:1] = C  # at least one past the table
    want = np.stack([np.asarray(c) for c in
                     jeng_mod._gather_rows(jnp.asarray(table), jnp.asarray(slot))])
    got = rows.gather_rows(torch.from_numpy(table), torch.from_numpy(slot))
    assert got.shape == (7, m) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("C", [1, 9, 4096])
def test_gather_rows_into_out_matches_jax(C):
    """slots -1, 0, C-1, C and C + 8 (clamped to [0, C-1]), written into a
    caller-given out whose earlier contents must not show through."""
    from gubernator_tpu.models import engine as jeng_mod

    rng = np.random.RandomState(C + 11)
    table = rng.randint(-(1 << 40), 1 << 40, (C, 8)).astype(np.int64)
    slot = np.array([-1, 0, C - 1, C, C + 8], np.int32)
    want = np.stack([np.asarray(c) for c in
                     jeng_mod._gather_rows(jnp.asarray(table), jnp.asarray(slot))])
    out = torch.full((rows.GATHER_FIELDS, len(slot)), -7, dtype=torch.int64)
    got = rows.gather_rows(torch.from_numpy(table), torch.from_numpy(slot), out)
    assert got is out
    np.testing.assert_array_equal(out.numpy(), want)


def test_launch_module_imports_without_cuda_or_nvcc(tmp_path):
    """The launch path and both wrappers' modules import, and their CPU
    dispatch runs, in a process that sees no card and has no nvcc: nothing
    is built or loaded before a launch."""
    code = (
        "import torch\n"
        "from gubernator_tpu_torch.ops import _build, _launch, ring, rows\n"
        "assert not torch.cuda.is_available()\n"
        "x = torch.arange(6, dtype=torch.int64).view(2, 3)\n"
        "assert ring.ring_all_reduce(x).tolist() == [[3, 5, 7], [3, 5, 7]]\n"
        "assert ring._kernels is None and rows._kernels is None\n"
        "assert _build._libs == {}\n"
        "print('ok')\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PATH=str(tmp_path),
               CUDA_HOME=str(tmp_path / "no-cuda"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120, cwd=os.path.dirname(os.path.dirname(
                              os.path.abspath(__file__))))
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def _fake_cuda(index=0, dtype=torch.int64, shape=(3, 8), contiguous=True):
    """What _launch.check reads of a tensor on a card, for a CPU-only test."""
    return SimpleNamespace(is_cuda=True, get_device=lambda: index, device=f"cuda:{index}",
                           dtype=dtype, ndim=len(shape), size=lambda i: shape[i],
                           shape=shape, is_contiguous=lambda: contiguous,
                           is_pinned=lambda: False)


@pytest.mark.parametrize("case,match", [
    (dict(index=1), "expected cuda:0"),
    (dict(dtype=torch.int32), "must be torch.int64"),
    (dict(shape=(3, 7)), r"must be \[n, 8\]"),
    (dict(shape=(24,)), r"must be \[n, 8\]"),
    (dict(contiguous=False), "contiguous"),
])
def test_launch_check_refuses(case, match):
    _launch.check(_fake_cuda(), "table", torch.int64, (None, 8), 0)  # takes it
    with pytest.raises(ValueError, match=match):
        _launch.check(_fake_cuda(**case), "table", torch.int64, (None, 8), 0)


def test_launch_check_refuses_unpinned_host_operands():
    """The pinned gather's operands: host memory, and page-locked. The
    entry point's address lookup refuses memory that is not page-locked;
    require_pinned, which names the operand then, refuses an ordinary CPU
    tensor and a tensor on a card; check(..., HOST) refuses the latter."""
    host = torch.zeros(4, dtype=torch.int32)
    _launch.check(host, "slots", torch.int32, (None,), _launch.HOST)  # host memory
    with pytest.raises(ValueError, match="host memory"):
        _launch.check(_fake_cuda(dtype=torch.int32, shape=(4,)), "slots", torch.int32,
                      (None,), _launch.HOST)
    for t in (host, torch.zeros((7, 1), dtype=torch.int64),
              _fake_cuda(dtype=torch.int32, shape=(4,))):
        with pytest.raises(ValueError, match="page-locked"):
            _launch.require_pinned(t, "slots")


def test_row_bump_matches_the_probe():
    rng = np.random.RandomState(5)
    N, B = 4096, 512
    table = rng.randint(-(1 << 31), 1 << 31, (N, 128), dtype=np.int64).astype(np.int32)
    table[:8] = np.iinfo(np.int32).max  # wraps to INT32_MIN
    for _ in range(3):
        s = rng.choice(N, B, replace=False).astype(np.int32)
        s[:2] = [3, 7]
        want = table.copy()
        want[s] += np.int32(1)
        got = torch.from_numpy(table.copy())
        out = rows.row_bump(got, torch.from_numpy(s))
        np.testing.assert_array_equal(got.numpy(), want)
        assert out.dtype == torch.int32 and out.tolist() == [int(s[0])]
        table = want


def test_row_bump_needs_distinct_slots():
    table = torch.zeros((16, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="distinct"):
        rows.row_bump(table, torch.tensor([1, 2, 1], dtype=torch.int32))
    rows.row_bump(table, torch.tensor([3, 20, -1], dtype=torch.int32))
    assert int(table.sum()) == 128  # out-of-range slots are dropped


def test_cuda_wrappers_refuse_cpu_tensors():
    t = torch.zeros((4, 8), dtype=torch.int64)
    out = torch.zeros((7, 1), dtype=torch.int64)
    for call in (lambda: rows.inject_rows_cuda(t, t[:1]),
                 lambda: rows.gather_rows_cuda(t, torch.zeros(1, dtype=torch.int32)),
                 lambda: rows.gather_rows_cuda(t, torch.zeros(1, dtype=torch.int32), out),
                 lambda: rows.row_bump_cuda(torch.zeros((4, 128), dtype=torch.int32),
                                            torch.zeros(1, dtype=torch.int32))):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert all(v == 0 for v in rows.launch_counts.values())


def test_bench_rows_runs_on_the_cpu():
    rec = bench_rows.run(device="cpu", cap=4096, batch=64, target_s=0.01)
    assert rec["variant"] == "plain_row_bump" and rec["device"] == "cpu"
    assert rec["iters"] >= 4 and rec["rows_per_s"] > 0
