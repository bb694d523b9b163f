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
    """What _launch.check and the wrappers read of a tensor on a card, for a
    CPU-only test."""
    return SimpleNamespace(is_cuda=True, get_device=lambda: index, device=f"cuda:{index}",
                           dtype=dtype, ndim=len(shape), size=lambda i: shape[i],
                           shape=shape, is_contiguous=lambda: contiguous,
                           is_pinned=lambda: False, data_ptr=lambda: 4096)


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


@pytest.mark.parametrize("N,B", [(4096, 512), (300, 300)])
def test_row_bump_into_out_matches_the_probe(N, B):
    """row_bump(table, slots, out): the probe's rows, and slots[0] written
    into the caller's i32[1] (the same tensor comes back), call after call."""
    rng = np.random.RandomState(N + B)
    table = rng.randint(-(1 << 31), 1 << 31, (N, 128), dtype=np.int64).astype(np.int32)
    table[:4] = np.iinfo(np.int32).max  # wraps to INT32_MIN
    got = torch.from_numpy(table.copy())
    out = torch.full((1,), -7, dtype=torch.int32)
    for _ in range(3):
        s = rng.choice(N, B, replace=False).astype(np.int32)
        table[s] += np.int32(1)
        assert rows.row_bump(got, torch.from_numpy(s), out) is out
        np.testing.assert_array_equal(got.numpy(), table)
        assert out.tolist() == [int(s[0])]


def _no_kernels(err):
    """A stand-in for the loaded rows library: every entry point returns
    `err` (1, cudaErrorInvalidValue, is what cudaHostGetDevicePointer gives
    for memory that is not page-locked) and launches nothing."""
    fail = lambda *a: err  # noqa: E731
    return SimpleNamespace(inject_rows_launch=fail, inject_rows_pinned_launch=fail,
                           row_bump_launch=fail, stream=lambda index: 0)


@pytest.mark.parametrize("call,match", [
    (lambda: rows.inject_rows_cuda(_fake_cuda(), _fake_cuda(dtype=torch.int32)),
     "inject rows must be torch.int64"),
    (lambda: rows.inject_rows_cuda(_fake_cuda(), _fake_cuda(shape=(3, 7))),
     r"inject rows must be \[n, 8\]"),
    (lambda: rows.inject_rows_cuda(_fake_cuda(), _fake_cuda(contiguous=False)),
     "inject rows must be contiguous"),
    (lambda: rows.inject_rows_cuda(_fake_cuda(), torch.zeros((2, 8), dtype=torch.int64)),
     "inject rows must be page-locked"),
    (lambda: rows.inject_rows_pinned(_fake_cuda(), torch.zeros((2, 8), dtype=torch.int64), 2,
                                     None),
     "inject rows must be page-locked"),
    (lambda: rows.inject_rows_pinned(_fake_cuda(dtype=torch.int32),
                                     torch.zeros((2, 8), dtype=torch.int64), 2, None),
     "table must be torch.int64"),
    (lambda: rows.InjectStaging(torch.zeros((4, 8), dtype=torch.int32), None),
     "inject staging must be torch.int64"),
    (lambda: rows.InjectStaging(torch.zeros((4, 7), dtype=torch.int64), None),
     r"inject staging must be \[n, 8\]"),
    (lambda: rows.InjectStaging(torch.zeros((4, 8), dtype=torch.int64), None).launch(
        _fake_cuda(), 5),
     "5 inject rows exceed the staging's 4"),
    (lambda: rows.row_bump_cuda(_fake_cuda(dtype=torch.int32, shape=(64, 128)),
                                _fake_cuda(dtype=torch.int32, shape=(4,)),
                                torch.zeros(1, dtype=torch.int32)),
     "out is on cpu, expected cuda:0"),
    (lambda: rows.row_bump_cuda(_fake_cuda(dtype=torch.int32, shape=(64, 128)),
                                _fake_cuda(dtype=torch.int32, shape=(4,)),
                                _fake_cuda(dtype=torch.int64, shape=(1,))),
     "out must be torch.int32"),
    (lambda: rows.row_bump_cuda(_fake_cuda(dtype=torch.int32, shape=(64, 128)),
                                _fake_cuda(dtype=torch.int32, shape=(4,)),
                                _fake_cuda(dtype=torch.int32, shape=(2,))),
     r"out must be \[1\]"),
    (lambda: rows.row_bump_cuda(_fake_cuda(dtype=torch.int32, shape=(64, 128)),
                                _fake_cuda(dtype=torch.int32, shape=(4,), contiguous=False)),
     "slots must be contiguous"),
])
def test_cuda_row_wrappers_refuse(monkeypatch, call, match):
    """With no card and no nvcc: inject_rows_cuda refuses inject rows of a
    wrong dtype, shape or contiguity, and host rows that are not
    page-locked (the entry point's address lookup fails, and the wrapper
    names the operand), as inject_rows_pinned does, which also checks the
    table; InjectStaging refuses a buffer of a wrong dtype or width, and a
    launch of more rows than it holds;
    row_bump_cuda refuses an out on the CPU or of a wrong dtype or shape,
    and strided slots. Nothing is counted."""
    monkeypatch.setattr(rows, "_kernels", _no_kernels(1))
    rows.reset_launch_counts()
    with pytest.raises(ValueError, match=match):
        call()
    assert all(v == 0 for v in rows.launch_counts.values())
    assert all(v == 0 for v in rows.pinned_counts.values())


class _Event:
    """The staging's event on the CPU: its synchronize() is where the card
    would have finished the last launch, so it checks that the rows that
    launch read were not rewritten before it."""

    def __init__(self):
        self.cuda_event = 1
        self.waits = 0
        self.launched = None  # (rows view, their content at the launch)

    def synchronize(self):
        self.waits += 1
        if self.launched is not None:
            view, seen = self.launched
            np.testing.assert_array_equal(view, seen)  # not rewritten in flight
            self.launched = None


def _cpu_staging(monkeypatch, R):
    """An InjectStaging over an ordinary CPU buffer whose launches run the
    plain inject and are recorded as (rows, first slot, buffer address)."""
    done = _Event()
    st = rows.InjectStaging(torch.zeros((R, 8), dtype=torch.int64), done)
    launches = []

    def launch(state, buf, m, ev):
        assert ev is done and done.launched is None, "rows handed out before the wait"
        view = buf.numpy()[:m]
        done.launched = (view, view.copy())
        launches.append((m, int(buf[0, 0]), buf.data_ptr()))
        rows.inject_rows_plain(state, buf[:m])

    monkeypatch.setattr(rows, "inject_rows_pinned", launch)
    return st, done, launches


@pytest.mark.parametrize("m", [5, 8, 19])
def test_inject_staging_reuse_and_chunks(monkeypatch, m):
    """The engine's staging rule, with an R = 8 row buffer: rows written
    into free() are launched in place (launch(state, m): one launch from
    the buffer); inject(state, rows) copies any array in, cut into chunks of R rows (m = 19: 8, 8, 3),
    each chunk launched from the buffer; free() waits on the event only
    when a launch is outstanding, and no launch's rows are rewritten before
    that wait. The table equals the plain inject of the same rows."""
    R, C = 8, 64
    st, done, launches = _cpu_staging(monkeypatch, R)
    rng = np.random.RandomState(m)
    inject = rng.randint(-(1 << 40), 1 << 40, (m, 8)).astype(np.int64)
    inject[:, 0] = rng.choice(C + 4, m, replace=False) - 2  # distinct; -2, -1, C, C + 1 drop
    table = torch.from_numpy(rng.randint(-9, 9, (C, 8)).astype(np.int64))
    want = table.clone()
    rows.inject_rows_plain(want, torch.from_numpy(inject))
    assert st.free() is st.rows_np and done.waits == 0  # nothing in flight yet
    st.inject(table, inject)
    sizes = [min(R, m - i) for i in range(0, m, R)]
    assert [n for n, _, _ in launches] == sizes
    assert all(addr == st.rows.data_ptr() for _, _, addr in launches)
    assert [s for _, s, _ in launches] == [int(inject[i, 0]) for i in range(0, m, R)]
    assert done.waits == len(sizes) - 1  # each later chunk waited for the one before
    torch.testing.assert_close(table, want, rtol=0, atol=0)
    if m <= R:  # the directory's way: rows written into free(), launched in place
        buf = st.free()
        assert done.waits == len(sizes)
        buf[:m] = inject[::-1]
        st.launch(table, m)
        assert len(launches) == len(sizes) + 1 and launches[-1][1] == int(inject[-1, 0])
        rows.inject_rows_plain(want, torch.from_numpy(inject[::-1].copy()))
        torch.testing.assert_close(table, want, rtol=0, atol=0)


def test_ab_rows_refuses_without_a_card(capsys):
    """The A/B driver loads this checkout's chip_smoke.py by path, and with
    no card it exits 2 before it starts a child."""
    from gubernator_tpu_torch import ab_rows

    assert callable(ab_rows._smoke().timed_kernel)
    assert ab_rows.main(["."]) == 2
    assert "no CUDA device" in capsys.readouterr().err
