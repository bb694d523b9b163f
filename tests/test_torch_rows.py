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
- the pinned forms: the form each m takes at the by-value class edges
  and, for the inject, at the copy threshold, the form, the address-lookup
  flag, the event and the copy's scratch each wrapper hands its entry point
  (a recording stand-in for the library), the staging's reuse rule by
  form (a by-value launch leaves nothing pending, a mapped one or a copy
  is waited on), the chunks and forms of a staging's inject of 8192 and
  8193 rows, and the plain inject and gather, the oracles of every form,
  against the JAX functions at those edges with slots -1, C - 1 and C.
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
import re
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


def _cu_constant(const):
    """An integer constant of csrc/rows.cu, as the loaded library reports it."""
    with open(os.path.join(os.path.dirname(rows.__file__), "..", "csrc", "rows.cu")) as f:
        return int(re.search(rf"\b{const} = (\d+)", f.read()).group(1))


# the by-value limits (the largest size classes, the library's
# `by_value_max`) and the least m the inject copies up (its `copy_min`)
LIMITS = {"gather_rows": _cu_constant("kGatherValueMax"),
          "inject_rows": _cu_constant("kInjectValueMax")}
COPY_MIN = _cu_constant("kInjectCopyMin")


def _no_kernels(err):
    """A stand-in for the loaded rows library: every entry point returns
    `err` (1, cudaErrorInvalidValue, is what cudaHostGetDevicePointer gives
    for memory that is not page-locked) and launches nothing."""
    fail = lambda *a: err  # noqa: E731
    return SimpleNamespace(inject_rows_launch=fail, inject_rows_pinned_launch=fail,
                           row_bump_launch=fail, stream=lambda index: 0,
                           by_value_max=LIMITS, copy_min=COPY_MIN)


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
    (lambda: rows.InjectStaging(torch.zeros((4, 8), dtype=torch.int64), None).launch(
        _fake_cuda(), 3),
     "inject rows must be page-locked"),
    (lambda: rows.InjectStaging(torch.zeros((LIMITS["inject_rows"] + 1, 8), dtype=torch.int64),
                                None).launch(_fake_cuda(), LIMITS["inject_rows"] + 1),
     "inject rows must be page-locked"),
    (lambda: rows.InjectStaging(torch.zeros((COPY_MIN, 8), dtype=torch.int64), None,
                                _fake_cuda(shape=(COPY_MIN, 8))).launch(_fake_cuda(), COPY_MIN),
     "inject rows must be page-locked"),
    (lambda: rows.InjectStaging(torch.zeros((COPY_MIN, 8), dtype=torch.int64), None,
                                _fake_cuda(shape=(COPY_MIN - 1, 8))),
     rf"inject scratch must be \[{COPY_MIN}, 8\]"),
    (lambda: rows.InjectStaging(torch.zeros((COPY_MIN, 8), dtype=torch.int64), None,
                                torch.zeros((COPY_MIN, 8), dtype=torch.int64)),
     "inject scratch needs CUDA tensors"),
    (lambda: rows.inject_rows_pinned(_fake_cuda(), torch.zeros((COPY_MIN, 8), dtype=torch.int64),
                                     COPY_MIN, None, True, _fake_cuda(shape=(COPY_MIN - 1, 8))),
     f"a copy of {COPY_MIN} inject rows does not fit the scratch"),
    (lambda: rows.inject_rows_pinned(_fake_cuda(), torch.zeros((COPY_MIN, 8), dtype=torch.int64),
                                     COPY_MIN, None, True, _fake_cuda(index=1,
                                                                     shape=(COPY_MIN, 8))),
     f"a copy of {COPY_MIN} inject rows does not fit the scratch"),
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
    table; InjectStaging refuses a buffer of a wrong dtype or width, a
    scratch of another shape or off the card, a launch of more rows than it
    holds, and a launch in every form from a buffer that is not page-locked;
    the copy form refuses a scratch too small or on another card;
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
    plain inject and are recorded as (rows, first slot, buffer address).
    Every launch reports the mapped form, whose rows the card reads after
    the launch returns: the form the reuse rule guards."""
    done = _Event()
    st = rows.InjectStaging(torch.zeros((R, 8), dtype=torch.int64), done)
    launches = []

    def launch(state, buf, m, ev, checked, scratch):
        assert ev is done and done.launched is None, "rows handed out before the wait"
        assert scratch is None  # a staging made without one
        assert checked is False  # an ordinary CPU buffer: the entry looks it up
        view = buf.numpy()[:m]
        done.launched = (view, view.copy())
        launches.append((m, int(buf[0, 0]), buf.data_ptr()))
        rows.inject_rows_plain(state, buf[:m])
        return "mapped"

    monkeypatch.setattr(rows, "inject_rows_pinned", launch)
    return st, done, launches


@pytest.mark.parametrize("m", [5, 8, 19])
def test_inject_staging_reuse_and_chunks(monkeypatch, m):
    """The engine's staging rule for mapped launches, with an R = 8 row
    buffer: rows written into free() are launched in place (launch(state,
    m): one launch from the buffer); inject(state, rows) copies any array in, cut into chunks of R rows (m = 19: 8, 8, 3),
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


# ------------------------------------------- the pinned forms, by m alone

@pytest.mark.parametrize("name,m,form", [
    ("gather_rows", 1, "by_value"), ("gather_rows", 16, "by_value"),
    ("gather_rows", 64, "by_value"), ("gather_rows", 65, "mapped"),
    ("gather_rows", 4096, "mapped"), ("gather_rows", 8192, "mapped"),
    ("inject_rows", 1, "by_value"), ("inject_rows", 16, "by_value"),
    ("inject_rows", 17, "by_value"), ("inject_rows", 64, "by_value"),
    ("inject_rows", 65, "by_value"), ("inject_rows", 448, "by_value"),
    ("inject_rows", 449, "mapped"), ("inject_rows", COPY_MIN - 1, "mapped"),
    ("inject_rows", COPY_MIN, "copy"), ("inject_rows", 4096, "copy"),
    ("inject_rows", 8192, "copy"),
])
def test_pinned_form_at_class_edges(monkeypatch, name, m, form):
    """A pinned launch goes by value up to the largest size class of
    csrc/rows.cu (64 slots, 448 rows), which the library reports, and
    mapped above; an inject of the library's copy_min rows or more (a
    restore's 8192-row chunk among them) is copied up. By m alone."""
    assert LIMITS == {"gather_rows": 64, "inject_rows": 448}
    assert 448 < COPY_MIN <= 8192
    monkeypatch.setattr(rows, "_kernels", SimpleNamespace(by_value_max=LIMITS,
                                                          copy_min=COPY_MIN))
    assert rows.by_value_max(name) == LIMITS[name]
    assert rows.copy_min() == COPY_MIN
    assert rows.pinned_form(name, m) == form


def _recording_kernels():
    """A stand-in for the loaded rows library whose pinned entry points
    record their arguments and launch nothing."""
    calls = []

    def record(name):
        def entry(*args):
            calls.append((name, args))
            return 0
        return entry

    return calls, SimpleNamespace(gather_rows_pinned_launch=record("gather"),
                                  inject_rows_pinned_launch=record("inject"),
                                  stream=lambda index: 77, by_value_max=LIMITS,
                                  copy_min=COPY_MIN)


@pytest.mark.parametrize("m", [1, 16, 64, 65, 300])
def test_pinned_gather_passes_its_form(monkeypatch, m):
    """gather_rows_pinned (the engine's entry: checked = 1) and
    gather_rows_cuda on host operands (the public one: checked = 0) hand
    the entry point the form m picks, and count the launch under it;
    gather_rows_pinned refuses an m whose slots or rows do not fit its
    buffers, before any launch."""
    calls, fake = _recording_kernels()
    monkeypatch.setattr(rows, "_kernels", fake)
    rows.reset_launch_counts()
    state = _fake_cuda(shape=(100, 8))
    slot = torch.zeros(m, dtype=torch.int32)
    out = torch.zeros((7, m), dtype=torch.int64)
    rows.gather_rows_pinned(state, slot, out, m)
    assert rows.gather_rows_cuda(state, slot, out) is out
    by_value = m <= 64
    assert [c[0] for c in calls] == ["gather", "gather"]
    for (_, args), checked in zip(calls, (1, 0)):
        assert args == (0, 4096, 100, slot.data_ptr(), m, out.data_ptr(), 77, by_value, checked)
    form = "by_value" if by_value else "mapped"
    assert rows.launch_counts["gather_rows"] == rows.pinned_counts["gather_rows"] == 2
    assert rows.launch_counts[f"gather_rows_{form}"] == 2
    assert sum(rows.launch_counts[f"gather_rows_{f}"] for f in ("by_value", "mapped")) == 2
    for bad_slot, bad_out in ((slot[:m - 1], out), (slot, out.view(-1)[:7 * m - 1])):
        with pytest.raises(ValueError, match="does not fit"):
            rows.gather_rows_pinned(state, bad_slot, bad_out, m)
    assert len(calls) == 2


def _card_state(shape=(100, 8)):
    """A fake table on card 0 whose new_empty (the public copy form's
    scratch) records the shape it was asked for."""
    made = []
    state = _fake_cuda(shape=shape)

    def new_empty(shape):
        made.append(shape)
        return SimpleNamespace(shape=shape, get_device=lambda: 0, data_ptr=lambda: 8192)

    state.new_empty = new_empty
    return state, made


@pytest.mark.parametrize("m", [1, 16, 17, 448, 449, COPY_MIN - 1, COPY_MIN, 8192])
def test_pinned_inject_passes_its_form(monkeypatch, m):
    """inject_rows_pinned (the staging's entry) records the staging's event
    only after a mapped launch or a copy, hands on the staging's page-lock
    flag (checked = 1 for a page-locked staging, 0 else), the form's code
    (mapped 0, by value 1, copy 2) and, for the copy form, the scratch, and
    returns the form it launched; inject_rows_cuda on page-locked rows (the
    public entry: checked = 0) records none, and its copy form copies into
    a scratch of m rows allocated on the table's card. Each launch is
    counted under its form."""
    calls, fake = _recording_kernels()
    monkeypatch.setattr(rows, "_kernels", fake)
    rows.reset_launch_counts()
    state, made = _card_state()
    buf = torch.zeros((m, 8), dtype=torch.int64)
    form = "by_value" if m <= 448 else "copy" if m >= COPY_MIN else "mapped"
    code = {"mapped": 0, "by_value": 1, "copy": 2}[form]
    scratch = _fake_cuda(shape=(8192, 8))
    copy_ptr = 4096 if form == "copy" else None
    assert rows.inject_rows_pinned(state, buf, m, SimpleNamespace(cuda_event=55), True,
                                   scratch) == form
    rows.inject_rows_cuda(state, buf)
    assert made == ([(m, 8)] if form == "copy" else [])
    assert rows.inject_rows_pinned(state, buf, m, None, False, scratch) == form
    assert rows.inject_rows_pinned(state, buf, 0, None, True, scratch) is None
    want_done = None if form == "by_value" else 55
    assert [c for _, c in calls] == [
        (0, 4096, 100, buf.data_ptr(), m, 77, want_done, code, 1, copy_ptr),
        (0, 4096, 100, buf.data_ptr(), m, 77, None, code, 0, 8192 if copy_ptr else None),
        (0, 4096, 100, buf.data_ptr(), m, 77, None, code, 0, copy_ptr)]
    calls.clear()
    assert rows.launch_counts["inject_rows"] == rows.pinned_counts["inject_rows"] == 3
    assert rows.launch_counts[f"inject_rows_{form}"] == 3
    assert sum(rows.launch_counts[f"inject_rows_{f}"]
               for f in ("by_value", "mapped", "copy")) == 3
    st = rows.InjectStaging(buf, None, _fake_cuda(shape=(m, 8)))  # looked up at each launch
    assert st.checked is False
    st.launch(state, m)
    assert [c for _, c in calls] == [(0, 4096, 100, buf.data_ptr(), m, 77, None, code, 0,
                                      copy_ptr)]
    assert st._pending is (form != "by_value")


@pytest.mark.parametrize("m,chunks", [(8192, [(8192, "copy")]),
                                      (8193, [(8192, "copy"), (1, "by_value")])])
def test_inject_staging_chunks_by_form(monkeypatch, m, chunks):
    """A staging of R = 8192 rows (the engine's max_width) cuts an inject of
    8193 rows into a chunk of 8192, copied up through its scratch, and one
    of 1, by value; 8192 rows are one copy. Each chunk that is copied up
    leaves the staging pending, so the next free() waits on its event
    before the host rewrites the rows."""
    calls, fake = _recording_kernels()
    monkeypatch.setattr(rows, "_kernels", fake)
    rows.reset_launch_counts()
    R = 8192
    buf = torch.zeros((R, 8), dtype=torch.int64)
    waited = []
    done = SimpleNamespace(cuda_event=9, synchronize=lambda: waited.append(len(calls)))
    st = rows.InjectStaging(buf, done, _fake_cuda(shape=(R, 8)))
    state, _made = _card_state()
    st.inject(state, np.zeros((m, 8), np.int64))
    code = {"mapped": 0, "by_value": 1, "copy": 2}
    assert [(c[4], c[7]) for _, c in calls] == [(n, code[f]) for n, f in chunks]
    assert [c[6] for _, c in calls] == [None if f == "by_value" else 9 for _, f in chunks]
    assert [c[9] for _, c in calls] == [4096 if f == "copy" else None for _, f in chunks]
    assert waited == [1] * (len(chunks) - 1)  # the second chunk waited for the copy
    assert st._pending is (chunks[-1][1] != "by_value")
    assert {f: rows.launch_counts[f"inject_rows_{f}"] for _, f in chunks} == {
        f: sum(1 for _, g in chunks if g == f) for _, f in chunks}


class _CardEvent:
    """The staging's event with a card behind it: a mapped launch reads its
    rows only when the card runs it, which is at the latest the next wait
    on the event; a by-value launch took its rows when it was made."""

    def __init__(self):
        self.cuda_event = 1
        self.waits = 0
        self.deferred = []  # mapped launches not run yet: (table, buffer view)

    def synchronize(self):
        self.waits += 1
        for table, view in self.deferred:
            rows.inject_rows_plain(table, torch.from_numpy(view.copy()))
        self.deferred = []


def test_inject_staging_reuse_rule_by_form(monkeypatch):
    """The staging's reuse rule with the launch entry stubbed as the card
    runs it: a by-value launch leaves nothing pending, so free() hands the
    buffer straight back and the host may rewrite it at once; a mapped
    launch is pending until free() waits on the event. Rewriting the
    buffer right after every launch that free() allows leaves the table
    equal to the plain inject of the rows as launched."""
    R, C = 512, 4096
    done = _CardEvent()

    def launch(state, buf, m, ev, checked, scratch):
        if m > LIMITS["inject_rows"]:
            ev.deferred.append((state, buf.numpy()[:m]))
            return "mapped"
        rows.inject_rows_plain(state, buf[:m].clone())
        return "by_value"

    monkeypatch.setattr(rows, "inject_rows_pinned", launch)
    st = rows.InjectStaging(torch.zeros((R, 8), dtype=torch.int64), done)
    rng = np.random.RandomState(12)
    table = torch.from_numpy(rng.randint(-9, 9, (C, 8)).astype(np.int64))
    want = table.clone()
    waits = []
    for m in (16, 449, 1, 448, 449, 449, 17, 449):
        a = rng.randint(-(1 << 40), 1 << 40, (m, 8)).astype(np.int64)
        a[:, 0] = rng.choice(C + 4, m, replace=False) - 2
        before = st.waits
        buf = st.free()
        waits.append(st.waits - before)
        buf[:m] = a
        st.launch(table, m)
        rows.inject_rows_plain(want, torch.from_numpy(a))
        if not st._pending:
            st.free()[:] = rng.randint(0, C, (R, 8))  # at once: the launch took its rows
    # a wait only for the frees that followed a mapped launch
    assert waits == [0, 0, 1, 0, 0, 1, 1, 0] and st.waits == done.waits == 3
    assert st._pending
    st.free()
    assert st.waits == 4 and not done.deferred
    torch.testing.assert_close(table, want, rtol=0, atol=0)


@pytest.mark.parametrize("m", [1, 16, 17, 64, 65, 448, 449])
def test_inject_rows_at_class_edges_matches_jax(m):
    """The plain inject (the oracle of both pinned forms) against the JAX
    engine's _inject_rows at the by-value class edges, with the slots -1,
    C - 1 and C among the lanes."""
    C = 4096
    rng = np.random.RandomState(100 + m)
    table = rng.randint(-(1 << 40), 1 << 40, (C, 8)).astype(np.int64)
    inject = rng.randint(-(1 << 62), 1 << 62, (m, 8)).astype(np.int64)
    inject[:, 0] = rng.choice(C - 1, m, replace=False)
    inject[:3, 0] = [-1, C - 1, C][:m]
    want = _jax_inject(table, inject)
    got = torch.from_numpy(table.copy())
    rows.inject_rows(got, torch.from_numpy(inject))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m", [1, 16, 64, 65])
def test_gather_rows_at_class_edges_matches_jax(m):
    """The plain gather (the oracle of both pinned forms) into a given out
    against the JAX engine's _gather_rows at the by-value class edges, with
    the slots -1, C - 1, C and C + 8 among the lanes."""
    from gubernator_tpu.models import engine as jeng_mod

    C = 4096
    rng = np.random.RandomState(200 + m)
    table = rng.randint(-(1 << 40), 1 << 40, (C, 8)).astype(np.int64)
    for edge in ([-1, C - 1, C, C + 8] if m == 1 else [None]):
        slot = rng.randint(0, C, m).astype(np.int32)
        if edge is None:
            slot[:4] = [-1, C - 1, C, C + 8]
        else:
            slot[0] = edge
        want = np.stack([np.asarray(c) for c in
                         jeng_mod._gather_rows(jnp.asarray(table), jnp.asarray(slot))])
        out = torch.full((7, m), -7, dtype=torch.int64)
        assert rows.gather_rows(torch.from_numpy(table), torch.from_numpy(slot), out) is out
        np.testing.assert_array_equal(out.numpy(), want)
