"""The port's decision path (gubernator_tpu_torch/ops/decide.py) against the
JAX package's, bit for bit.

Both packages start from ONE populated table, carried across by
gubernator_tpu_torch/convert.py, and take the same numpy stimuli: the wide,
compact and lean staging formats, per window and as scans, shaped like
tests/test_decide.py's TestKernelMatchesOracle, TestScanPacked,
TestCompactStaging and TestLeanStaging. Every value is an integer, so the
tolerance is zero: responses and whole tables must be equal.

On the CPU the port's entry points run their plain PyTorch version; the
CUDA kernel behind them is held to that version on the card by
chip_smoke.py.
"""

import datetime as dt
import importlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu_torch import convert
from gubernator_tpu_torch.ops import decide as td
from gubernator_tpu_torch.types import Behavior
from gubernator_tpu_torch.utils.gregorian import gregorian_duration, gregorian_expiration

# the JAX package's ops/__init__ re-exports the decide() function under the
# submodule's name
jd = importlib.import_module("gubernator_tpu.ops.decide")

NOW = 1_700_000_000_000
RESET = int(Behavior.RESET_REMAINING)
GREG = int(Behavior.DURATION_IS_GREGORIAN)

# one compiled JAX program per (function, shape)
_J = {name: jax.jit(getattr(jd, name)) for name in (
    "decide_packed", "decide_scan_packed", "decide_packed_compact",
    "decide_scan_packed_compact", "decide_packed_lean",
    "decide_scan_packed_lean")}


def populated_table(rng, C, now=NOW):
    """i64[C, 8]: vacant, token and leaky rows, live and expired, drained
    and full, sticky OVER_LIMIT, nonzero hit counters."""
    t = np.zeros((C, 8), np.int64)
    t[:, 0] = rng.choice([-1, 0, 1], C, p=[0.3, 0.4, 0.3])
    t[:, 1] = rng.choice([1, 5, 10, 100], C)
    t[:, 2] = rng.randint(0, 101, C) % (t[:, 1] + 1)
    t[:, 3] = rng.choice([1000, 10_000, 60_000], C)
    t[:, 4] = now - rng.randint(0, 120_000, C)
    t[:, 5] = t[:, 4] + t[:, 3]  # about half are expired at `now`
    t[:, 6] = rng.randint(0, 2, C)
    t[:, 7] = rng.randint(0, 1000, C)
    return t


def rand_wide(rng, table, B, now, *, slots=None, greg=True, lean=False):
    """One wide i64[9, B] window over distinct slots of `table`, padding
    lanes past a random live count. Requests mostly match the row's
    algorithm, limit and duration; some change them, peek (hits 0), ask
    for more than the limit, reset, or run on a gregorian calendar."""
    C = table.shape[0]
    p = np.zeros((9, B), np.int64)
    n = rng.randint(1, B + 1)
    pool = np.arange(C) if slots is None else slots
    s = rng.choice(pool, n, replace=False)
    row = table[s]
    p[0, :n] = s
    p[0, n:] = -1
    p[1, :n] = rng.choice([0, 1, 1, 1, 2, 5, 50, 1000], n)
    p[2, :n] = np.where(rng.rand(n) < 0.7, row[:, 1],
                        rng.choice([1, 2, 10, 100, 2**30], n))
    p[3, :n] = np.where(rng.rand(n) < 0.7, row[:, 3],
                        rng.choice([500, 60_000, 2**31 - 1], n))
    p[4, :n] = np.where((rng.rand(n) < 0.8) & (row[:, 0] >= 0), row[:, 0],
                        rng.randint(0, 2, n))
    p[5, :n] = np.where(rng.rand(n) < 0.1, RESET, 0)
    p[8, :n] = rng.rand(n) < 0.1
    if greg:
        g = rng.rand(n) < 0.25
        local = dt.datetime.fromtimestamp(now / 1000.0)
        codes = rng.randint(0, 3, n)  # minutes / hours / days
        p[3, :n] = np.where(g, codes, p[3, :n])
        p[5, :n] |= np.where(g, GREG, 0)
        p[6, :n] = np.where(g, [gregorian_expiration(local, c) for c in codes], 0)
        p[7, :n] = np.where(g, [gregorian_duration(local, c) for c in codes], 0)
    if lean:
        p[1, :n] = 1
        p[2, :n] = rng.choice([1, 5, 10, 100], n)
        p[3, :n] = rng.choice([1000, 60_000], n)
    return p


def both_tables(table):
    """The same table as a jax array and as the port's CPU tensor."""
    return jnp.asarray(table), convert.table_to_torch(table, device="cpu")


def assert_same(j_out, t_out):
    np.testing.assert_array_equal(np.asarray(j_out), convert.to_numpy(t_out))


def run_format(fmt, j_state, t_state, wide, now, scan=False):
    """Push one wide-staged window (or stack) through both packages in
    format `fmt`; returns the new JAX state after comparing responses."""
    sfx = "" if fmt == "wide" else "_" + fmt
    name = ("decide_scan_packed" if scan else "decide_packed") + sfx
    if fmt == "wide":
        args = (wide,)
    elif fmt == "compact":
        args = (td.compact_window(wide),)
        assert args[0] is not None
    else:
        args = td.lean_window(wide, t_state.shape[0])
        assert args is not None
    j_state, j_out = _J[name](j_state, *args, now)
    t_args = [convert.to_torch(a, a.dtype, "cpu") for a in args]
    t_out = getattr(td, name)(t_state, *t_args, now)
    assert_same(j_out, t_out)
    return j_state


@pytest.mark.parametrize("fmt", ["wide", "compact", "lean"])
@pytest.mark.parametrize("seed", range(3))
def test_windows_match_jax(fmt, seed):
    """Per-window entry points, 8 windows over one populated table with
    advancing now: equal responses each window, equal tables at the end."""
    rng = np.random.RandomState(seed)
    C, B = 256, 32
    table = populated_table(rng, C)
    j_state, t_state = both_tables(table)
    for i in range(8):
        now = NOW + i * 7_000
        wide = rand_wide(rng, table, B, now, greg=fmt == "wide",
                         lean=fmt == "lean")
        j_state = run_format(fmt, j_state, t_state, wide, now)
    assert_same(j_state, t_state)


@pytest.mark.parametrize("fmt", ["wide", "compact", "lean"])
@pytest.mark.parametrize("seed", range(2))
def test_scans_match_jax(fmt, seed):
    """Scan entry points: K windows over a small slot pool, so later
    windows read what earlier ones wrote."""
    rng = np.random.RandomState(100 + seed)
    C, K, B = 256, 5, 16
    table = populated_table(rng, C)
    pool = rng.choice(C, 24, replace=False)
    j_state, t_state = both_tables(table)
    wide = np.stack([rand_wide(rng, table, B, NOW, slots=pool,
                               greg=fmt == "wide", lean=fmt == "lean")
                     for _ in range(K)])
    j_state = run_format(fmt, j_state, t_state, wide, NOW, scan=True)
    assert_same(j_state, t_state)


def test_scan_equals_sequential_windows():
    """TestScanPacked's property on the port: a K-window scan leaves the
    table and the responses K sequential windows would."""
    rng = np.random.RandomState(7)
    C, K, B = 128, 5, 16
    table = populated_table(rng, C)
    pool = rng.choice(C, 20, replace=False)
    wide = np.stack([rand_wide(rng, table, B, NOW, slots=pool)
                     for _ in range(K)])
    seq = convert.table_to_torch(table, "cpu")
    outs = [td.decide_packed(seq, torch.from_numpy(w), NOW) for w in wide]
    scan = convert.table_to_torch(table, "cpu")
    got = td.decide_scan_packed(scan, torch.from_numpy(wide), NOW)
    assert torch.equal(got, torch.stack(outs))
    assert torch.equal(seq, scan)


def _edge_window(C):
    """Lanes the kernel must treat exactly as XLA does: a slot past the
    table (gather clamps, store drops), int64 wraparound, negative
    durations, a sticky status outside {0, 1} (truncated to i32 in the
    response), an algorithm code past 1 (runs as leaky), and padding
    lanes in the middle."""
    p = np.zeros((9, 9), np.int64)
    big = np.iinfo(np.int64).max
    p[0] = [C + 5, 0, 1, 2, -1, 3, 4, -1, 5]
    p[1] = [1, 1, 3, 0, 9, 1, 1, 9, 2]
    p[2] = [10, big, 7, 5, 9, 10, 10, 9, 3]
    p[3] = [60_000, big, -7_001, 60_000, 9, 60_000, 1000, 9, -1]
    p[4] = [0, 0, 1, 0, 0, 0, 7, 0, 1]
    return p


def test_edge_lanes_match_jax():
    rng = np.random.RandomState(3)
    C = 16
    table = populated_table(rng, C)
    table[C - 1] = [0, 10, 4, 60_000, NOW - 5, NOW + 60_000, 1, 3]
    # alive, and stamp + a changed duration wraps past int64
    table[0] = [0, 10, 4, 5, np.iinfo(np.int64).max - 3, NOW + 1000, 0, 0]
    table[3] = [0, 10, 4, 60_000, NOW - 5, NOW + 60_000, (1 << 33) + 5, 3]
    j_state, t_state = both_tables(table)
    j_state = run_format("wide", j_state, t_state, _edge_window(C), NOW)
    assert_same(j_state, t_state)
    # the clamped lane read the last row but did not store there
    assert t_state[C - 1].tolist() == table[C - 1].tolist()


def test_padding_and_sign_bit_lean_match_jax():
    """Lean config ids >= 64 set the i32 sign bit; padding lanes ride the
    0xFFFFFF sentinel (TestLeanStaging.test_sign_bit_config_ids)."""
    C, B = 4096, td.LEAN_MAX_CFG
    table = populated_table(np.random.RandomState(5), C)
    p = np.zeros((9, B), np.int64)
    p[0] = np.arange(B) + (C - B - 1)
    p[0, -3:] = -1
    p[1] = 1
    p[2] = np.arange(B) + 1  # up to 128 distinct configs
    p[3] = 60_000
    lanes, _cfg = td.lean_window(p, C)
    assert (lanes < 0).any()
    j_state, t_state = both_tables(table)
    j_state = run_format("lean", j_state, t_state, p, NOW)
    assert_same(j_state, t_state)


def test_decide_reqbatch_matches_jax():
    """decide() itself on a ReqBatch, as the GLOBAL sync calls it."""
    rng = np.random.RandomState(11)
    C, B = 64, 16
    table = populated_table(rng, C)
    wide = rand_wide(rng, table, B, NOW)
    j_state, t_state = both_tables(table)
    j_new, j_resp = jax.jit(jd.decide)(
        j_state, jd.ReqBatch(
            slot=wide[0].astype(np.int32), hits=wide[1], limit=wide[2],
            duration=wide[3], algorithm=wide[4].astype(np.int32),
            behavior=wide[5].astype(np.int32), greg_expire=wide[6],
            greg_interval=wide[7], fresh=wide[8] != 0), NOW)
    t_resp = td.decide(t_state, td._reqs_wide(torch.from_numpy(wide)), NOW)
    for j, t in zip(j_resp, t_resp):
        assert_same(j, t)
    assert_same(j_new, t_state)


def test_make_table_matches_jax():
    assert_same(jd.make_table(32), td.make_table(32, device="cpu"))


@pytest.mark.parametrize("case", ["mixed", "greg", "hits", "too_big", "many_cfg",
                                  "capacity"])
def test_host_packers_match_jax(case):
    """compact_window, lean_window and widen_compact_out are copies: the
    same input gives the same bytes (or the same refusal)."""
    rng = np.random.RandomState(1)
    C = 1 << 20
    table = populated_table(rng, 512)
    wide = rand_wide(rng, table, 32, NOW, greg=case == "greg",
                     lean=case != "hits")
    if case == "too_big":
        wide[2, 0] = 2**31
    if case == "many_cfg":
        wide = np.zeros((9, 200), np.int64)
        wide[0] = np.arange(200)
        wide[1] = 1
        wide[2] = np.arange(200) + 1
    if case == "capacity":
        C = 1 << 24
    for fn, args in ((td.compact_window, (wide,)),
                     (td.lean_window, (wide, C))):
        jfn = getattr(jd, fn.__name__)
        want, got = jfn(*args), fn(*args)
        if want is None:
            assert got is None
            continue
        for w, g in zip(want if isinstance(want, tuple) else (want,),
                        got if isinstance(got, tuple) else (got,)):
            assert w.dtype == g.dtype
            np.testing.assert_array_equal(w, g)
    out = rng.randint(-5, 1000, (2, 4, 32)).astype(np.int32)
    np.testing.assert_array_equal(jd.widen_compact_out(out, NOW),
                                  td.widen_compact_out(out, NOW))


def test_pack_window_matches_jax():
    from gubernator_tpu import RateLimitReq as JReq
    from gubernator_tpu.models.prep import preprocess as jprep
    from gubernator_tpu_torch import RateLimitReq as TReq
    from gubernator_tpu_torch.models.prep import preprocess as tprep

    fields = [dict(name="n", unique_key=f"k{i % 5}", hits=i, limit=10 + i,
                   duration=[1000, 1][i % 2], algorithm=i % 2,
                   behavior=[0, GREG][i % 2]) for i in range(12)]
    _, jr, _ = jprep([JReq(**f) for f in fields], NOW)
    _, tr, _ = tprep([TReq(**f) for f in fields], NOW)
    assert len(jr) == len(tr)
    for jw, tw in zip(jr, tr):
        slots = list(range(len(jw)))
        fresh = [True] * len(jw)
        np.testing.assert_array_equal(jd.pack_window(jw, slots, fresh, 16),
                                      td.pack_window(tw, slots, fresh, 16))


def test_cpu_wrappers_never_need_the_kernel():
    """A CPU table takes the plain version: no build, no launch counted."""
    td.reset_launch_counts()
    state = td.make_table(8, device="cpu")
    p = np.zeros((9, 4), np.int64)
    p[0] = [0, 1, -1, -1]
    p[1:4, :2] = [[1, 1], [5, 5], [1000, 1000]]
    td.decide_packed(state, torch.from_numpy(p), NOW)
    assert all(v == 0 for v in td.launch_counts.values())
    assert state[0, 2].item() == 4


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        td.decide_cuda(td.WIDE, td.make_table(8, device="cpu"),
                       torch.zeros((9, 4), dtype=torch.int64), None, NOW)


# ------------------------------------------------ scan groups as the engine sends them

def _scan_group(rng, table, fmt, kind, K, B):
    """A wide i64[K, 9, B] scan group. 'herd': one row in every window, one
    live lane each at a random position, the same request (the engine's
    hot-key herd: d one-item rounds). 'depths': each of a few rows appears
    in a random subset of the windows, 1 to K deep, beside lanes on rows
    of their own, so the windows share rows at random depths."""
    C = table.shape[0]
    wide = np.zeros((K, 9, B), np.int64)
    wide[:, 0, :] = -1
    if kind == "herd":
        req = rand_wide(rng, table, 1, NOW, greg=fmt == "wide", lean=fmt == "lean")[:, 0]
        req[8] = 0
        for k in range(K):
            wide[k, :, rng.randint(B)] = req
        return wide
    shared = rng.choice(C, 6, replace=False)
    depth = rng.randint(1, K + 1, len(shared))
    own = iter(rng.permutation(np.setdiff1d(np.arange(C), shared)))
    for k in range(K):
        w = rand_wide(rng, table, B, NOW, greg=fmt == "wide", lean=fmt == "lean")
        n = int((w[0] >= 0).sum())
        w[0, :n] = [next(own) for _ in range(n)]
        for s, d in zip(shared, depth):
            if rng.rand() < d / K:
                lane = rng.randint(B)
                w[:, lane] = rand_wide(rng, table, 1, NOW, slots=np.array([s]),
                                       greg=fmt == "wide", lean=fmt == "lean")[:, 0]
        wide[k] = w
    return wide


@pytest.mark.parametrize("kind", ["herd", "depths"])
@pytest.mark.parametrize("fmt", ["wide", "compact", "lean"])
def test_scan_groups_match_jax(fmt, kind):
    """The scan groups the hand scan kernel reorders by row: a herd of
    K = 32 one-lane windows on one row, and windows sharing rows at random
    depths. The plain version is held to the JAX scan; the kernel is held
    to the plain version on the card by chip_smoke.py."""
    rng = np.random.RandomState({"herd": 21, "depths": 22}[kind] + len(fmt))
    C, K, B = 512, 32 if kind == "herd" else 8, 16
    table = populated_table(rng, C)
    j_state, t_state = both_tables(table)
    wide = _scan_group(rng, table, fmt, kind, K, B)
    j_state = run_format(fmt, j_state, t_state, wide, NOW, scan=True)
    assert_same(j_state, t_state)


def _last_row_window(rng, table, fmt, B, writer=True):
    """A window with a lane that writes row C-1 (a live token bucket) and
    live lanes past the table (C, C + 3), which read row C-1 as it stood
    before the window; the other lanes random."""
    C = table.shape[0]
    w = rand_wide(rng, table, B, NOW, slots=np.arange(C - 1), greg=fmt == "wide",
                  lean=fmt == "lean")
    req = [1, 10, 60_000, 0, 0, 0, 0, 0]
    for lane, s in [(1, C - 1)] * writer + [(B - 1, C), (B - 2, C + 3)]:
        w[0, lane] = s
        w[1:, lane] = req
    return w


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("fmt", ["wide", "lean"])
def test_last_row_written_beside_lanes_past_the_table(fmt, scan):
    """XLA reads every lane's row before any lane of the window writes: a
    lane past the table reads row C-1 as it stood before its window, even
    where a lane of the same window writes row C-1, and its own store is
    dropped. One window, and a scan of three windows (the middle one
    without the writer)."""
    rng = np.random.RandomState(31 + scan)
    C, B = 64, 16
    table = populated_table(rng, C)
    table[C - 1] = [0, 10, 4, 60_000, NOW - 5, NOW + 60_000, 0, 3]
    j_state, t_state = both_tables(table)
    if scan:
        wide = np.stack([_last_row_window(rng, table, fmt, B, writer=k != 1)
                         for k in range(3)])
    else:
        wide = _last_row_window(rng, table, fmt, B)
    j_state = run_format(fmt, j_state, t_state, wide, NOW, scan=scan)
    assert_same(j_state, t_state)
    # the writer deducted once a window it ran in; the readers saw the row
    # before their window, so each answered from it
    assert int(t_state[C - 1, 2]) == 4 - (2 if scan else 1)


# --------------------------------------- the CUDA wrapper, with no card and no nvcc

def _fake_cuda(dtype=torch.int64, shape=(64, 8), index=0, contiguous=True):
    """What _launch.check and decide_cuda read of a tensor on a card."""
    return SimpleNamespace(is_cuda=True, get_device=lambda: index, device=f"cuda:{index}",
                           dtype=dtype, shape=shape, is_contiguous=lambda: contiguous,
                           data_ptr=lambda: 4096)


def _library(calls):
    """A stand-in for the loaded decide library: records each launch's
    arguments and returns 0 (accepted)."""
    def launch(*args):
        calls.append(args)
        return 0
    return SimpleNamespace(decide_launch=launch, stream=lambda index: 7, scratch_words=1024,
                           max_owners=64)


_I32, _I64 = torch.int32, torch.int64


@pytest.mark.parametrize("args,match", [
    ((td.WIDE, _fake_cuda(shape=(64, 7)), _fake_cuda(shape=(9, 16)), None, False),
     r"table must be \[n, 8\]"),
    ((td.WIDE, _fake_cuda(shape=(0, 8)), _fake_cuda(shape=(9, 16)), None, False),
     "empty table"),
    ((td.WIDE, _fake_cuda(), _fake_cuda(dtype=_I32, shape=(9, 16)), None, False),
     "staging must be torch.int64"),
    ((td.WIDE, _fake_cuda(), _fake_cuda(shape=(8, 16)), None, False),
     r"staging must be \[9, n\]"),
    ((td.WIDE, _fake_cuda(), _fake_cuda(shape=(9, 16)), None, True),
     r"staging must be \[n, 9, n\]"),
    ((td.COMPACT, _fake_cuda(), _fake_cuda(dtype=_I32, shape=(4, 6, 16)), None, True),
     r"staging must be \[n, 5, n\]"),
    ((td.COMPACT, _fake_cuda(), _fake_cuda(dtype=_I32, shape=(5, 16), contiguous=False),
      None, False), "staging must be contiguous"),
    ((td.LEAN, _fake_cuda(), _fake_cuda(dtype=_I32, shape=(16,), index=1),
      _fake_cuda(shape=(128, 4)), False), "staging is on cuda:1, expected cuda:0"),
    ((td.LEAN, _fake_cuda(), _fake_cuda(dtype=_I32, shape=(4, 16)),
      _fake_cuda(shape=(64, 4)), True), r"config table must be \[128, 4\]"),
    ((td.LEAN, _fake_cuda(), _fake_cuda(dtype=_I32, shape=(16,)),
      torch.zeros((128, 4), dtype=_I64), False), "config table is on cpu, expected cuda:0"),
])
def test_cuda_decide_wrapper_refuses(monkeypatch, args, match):
    """decide_cuda refuses, through _launch.check, a table or staging of a
    wrong dtype, shape, contiguity or card, and a bad lean config table;
    nothing is launched or counted."""
    calls = []
    monkeypatch.setattr(td, "_kernels", _library(calls))
    td.reset_launch_counts()
    with pytest.raises(ValueError, match=match):
        td.decide_cuda(*args[:4], NOW, args[4])
    assert calls == [] and all(v == 0 for v in td.launch_counts.values())


@pytest.mark.parametrize("out,match", [
    (torch.zeros((4, 16), dtype=_I32), "out is on cpu, expected cuda:0"),
    (_fake_cuda(dtype=_I64, shape=(4, 16)), "out must be torch.int32"),
    (_fake_cuda(dtype=_I32, shape=(4, 15)), r"out must be \[4, 16\]"),
    (_fake_cuda(dtype=_I32, shape=(2, 4, 16)), r"out must be \[4, 16\]"),
    (_fake_cuda(dtype=_I32, shape=(4, 16), contiguous=False), "out must be contiguous"),
])
def test_cuda_decide_wrapper_refuses_out(monkeypatch, out, match):
    """A caller's out= is checked like row_bump's: on the table's card, the
    response's dtype and shape, contiguous."""
    calls = []
    monkeypatch.setattr(td, "_kernels", _library(calls))
    with pytest.raises(ValueError, match=match):
        td.decide_cuda(td.COMPACT, _fake_cuda(), _fake_cuda(dtype=_I32, shape=(5, 16)), None,
                       NOW, False, out)
    assert calls == []


@pytest.mark.parametrize("fmt,scan,staging,key", [
    (td.WIDE, False, (9, 16), "decide_wide"),
    (td.COMPACT, False, (5, 16), "decide_compact"),
    (td.LEAN, False, (16,), "decide_lean"),
    (td.WIDE, True, (4, 9, 16), "decide_scan_wide"),
    (td.COMPACT, True, (4, 5, 16), "decide_scan_compact"),
    (td.LEAN, True, (4, 16), "decide_scan_lean"),
])
def test_cuda_decide_wrapper_counts_its_launch(monkeypatch, fmt, scan, staging, key):
    """One launch, one count, under the key of its format and form; the
    entry point gets K, B, the scan flag, the card's scratch and the raw
    stream, and the caller's out comes back."""
    calls = []
    monkeypatch.setattr(td, "_kernels", _library(calls))
    monkeypatch.setitem(td._scratch, 0, _fake_cuda(shape=(1024,)))
    td.reset_launch_counts()
    dtype = _I64 if fmt == td.WIDE else _I32
    out = _fake_cuda(dtype=dtype, shape=(4, 4, 16) if scan else (4, 16))
    cfg = _fake_cuda(shape=(128, 4)) if fmt == td.LEAN else None
    got = td.decide_cuda(fmt, _fake_cuda(), _fake_cuda(dtype=dtype, shape=staging), cfg,
                         NOW, scan, out)
    assert got is out
    assert {k: v for k, v in td.launch_counts.items() if v} == {key: 1}
    assert td.launch_shapes == {(key, 4 if scan else 1, 16): 1}
    (index, f, _t, C, owners, _p, _c, _o, K, B, now, sc, _s, stream), = calls
    assert (index, f, C, owners, K, B, now, sc, stream) == (0, fmt, 64, 1, 4 if scan else 1,
                                                            16, NOW, int(scan), 7)


@pytest.mark.parametrize("kc", [0, 2, 32])
def test_scan_chunk_asks_the_library(monkeypatch, kc):
    """scan_chunk passes the card, format, K and B to decide_scan_chunk and
    returns the windows a chunk takes (0: one launch a window); it launches
    and counts nothing, and a refused query raises."""
    calls = []

    def query(index, fmt, K, B, out):
        calls.append((index, fmt, K, B))
        out._obj.value = kc
        return 0

    monkeypatch.setattr(td, "_kernels", SimpleNamespace(decide_scan_chunk=query))
    td.reset_launch_counts()
    assert td.scan_chunk(0, td.LEAN, 8, 8192) == kc
    assert calls == [(0, td.LEAN, 8, 8192)]
    assert td.launch_shapes == {} and not any(td.launch_counts.values())
    monkeypatch.setattr(td, "_kernels", SimpleNamespace(decide_scan_chunk=lambda *a: 1))
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        td.scan_chunk(0, td.WIDE, 2, 64)
