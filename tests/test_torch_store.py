"""The port's persistence against the JAX package's, bit for bit, on the CPU.

Each stimulus goes through the JAX Engine and the port's Engine(device="cpu")
at the small widths the JAX package's tests use: a Store read and written
through around every window (tests/test_engine.py's TestStoreSPI and store
scan cases, tests/test_fuzz.py's store differential), a Loader restored at
construction and saved by close() (TestLoaderSPI, TestFileLoader), the
streamed binary snapshot and the JSONL one written by each package and
restored by the other, and the host-state reads (rows_for_keys,
device_hit_counts, resolve_slots). Responses, Store contents and call
counts, saved snapshots (byte for byte) and whole tables must be equal: the
tolerance is zero. The store gates (no fast window, no pipeline, no
columnar path, no lone-request path with a Store) are held to the JAX
Engine's answers.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gubernator_tpu_torch import convert
from gubernator_tpu_torch.models.engine import Engine
from gubernator_tpu_torch.ops import rows as rowk
from gubernator_tpu_torch import store as tstore
from gubernator_tpu_torch.types import Behavior, RateLimitReq

# far-future epoch: snapshots drop rows that expired against the wall clock
NOW = 2_000_000_000_000
RESET = int(Behavior.RESET_REMAINING)


def _engines(monkeypatch, directory, jstore=None, tstore_=None, **kw):
    """(JAX engine, port engine) on the same kind of directory."""
    if directory == "python":
        monkeypatch.setenv("GUBER_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("GUBER_NO_NATIVE", raising=False)
    from gubernator_tpu.models.engine import Engine as JaxEngine

    jeng = JaxEngine(store=jstore, **kw)
    teng = Engine(store=tstore_, device="cpu", **kw)
    assert (teng._prep_fast is not None) == (directory == "native")
    return jeng, teng


def _resp(r):
    return (int(r.status), r.limit, r.remaining, r.reset_time, r.error)


def _snap(s):
    return dataclasses.astuple(s)


def _same_tables(jeng, teng):
    np.testing.assert_array_equal(np.asarray(jeng.state),
                                  convert.table_to_numpy(teng.state))
    assert teng.key_count() == jeng.key_count()


def _same_stores(js, ts):
    assert {k: _snap(v) for k, v in ts.data.items()} == \
        {k: _snap(v) for k, v in js.data.items()}
    assert ts.called == js.called


def _decide(jeng, teng, fields, now):
    """One batch through both engines; their answers must be equal."""
    from gubernator_tpu import RateLimitReq as JReq

    want = jeng.get_rate_limits([JReq(**f) for f in fields], now_ms=now)
    got = teng.get_rate_limits([RateLimitReq(**f) for f in fields], now_ms=now)
    assert [_resp(r) for r in got] == [_resp(r) for r in want]
    return got


def req(key, hits=1, limit=10, duration=60_000, algorithm=0, behavior=0):
    return dict(name="test", unique_key=key, hits=hits, limit=limit,
                duration=duration, algorithm=algorithm, behavior=behavior)


def _row(key, remaining):
    return dict(key=key, algo=0, limit=10, remaining=remaining,
                duration=60_000, stamp=NOW - 1000, expire_at=NOW + 59_000)


# (engine widths, rows the Store holds before the first batch, [(batch, now)]):
# tests/test_engine.py's TestStoreSPI (:140-183) and store scan cases
# (:342-392), each batch as that test sends it
STORE_CASES = {
    "read_through_and_write_through": (
        (32, 8, 32), [], [([req("s1")], NOW), ([req("s1", hits=2)], NOW + 1)]),
    "read_through_restores_state": (
        (32, 8, 32), [_row("test_s2", 3)], [([req("s2")], NOW)]),
    "reset_remaining_removes": (
        (32, 8, 32), [], [([req("s3")], NOW),
                          ([req("s3", behavior=RESET)], NOW + 1)]),
    "algorithm_switch_removes_then_recreates": (
        (32, 8, 32), [], [([req("s4")], NOW),
                          ([req("s4", algorithm=1)], NOW + 1)]),
    "store_rides_scan_with_batched_hooks": (
        (2048, 8, 64), [], [([req("sd", hits=2)] * 4, NOW)]),
    "store_scan_chunked_round0_keeps_fresh_flags": (
        (2048, 16, 16), [], [([req(f"cf{i}", hits=2) for i in range(20)]
                              + [req(f"cf{i}", hits=3) for i in range(4)], NOW)]),
    # the same batch once 128 other keys fill the directory: every new key
    # takes a recycled slot whose stale row is live, so a lost fresh flag
    # shows in the answers
    "store_scan_chunked_round0_recycled_slots": (
        (128, 16, 16), [], [([req(f"old{i}", hits=5) for i in range(128)], NOW),
                            ([req(f"cf{i}", hits=2) for i in range(20)]
                             + [req(f"cf{i}", hits=3) for i in range(4)], NOW + 1)]),
    "store_scan_read_through_restores": (
        (2048, 8, 64), [_row("test_sr", 3)], [([req("sr")] * 3, NOW)]),
}


@pytest.mark.parametrize("directory", ["native", "python"])
@pytest.mark.parametrize("case", sorted(STORE_CASES))
def test_store_case_matches_jax(monkeypatch, case, directory):
    from gubernator_tpu.store import BucketSnapshot as JSnap, MockStore as JStore

    (capacity, lo, hi), held, steps = STORE_CASES[case]
    js, ts = JStore(), tstore.MockStore()
    for r in held:
        js.data[r["key"]] = JSnap(**r)
        ts.data[r["key"]] = tstore.BucketSnapshot(**r)
    jeng, teng = _engines(monkeypatch, directory, js, ts, capacity=capacity,
                          min_width=lo, max_width=hi)
    for fields, now in steps:
        _decide(jeng, teng, fields, now)
        _same_stores(js, ts)
    _same_tables(jeng, teng)
    assert ts.called["get"] > 0 and ts.called["on_change"] > 0
    assert teng.stats.stage_ns["store"] > 0
    if case.startswith("store_scan_chunked_round0"):
        # the tail's union (20 keys) exceeds max_width: more keys than a
        # window's inject staging holds
        assert [ts.data[f"test_cf{i}"].remaining for i in (0, 19)] == [5, 8]


@pytest.mark.parametrize("directory", ["native", "python"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_store_differential_matches_jax(monkeypatch, seed, directory):
    """tests/test_fuzz.py's test_store_differential stimulus (:151): random
    batches with herds, gregorian codes, RESET_REMAINING, algorithm
    switches and expiry-crossing jumps, write-through Stores attached."""
    import random

    from gubernator_tpu.store import MockStore as JStore
    from test_fuzz import JUMPS, NOW as FUZZ_NOW, STEPS, _random_batch

    rng = random.Random(7000 + seed)
    js, ts = JStore(), tstore.MockStore()
    jeng, teng = _engines(monkeypatch, directory, js, ts, capacity=128,
                          min_width=8, max_width=32)
    now = FUZZ_NOW + rng.randrange(10**9)
    keys = [f"s{i}" for i in range(rng.choice([3, 8]))]
    for _ in range(STEPS // 2):
        now += rng.choice(JUMPS)
        batch = [dataclasses.asdict(r) for r in _random_batch(rng, keys)]
        _decide(jeng, teng, batch, now)
    _same_stores(js, ts)
    _same_tables(jeng, teng)


def test_store_gates_match_jax(monkeypatch):
    """With a Store: no fast window, no pipeline, no columnar path, no
    lone-request decision or mirror; without one, all of them."""
    from gubernator_tpu import RateLimitReq as JReq
    from gubernator_tpu.store import MockStore as JStore

    jeng, teng = _engines(monkeypatch, "native", JStore(), tstore.MockStore(),
                          capacity=64, min_width=8, max_width=32)
    bare = Engine(device="cpu", capacity=64, min_width=8, max_width=32)

    def no_fast(*_a):
        raise AssertionError("the fast window ran with a Store")

    monkeypatch.setattr(teng, "_fast_window", no_fast)
    _decide(jeng, teng, [req("g1"), req("g2")], NOW)
    for eng in (jeng, teng):
        assert eng.supports_pipeline() is False
        assert eng.supports_columnar() is False
        assert eng.seed_mirror("test_g1") is False
    assert teng.launch_windows([[RateLimitReq(**req("g1"))]], NOW) is None
    assert teng.decide_native_single(RateLimitReq(**req("g1")), NOW + 1) is None
    assert jeng.decide_native_single(JReq(**req("g1")), NOW + 1) is None
    assert bare.supports_pipeline() and bare.supports_columnar()
    bare.get_rate_limits([RateLimitReq(**req("g1"))], now_ms=NOW)
    assert bare.seed_mirror("test_g1") is True
    assert bare.decide_native_single(RateLimitReq(**req("g1")), NOW + 1) is not None


# ------------------------------------------------------------------ Loaders

@pytest.mark.parametrize("case", ["load_and_save_roundtrip", "save_skips_expired"])
def test_mock_loader_matches_jax(monkeypatch, case):
    """tests/test_engine.py's TestLoaderSPI (:185-209) through both."""
    from gubernator_tpu.store import BucketSnapshot as JSnap, MockLoader as JLoader

    monkeypatch.delenv("GUBER_NO_NATIVE", raising=False)
    from gubernator_tpu.models.engine import Engine as JaxEngine

    held = [_row("test_l1", 4)] if case == "load_and_save_roundtrip" else []
    jl = JLoader([JSnap(**r) for r in held])
    tl = tstore.MockLoader([tstore.BucketSnapshot(**r) for r in held])
    jeng = JaxEngine(capacity=32, min_width=8, max_width=32, loader=jl)
    teng = Engine(capacity=32, min_width=8, max_width=32, loader=tl, device="cpu")
    assert tl.called == jl.called and tl.called["load"] == 1
    if held:
        _decide(jeng, teng, [req("l1")], NOW)
    else:
        _decide(jeng, teng, [req("l2", duration=1)], 1_000)  # long expired
        _decide(jeng, teng, [req("l3", duration=10**12)], NOW)
    jeng.close()
    teng.close()
    assert tl.called == jl.called and tl.called["save"] == 1
    assert [_snap(s) for s in tl.contents] == [_snap(s) for s in jl.contents]
    assert len(tl.contents) == 1
    _same_tables(jeng, teng)


def test_file_loader_restart_matches_jax(monkeypatch, tmp_path):
    """tests/test_engine.py's TestFileLoader restart round trip (:245): each
    package saves its JSONL file at close() (the two files byte-equal),
    and each restarts from the OTHER package's file."""
    from gubernator_tpu.models.engine import Engine as JaxEngine
    from gubernator_tpu.store import FileLoader as JFile
    from gubernator_tpu_torch.utils.interval import millisecond_now

    monkeypatch.delenv("GUBER_NO_NATIVE", raising=False)
    now = millisecond_now()
    jpath, tpath = str(tmp_path / "j" / "b.jsonl"), str(tmp_path / "t" / "b.jsonl")
    jeng = JaxEngine(capacity=64, min_width=8, max_width=32, loader=JFile(jpath))
    teng = Engine(capacity=64, min_width=8, max_width=32,
                  loader=tstore.FileLoader(tpath), device="cpu")
    fields = [dict(name="f", unique_key=f"k{i}", hits=2, limit=10,
                   duration=3_600_000) for i in range(5)]
    assert [r.remaining for r in _decide(jeng, teng, fields, now)] == [8] * 5
    jeng.close()
    teng.close()
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    jeng2 = JaxEngine(capacity=64, min_width=8, max_width=32, loader=JFile(tpath))
    teng2 = Engine(capacity=64, min_width=8, max_width=32,
                   loader=tstore.FileLoader(jpath), device="cpu")
    _same_tables(jeng2, teng2)
    got = _decide(jeng2, teng2, [dict(f, hits=1) for f in fields], now + 1000)
    assert [r.remaining for r in got] == [7] * 5
    _same_tables(jeng2, teng2)


# --------------------------------------------------------------- snapshots

SLAB = 1000  # rows per slab: 4,500 slots take five slabs, the last read from 3,500
CAP = 4500


def _fill(jeng, teng, n_keys, seed):
    """Drive both engines over n_keys keys: live rows, rows long expired
    (a 1970 clock), rows cleared by RESET_REMAINING (vacant), both
    algorithms; then lone decisions on the native directory, so some
    mirrors are dirty when the table is read."""
    rng = np.random.RandomState(seed)
    fields = [req(f"k{i}", hits=int(rng.randint(0, 4)),
                  limit=int(rng.choice([5, 50, 1000])),
                  duration=int(rng.choice([1000, 60_000, 3_600_000])),
                  algorithm=int(rng.randint(0, 2))) for i in range(n_keys)]
    for s in range(0, n_keys, 32):
        batch = fields[s:s + 32]
        if s // 32 % 9 == 4:
            _decide(jeng, teng, batch, 1_000)  # expired long ago
        else:
            _decide(jeng, teng, batch, NOW)
    _decide(jeng, teng, [dict(f, behavior=RESET) for f in fields[::97]], NOW + 5)
    if teng._prep_fast is not None:
        from gubernator_tpu import RateLimitReq as JReq

        for f in fields[1::151]:
            key = "test_" + f["unique_key"]
            assert teng.seed_mirror(key) == jeng.seed_mirror(key)
            w = jeng.decide_native_single(JReq(**f), now_ms=NOW + 7)
            g = teng.decide_native_single(RateLimitReq(**f), now_ms=NOW + 7)
            assert (w is None) == (g is None)
            if g is not None:
                assert _resp(g) == _resp(w)
    return fields


def _slabs(eng, include_expired=False):
    return [(bytes(b), np.asarray(o).copy(), np.asarray(r).copy())
            for b, o, r in eng.snapshot_slabs(include_expired)]


def _same_slabs(got, want):
    assert len(got) == len(want)
    for (gb, go, gr), (wb, wo, wr) in zip(got, want):
        assert gb == wb
        np.testing.assert_array_equal(go, wo)
        np.testing.assert_array_equal(gr, wr)


def _by_key(slabs):
    out = {}
    for blob, off, rows in slabs:
        for j in range(len(off) - 1):
            out[blob[off[j]:off[j + 1]]] = tuple(rows[j])
    return out


@pytest.fixture
def small_slabs(monkeypatch):
    from gubernator_tpu.models.engine import Engine as JaxEngine

    monkeypatch.setattr(JaxEngine, "_SNAPSHOT_SLAB_ROWS", SLAB)
    monkeypatch.setattr(Engine, "_SNAPSHOT_SLAB_ROWS", SLAB)


@pytest.mark.parametrize("directory", ["native", "python"])
def test_binary_snapshot_crosses_packages(monkeypatch, tmp_path, small_slabs,
                                          directory):
    """4,300 keys over 4,500 slots in slabs of 1,000: the slab streams
    are equal slab for slab (expired rows in or out), the files
    BinarySnapshotLoader writes from them are byte-equal, and each package
    restores the other's file (through the Loader at construction) into
    equal tables holding the original's live rows."""
    from gubernator_tpu.models.engine import Engine as JaxEngine
    from gubernator_tpu.store import BinarySnapshotLoader as JBin

    jeng, teng = _engines(monkeypatch, directory, capacity=CAP, min_width=8,
                          max_width=32)
    _fill(jeng, teng, 4300, seed=5)
    assert max(s for _k, s in teng.directory.items()) >= 4000  # the last slab
    want = _slabs(jeng)
    _same_slabs(_slabs(teng), want)
    _same_tables(jeng, teng)  # the slab walk flushed the same mirrors
    assert len(want) >= 4 and all(len(o) - 1 <= SLAB for _, o, _ in want)
    _same_slabs(_slabs(teng, include_expired=True),
                _slabs(jeng, include_expired=True))
    jpath, tpath = str(tmp_path / "j.snap"), str(tmp_path / "t.snap")
    JBin(jpath).save_slabs(jeng.snapshot_slabs())
    tstore.BinarySnapshotLoader(tpath).save_slabs(teng.snapshot_slabs())
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    jeng2 = JaxEngine(capacity=CAP, min_width=8, max_width=32, loader=JBin(tpath))
    teng2 = Engine(capacity=CAP, min_width=8, max_width=32,
                   loader=tstore.BinarySnapshotLoader(jpath), device="cpu")
    _same_tables(jeng2, teng2)
    live = _by_key(want)
    assert _by_key(_slabs(teng2)) == live
    assert teng2.key_count() == len(live) < 4300


def test_jsonl_snapshot_crosses_packages(monkeypatch, tmp_path, small_slabs):
    """The BucketSnapshot path: snapshot_stream saved by each package's
    FileLoader (byte-equal files) and restored by the other's
    load_snapshot; BinarySnapshotLoader's JSONL import restores the same."""
    from gubernator_tpu.models.engine import Engine as JaxEngine
    from gubernator_tpu.store import FileLoader as JFile

    jeng, teng = _engines(monkeypatch, "native", capacity=CAP, min_width=8,
                          max_width=32)
    _fill(jeng, teng, 3000, seed=6)
    assert [_snap(s) for s in teng.snapshot()] == [_snap(s) for s in jeng.snapshot()]
    jpath, tpath = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    JFile(jpath).save(jeng.snapshot_stream())
    tstore.FileLoader(tpath).save(teng.snapshot_stream())
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    jeng2 = JaxEngine(capacity=CAP, min_width=8, max_width=32)
    teng2 = Engine(capacity=CAP, min_width=8, max_width=32, device="cpu")
    assert jeng2.load_snapshot(JFile(tpath).load()) == \
        teng2.load_snapshot(tstore.FileLoader(jpath).load())
    _same_tables(jeng2, teng2)
    teng3 = Engine(capacity=CAP, min_width=8, max_width=32, device="cpu",
                   loader=tstore.BinarySnapshotLoader(jpath))
    _same_tables(jeng2, teng3)


class _Event:
    """A page-locked staging's event on the CPU: synchronize() stands where
    the card would have finished the last launch from the buffer, and
    checks that the rows it read were not rewritten before it."""

    def __init__(self):
        self.cuda_event = 1
        self.launched = None

    def record(self, _stream=None):
        pass

    def synchronize(self):
        if self.launched is not None:
            view, seen = self.launched
            np.testing.assert_array_equal(view, seen)
            self.launched = None


def test_card_path_staging_matches_jax(monkeypatch, small_slabs):
    """The card's form of the persistence path, with CPU buffers standing in
    for page-locked ones: restore chunks written into the engine's inject
    staging and launched from it by count (the reuse rule checked at every
    wait), Store read-through rows copied into it, and snapshot slabs read
    through one reused SlabStaging, whose rows the stream must copy out
    before the next slab overwrites them."""
    from gubernator_tpu.models.engine import Engine as JaxEngine
    from gubernator_tpu.store import BucketSnapshot as JSnap, MockStore as JStore

    launches = []

    def launch(state, buf, m, ev):
        assert ev.launched is None, "the staging was handed out before the wait"
        view = buf.numpy()[:m]
        ev.launched = (view, view.copy())
        launches.append(m)
        rowk.inject_rows_plain(state, buf[:m])

    def staged(eng):
        eng._inject = rowk.InjectStaging(torch.zeros((32, 8), dtype=torch.int64), _Event())
        return eng

    monkeypatch.setattr(rowk, "inject_rows_pinned", launch)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda _dev=None: None)
    jeng, teng = _engines(monkeypatch, "native", capacity=CAP, min_width=8,
                          max_width=32)
    _fill(jeng, teng, 2500, seed=7)
    slabs = list(jeng.snapshot_slabs())
    n = sum(len(o) - 1 for _, o, _ in slabs)
    jeng2 = JaxEngine(capacity=CAP, min_width=8, max_width=32)
    jeng2.load_snapshot_slabs(iter(slabs))
    teng2 = staged(Engine(capacity=CAP, min_width=8, max_width=32, device="cpu"))
    assert teng2.load_snapshot_slabs(iter(slabs)) == n
    assert sum(launches) == n and max(launches) == 32
    _same_tables(jeng2, teng2)

    slab = rowk.SlabStaging(torch.zeros((SLAB, 8), dtype=torch.int64), _Event())
    monkeypatch.setattr(teng2, "_read_slab", lambda start, _rows: slab.read(teng2.state, start))
    want = _slabs(jeng2)
    _same_slabs(list(teng2.snapshot_slabs()), want)
    assert slab.reads == len(want) > 1

    # the Stores hold the first two slabs' buckets; an empty table reads
    # them all through
    js, ts = JStore(), tstore.MockStore()
    for blob, off, rows in slabs[:2]:
        for j in range(len(off) - 1):
            key = blob[off[j]:off[j + 1]].decode()
            fields = [int(v) for v in rows[j]]
            js.data[key] = JSnap(key, *fields)
            ts.data[key] = tstore.BucketSnapshot(key, *fields)
    jeng3, teng3 = _engines(monkeypatch, "native", js, ts, capacity=CAP,
                            min_width=8, max_width=32)
    staged(teng3)
    del launches[:]
    keys = [k[len("test_"):] for k in list(ts.data)[:200]]
    for s in range(0, len(keys), 40):  # wider than max_width: the python pipeline
        _decide(jeng3, teng3, [req(k, hits=0) for k in keys[s:s + 40]], NOW + 9)
    _same_stores(js, ts)
    _same_tables(jeng3, teng3)
    assert sum(launches) == 200


# ------------------------------------------------------- host-state reads

@pytest.mark.parametrize("directory", ["native", "python"])
def test_host_state_reads_match_jax(monkeypatch, directory):
    """rows_for_keys (dirty mirrors flushed first), device_hit_counts and
    resolve_slots on the same engines, over present, absent, vacant and
    expired keys."""
    jeng, teng = _engines(monkeypatch, directory, capacity=CAP, min_width=8,
                          max_width=32)
    fields = _fill(jeng, teng, 1200, seed=8)
    keys = ["test_" + f["unique_key"] for f in fields[::3]] + ["test_absent"]
    fk, fr = teng.rows_for_keys(keys)
    wk, wr = jeng.rows_for_keys(keys)
    assert fk == wk and 0 < len(fk) < len(keys)
    np.testing.assert_array_equal(fr, wr)
    assert fr.dtype == np.int64 and fr.shape == (len(fk), 7)
    _same_tables(jeng, teng)
    assert teng.device_hit_counts(keys) == jeng.device_hit_counts(keys)
    slots = [s for _k, s in teng.directory.items()][::7] + [CAP + 3, -1]
    got = teng.resolve_slots(slots)
    assert got == jeng.resolve_slots(slots) and len(got) == len(slots) - 2
    assert teng.resolve_slots([]) == {}
    assert teng.rows_for_keys(["test_absent"])[1].shape == (0, 7)
