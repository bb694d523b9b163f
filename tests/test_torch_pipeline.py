"""The port's serving pipeline against the JAX package's, bit for bit.

The same submissions, from one async submitter, go through the JAX Engine
behind the JAX BackendCombiner and through the port's Engine(device="cpu")
behind the port's BackendCombiner (service/combiner.py, a copy). Every
response field must be equal, and so must every key's table row (the
combiners merge whatever is pending when their worker wakes, so slots are
compared through the directory, key by key). The stimuli are those of
tests/test_pipeline.py: the duplicate-key hammer, mixed traffic with
gregorian, invalid and oversized submissions, duplicates within a
submission, cross-window collisions under one now_ms, and the mid-group cut
at m = 5 of 8. The port at depth 4 must also answer as the port at depth 1.
launch_windows / collect_windows are also called directly on both engines,
where whole tables and EngineStats counters must be equal.

The port combiner's own paths run on a blocking fake backend
(backpressure, close() drains, depth 1 stays serial); a fake event shows
that a pipeline slot's staging (ops/staging.py) is refilled only after the
wait on its last launch; and the port's lock witness records no unknown
edge and no inversion.
"""

import threading
import time

import numpy as np
import pytest
import torch

from gubernator_tpu_torch import convert
from gubernator_tpu_torch.models.engine import Engine
from gubernator_tpu_torch.obs import witness
from gubernator_tpu_torch.ops.staging import WindowStaging
from gubernator_tpu_torch.service.combiner import BackendCombiner
from gubernator_tpu_torch.types import Behavior, RateLimitReq, RateLimitResp

NOW = 1_700_000_000_000
GREG = int(Behavior.DURATION_IS_GREGORIAN)
KW = dict(capacity=256, min_width=8, max_width=16)


def _f(key, hits=1, limit=1000, duration=60_000, behavior=0, name="pl"):
    return dict(name=name, unique_key=key, hits=hits, limit=limit,
                duration=duration, behavior=int(behavior))


def _jax_engine():
    from gubernator_tpu.models.engine import Engine as JaxEngine

    eng = JaxEngine(**KW)
    assert eng.supports_pipeline()
    return eng


def _port_engine():
    eng = Engine(device="cpu", **KW)
    assert eng.supports_pipeline()
    return eng


def _resp(r):
    return (int(r.status), r.limit, r.remaining, r.reset_time, r.error)


def _drive(combiner, subs, req_cls, shared_now):
    """One async submitter: submission order is the per-key order every
    combiner must honor. `shared_now` pins one timestamp for all
    submissions, so the combiner merges them into multi-window groups."""
    futs = [combiner.submit_async([req_cls(**f) for f in s],
                                  NOW if shared_now else NOW + i)
            for i, s in enumerate(subs)]
    return [[_resp(r) for r in f.result(timeout=60)] for f in futs]


def _rows_by_key(directory, table):
    return {k: table[s].tolist() for k, s in directory.items()}


def _run_jax(subs, depth, scan, shared_now):
    from gubernator_tpu import RateLimitReq as JReq
    from gubernator_tpu.service.combiner import BackendCombiner as JaxCombiner

    eng = _jax_engine()
    c = JaxCombiner(eng, depth=depth, scan=scan)
    try:
        got = _drive(c, subs, JReq, shared_now)
    finally:
        c.close()
    return got, _rows_by_key(eng.directory, np.asarray(eng.state))


def _run_port(subs, depth, scan, shared_now):
    eng = _port_engine()
    c = BackendCombiner(eng, depth=depth, scan=scan)
    try:
        assert c.pipelined == (depth > 1)
        got = _drive(c, subs, RateLimitReq, shared_now)
        stats = c.stats
    finally:
        c.close()
    return got, _rows_by_key(eng.directory, convert.table_to_numpy(eng.state)), stats


def _hammer():
    return [[_f("hot", hits=1 + (i % 3), limit=10_000)] for i in range(120)]


def _mixed():
    rng = np.random.RandomState(7)
    subs = []
    for _ in range(60):
        reqs = []
        for _ in range(int(rng.randint(1, 10))):
            kind = rng.rand()
            if kind < 0.06:
                reqs.append(_f("", hits=1))  # invalid: an error lane
            elif kind < 0.18:
                reqs.append(_f(f"g{int(rng.randint(3))}",
                               duration=int(rng.randint(2)), behavior=GREG))
            else:
                reqs.append(_f(f"h{int(rng.randint(8))}", limit=500,
                               hits=int(rng.randint(3))))
        subs.append(reqs)
    # oversized submissions (> max_width = 16) take the serial path
    subs[20] = [_f(f"h{j % 8}", limit=500) for j in range(40)]
    subs[40] = [_f("hot", limit=500) for _ in range(40)]
    return subs


def _dups_within():
    subs = []
    for _ in range(40):
        subs.append([_f("dup", limit=10_000)] * 3)
        subs.append([_f("dup", limit=10_000)])
    return subs


def _cross_window():
    rng = np.random.RandomState(11)
    subs = []
    for _ in range(50):
        reqs = [_f(f"x{int(rng.randint(4))}", limit=10_000)
                for _ in range(int(rng.randint(1, 8)))]
        if rng.rand() < 0.4:  # an in-submission duplicate: a leftover
            reqs.append(reqs[0])
        subs.append(reqs)
    return subs


def _mid_group_cut():
    """Eight full windows under one now_ms, the fifth with an in-window
    duplicate: the group cuts at m = 5, pow2(5) == pow2(8)."""
    subs = [[_f(f"s{i}_{j}", limit=100) for j in range(16)] for i in range(8)]
    subs[4][15] = _f("s4_0", limit=100)
    return subs + [[_f("s0_0", limit=100)]]


# (stimulus, depth, scan, shared_now), as tests/test_pipeline.py runs each
STIMULI = {
    "hammer": (_hammer, 4, 4, False),
    "mixed": (_mixed, 4, 4, False),
    "dups_within": (_dups_within, 3, 2, False),
    "cross_window": (_cross_window, 4, 8, True),
    "mid_group_cut": (_mid_group_cut, 4, 8, True),
}


@pytest.mark.parametrize("name", sorted(STIMULI))
def test_combiner_matches_jax(name):
    make, depth, scan, shared_now = STIMULI[name]
    subs = make()
    want, want_rows = _run_jax(subs, depth, scan, shared_now)
    got, got_rows, stats = _run_port(subs, depth, scan, shared_now)
    assert stats["pipelined_windows"] > 0
    assert got == want
    assert got_rows == want_rows


@pytest.mark.parametrize("name", sorted(STIMULI))
def test_depth_four_matches_depth_one(name):
    make, _depth, scan, shared_now = STIMULI[name]
    subs = make()
    serial, serial_rows, _ = _run_port(subs, 1, scan, shared_now)
    piped, piped_rows, stats = _run_port(subs, 4, scan, shared_now)
    assert stats["pipelined_windows"] > 0
    assert piped == serial
    assert piped_rows == serial_rows


COUNTERS = ("requests", "batches", "rounds", "over_limit", "errors")


def _groups(seed):
    """Window groups for direct launch_windows calls: duplicate keys
    within and across windows, gregorian and invalid lanes, peeks,
    windows of every width up to max_width, groups of 1-8 windows."""
    rng = np.random.RandomState(seed)
    groups = []
    for g in range(14):
        group = []
        for _ in range(int(rng.randint(1, 9))):
            win = []
            for _ in range(int(rng.randint(1, 17))):
                u = rng.rand()
                f = _f(f"k{int(rng.randint(30))}", hits=int(rng.choice([0, 1, 1, 2])),
                       limit=int(rng.choice([3, 50])))
                if u < 0.05:
                    f.update(behavior=GREG, duration=int(rng.randint(2)))
                elif u < 0.08:
                    f["name"] = ""
                win.append(f)
            group.append(win)
        groups.append((NOW + 300 * g, group))
    groups.append((NOW + 9000, _mid_group_cut()[:8]))
    return groups


@pytest.mark.parametrize("seed", [1, 2])
def test_launch_collect_matches_jax(seed):
    """Direct launch_windows / collect_windows on both engines, two groups
    in flight at a time on the port (each with its own staging dict), one
    at a time on the JAX engine: equal responses, tables and counters."""
    from gubernator_tpu import RateLimitReq as JReq

    jeng, teng = _jax_engine(), _port_engine()
    slots = [dict() for _ in range(3)]
    pending = []
    got, want = [], []
    for i, (now, group) in enumerate(_groups(seed)):
        h = jeng.launch_windows([[JReq(**f) for f in w] for w in group], now_ms=now)
        assert h is not None
        want.append([[_resp(r) for r in rs] for rs in jeng.collect_windows(h)])
        h = teng.launch_windows([[RateLimitReq(**f) for f in w] for w in group],
                                now_ms=now, staging=slots[i % 3])
        assert h is not None
        pending.append(h)
        if len(pending) == 2:
            got.append([[_resp(r) for r in rs]
                        for rs in teng.collect_windows(pending.pop(0))])
    for h in pending:
        got.append([[_resp(r) for r in rs] for rs in teng.collect_windows(h)])
    assert got == want
    np.testing.assert_array_equal(np.asarray(jeng.state),
                                  convert.table_to_numpy(teng.state))
    assert ({c: getattr(teng.stats, c) for c in COUNTERS}
            == {c: getattr(jeng.stats, c) for c in COUNTERS})


def test_mid_group_cut_never_launches_unprepped_windows():
    eng = _port_engine()
    windows = [[RateLimitReq(**f) for f in w] for w in _mid_group_cut()[:8]]
    got = eng.collect_windows(eng.launch_windows(windows, now_ms=NOW))
    assert [r.remaining for r in got[0]] == [99] * 16
    assert [r.remaining for r in got[4]] == [99] * 15 + [98]
    after = eng.get_rate_limits([RateLimitReq(**_f("s0_0", limit=100))], now_ms=NOW)
    assert (after[0].remaining, after[0].limit) == (98, 100)


def test_noop_probes_leave_the_table_untouched():
    eng = _port_engine()
    before = eng.state.clone()
    handles = [eng.launch_noop() for _ in range(3)]
    for h in handles:
        eng.collect_noop(h)
    eng.warmup_pipeline(max_group=8)
    assert torch.equal(before, eng.state)
    assert eng.key_count() == 0


def test_pipelined_launches_take_no_blocking_copy(monkeypatch):
    """The pipelined calls stage through the slot's buffers only: with the
    serial path's pageable upload (_up) and its whole-stream fetch
    (_fetch_staged) made to raise, groups with no leftover lanes launch
    and collect, object and columnar, and answer as the serial path
    does."""
    serial = _port_engine()
    eng = _port_engine()
    wins = [[RateLimitReq(**_f(f"n{w}_{j}", hits=1 + j % 2)) for j in range(3 + 4 * w)]
            for w in range(3)]
    want = [serial.get_rate_limits(w, now_ms=NOW) for w in wins]

    def refuse(*_a, **_k):
        raise AssertionError("a blocking copy on the pipelined path")

    monkeypatch.setattr(eng, "_up", refuse)
    monkeypatch.setattr(eng, "_fetch_staged", refuse)
    got = eng.collect_windows(eng.launch_windows(wins, now_ms=NOW, staging={}))
    assert [[_resp(r) for r in rs] for rs in got] == [[_resp(r) for r in rs] for rs in want]
    names = [r.name.encode() for r in wins[2]]
    keys = [r.unique_key.encode() for r in wins[2]]
    off = np.zeros(len(keys) + 1, np.int32)
    np.cumsum([len(a) + len(b) for a, b in zip(names, keys)], out=off[1:])
    cols = (len(keys), b"".join(a + b for a, b in zip(names, keys)), off,
            np.array([len(a) for a in names], np.int32),
            np.array([r.hits for r in wins[2]], np.int64),
            np.array([r.limit for r in wins[2]], np.int64),
            np.array([r.duration for r in wins[2]], np.int64),
            np.zeros(len(keys), np.int32), np.zeros(len(keys), np.int32))
    outs = [tuple(np.zeros(len(keys), t) for t in (np.int32, np.int64, np.int64, np.int64))]
    h = eng.launch_columnar_windows([cols], 0, now_ms=NOW + 1, staging={})
    assert [len(x) for x in eng.collect_columnar_windows(h, outs)] == [0]
    again = serial.get_rate_limits(wins[2], now_ms=NOW + 1)
    assert outs[0][2].tolist() == [r.remaining for r in again]


class _FakeEvent:
    """A slot's event on the CPU: record() stands where the card would
    queue the event after the slot's launch, and synchronize() where the
    host waits for it. It keeps the wide rows as the launch left them and
    checks, at the wait, that nothing has rewritten them yet."""

    def __init__(self, staging):
        self.staging = staging
        self.log = []
        self.seen = None

    def record(self, stream=None):
        self.log.append("record")
        self.seen = self.staging.wide_np.copy()

    def synchronize(self):
        self.log.append("wait")
        np.testing.assert_array_equal(self.staging.wide_np, self.seen)


def test_slot_staging_is_refilled_only_after_its_wait():
    """Three groups of one shape through one slot's dict: the second and
    third acquire the slot only after waiting on the event the previous
    launch recorded; a handle whose slot was refilled before its collect
    raises instead of reading another launch's response."""
    eng = _port_engine()
    st = WindowStaging.allocate(2, 16, eng.device)
    st.done = ev = _FakeEvent(st)
    slot = {(2, 9, 16): st}
    results = []
    for g in range(3):
        wins = [[RateLimitReq(**_f(f"r{g}_{w}_{j}")) for j in range(9)]
                for w in range(2)]
        h = eng.launch_windows(wins, now_ms=NOW + g, staging=slot)
        assert slot[(2, 9, 16)] is st
        if g == 0:
            assert st.wide_np[:, 0, :9].min() >= 0  # the rows the launch read
        results.append(eng.collect_windows(h))
    assert ev.log == ["record", "wait"] * 3
    assert all(r.remaining == 999 for res in results for rs in res for r in rs)
    # two launches through the slot before any collect: the second waits
    # on the first's event before it refills the rows
    wins = [[RateLimitReq(**_f(f"late{w}_{j}")) for j in range(9)] for w in range(2)]
    h1 = eng.launch_windows(wins, now_ms=NOW, staging=slot)
    eng.launch_windows(wins, now_ms=NOW, staging=slot)
    assert ev.log[6:] == ["record", "wait", "record"]
    with pytest.raises(RuntimeError, match="reused before"):
        eng.collect_windows(h1)


class _BlockingPipeBackend:
    """A launch/collect backend whose collects block until released: drives
    the combiner's backpressure and drain paths."""

    max_width = 64

    def __init__(self):
        self.release = threading.Event()
        self.launched = 0
        self.collected = 0
        self.max_uncollected = 0
        self._lock = threading.Lock()

    def supports_pipeline(self):
        return True

    def launch_windows(self, windows, now_ms=None, staging=None):
        with self._lock:
            self.launched += len(windows)
            self.max_uncollected = max(self.max_uncollected,
                                       self.launched - self.collected)
        return [list(w) for w in windows]

    def collect_windows(self, handle):
        self.release.wait(10)
        with self._lock:
            self.collected += len(handle)
        return [[RateLimitResp(limit=r.limit, remaining=r.limit - r.hits) for r in w]
                for w in handle]

    def get_rate_limits(self, reqs, now_ms=None):
        return [RateLimitResp(limit=r.limit, remaining=r.limit - r.hits) for r in reqs]


def test_backpressure_caps_inflight_at_depth():
    be = _BlockingPipeBackend()
    depth = 2
    c = BackendCombiner(be, depth=depth, scan=1)
    try:
        assert c.pipelined
        futs = [c.submit_async([RateLimitReq(**_f(f"b{i}"))], NOW + i)
                for i in range(depth + 6)]
        deadline = time.monotonic() + 5
        while c.stats["fill_stalls"] < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert c.stats["fill_stalls"] >= 1
        assert be.max_uncollected <= depth
        assert be.launched <= depth  # the pack stage really stalled
        be.release.set()
        for f in futs:
            assert f.result(timeout=10)[0].remaining == 999
        assert be.max_uncollected <= depth
    finally:
        be.release.set()
        c.close()


def test_close_drains_inflight_windows():
    be = _BlockingPipeBackend()
    c = BackendCombiner(be, depth=2, scan=1)
    futs = [c.submit_async([RateLimitReq(**_f(f"d{i}"))], NOW + i) for i in range(8)]
    time.sleep(0.05)  # some launched, some queued, some pending
    be.release.set()
    c.close(timeout_s=10)
    for f in futs:
        assert f.result(timeout=1)[0].remaining == 999


def test_depth_one_stays_serial():
    c = BackendCombiner(_port_engine(), depth=1)
    try:
        assert not c.pipelined
        assert c.submit([RateLimitReq(**_f("s"))], NOW)[0].remaining == 999
        assert c.stats["pipelined_windows"] == 0
    finally:
        c.close()


def test_autotune_resolves_auto_depth_on_noops():
    eng = _port_engine()
    c = BackendCombiner(eng, depth="auto")
    try:
        d = c.autotune(depths=(2, 3), probe_windows=4)
        assert d in (2, 3) and c.depth == d
        assert eng.key_count() == 0
        assert c.submit([RateLimitReq(**_f("after"))], NOW)[0].remaining == 999
    finally:
        c.close()


def test_concurrent_hammer_exact_hits():
    from concurrent.futures import ThreadPoolExecutor

    c = BackendCombiner(_port_engine(), depth=4)
    try:
        assert c.pipelined
        with ThreadPoolExecutor(max_workers=16) as pool:
            futs = [pool.submit(c.submit, [RateLimitReq(**_f("shared"))], NOW)
                    for _ in range(16)]
            remainings = sorted(f.result()[0].remaining for f in futs)
        assert remainings == list(range(984, 1000))
    finally:
        c.close()


def test_port_witness_sees_only_committed_lock_orders():
    """The port's locks (engine, combiner.window, combiner.backlog,
    combiner.counters) are witness locks in the test suite (tests/conftest.py
    arms the witness), and a pipelined combiner run over the engine records
    no edge lockmap.json lacks and no inversion. tests/conftest.py gates
    only the JAX package's witness in process, so the port's is checked
    here."""
    if not witness.witness_enabled():
        pytest.skip("GUBER_LOCK_WITNESS is off")
    eng = _port_engine()
    assert "engine" in repr(eng._lock)
    _run_port(_cross_window(), 4, 8, True)
    c = BackendCombiner(eng, depth=3, scan=4)
    try:
        c.submit([RateLimitReq(**_f("w"))], NOW)
    finally:
        c.close()
    snap = witness.the_witness().snapshot()
    assert snap["unknown"] == [] and snap["inversions"] == [], snap
    assert ["combiner.window", "combiner.backlog"] in snap["observed"]
