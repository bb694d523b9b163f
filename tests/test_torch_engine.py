"""The port's Engine on the CPU against the JAX package's Engine, bit for bit.

Both engines take one seeded request stream, batch by batch at the same
now_ms, and must give equal responses (status, limit, remaining, reset,
error), equal whole tables and equal EngineStats counters. Each case runs
twice: on the native directories (keydir.cpp, the same C++ in both
packages, so the same slots; windows of at most max_width requests take the
one-pass fast window) and on the pure-Python KeyDirectory
(GUBER_NO_NATIVE=1). The stream covers duplicate keys across rounds, the
scan tail, expiry as now_ms advances, error strings, gregorian durations,
every staging format, and slot recycling once the directory is full. A lone
request case interleaves seed_mirror and decide_native_single with the
windows, so dirty mirrors are injected by the next window's lookup.
"""

import numpy as np
import pytest
import torch

from gubernator_tpu_torch import convert
from gubernator_tpu_torch.models.engine import Engine, _gather_rows
from gubernator_tpu_torch.types import Behavior, RateLimitReq

NOW = 1_700_000_000_000
GREG = int(Behavior.DURATION_IS_GREGORIAN)
RESET = int(Behavior.RESET_REMAINING)


def request_stream(seed, n_keys, n_batches, max_batch):
    """[(now_ms, [request fields])]: Zipf-skewed keys (duplicates ->
    rounds -> scan tail), per-key configs with occasional changes, hits
    mostly 1, peeks, RESET_REMAINING, gregorian (some with an invalid
    code) and empty names/keys; every fifth batch a hot-key herd."""
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, n_keys + 1) ** 1.1
    p /= p.sum()
    key_limit = rng.choice([2, 5, 20, 100], n_keys)
    key_dur = rng.choice([1000, 5000, 60_000], n_keys)
    key_algo = (rng.rand(n_keys) < 0.2).astype(int)
    now = NOW
    out = []
    for b in range(n_batches):
        now += int(rng.choice([0, 1, 400, 2500, 7000]))
        if b % 5 == 4:
            # a hot-key herd: one key, hits 1, d duplicates = d rounds
            # (d = 1: a lone lean window)
            k = int(rng.randint(0, 3))
            out.append((now, [dict(name="api", unique_key=f"key{k}", hits=1,
                                   limit=int(key_limit[k]),
                                   duration=int(key_dur[k]),
                                   algorithm=int(key_algo[k]), behavior=0)]
                        * int(rng.choice([1, 3, 6, 11]))))
            continue
        n = rng.randint(1, max_batch + 1)
        batch = []
        for k in rng.choice(n_keys, n, p=p):
            u = rng.rand()
            f = dict(name="api", unique_key=f"key{k}",
                     hits=int(rng.choice([1, 1, 1, 1, 1, 1, 0, 2, 5])),
                     limit=int(key_limit[k]), duration=int(key_dur[k]),
                     algorithm=int(key_algo[k]), behavior=0)
            if u < 0.03:
                f["behavior"] = GREG
                f["duration"] = int(rng.choice([0, 1, 2, 99]))  # 99: invalid
            elif u < 0.06:
                f["behavior"] = RESET
            elif u < 0.09:
                f["limit"] = int(rng.choice([1, 3, 50]))
            elif u < 0.11:
                f["duration"] = int(rng.choice([500, 30_000]))
            elif u < 0.12:
                f["name"] = ""
            elif u < 0.13:
                f["unique_key"] = ""
            batch.append(f)
        out.append((now, batch))
    return out


def _engines(monkeypatch, directory, **kw):
    """(JAX engine, port engine) on the same kind of directory."""
    if directory == "python":
        monkeypatch.setenv("GUBER_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("GUBER_NO_NATIVE", raising=False)
    from gubernator_tpu.models.engine import Engine as JaxEngine

    jeng = JaxEngine(**kw)
    teng = Engine(device="cpu", **kw)
    assert (teng._prep_fast is not None) == (directory == "native")
    assert (jeng._prep_fast is not None) == (directory == "native")
    return jeng, teng


def _resp_tuple(r):
    return (int(r.status), r.limit, r.remaining, r.reset_time, r.error)


COUNTERS = ("requests", "batches", "rounds", "over_limit", "errors",
            "native_singles")


def _assert_same_end_state(jeng, teng):
    np.testing.assert_array_equal(np.asarray(jeng.state),
                                  convert.table_to_numpy(teng.state))
    assert teng.key_count() == jeng.key_count()
    assert ({c: getattr(teng.stats, c) for c in COUNTERS}
            == {c: getattr(jeng.stats, c) for c in COUNTERS})
    assert set(teng.stats.stage_ns) == set(jeng.stats.stage_ns)


@pytest.mark.parametrize("directory", ["native", "python"])
@pytest.mark.parametrize("capacity,n_keys,staging", [
    (4096, 300, "auto"),   # roomy table: rounds, scan tail, every format
    (40, 120, "auto"),     # full directory: LRU slot recycling
    (4096, 300, "wide"),   # the wide-only pin
])
def test_engine_matches_jax(monkeypatch, capacity, n_keys, staging, directory):
    monkeypatch.setenv("GUBER_STAGING", staging)
    jeng, teng = _engines(monkeypatch, directory, capacity=capacity,
                          min_width=8, max_width=32)
    assert teng.state.device.type == "cpu"
    from gubernator_tpu import RateLimitReq as JReq

    for now, batch in request_stream(capacity, n_keys, 25, 70):
        want = jeng.get_rate_limits([JReq(**f) for f in batch], now_ms=now)
        got = teng.get_rate_limits([RateLimitReq(**f) for f in batch], now_ms=now)
        assert [_resp_tuple(r) for r in got] == [_resp_tuple(r) for r in want]
    _assert_same_end_state(jeng, teng)
    if capacity < n_keys:
        assert teng.directory.evictions > 0


def _lone_requests(batch, n_hot):
    """The fields of the n_hot most frequent valid keys of a batch, each as
    a plain (non-gregorian) request of hits 1."""
    counts = {}
    for f in batch:
        if f["name"] and f["unique_key"]:
            counts.setdefault(f["unique_key"], [0, f])[0] += 1
    hot = sorted(counts.values(), key=lambda c: (-c[0], c[1]["unique_key"]))
    out = []
    for _n, f in hot[:n_hot]:
        lone = dict(f, hits=1)
        if lone["behavior"] & GREG:
            lone.update(behavior=0, duration=60_000)
        out.append(lone)
    return out


@pytest.mark.parametrize("directory", ["native", "python"])
@pytest.mark.parametrize("capacity,n_keys", [(4096, 300), (40, 120)])
def test_lone_requests_match_jax(monkeypatch, capacity, n_keys, directory):
    """After every window, for its hottest keys: seed_mirror, then three
    decide_native_single calls, a miss going through get_rate_limits as a
    one-request window (as the JAX package's caller does). Native decisions
    dirty the mirrors; the next window's lookup injects them."""
    jeng, teng = _engines(monkeypatch, directory, capacity=capacity,
                          min_width=8, max_width=32)
    from gubernator_tpu import RateLimitReq as JReq

    seen = {"fast": 0, "inject_rows": 0}
    fast, apply_inject = teng._fast_window, teng._apply_inject_rows

    def counted_fast(*a):
        seen["fast"] += 1
        return fast(*a)

    def counted_inject(inject):
        seen["inject_rows"] += 0 if inject is None else len(inject)
        return apply_inject(inject)

    monkeypatch.setattr(teng, "_fast_window", counted_fast)
    monkeypatch.setattr(teng, "_apply_inject_rows", counted_inject)
    n_native = 0
    for now, batch in request_stream(capacity + 1, n_keys, 25, 40):
        want = jeng.get_rate_limits([JReq(**f) for f in batch], now_ms=now)
        got = teng.get_rate_limits([RateLimitReq(**f) for f in batch], now_ms=now)
        assert [_resp_tuple(r) for r in got] == [_resp_tuple(r) for r in want]
        for f in _lone_requests(batch, 4):
            key = f["name"] + "_" + f["unique_key"]
            assert teng.seed_mirror(key) == jeng.seed_mirror(key)
            for j in range(3):
                t = now + 1 + j
                w1 = jeng.decide_native_single(JReq(**f), now_ms=t)
                g1 = teng.decide_native_single(RateLimitReq(**f), now_ms=t)
                assert (g1 is None) == (w1 is None)
                if g1 is None:
                    w1 = jeng.get_rate_limits([JReq(**f)], now_ms=t)[0]
                    g1 = teng.get_rate_limits([RateLimitReq(**f)], now_ms=t)[0]
                else:
                    n_native += 1
                assert _resp_tuple(g1) == _resp_tuple(w1)
    _assert_same_end_state(jeng, teng)
    if directory == "native":
        assert seen["fast"] > 0 and seen["inject_rows"] > 0 and n_native > 0
        assert teng.stats.native_singles == n_native
    else:
        assert seen["fast"] == 0 and n_native == 0


def test_stream_reaches_every_path(monkeypatch):
    """The stream above really drives all six entry points: lean, compact
    and wide windows, and lean, compact and wide scans."""
    from gubernator_tpu_torch.models import engine as eng_mod

    calls = dict.fromkeys(ENTRY_POINTS, 0)
    for name in ENTRY_POINTS:
        def counted(*a, _fn=getattr(eng_mod, name), _name=name):
            calls[_name] += 1
            return _fn(*a)

        monkeypatch.setattr(eng_mod, name, counted)
    teng = Engine(device="cpu", capacity=4096, min_width=8, max_width=32)
    for now, batch in request_stream(4096, 300, 25, 70):
        teng.get_rate_limits([RateLimitReq(**f) for f in batch], now_ms=now)
    assert all(calls.values()), calls


ENTRY_POINTS = ("decide_packed", "decide_packed_compact", "decide_packed_lean",
                "decide_scan_packed", "decide_scan_packed_compact",
                "decide_scan_packed_lean")


def test_warmup_leaves_table_untouched():
    teng = Engine(device="cpu", capacity=64, min_width=8, max_width=32)
    before = teng.state.clone()
    teng.warmup()
    assert torch.equal(before, teng.state)


@pytest.mark.parametrize("part", ["inject", "gather"])
def test_inject_and_gather_match_jax(monkeypatch, part):
    """The row inject and gather (engine.py:74, :86 of the JAX package, the
    inject fed through _apply_inject_rows :1123): the same rows land, slots
    below 0 or at and past C are dropped, algo and status are truncated
    through int32 ("inject"); a gather clamps its slots to [0, C-1]
    ("gather")."""
    from gubernator_tpu.models import engine as jeng_mod

    monkeypatch.setenv("GUBER_NO_NATIVE", "1")
    rng = np.random.RandomState(4)
    C = 32
    table = rng.randint(-5, 1000, (C, 8)).astype(np.int64)
    jeng = jeng_mod.Engine(capacity=C, min_width=8, max_width=32)
    teng = Engine(device="cpu", capacity=C, min_width=8, max_width=32)
    import jax.numpy as jnp

    jeng.state = jnp.asarray(table)
    teng.state = convert.table_to_torch(table, "cpu")
    inject = rng.randint(0, 100, (8, 8)).astype(np.int64)
    inject[:, 0] = [3, -1, 31, 0, 40, 7, C, 12]
    inject[:, 1] = [0, 1, (1 << 33) + 1, -(1 << 40) + 3, 1, 0, 1, (1 << 31) + 7]
    inject[:, 7] = [0, 1, (1 << 31) + 5, -(1 << 35) - 2, 0, 3, 0, -(1 << 31) - 1]
    if part == "inject":
        jeng._apply_inject_rows(inject)
        teng._apply_inject_rows(inject)
        np.testing.assert_array_equal(np.asarray(jeng.state),
                                      convert.table_to_numpy(teng.state))
        return
    slot = np.array([3, -1, 31, 0, -1, 7, C, 40, 12], np.int32)
    for w, g in zip(jeng_mod._gather_rows(jeng.state, jnp.asarray(slot)),
                    _gather_rows(teng.state, torch.from_numpy(slot))):
        np.testing.assert_array_equal(np.asarray(w), convert.to_numpy(g))


@pytest.mark.parametrize("directory", ["native", "python"])
def test_seed_mirror_edge_rows_match_jax(monkeypatch, directory):
    """seed_mirror on a key whose row sits at the table's last slot (C - 1),
    then lone decisions from that mirror; and on a key whose row is vacant
    (nothing to mirror: both engines answer False and decide on the kernel
    path)."""
    from gubernator_tpu import RateLimitReq as JReq

    C = 8
    jeng, teng = _engines(monkeypatch, directory, capacity=C, min_width=8, max_width=8)
    fields = [dict(name="api", unique_key=f"key{i}", hits=1, limit=5, duration=60_000)
              for i in range(C)]
    want = jeng.get_rate_limits([JReq(**f) for f in fields], now_ms=NOW)
    got = teng.get_rate_limits([RateLimitReq(**f) for f in fields], now_ms=NOW)
    assert [_resp_tuple(r) for r in got] == [_resp_tuple(r) for r in want]
    slot_of = dict(teng.directory.items())
    last = next(k for k, s in slot_of.items() if s == C - 1)
    vacant = next(k for k, s in slot_of.items() if s == 2)
    for eng in (jeng, teng):  # the row of `vacant` goes vacant (algo -1)
        if eng is jeng:
            jeng.state = jeng.state.at[2, 0].set(-1)
        else:
            teng.state[2, 0] = -1
    assert teng.seed_mirror(vacant) is jeng.seed_mirror(vacant) is False
    seeded = teng.seed_mirror(last)
    assert seeded == jeng.seed_mirror(last) == (directory == "native")
    by_key = {f"{f['name']}_{f['unique_key']}": f for f in fields}
    for f, native in ((by_key[last], seeded), (by_key[vacant], False)):
        t = NOW + 1
        w1 = jeng.decide_native_single(JReq(**f), now_ms=t)
        g1 = teng.decide_native_single(RateLimitReq(**f), now_ms=t)
        assert (g1 is None) == (w1 is None) == (not native)
        if g1 is None:
            w1 = jeng.get_rate_limits([JReq(**f)], now_ms=t)[0]
            g1 = teng.get_rate_limits([RateLimitReq(**f)], now_ms=t)[0]
        assert _resp_tuple(g1) == _resp_tuple(w1)
    _assert_same_end_state(jeng, teng)


class _StagingEvent:
    """The inject staging's event on the CPU: synchronize() stands where the
    card would have finished the last inject, and checks that the rows that
    inject read were not rewritten before it."""

    def __init__(self):
        self.cuda_event = 1
        self.launched = None

    def synchronize(self):
        if self.launched is not None:
            view, seen = self.launched
            np.testing.assert_array_equal(view, seen)
            self.launched = None


@pytest.mark.parametrize("staging", ["allocated", "reused"])
def test_scan_group_injects_match_jax(monkeypatch, staging):
    """Several windows of one scan group each surface dirty mirrors, so
    several injects run before the group's one fetch. Engines with
    min_width = max_width = 8 on the native directory: 40 keys get rows,
    mirrors and native decisions (dirty mirrors); then a batch of those 40
    keys and a few duplicates (wider than max_width: the python pipeline)
    splits round 0 into five windows of 8, one scan group, whose lookups
    each inject up to 8 rows. Responses, lone responses, tables and stats
    equal the JAX engine's. "reused": the port engine injects through an
    InjectStaging of max_width rows (a CPU buffer whose launches run the
    plain inject), the card's reuse rule, with every inject's rows checked
    unchanged until the next wait on the staging."""
    from gubernator_tpu import RateLimitReq as JReq
    from gubernator_tpu_torch.ops import rows

    jeng, teng = _engines(monkeypatch, "native", capacity=256, min_width=8, max_width=8)
    if staging == "reused":
        done = _StagingEvent()

        def launch(state, buf, m, ev):
            assert ev.launched is None, "the staging was handed out before the wait"
            view = buf.numpy()[:m]
            ev.launched = (view, view.copy())
            rows.inject_rows_plain(state, buf[:m])

        monkeypatch.setattr(rows, "inject_rows_pinned", launch)
        teng._inject = rows.InjectStaging(torch.zeros((8, 8), dtype=torch.int64), done)
    per_fetch, pending = [], [0]
    apply_inject, fetch = teng._apply_inject_rows, teng._fetch_staged

    def counted_inject(inject):
        pending[0] += 0 if inject is None or len(inject) == 0 else 1
        return apply_inject(inject)

    def counted_fetch(handle):
        per_fetch.append(pending[0])
        pending[0] = 0
        return fetch(handle)

    monkeypatch.setattr(teng, "_apply_inject_rows", counted_inject)
    monkeypatch.setattr(teng, "_fetch_staged", counted_fetch)
    rng = np.random.RandomState(3)
    keys = [dict(name="api", unique_key=f"key{k}", hits=1, limit=int(rng.choice([5, 50])),
                 duration=60_000, algorithm=int(rng.randint(0, 2))) for k in range(40)]
    now = NOW
    for start in range(0, 40, 8):  # every key gets a row
        batch = keys[start:start + 8]
        want = jeng.get_rate_limits([JReq(**f) for f in batch], now_ms=now)
        got = teng.get_rate_limits([RateLimitReq(**f) for f in batch], now_ms=now)
        assert [_resp_tuple(r) for r in got] == [_resp_tuple(r) for r in want]
    for rnd in range(3):
        now += 500
        for f in keys:  # a mirror for every key, dirtied by a native decision
            key = f["name"] + "_" + f["unique_key"]
            assert teng.seed_mirror(key) == jeng.seed_mirror(key) is True
            w1 = jeng.decide_native_single(JReq(**f), now_ms=now)
            g1 = teng.decide_native_single(RateLimitReq(**f), now_ms=now)
            assert g1 is not None and _resp_tuple(g1) == _resp_tuple(w1)
        batch = [dict(f, hits=int(rng.choice([0, 1, 2]))) for f in keys]
        batch += [dict(keys[int(k)]) for k in rng.choice(40, 4, replace=False)]
        order = rng.permutation(len(batch))
        batch = [batch[i] for i in order]
        want = jeng.get_rate_limits([JReq(**f) for f in batch], now_ms=now + 1)
        got = teng.get_rate_limits([RateLimitReq(**f) for f in batch], now_ms=now + 1)
        assert [_resp_tuple(r) for r in got] == [_resp_tuple(r) for r in want]
    _assert_same_end_state(jeng, teng)
    assert max(per_fetch) >= 5, per_fetch  # one group: five injects, one fetch
    if staging == "reused":  # a free() after an inject waits on its event
        assert 0 < teng._inject.waits <= sum(per_fetch) + pending[0]
