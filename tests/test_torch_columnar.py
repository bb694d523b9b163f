"""The port's columnar path against the JAX package's, bit for bit.

Wire columns (the peerlink layout, built by cols_from as
tests/test_columnar_pipeline.py builds them) go through both engines:
lock-step submit_columnar / complete_columnar, and the pipelined
launch_columnar_windows / collect_columnar_windows loop at depth 3 and scan 4
(drain everything on a cut, leftovers through the request-object path). Every
response field, the whole table and the EngineStats counters must be equal
between the packages, and the port's pipelined loop must answer as its
lock-step one. The cases: random chunks (duplicates, gregorian, invalid,
RESET_REMAINING, both algorithms), the group cut at m = 5 of 8, over-commit
launching its prefix and reporting, and a mixed-width group after
bucket_splits. bucket_splits and native.prep_pack_columnar are held equal to
the JAX package's on their own.
"""

import collections

import numpy as np
import pytest
import torch

from gubernator_tpu_torch import convert
from gubernator_tpu_torch import native as tnative
from gubernator_tpu_torch.models.engine import Engine
from gubernator_tpu_torch.models.prep import bucket_splits
from gubernator_tpu_torch.types import Algorithm, Behavior, RateLimitReq

NOW = 1_700_000_000_000
SLOW = (int(Behavior.DURATION_IS_GREGORIAN) | int(Behavior.GLOBAL)
        | int(Behavior.MULTI_REGION))
KW = dict(capacity=2048, min_width=8, max_width=16)
COUNTERS = ("requests", "batches", "rounds", "over_limit", "errors")


def cols_from(reqs):
    """The peerlink wire layout of one sub-window, as a launch tuple."""
    names = [r.name.encode() for r in reqs]
    ukeys = [r.unique_key.encode() for r in reqs]
    keys = b"".join(a + b for a, b in zip(names, ukeys))
    off = np.zeros(len(reqs) + 1, np.int32)
    np.cumsum([len(a) + len(b) for a, b in zip(names, ukeys)], out=off[1:])
    return (len(reqs), keys, off,
            np.array([len(a) for a in names], np.int32),
            np.array([r.hits for r in reqs], np.int64),
            np.array([r.limit for r in reqs], np.int64),
            np.array([r.duration for r in reqs], np.int64),
            np.array([int(r.algorithm) for r in reqs], np.int32),
            np.array([int(r.behavior) for r in reqs], np.int32))


class Side:
    """One package's engine, its request class and its bucket_splits."""

    def __init__(self, which):
        if which == "jax":
            from gubernator_tpu import RateLimitReq as JReq
            from gubernator_tpu.models.engine import Engine as JaxEngine
            from gubernator_tpu.models.prep import bucket_splits as jsplits

            self.eng, self.req, self.splits = JaxEngine(**KW), JReq, jsplits
        else:
            self.eng = Engine(device="cpu", **KW)
            self.req, self.splits = RateLimitReq, bucket_splits
        assert self.eng.supports_columnar()

    def reqs(self, fields):
        return [self.req(**f) for f in fields]

    def table(self):
        st = self.eng.state
        return convert.table_to_numpy(st) if isinstance(st, torch.Tensor) else np.asarray(st)


def _outs(n):
    return (np.zeros(n, np.int32), np.zeros(n, np.int64),
            np.zeros(n, np.int64), np.zeros(n, np.int64))


def _object_path(eng, outs, i, req, now_ms):
    r = eng.get_rate_limits([req], now_ms=now_ms)[0]
    for col, v in zip(outs, (r.status, r.limit, r.remaining, r.reset_time)):
        col[i] = v


def run_lockstep(side, fields, now_ms):
    """Complete sub-window i before submitting i+1; leftovers through the
    object path after each."""
    eng, reqs = side.eng, side.reqs(fields)
    outs = _outs(len(reqs))
    s0 = 0
    for ln in side.splits(len(reqs), eng.min_width, eng.max_width):
        s1 = s0 + ln
        h = eng.submit_columnar(*cols_from(reqs[s0:s1]), SLOW, now_ms=now_ms)
        assert h is not None
        left = eng.complete_columnar(h, *(c[s0:s1] for c in outs))
        for i in left.tolist():
            _object_path(eng, outs, s0 + i, reqs[s0 + i], now_ms)
        s0 = s1
    return outs


def run_pipelined(side, fields, now_ms, depth=3, scan=4, staging=None):
    """The peerlink loop distilled: scan-group launches with `depth` in
    flight, collected in launch order, and on any group cut a barrier
    (collect everything, retire leftovers through the object path)."""
    eng, reqs = side.eng, side.reqs(fields)
    outs = _outs(len(reqs))
    spans, s0 = [], 0
    for ln in side.splits(len(reqs), eng.min_width, eng.max_width):
        spans.append((s0, s0 + ln))
        s0 += ln
    staging = staging or [dict() for _ in range(depth + 2)]
    inflight = collections.deque()
    stats = {"groups": 0, "cuts": 0, "max_inflight": 0}
    wi = seq = 0

    def drain_one():
        h, gspans = inflight.popleft()
        gouts = [tuple(c[a:b] for c in outs) for a, b in gspans]
        for (a, _b), left in zip(gspans, eng.collect_columnar_windows(h, gouts)):
            for i in left.tolist():
                _object_path(eng, outs, a + i, reqs[a + i], now_ms)

    while wi < len(spans) or inflight:
        barrier = False
        while wi < len(spans) and len(inflight) < depth:
            gspans = spans[wi:wi + scan]
            h = eng.launch_columnar_windows(
                [cols_from(reqs[a:b]) for a, b in gspans], SLOW, now_ms=now_ms,
                staging=staging[seq % len(staging)])
            assert h is not None
            seq += 1
            consumed = len(h[0])
            wi += consumed
            inflight.append((h, gspans[:consumed]))
            stats["groups"] += 1
            stats["max_inflight"] = max(stats["max_inflight"], len(inflight))
            if h[1] is not None:
                raise RuntimeError(h[1])
            if consumed < len(gspans) or (consumed and len(h[0][-1][-1])):
                stats["cuts"] += 1
                barrier = True
                break
        if inflight:
            if barrier or wi >= len(spans):
                while inflight:
                    drain_one()
            else:
                drain_one()
    return outs, stats


def _random_fields(rng, n, n_keys=25):
    out = []
    for _ in range(n):
        kind = rng.random()
        beh, duration = 0, 60_000
        key = f"k{rng.integers(0, n_keys)}"
        if kind < 0.05:
            beh = int(Behavior.DURATION_IS_GREGORIAN)
            duration = int(rng.integers(0, 2))
            key = f"g{rng.integers(0, 3)}"
        elif kind < 0.08:
            key = ""  # invalid: an error lane through the object path
        elif kind < 0.12:
            beh = int(Behavior.RESET_REMAINING)
        out.append(dict(name="cp", unique_key=key, hits=int(rng.integers(0, 3)),
                        limit=40, duration=duration,
                        algorithm=int(Algorithm.TOKEN_BUCKET if rng.random() < .7
                                      else Algorithm.LEAKY_BUCKET),
                        behavior=beh))
    return out


def _same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _same_engines(jax_side, port_side):
    np.testing.assert_array_equal(jax_side.table(), port_side.table())
    assert ({c: getattr(port_side.eng.stats, c) for c in COUNTERS}
            == {c: getattr(jax_side.eng.stats, c) for c in COUNTERS})


@pytest.mark.parametrize("mode", ["lockstep", "pipelined"])
def test_random_chunks_match_jax(mode):
    """Random chunks through both packages' engines, lock-step or
    pipelined (a dict a slot, reused across chunks): equal fields, tables
    and counters; the port's pipelined loop also equals its lock-step."""
    jax_side, port_side, lock_side = Side("jax"), Side("port"), Side("port")
    run = run_lockstep if mode == "lockstep" else run_pipelined
    jax_slots, port_slots = [dict() for _ in range(5)], [dict() for _ in range(5)]
    rng = np.random.default_rng(17)
    for it in range(10):
        fields = _random_fields(rng, int(rng.integers(20, 120)))
        now = NOW + it * 500
        if mode == "lockstep":
            want, got = run(jax_side, fields, now), run(port_side, fields, now)
        else:
            want = run(jax_side, fields, now, staging=jax_slots)
            got = run(port_side, fields, now, staging=port_slots)
        if mode == "pipelined":
            (want, _), (got, _) = want, got
            _same(got, run_lockstep(lock_side, fields, now))
        _same(got, want)
    _same_engines(jax_side, port_side)


def test_distinct_keys_fill_the_pipeline():
    side = Side("port")
    fields = [dict(name="cp", unique_key=f"d{i}", hits=1, limit=10, duration=60_000)
              for i in range(256)]
    (st, _li, re, _rs), stats = run_pipelined(side, fields, NOW, depth=3, scan=4)
    assert (st == 0).all() and (re == 9).all()
    assert stats["cuts"] == 0 and stats["max_inflight"] == 3
    assert stats["groups"] == 4  # 16 windows / scan 4


def test_hammer_cuts_and_keeps_wire_order():
    side = Side("port")
    fields = [dict(name="cp", unique_key="hot", hits=1, limit=1000, duration=60_000)
              for _ in range(96)]
    (st, _li, re, _rs), stats = run_pipelined(side, fields, NOW, depth=4, scan=4)
    assert re.tolist() == list(range(999, 999 - 96, -1))
    assert (st == 0).all() and stats["cuts"] > 0


def _cut_windows():
    wins = [[dict(name="s", unique_key=f"w{w}k{i}", hits=1, limit=100, duration=60_000)
             for i in range(16)] for w in range(8)]
    wins[4][15] = dict(wins[4][0])  # window 4 ends with a duplicate: cut at m = 5
    return wins


def test_group_cut_matches_jax():
    """A cut at window m = 5 of 8 launches only the prepped windows (the
    zeroed rows of the rest would be live slot-0 lanes): both packages
    consume 5, answer alike and leave equal tables."""
    sides = Side("jax"), Side("port")
    got = []
    for side in sides:
        h = side.eng.launch_columnar_windows(
            [cols_from(side.reqs(w)) for w in _cut_windows()], SLOW, now_ms=NOW)
        assert h is not None and len(h[0]) == 5 and h[1] is None
        outs = [_outs(16) for _ in range(5)]
        lefts = side.eng.collect_columnar_windows(h, outs)
        assert [len(x) for x in lefts] == [0, 0, 0, 0, 1]
        after = side.eng.get_rate_limits(side.reqs([_cut_windows()[0][0]]), now_ms=NOW)
        got.append((outs, after[0].remaining))
    (jo, jr), (po, pr) = got
    for a, b in zip(jo, po):
        _same(a, b)
    assert jr == pr == 98
    _same_engines(*sides)


def test_over_commit_launches_prefix_and_reports(monkeypatch):
    """Over-commit mid-group (the C prep stubbed for the second window, as
    a real over-commit cannot happen with max_width <= capacity): the
    window prepped before it still launches, the handle carries the error,
    and both packages agree."""
    from gubernator_tpu import native as jnative

    sides = Side("jax"), Side("port")
    results = []
    for side, mod in zip(sides, (jnative, tnative)):
        real = mod.prep_pack_columnar
        calls = {"n": 0}

        def failing(directory, n, *args, _real=real, _calls=calls, _mod=mod):
            _calls["n"] += 1
            if _calls["n"] == 2:
                return _mod.PREP_OVERCOMMIT, None, None, np.empty((0, 8), np.int64)
            return _real(directory, n, *args)

        monkeypatch.setattr(mod, "prep_pack_columnar", failing)
        wins = [[dict(name="o", unique_key=f"w{w}k{i}", hits=1, limit=50,
                      duration=60_000) for i in range(10)] for w in range(3)]
        h = side.eng.launch_columnar_windows(
            [cols_from(side.reqs(w)) for w in wins], SLOW, now_ms=NOW)
        monkeypatch.setattr(mod, "prep_pack_columnar", real)
        assert h is not None and len(h[0]) == 1 and "over-committed" in h[1]
        outs = [_outs(10)]
        assert len(side.eng.collect_columnar_windows(h, outs)[0]) == 0
        assert outs[0][2].tolist() == [49] * 10  # the prefix really decided
        results.append(outs[0])
    _same(*results)
    _same_engines(*sides)


def test_mixed_width_group_after_bucket_splits():
    """A chunk one item past a window boundary: the tail sub-window rides
    the same scan group at the group's widest bucket, in both packages."""
    fields = [dict(name="mx", unique_key=f"t{i}", hits=1, limit=10, duration=60_000)
              for i in range(33)]
    sides = Side("jax"), Side("port")
    got = [run_pipelined(side, fields, NOW, depth=2, scan=4) for side in sides]
    for outs, stats in got:
        assert (outs[0] == 0).all() and (outs[2] == 9).all()
        assert stats["groups"] == 1  # [16, 16, 1] in one launch
    _same(got[0][0], got[1][0])
    _same_engines(*sides)


@pytest.mark.parametrize("lo,hi", [(8, 16), (8, 256), (64, 5000), (64, 8192), (1, 3)])
def test_bucket_splits_match_jax(lo, hi):
    from gubernator_tpu.models.prep import bucket_splits as jsplits

    for n in [*range(1, 70), 255, 256, 257, 300, 4096, 8191, 8193, 10_001, 40_000]:
        got = bucket_splits(n, lo, hi)
        assert got == jsplits(n, lo, hi)
        assert sum(got) == n and all(0 < ln <= hi for ln in got)


@pytest.mark.parametrize("capacity", [2048, 24])
def test_prep_pack_columnar_matches_jax(capacity):
    """The binding on the same columns, window after window on a roomy and
    on a full directory: equal n0, lane items, leftovers, inject rows and
    staging rows; over-wide windows give PREP_FALLBACK in both, and the
    port's writes its inject rows into the caller's array."""
    from gubernator_tpu import native as jnative

    jd, td = jnative.NativeKeyDirectory(capacity), tnative.NativeKeyDirectory(capacity)
    rng = np.random.default_rng(capacity)
    for it in range(12):
        n = int(rng.integers(1, 17))
        cols = cols_from([RateLimitReq(**f) for f in _random_fields(rng, n, n_keys=40)])
        width = 16 if it != 5 else n - 1 if n > 1 else 0
        if width == 0:
            continue
        jp, tp = np.zeros((9, width), np.int64), np.zeros((9, width), np.int64)
        want = jnative.prep_pack_columnar(jd, *cols, SLOW, jp)
        inject = np.full((16, 8), -7, np.int64)
        got = tnative.prep_pack_columnar(td, *cols, SLOW, tp, inject)
        assert got[0] == want[0]
        if want[0] < 0:
            assert want[0] == tnative.PREP_FALLBACK
            continue
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(tp, jp)
        if len(got[3]):
            assert np.shares_memory(got[3], inject)
    assert len(td) == len(jd) and td.evictions == jd.evictions
