"""The port's Engine on the CPU against the JAX package's Engine, bit for bit.

Both engines take one seeded request stream, batch by batch at the same
now_ms, and must give equal responses (status, limit, remaining, reset,
error) and equal whole tables. The JAX engine is built with
GUBER_NO_NATIVE=1, so both use the same pure-Python KeyDirectory and assign
the same slots. The stream covers duplicate keys across rounds, the scan
tail, expiry as now_ms advances, error strings, gregorian durations, every
staging format, and slot recycling once the directory is full.
"""

import numpy as np
import pytest
import torch

from gubernator_tpu_torch import convert
from gubernator_tpu_torch.models.engine import Engine, _gather_rows, _inject_rows
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


def _jax_engine(monkeypatch, **kw):
    monkeypatch.setenv("GUBER_NO_NATIVE", "1")
    from gubernator_tpu.models.engine import Engine as JaxEngine

    return JaxEngine(**kw)


def _resp_tuple(r):
    return (int(r.status), r.limit, r.remaining, r.reset_time, r.error)


@pytest.mark.parametrize("capacity,n_keys,staging", [
    (4096, 300, "auto"),   # roomy table: rounds, scan tail, every format
    (40, 120, "auto"),     # full directory: LRU slot recycling
    (4096, 300, "wide"),   # the wide-only pin
])
def test_engine_matches_jax(monkeypatch, capacity, n_keys, staging):
    monkeypatch.setenv("GUBER_STAGING", staging)
    kw = dict(capacity=capacity, min_width=8, max_width=32)
    jeng = _jax_engine(monkeypatch, **kw)
    teng = Engine(device="cpu", **kw)
    assert teng.state.device.type == "cpu"
    from gubernator_tpu import RateLimitReq as JReq

    for now, batch in request_stream(capacity, n_keys, 25, 70):
        want = jeng.get_rate_limits([JReq(**f) for f in batch], now_ms=now)
        got = teng.get_rate_limits([RateLimitReq(**f) for f in batch], now_ms=now)
        assert [_resp_tuple(r) for r in got] == [_resp_tuple(r) for r in want]
    np.testing.assert_array_equal(np.asarray(jeng.state),
                                  convert.table_to_numpy(teng.state))
    assert teng.key_count() == jeng.key_count()
    if capacity < n_keys:
        assert teng.directory.evictions > 0


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


def test_inject_and_gather_match_jax():
    """The row inject and gather (engine.py:74, :86 of the JAX package) as
    plain tensor indexing: the same rows land, -1 lanes are dropped."""
    from gubernator_tpu.models import engine as jeng_mod

    rng = np.random.RandomState(4)
    C = 32
    table = rng.randint(-5, 1000, (C, 8)).astype(np.int64)
    slot = np.array([3, -1, 31, 0, -1, 7], np.int32)
    cols = [rng.randint(0, 100, 6).astype(dt) for dt in
            (np.int32,) + (np.int64,) * 5 + (np.int32,)]
    import jax.numpy as jnp

    want = jeng_mod._inject_rows(jnp.asarray(table), jnp.asarray(slot),
                                 *map(jnp.asarray, cols))
    got = convert.table_to_torch(table, "cpu")
    _inject_rows(got, torch.from_numpy(slot),
                 *[torch.from_numpy(c) for c in cols])
    np.testing.assert_array_equal(np.asarray(want), convert.to_numpy(got))
    for w, g in zip(jeng_mod._gather_rows(want, jnp.asarray(slot)),
                    _gather_rows(got, torch.from_numpy(slot))):
        np.testing.assert_array_equal(np.asarray(w), convert.to_numpy(g))
