"""The port's native key directory against the JAX package's, bit for bit.

Both packages build the same keydir.cpp (the port keeps a byte-for-byte
copy) and bind it through ctypes. On one seeded stream of key batches, at a
roomy table and at a full one (LRU recycling), every call must give equal
results: lookup_inject (slots, fresh flags, dirty-mirror inject rows),
mirror_seed / decide_one / mirror_flush, peek_slot, drop, items and the
eviction count. prep_pack_fast, the one-pass window prep over request
objects, is compared on windows built in each package's own RateLimitReq
from the same fields: gregorian, invalid, duplicate and over-wide
(PREP_FALLBACK) windows, and over-committing ones at the full table. The
factory make_key_directory gives the python directory only under
GUBER_NO_NATIVE and raises when the build fails.
"""

import pathlib

import numpy as np
import pytest

from gubernator_tpu import RateLimitReq as JReq
from gubernator_tpu import native as jnative
from gubernator_tpu_torch import native as tnative
from gubernator_tpu_torch.models.keyspace import KeyDirectory
from gubernator_tpu_torch.ops import _build
from gubernator_tpu_torch.types import Behavior, RateLimitReq

REPO = pathlib.Path(__file__).resolve().parent.parent
NOW = 1_700_000_000_000
GREG = int(Behavior.DURATION_IS_GREGORIAN)
RESET = int(Behavior.RESET_REMAINING)


def test_keydir_source_is_the_jax_packages():
    assert ((REPO / "gubernator_tpu_torch/native/keydir.cpp").read_bytes()
            == (REPO / "gubernator_tpu/native/keydir.cpp").read_bytes())


def _key(k: int) -> str:
    # a few non-ASCII keys take the per-key encode path of _pack_keys
    return f"api_ключ{k}" if k % 17 == 0 else f"api_key{k}"


def _zipf(rng, n_keys, n):
    p = 1.0 / np.arange(1, n_keys + 1) ** 1.1
    return rng.choice(n_keys, n, p=p / p.sum())


def _mirror_row(rng, now):
    """A live-ish table row (algo, limit, remaining, duration, stamp,
    expire_at, status): mostly unexpired, some expired or switched."""
    limit = int(rng.choice([1, 5, 20, 100]))
    dur = int(rng.choice([1000, 60_000]))
    stamp = now - int(rng.randint(0, 2 * dur))
    return [int(rng.randint(0, 2)), limit, int(rng.randint(0, limit + 1)), dur,
            stamp, stamp + dur, int(rng.randint(0, 2))]


def _assert_lookup_equal(a, b):
    assert a[0] == b[0] and a[1] == b[1]
    np.testing.assert_array_equal(a[2], b[2])


@pytest.mark.parametrize("capacity,n_keys", [(512, 300), (40, 120)])
def test_directory_matches_jax(capacity, n_keys):
    jd, td = jnative.NativeKeyDirectory(capacity), tnative.NativeKeyDirectory(capacity)
    rng = np.random.RandomState(capacity)
    now = NOW
    for b in range(40):
        now += int(rng.choice([0, 5, 700, 3000]))
        keys = [_key(k) for k in _zipf(rng, n_keys, rng.randint(1, 31))]
        _assert_lookup_equal(td.lookup_inject(keys), jd.lookup_inject(keys))
        for k in rng.choice(keys, min(3, len(keys)), replace=False):
            row = _mirror_row(rng, now)
            td.mirror_seed(k, row)
            jd.mirror_seed(k, row)
        for _ in range(6):
            k = str(rng.choice(keys))
            args = (k, int(rng.choice([0, 1, 1, 2, 5])), int(rng.choice([1, 5, 20, 100])),
                    int(rng.choice([1000, 60_000])), int(rng.randint(0, 2)),
                    int(rng.choice([0, 0, 0, RESET])), now + int(rng.randint(0, 50)))
            assert td.decide_one(*args) == jd.decide_one(*args)
        probe = [_key(k) for k in rng.randint(0, n_keys, 5)]
        assert [td.peek_slot(k) for k in probe] == [jd.peek_slot(k) for k in probe]
        assert [k in td for k in probe] == [k in jd for k in probe]
        if b % 7 == 3:
            td.drop(probe[0])
            jd.drop(probe[0])
        if b % 10 == 9:
            np.testing.assert_array_equal(td.mirror_flush(2), jd.mirror_flush(2))
            np.testing.assert_array_equal(td.mirror_flush(), jd.mirror_flush())
        assert len(td) == len(jd)
        assert td.evictions == jd.evictions
    assert td.items() == jd.items()
    assert td.keys() == jd.keys()
    if capacity < n_keys:
        assert td.evictions > 0


def _window(rng, n_keys, n):
    """Request fields for one window: Zipf keys (duplicates) or, one window
    in four, distinct keys; a few gregorian lanes (some with an invalid
    code), empty names and keys."""
    out = []
    uniform = rng.rand() < 0.25 and n <= n_keys
    keys = rng.choice(n_keys, n, replace=False) if uniform else _zipf(rng, n_keys, n)
    for k in keys:
        u = rng.rand()
        f = dict(name="api", unique_key=f"key{k}", hits=int(rng.choice([0, 1, 1, 2])),
                 limit=int(rng.choice([5, 20])), duration=60_000,
                 algorithm=int(rng.randint(0, 2)), behavior=0)
        if u < 0.05:
            f.update(behavior=GREG, duration=int(rng.choice([0, 1, 99])))
        elif u < 0.08:
            f["behavior"] = RESET
        elif u < 0.1:
            f["name"] = ""
        elif u < 0.12:
            f["unique_key"] = ""
        out.append(f)
    return out


@pytest.mark.parametrize("capacity", [512, 24])
def test_prep_pack_fast_matches_jax(capacity):
    """24 slots under windows of up to 40 distinct keys: some windows
    over-commit (PREP_OVERCOMMIT) after mirror rows were collected."""
    jd, td = jnative.NativeKeyDirectory(capacity), tnative.NativeKeyDirectory(capacity)
    rng = np.random.RandomState(7 + capacity)
    width = 32
    codes = {"fallback": 0, "overcommit": 0, "inject": 0, "leftover": 0}
    for _ in range(40):
        n = int(rng.choice([1, 8, 31, 32, 40]))
        fields = _window(rng, 200, n)
        pj, pt = np.zeros((9, width), np.int64), np.zeros((9, width), np.int64)
        want = jnative.prep_pack_fast(jd, [JReq(**f) for f in fields], pj, GREG)
        got = tnative.prep_pack_fast(td, [RateLimitReq(**f) for f in fields], pt, GREG)
        assert got[0] == want[0]
        for g, w in zip(got[1:], want[1:]):
            if w is None:
                assert g is None
            else:
                np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(pt, pj)
        codes["fallback"] += got[0] == tnative.PREP_FALLBACK
        codes["overcommit"] += got[0] == tnative.PREP_OVERCOMMIT
        codes["inject"] += len(got[3])
        codes["leftover"] += 0 if got[2] is None else len(got[2])
        # dirty a few mirrors, so the next window's lookup injects them
        for f in fields[:4]:
            if f["name"] and f["unique_key"]:
                key = f["name"] + "_" + f["unique_key"]
                row = _mirror_row(rng, NOW)
                td.mirror_seed(key, row)
                jd.mirror_seed(key, row)
                args = (key, 1, row[1], row[3], row[0], 0, NOW)
                assert td.decide_one(*args) == jd.decide_one(*args)
    assert codes["fallback"] and codes["inject"] and codes["leftover"], codes
    if capacity < width:
        assert codes["overcommit"], codes


def test_make_key_directory_python_under_no_native(monkeypatch):
    monkeypatch.setenv("GUBER_NO_NATIVE", "1")
    assert isinstance(tnative.make_key_directory(8), KeyDirectory)
    monkeypatch.delenv("GUBER_NO_NATIVE")
    assert isinstance(tnative.make_key_directory(8), tnative.NativeKeyDirectory)


def test_make_key_directory_raises_when_the_build_fails(monkeypatch, tmp_path):
    """No silent fallback: a compiler that fails makes the factory, and so
    the Engine, raise; GUBER_NO_NATIVE still gives the python directory."""
    from gubernator_tpu_torch.models.engine import Engine

    monkeypatch.delenv("GUBER_NO_NATIVE", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "GXX", "false")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_PYLIB", None)
    with pytest.raises(RuntimeError, match="keydir.cpp"):
        tnative.make_key_directory(8)
    with pytest.raises(RuntimeError, match="keydir.cpp"):
        Engine(device="cpu", capacity=8)
    monkeypatch.setenv("GUBER_NO_NATIVE", "1")
    assert Engine(device="cpu", capacity=8)._prep_fast is None


def _garbage_rows(rows):
    """A caller's inject array (the engine's page-locked staging on the card)
    holding stale rows: only the rows the C call writes may be read back."""
    return np.full((rows, 8), -(1 << 50) + 3, np.int64)


@pytest.mark.parametrize("capacity", [512, 24])
def test_prep_pack_fast_into_caller_array_matches_jax(capacity):
    """The same window stream with lone-request mirrors, through the JAX
    binding, the port's binding with its own allocation, and the port's
    binding writing into one reused caller array (larger than any window,
    stale rows in it): equal n0, lanes, leftover, packed rows and inject
    rows, and the caller-array inject is a view of that array's first rows."""
    width = 32
    jd = jnative.NativeKeyDirectory(capacity)
    own, into = tnative.NativeKeyDirectory(capacity), tnative.NativeKeyDirectory(capacity)
    staging = _garbage_rows(width + 8)
    rng = np.random.RandomState(41 + capacity)
    injected = 0
    for _ in range(40):
        n = int(rng.choice([1, 8, 31, 32, 40]))
        fields = _window(rng, 200, n)
        packed = [np.zeros((9, width), np.int64) for _ in range(3)]
        want = jnative.prep_pack_fast(jd, [JReq(**f) for f in fields], packed[0], GREG)
        reqs = [RateLimitReq(**f) for f in fields]
        got_own = tnative.prep_pack_fast(own, reqs, packed[1], GREG)
        got_into = tnative.prep_pack_fast(into, reqs, packed[2], GREG, staging)
        for got in (got_own, got_into):
            assert got[0] == want[0]
            for g, w in zip(got[1:], want[1:]):
                if w is None:
                    assert g is None
                else:
                    np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(packed[1], packed[0])
        np.testing.assert_array_equal(packed[2], packed[0])
        assert np.shares_memory(got_into[3], staging) or len(got_into[3]) == 0
        if len(got_into[3]):
            assert got_into[3].__array_interface__["data"][0] == staging.ctypes.data
        injected += len(got_into[3])
        for f in fields[:4]:  # dirty a few mirrors in all three directories
            if f["name"] and f["unique_key"]:
                key = f["name"] + "_" + f["unique_key"]
                row = _mirror_row(rng, NOW)
                for d in (jd, own, into):
                    d.mirror_seed(key, row)
                args = (key, 1, row[1], row[3], row[0], 0, NOW)
                assert own.decide_one(*args) == into.decide_one(*args) == jd.decide_one(*args)
    assert injected > 0


@pytest.mark.parametrize("capacity,n_keys", [(512, 300), (40, 120)])
def test_lookup_inject_into_caller_array_matches_jax(capacity, n_keys):
    """lookup_inject on one seeded stream with dirty mirrors: the port
    writing into one reused caller array gives the slots, fresh flags and
    inject rows of its own allocation and of the JAX binding."""
    jd = jnative.NativeKeyDirectory(capacity)
    own, into = tnative.NativeKeyDirectory(capacity), tnative.NativeKeyDirectory(capacity)
    staging = _garbage_rows(31)
    rng = np.random.RandomState(capacity + n_keys)
    now, injected = NOW, 0
    for _ in range(40):
        now += int(rng.choice([0, 5, 700]))
        keys = [_key(k) for k in _zipf(rng, n_keys, rng.randint(1, 31))]
        want = jd.lookup_inject(keys)
        got_into = into.lookup_inject(keys, staging)
        _assert_lookup_equal(own.lookup_inject(keys), want)
        _assert_lookup_equal(got_into, want)
        if len(got_into[2]):
            assert got_into[2].__array_interface__["data"][0] == staging.ctypes.data
        injected += len(got_into[2])
        for k in rng.choice(keys, min(4, len(keys)), replace=False):
            row = _mirror_row(rng, now)
            for d in (jd, own, into):
                d.mirror_seed(k, row)
            args = (k, 1, row[1], row[3], row[0], 0, now + 1)
            assert own.decide_one(*args) == into.decide_one(*args) == jd.decide_one(*args)
    assert injected > 0


@pytest.mark.parametrize("bad,match", [
    (np.zeros((8, 8), np.int32), r"got int32\(8, 8\)"),
    (np.zeros((8, 7), np.int64), r"got int64\(8, 7\)"),
    (np.zeros((2, 8), np.int64), r">= 3, 8\], got int64\(2, 8\)"),
    (np.zeros((8, 16), np.int64)[:, ::2], r"got int64\(8, 8\)"),
    (np.zeros(64, np.int64), r"got int64\(64,\)"),
])
def test_caller_inject_array_is_checked(bad, match):
    """A caller's inject array the C call could overrun or misread is
    refused before the call: wrong dtype, row width, too few rows for the
    keys, a strided view, one dimension."""
    d = tnative.NativeKeyDirectory(16)
    with pytest.raises(ValueError, match=match):
        d.lookup_inject(["a", "b", "c"], bad)
    assert len(d) == 0  # nothing was looked up
