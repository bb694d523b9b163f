"""The interned staging format and the config-interning native preps, the
port's against the JAX package's, bit for bit.

- tests/test_decide.py's TestInternedStaging and InternCache cases through
  the port: the numpy interners (intern_window, InternCache) must emit what
  the JAX package's emit, and the port's decide_packed_interned and its scan
  form must answer and write the table as the JAX functions do, and as the
  wide format does on the same window. A config table shorter than 256 rows
  reads its last row for an id past it, as XLA's gather clamps.
- tests/test_columnar.py's TestInternedPrep and TestLeanPrep: the port's
  native prep_pack_interned / prep_pack_lean against the JAX package's on
  the same wire columns, each on its own engine: the packed lanes, leftovers,
  inject rows and config tables must be equal, and so must the answers and
  the tables after the kernels and the leftover path.
- The CUDA wrapper's checks and counts for the interned format, with a
  stand-in library.

On the CPU the port's entry points run the plain versions; the interned
kernel in csrc/decide.cu is held to them on the card by chip_smoke.py.
"""

import importlib
import random
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from gubernator_tpu import native as jnative
from gubernator_tpu.models.engine import Engine as JEngine
from gubernator_tpu.types import RateLimitReq as JReq
from gubernator_tpu_torch import convert
from gubernator_tpu_torch import native as tnative
from gubernator_tpu_torch.models.engine import Engine
from gubernator_tpu_torch.ops import decide as td
from gubernator_tpu_torch.types import Behavior, RateLimitReq

jd = importlib.import_module("gubernator_tpu.ops.decide")

NOW = 1_700_000_000_000
RESET = int(Behavior.RESET_REMAINING)
GREG = int(Behavior.DURATION_IS_GREGORIAN)
SLOW = GREG | int(Behavior.GLOBAL) | int(Behavior.MULTI_REGION)

_J = {name: jax.jit(getattr(jd, name)) for name in (
    "decide_packed", "decide_packed_interned", "decide_scan_packed_interned",
    "decide_packed_lean")}


def rand_wide(rng, r, C, B, behaviors):
    """tests/test_decide.py TestCompactStaging._rand_wide: distinct slots,
    padding past a random live count, values inside the interned range."""
    p = np.zeros((9, B), np.int64)
    n = r.randint(1, B)
    p[0, :n] = rng.choice(C, n, replace=False)
    p[0, n:] = -1
    p[1, :n] = rng.randint(0, 6, n)
    p[2, :n] = rng.choice([1, 5, 100, 10_000, 2**30], n)
    p[3, :n] = rng.choice([500, 60_000, 2**31 - 1], n)
    p[4, :n] = rng.randint(0, 2, n)
    p[5, :n] = rng.choice(behaviors, n)
    p[8, :n] = rng.randint(0, 2, n)
    return p


def tables(C):
    return jd.make_table(C), td.make_table(C, "cpu")


def t_interned(state, iw, cfg, now, scan=False):
    fn = td.decide_scan_packed_interned if scan else td.decide_packed_interned
    return fn(state, torch.from_numpy(np.ascontiguousarray(iw)),
              torch.from_numpy(np.ascontiguousarray(cfg)), now).numpy()


# -------------------------------------- TestInternedStaging through the port

@pytest.mark.parametrize("seed", range(4))
def test_interned_matches_jax_and_wide(seed):
    r = random.Random(seed)
    rng = np.random.RandomState(seed)
    C, B = 256, 32
    behaviors = [0, RESET, int(Behavior.NO_BATCHING)]
    j_st, t_st = tables(C)
    t_wide = td.make_table(C, "cpu")
    for i in range(12):
        now = NOW + i * 1000
        wide = rand_wide(rng, r, C, B, behaviors)
        iw, cfg = td.intern_window(wide)
        j_iw, j_cfg = jd.intern_window(wide)
        np.testing.assert_array_equal(iw, j_iw)
        np.testing.assert_array_equal(cfg, j_cfg)
        assert iw.dtype == np.int32 and iw.shape == (2, B) and cfg.shape == (256, 2)
        j_st, j_out = _J["decide_packed_interned"](j_st, iw, cfg, now)
        out = t_interned(t_st, iw, cfg, now)
        np.testing.assert_array_equal(out, np.asarray(j_out))
        w_out = td.decide_packed(t_wide, torch.from_numpy(wide), now).numpy()
        np.testing.assert_array_equal(w_out, td.widen_compact_out(out, now))
    np.testing.assert_array_equal(t_st.numpy(), np.asarray(j_st))
    np.testing.assert_array_equal(t_st.numpy(), t_wide.numpy())


@pytest.mark.parametrize("K,B", [(6, 16), (2, 64), (32, 8)])
def test_interned_scan_matches_jax(K, B):
    r = random.Random(K * 100 + B)
    rng = np.random.RandomState(K * 100 + B)
    C = 256
    wide = np.stack([rand_wide(rng, r, C, B, [0, RESET]) for _ in range(K)])
    # windows share rows: a scan must apply them in order
    wide[1:, 0, 0] = wide[0, 0, 0] if wide[0, 0, 0] >= 0 else 3
    iw, cfg = td.intern_window(wide)
    assert iw.shape == (K, 2, B)
    j_st, j_out = _J["decide_scan_packed_interned"](jd.make_table(C), iw, cfg, NOW)
    t_st = td.make_table(C, "cpu")
    out = t_interned(t_st, iw, cfg, NOW, scan=True)
    np.testing.assert_array_equal(out, np.asarray(j_out))
    np.testing.assert_array_equal(t_st.numpy(), np.asarray(j_st))


def test_rejects_what_it_cannot_represent():
    base = np.zeros((9, 4), np.int64)
    base[0] = [0, 1, 2, -1]
    base[1:4] = 1
    cases = {"base": base}
    for name, (row, lane, v) in {"big_hits": (1, 1, 1 << 15), "neg": (1, 0, -1),
                                 "too_big": (2, 1, 2**31), "greg": (5, 2, GREG)}.items():
        c = base.copy()
        c[row, lane] = v
        cases[name] = c
    many = np.zeros((9, td.INTERN_MAX_CFG + 1), np.int64)
    many[0] = np.arange(td.INTERN_MAX_CFG + 1)
    many[1] = 1
    many[2] = np.arange(td.INTERN_MAX_CFG + 1) + 1
    many[3] = 1000
    cases["257"] = many.copy()
    many[2, td.INTERN_MAX_CFG] = many[2, 0]
    cases["256"] = many
    for name, c in cases.items():
        got, want = td.intern_window(c), jd.intern_window(c)
        assert (got is None) == (want is None), name
        if got is not None:
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    assert td.intern_window(cases["base"]) is not None
    assert all(td.intern_window(cases[n]) is None
               for n in ("big_hits", "neg", "too_big", "greg", "257"))
    iw, cfg = td.intern_window(cases["256"])
    cfgids = (iw[1] >> 23) & 0xFF
    np.testing.assert_array_equal(cfg[cfgids, 0], cases["256"][2])
    np.testing.assert_array_equal(cfg[cfgids, 1], cases["256"][3])


def test_hits_zero_peek_and_fresh():
    j_st, t_st = tables(16)
    mk = np.zeros((9, 2), np.int64)
    mk[0] = [3, -1]
    mk[1, 0], mk[2, 0], mk[3, 0], mk[8, 0] = 2, 10, 60_000, 1
    iw, cfg = td.intern_window(mk)
    j_st, _ = _J["decide_packed_interned"](j_st, iw, cfg, NOW)
    t_interned(t_st, iw, cfg, NOW)
    peek = mk.copy()
    peek[1, 0] = 0
    peek[8, 0] = 0
    iw2, cfg2 = td.intern_window(peek)
    j_st, j_out = _J["decide_packed_interned"](j_st, iw2, cfg2, NOW + 5)
    out = t_interned(t_st, iw2, cfg2, NOW + 5)
    np.testing.assert_array_equal(out, np.asarray(j_out))
    np.testing.assert_array_equal(t_st.numpy(), np.asarray(j_st))
    assert out[2, 0] == 8  # the peek reported and deducted nothing


@pytest.mark.parametrize("n_cfg", [1, 7, 255])
def test_short_config_table_clamps_like_xla(n_cfg):
    """A config table of fewer than 256 rows: ids past it read its last row,
    in the JAX function (XLA's gather clamps) and in the port's plain
    version alike; the CUDA wrapper pads the table to 256 rows that way."""
    rng = np.random.RandomState(n_cfg)
    B = 64
    iw = np.zeros((2, B), np.int32)
    iw[0] = rng.permutation(128)[:B]
    iw[1] = (rng.randint(0, 4, B) | (rng.randint(0, 2, B) << 15)
             | (rng.randint(0, 256, B) << 23))
    cfg = np.stack([rng.randint(1, 50, n_cfg), rng.choice([1000, 60_000], n_cfg)],
                   axis=1).astype(np.int64)
    j_st, j_out = _J["decide_packed_interned"](jd.make_table(128), iw, cfg, NOW)
    t_st = td.make_table(128, "cpu")
    np.testing.assert_array_equal(t_interned(t_st, iw, cfg, NOW), np.asarray(j_out))
    np.testing.assert_array_equal(t_st.numpy(), np.asarray(j_st))
    padded = td._pad_interned_cfg(torch.from_numpy(cfg))
    assert padded.shape == (256, 2)
    assert torch.equal(padded[:n_cfg], torch.from_numpy(cfg))
    assert (padded[n_cfg:] == torch.from_numpy(cfg[-1])).all()


def test_intern_cache_matches_jax():
    """Across windows that grow the table, the port's InternCache emits the
    JAX cache's meta words and config table, and decides as the wide
    format does."""
    r = random.Random(21)
    rng = np.random.RandomState(21)
    C, B = 256, 32
    cache, j_cache = td.InternCache(), jd.InternCache()
    j_st, t_st = tables(C)
    t_wide = td.make_table(C, "cpu")
    for i in range(10):
        wide = rand_wide(rng, r, C, B, [0])
        iw = cache.intern(wide)
        np.testing.assert_array_equal(iw, j_cache.intern(wide))
        np.testing.assert_array_equal(cache.cfg, j_cache.cfg)
        assert cache.n_cfg == j_cache.n_cfg <= td.INTERN_MAX_CFG
        j_st, j_out = _J["decide_packed_interned"](j_st, iw, cache.cfg, NOW + i)
        out = t_interned(t_st, iw, cache.cfg, NOW + i)
        np.testing.assert_array_equal(out, np.asarray(j_out))
        w_out = td.decide_packed(t_wide, torch.from_numpy(wide), NOW + i).numpy()
        np.testing.assert_array_equal(w_out, td.widen_compact_out(out, NOW + i))
    np.testing.assert_array_equal(t_st.numpy(), np.asarray(j_st))


def test_intern_cache_overflow_and_ineligible_leave_cache_intact():
    cache = td.InternCache()
    base = np.zeros((9, 4), np.int64)
    base[0] = [0, 1, 2, -1]
    base[1] = 1
    base[2] = [7, 7, 7, 0]
    base[3] = 1000
    assert cache.intern(base) is not None
    n0 = cache.n_cfg
    greg = base.copy()
    greg[5, 1] = GREG
    assert cache.intern(greg) is None and cache.n_cfg == n0
    many = np.zeros((9, td.INTERN_MAX_CFG + 1), np.int64)
    many[0] = np.arange(td.INTERN_MAX_CFG + 1)
    many[1] = 1
    many[2] = np.arange(td.INTERN_MAX_CFG + 1) + 100
    many[3] = 999
    assert cache.intern(many) is None and cache.n_cfg == n0
    np.testing.assert_array_equal(cache.intern(base), jd.InternCache().intern(base))


def test_staging_to_torch_takes_interned():
    wide = np.zeros((2, 9, 8), np.int64)
    wide[:, 0] = -1
    iw, cfg = td.intern_window(wide)
    t_iw, t_cfg = convert.staging_to_torch(iw, cfg, device="cpu")
    assert t_iw.dtype == torch.int32 and t_iw.shape == (2, 2, 8) and t_cfg.shape == (256, 2)
    with pytest.raises(ValueError, match="interned staging"):
        convert.staging_to_torch(iw[:, :1], cfg, device="cpu")


# --------------------------------------------- the native preps, port vs JAX

@pytest.fixture
def jax_lib(monkeypatch):
    """The JAX package's native library, for one test. Its _build_lib writes
    every build to one temporary name, so a test process that builds it while
    another does can fail once and cache the failure; the library is in place
    after the other build, so the load is tried again. The module's load
    state (_LIB, _LIB_ERR) is put back as it was when the test ends: the
    retries are this test's alone, and a failure cached before it stays
    cached for the tests after it."""
    monkeypatch.setattr(jnative, "_LIB", jnative._LIB)
    monkeypatch.setattr(jnative, "_LIB_ERR", jnative._LIB_ERR)
    for _ in range(10):
        try:
            return jnative.load_library()
        except RuntimeError:
            monkeypatch.setattr(jnative, "_LIB_ERR", None)
            time.sleep(0.5)
    return jnative.load_library()


def cols_from(reqs):
    """tests/test_columnar.py cols_from: the peerlink wire columns."""
    names = [r.name.encode() for r in reqs]
    ukeys = [r.unique_key.encode() for r in reqs]
    keys = b"".join(a + b for a, b in zip(names, ukeys))
    off = np.zeros(len(reqs) + 1, np.int32)
    np.cumsum([len(a) + len(b) for a, b in zip(names, ukeys)], out=off[1:])
    return dict(
        n=len(reqs), keys=keys, key_off=off,
        name_len=np.array([len(a) for a in names], np.int32),
        hits=np.array([r.hits for r in reqs], np.int64),
        limit=np.array([r.limit for r in reqs], np.int64),
        duration=np.array([r.duration for r in reqs], np.int64),
        algorithm=np.array([int(r.algorithm) for r in reqs], np.int32),
        behavior=np.array([int(r.behavior) for r in reqs], np.int32))


def _prep(mod, fmt, eng, state, c, iw):
    fn = mod.prep_pack_interned if fmt == "interned" else mod.prep_pack_lean
    return fn(eng.directory, c["n"], c["keys"], c["key_off"], c["name_len"], c["hits"],
              c["limit"], c["duration"], c["algorithm"], c["behavior"], SLOW, iw, state)


def _engines(capacity=4096, max_width=256):
    return (JEngine(capacity=capacity, min_width=16, max_width=max_width),
            Engine(capacity=capacity, min_width=16, max_width=max_width, device="cpu"))


def _states(fmt):
    if fmt == "interned":
        return jnative.InternPrepState(), tnative.InternPrepState()
    return jnative.LeanPrepState(), tnative.LeanPrepState()


def run_both(fmt, je, te, jstate, tstate, fields, now):
    """One window of wire columns through each package's prep, kernel and
    leftover path; everything the two do must be equal. Returns the
    answers."""
    c = cols_from([RateLimitReq(**f) for f in fields])
    n = c["n"]
    width = max(16, 1 << (n - 1).bit_length())
    shape = (2, width) if fmt == "interned" else (width,)
    j_iw, t_iw = np.empty(shape, np.int32), np.empty(shape, np.int32)
    jn0, jlane, jleft, jinj = _prep(jnative, fmt, je, jstate, c, j_iw)
    tn0, tlane, tleft, tinj = _prep(tnative, fmt, te, tstate, c, t_iw)
    assert tn0 == jn0
    np.testing.assert_array_equal(tinj, jinj)
    np.testing.assert_array_equal(tstate.cfg, jstate.cfg)
    assert tstate.n_cfg == jstate.n_cfg
    if tn0 < 0:
        return tn0, None
    np.testing.assert_array_equal(tlane, jlane)
    np.testing.assert_array_equal(tleft, jleft)
    np.testing.assert_array_equal(t_iw, j_iw)
    je._apply_inject_rows(jinj)
    te._apply_inject_rows(tinj)
    got = np.zeros((4, n), np.int64)
    if tn0:
        kern = "decide_packed_interned" if fmt == "interned" else "decide_packed_lean"
        je.state, j_out = _J[kern](je.state, j_iw, jstate.cfg, now)
        fn = td.decide_packed_interned if fmt == "interned" else td.decide_packed_lean
        t_out = fn(te.state, torch.from_numpy(t_iw), torch.from_numpy(tstate.cfg), now).numpy()
        np.testing.assert_array_equal(t_out, np.asarray(j_out))
        got[:, tlane] = td.widen_compact_out(t_out, now)[:, :tn0]
    for i in tleft.tolist():
        a = je.get_rate_limits([JReq(**fields[i])], now_ms=now)[0]
        b = te.get_rate_limits([RateLimitReq(**fields[i])], now_ms=now)[0]
        assert (a.status, a.limit, a.remaining, a.reset_time) == (
            b.status, b.limit, b.remaining, b.reset_time)
        got[:, i] = (b.status, b.limit, b.remaining, b.reset_time)
    np.testing.assert_array_equal(te.state.numpy(), np.asarray(je.state))
    return tn0, got


def _workload(rng, n, name, lean):
    out = []
    for _ in range(n):
        beh = 0
        if rng.random() < 0.1:
            beh |= RESET
        if rng.random() < 0.05:
            beh |= GREG
        if lean:
            hits = 1 if rng.random() < 0.8 else int(rng.integers(0, 5))
        else:
            hits = int(rng.integers(0, 3))
            if rng.random() < 0.05:
                hits = 1 << 20  # past the 15-bit lane
        out.append(dict(name=name, unique_key=f"k{rng.integers(0, 40)}", hits=hits,
                        limit=25 if rng.random() < 0.9 else (1 << 40), duration=60_000,
                        algorithm=0 if rng.random() < .7 else 1, behavior=beh))
    return out


@pytest.mark.usefixtures("jax_lib")
@pytest.mark.parametrize("fmt", ["interned", "lean"])
def test_random_workload_matches_jax(fmt):
    """TestInternedPrep / TestLeanPrep's random workload: the preps, the
    kernels and the leftovers, package against package, and against the
    request-object path of a third engine."""
    je, te = _engines()
    ref = Engine(capacity=4096, min_width=16, max_width=256, device="cpu")
    jstate, tstate = _states(fmt)
    rng = np.random.default_rng(23 if fmt == "interned" else 31)
    for it in range(20):
        fields = _workload(rng, int(rng.integers(1, 120)), "ip", fmt == "lean")
        now = NOW + it * 500
        n0, got = run_both(fmt, je, te, jstate, tstate, fields, now)
        assert n0 >= 0
        want = ref.get_rate_limits([RateLimitReq(**f) for f in fields], now_ms=now)
        for i, w in enumerate(want):
            assert tuple(got[:, i]) == (w.status, w.limit, w.remaining, w.reset_time)


@pytest.mark.usefixtures("jax_lib")
@pytest.mark.parametrize("fmt,n_cfg", [("interned", 300), ("lean", 200)])
def test_overflow_rolls_back_like_jax(fmt, n_cfg):
    """More distinct configs than the table holds: PREP_CFG_OVERFLOW with
    the config state untouched, in both packages; smaller windows are served
    afterwards."""
    je, te = _engines(2048, 1024)
    jstate, tstate = _states(fmt)
    fields = [dict(name="of", unique_key=f"k{i}", hits=1, limit=100 + i, duration=60_000)
              for i in range(n_cfg)]
    n0, _ = run_both(fmt, je, te, jstate, tstate, fields, NOW)
    assert n0 == tnative.PREP_CFG_OVERFLOW == jnative.PREP_CFG_OVERFLOW
    assert tstate.n_cfg == 0
    n0, got = run_both(fmt, je, te, jstate, tstate, fields[:10], NOW)
    assert n0 == 10 and tstate.n_cfg == 10
    assert (got[2] == np.arange(10) + 99).all()


def test_lean_matches_interned_lanes():
    """On hits == 1 windows the port's lean and interned preps agree on
    lanes, leftovers and decisions; only the wire width differs."""
    ea = Engine(capacity=4096, min_width=16, max_width=1024, device="cpu")
    eb = Engine(capacity=4096, min_width=16, max_width=1024, device="cpu")
    lstate, istate = tnative.LeanPrepState(), tnative.InternPrepState()
    rng = np.random.default_rng(7)
    for it in range(6):
        reqs = [RateLimitReq(name="li", unique_key=f"k{rng.integers(0, 200)}", hits=1,
                             limit=int(rng.choice([10, 100, 1000])), duration=60_000)
                for _ in range(64)]
        c = cols_from(reqs)
        iw_l, iw_i = np.empty(64, np.int32), np.empty((2, 64), np.int32)
        n0, lane_l, left_l, _ = _prep(tnative, "lean", ea, lstate, c, iw_l)
        n1, lane_i, left_i, _ = _prep(tnative, "interned", eb, istate, c, iw_i)
        assert n0 == n1
        np.testing.assert_array_equal(lane_l, lane_i)
        np.testing.assert_array_equal(left_l, left_i)
        now = NOW + it
        out_l = td.decide_packed_lean(ea.state, torch.from_numpy(iw_l),
                                      torch.from_numpy(lstate.cfg), now)
        out_i = td.decide_packed_interned(eb.state, torch.from_numpy(iw_i),
                                          torch.from_numpy(istate.cfg), now)
        assert torch.equal(out_l[:, :n0], out_i[:, :n0])


def test_prep_refuses_a_wrong_staging():
    eng = Engine(capacity=64, min_width=16, max_width=64, device="cpu")
    c = cols_from([RateLimitReq(name="w", unique_key="a", hits=1, limit=5, duration=1000)])
    with pytest.raises(ValueError, match=r"iw must be i32\[2, width\]"):
        _prep(tnative, "interned", eng, tnative.InternPrepState(), c, np.empty(16, np.int32))
    with pytest.raises(ValueError, match="C-contiguous int32"):
        _prep(tnative, "lean", eng, tnative.LeanPrepState(), c, np.empty(16, np.int64))


# --------------------------------------- the CUDA wrapper, with no card and no nvcc

def _fake_cuda(dtype=torch.int64, shape=(64, 8), index=0, contiguous=True):
    return SimpleNamespace(is_cuda=True, get_device=lambda: index, device=f"cuda:{index}",
                           dtype=dtype, shape=shape, is_contiguous=lambda: contiguous,
                           data_ptr=lambda: 4096)


def _library(calls):
    def launch(*args):
        calls.append(args)
        return 0
    return SimpleNamespace(decide_launch=launch, stream=lambda index: 7, scratch_words=1024,
                           max_owners=64)


_I32 = torch.int32


@pytest.mark.parametrize("staging,cfg,scan,match", [
    ((5, 16), (256, 2), False, r"staging must be \[2, n\]"),
    ((2, 16), (256, 4), False, r"config table must be \[256, 2\]"),
    ((4, 16), (256, 2), True, r"staging must be \[n, 2, n\]"),
])
def test_interned_wrapper_refuses(monkeypatch, staging, cfg, scan, match):
    calls = []
    monkeypatch.setattr(td, "_kernels", _library(calls))
    td.reset_launch_counts()
    with pytest.raises(ValueError, match=match):
        td.decide_cuda(td.INTERNED, _fake_cuda(), _fake_cuda(dtype=_I32, shape=staging),
                       _fake_cuda(shape=cfg), NOW, scan)
    assert calls == [] and not any(td.launch_counts.values())


@pytest.mark.parametrize("scan,staging,key", [
    (False, (2, 16), "decide_interned"), (True, (4, 2, 16), "decide_scan_interned")])
def test_interned_wrapper_counts_its_launch(monkeypatch, scan, staging, key):
    calls = []
    monkeypatch.setattr(td, "_kernels", _library(calls))
    monkeypatch.setitem(td._scratch, 0, _fake_cuda(shape=(1024,)))
    td.reset_launch_counts()
    cfg = _fake_cuda(shape=(256, 2))
    out = _fake_cuda(dtype=_I32, shape=(4, 4, 16) if scan else (4, 16))
    assert td.decide_cuda(td.INTERNED, _fake_cuda(), _fake_cuda(dtype=_I32, shape=staging),
                          cfg, NOW, scan, out) is out
    assert {k: v for k, v in td.launch_counts.items() if v} == {key: 1}
    (index, fmt, _t, C, owners, _p, cfg_ptr, _o, K, B, now, sc, _s, stream), = calls
    assert (index, fmt, C, owners, cfg_ptr, K, B, now, sc, stream) == (
        0, td.INTERNED, 64, 1, 4096, 4 if scan else 1, 16, NOW, int(scan), 7)
