"""The port's device directory (gubernator_tpu_torch/ops/devdir.py and
models/devdir_engine.py) against the JAX package's, bit for bit.

- The probe and the vacancy sweep: the same numpy stimuli (made from a seed)
  through the JAX functions and the port's plain versions, at tables of 5,
  16, 64 and 4096 positions (wrapped and repeated candidates at the small
  ones), batch after batch on the evolving columns. The stimuli carry
  padding lanes, matches, a region filled solid (evictions, and lanes whose
  every candidate was stamped this batch), distinct hashes of one probe base
  (in-batch contention) and negative hashes. Slots, fresh and retry flags
  and both columns must be equal.
- The reference's own tests (tests/test_devdir.py, tests/test_devdir_engine.py)
  through the port: the directory contracts, the engine-level differential
  against the host-directory Engine, and the DevDirEngine trials with the
  port's DevDirEngine(device="cpu") against the JAX DevDirEngine: responses,
  fingerprints, stamps and table after every step.
- The carry of a JAX engine's state into the port mid-run (convert.py), the
  lone path's misses, the fingerprints, and the CUDA wrappers' argument
  checks with a stand-in library.

Every value is an integer, so the tolerance is zero. The CUDA kernels behind
the port's entry points are held to these plain versions on the card by
chip_smoke.py (phase 8).
"""

import random
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from gubernator_tpu.models import Engine as JEngine
from gubernator_tpu.models.devdir_engine import DevDirEngine as JDevDirEngine
from gubernator_tpu.ops import devdir as jdd
from gubernator_tpu.types import RateLimitReq as JReq
from gubernator_tpu_torch import convert, native
from gubernator_tpu_torch.models.devdir_engine import DevDirEngine
from gubernator_tpu_torch.models.engine import Engine
from gubernator_tpu_torch.ops import decide as td
from gubernator_tpu_torch.ops import devdir as dd
from gubernator_tpu_torch.store import MockStore
from gubernator_tpu_torch.types import Behavior, RateLimitReq

NOW = 1_700_000_000_000
JUMPS = [0, 1, 50, 997, 10_000, 3_600_000]
RESET = int(Behavior.RESET_REMAINING)
GREG = int(Behavior.DURATION_IS_GREGORIAN)

_J = {"evict": jax.jit(jdd.probe_assign_evict), "plain": jax.jit(jdd.probe_assign),
      "refresh": jax.jit(jdd.refresh_vacancies)}


# ------------------------------------------------------------- stimuli

def keys_at(rng, pos, C):
    """Keys whose probe starts 0-3 positions before `pos`, as a probe would
    have placed them there: a later probe of such a key matches."""
    return ((pos - rng.integers(0, 4, pos.shape)) % C
            + C * rng.integers(1, 1 << 40, pos.shape)).astype(np.int64)


def directory(rng, C, now):
    """fps and touch i64[C]: about half occupied, stamps older than `now`,
    and a solid region of up to 40 positions (every one occupied) whose
    first half was stamped `now` (un-evictable this batch). Returns the
    columns and the solid region's positions."""
    fps = np.where(rng.random(C) < 0.5, keys_at(rng, np.arange(C), C), 0).astype(np.int64)
    touch = rng.integers(0, now, C).astype(np.int64)
    n = min(C, 40)
    solid = (int(rng.integers(0, C)) + np.arange(n)) % C
    fps[solid] = keys_at(rng, solid, C)
    touch[solid[: n // 2]] = now
    return fps, touch, solid


def hashes_for(rng, fps, solid, C, B):
    """i64[B] probe hashes: matches of occupied positions, new keys, distinct
    keys sharing one probe base (contention), keys whose base lies in the
    solid region, padding (0), negated keys, and INT64_MIN once."""
    h = rng.integers(1, 1 << 62, B).astype(np.int64)
    kind = rng.integers(0, 6, B)
    live = fps[fps != 0]
    base0 = int(rng.integers(0, C))
    for i in range(B):
        k = kind[i]
        if k == 0 and live.size:
            h[i] = rng.choice(live)
        elif k == 2:
            h[i] = base0 + C * int(rng.integers(1, 1 << 40))
        elif k == 3:
            h[i] = int(rng.choice(solid)) + C * int(rng.integers(1, 1 << 40))
        elif k == 4:
            h[i] = 0
        elif k == 5:
            h[i] = -h[i]
    if B > 3:
        h[3] = np.iinfo(np.int64).min
    return h


def assert_tensor(t, a):
    np.testing.assert_array_equal(t.numpy(), np.asarray(a))


# -------------------------------------------------- probe and sweep, plain

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("C", [5, 16, 64, 4096])
def test_probe_assign_evict_matches_jax(C, seed):
    rng = np.random.default_rng(seed * 1000 + C)
    seq = 20
    fps, touch, solid = directory(rng, C, seq + 1)
    j_fps, j_touch = fps, touch
    t_fps, t_touch = torch.from_numpy(fps.copy()), torch.from_numpy(touch.copy())
    reached = set()
    for _batch in range(6):
        seq += 1
        h = hashes_for(rng, np.asarray(j_fps), solid, C, 64)
        j_fps, j_touch, j_slot, j_fresh, j_retry = _J["evict"](j_fps, j_touch, h, seq)
        slot, fresh, retry = dd.probe_assign_evict(t_fps, t_touch, torch.from_numpy(h), seq)
        assert_tensor(slot, j_slot)
        assert_tensor(fresh, j_fresh)
        assert_tensor(retry, j_retry)
        assert_tensor(t_fps, j_fps)
        assert_tensor(t_touch, j_touch)
        fresh_np, slot_np = np.asarray(j_fresh), np.asarray(j_slot)
        reached |= {name for name, hit in (
            ("claim", fresh_np.any()), ("retry", np.asarray(j_retry).any()),
            ("match", ((slot_np >= 0) & ~fresh_np).any())) if hit}
    # the stimuli reached every branch
    assert reached == {"claim", "retry", "match"}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("C", [5, 16, 64, 4096])
def test_probe_assign_matches_jax(C, seed):
    rng = np.random.default_rng(seed * 1000 + C + 7)
    fps, _touch, solid = directory(rng, C, 1)
    j_fps, t_fps = fps, torch.from_numpy(fps.copy())
    for _batch in range(6):
        h = hashes_for(rng, np.asarray(j_fps), solid, C, 64)
        j_fps, j_slot, j_fresh = _J["plain"](j_fps, h)
        slot, fresh = dd.probe_assign(t_fps, torch.from_numpy(h))
        assert_tensor(slot, j_slot)
        assert_tensor(fresh, j_fresh)
        assert_tensor(t_fps, j_fps)


def test_probe_writes_the_staging_rows():
    """With a staging, the probe writes each lane's slot into row 0 and its
    fresh flag into row 8, as the engine's decide reads them; the other rows
    are untouched."""
    rng = np.random.default_rng(5)
    fps, touch, solid = directory(rng, 64, 9)
    h = hashes_for(rng, fps, solid, 64, 32)
    packed = torch.from_numpy(rng.integers(-5, 5, (9, 32)).astype(np.int64))
    before = packed.clone()
    slot, fresh, _retry = dd.probe_assign_evict(
        torch.from_numpy(fps), torch.from_numpy(touch), torch.from_numpy(h), 10, packed=packed)
    assert torch.equal(packed[0], slot.long()) and torch.equal(packed[8], fresh.long())
    assert torch.equal(packed[1:8], before[1:8])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_refresh_vacancies_matches_jax(seed):
    rng = np.random.default_rng(seed)
    C = 4096
    fps = rng.integers(0, 1 << 62, C).astype(np.int64)
    table = np.zeros((C, 8), np.int64)
    table[:, 0] = rng.choice([-1, 0, 1], C)
    table[:, 5] = NOW + rng.integers(-5, 5, C)
    got = torch.from_numpy(fps.copy())
    dd.refresh_vacancies(got, torch.from_numpy(table), NOW)
    assert_tensor(got, _J["refresh"](fps, table, NOW))
    assert 0 < int((got == 0).sum()) < C


def test_claim_winners_is_highest_lane():
    cslot = torch.tensor([3, 7, 3, 3, 7, 1], dtype=torch.int64)
    ok = torch.tensor([True, True, True, False, True, True])
    assert dd.claim_winners(ok, cslot).tolist() == [False, False, True, False, True, True]
    assert_tensor(dd.claim_winners(ok, cslot), jdd._claim_winners(ok.numpy(), cslot.numpy()))


# ------------------------------------ tests/test_devdir.py through the port

def _probe(fps, keys):
    hashes = torch.tensor([dd.key_fingerprint(k) for k in keys], dtype=torch.int64)
    slot, fresh = dd.probe_assign(fps, hashes)
    return slot.numpy(), fresh.numpy()


class TestDirectoryContracts:
    def test_slot_stability_and_freshness(self):
        fps = dd.make_fingerprints(256, "cpu")
        s1, f1 = _probe(fps, ["a", "b", "c"])
        assert f1.all() and len(set(s1.tolist())) == 3
        s2, f2 = _probe(fps, ["c", "a", "b"])
        assert not f2.any()
        assert set(s2.tolist()) == set(s1.tolist())
        assert s2[1] == s1[0] and s2[0] == s1[2]

    def test_padding_lanes_stay_out(self):
        fps = dd.make_fingerprints(64, "cpu")
        slot, _fresh = dd.probe_assign(
            fps, torch.tensor([dd.key_fingerprint("x"), 0, 0], dtype=torch.int64))
        assert slot[0] >= 0 and (slot[1:] == -1).all()
        assert int(fps.bool().sum()) == 1

    def test_exhausted_probe_returns_fallback_lane(self):
        fps = dd.make_fingerprints(dd.PROBE_DEPTH, "cpu")
        seen = set()
        fallback = 0
        for i in range(dd.PROBE_DEPTH * 3):
            slot, _ = _probe(fps, [f"k{i}"])
            if slot[0] < 0:
                fallback += 1
            else:
                assert slot[0] not in seen or f"k{i}" in seen
                seen.add(int(slot[0]))
        assert fallback > 0
        assert len(seen) <= dd.PROBE_DEPTH

    def test_vacancy_refresh_recycles(self):
        fps = dd.make_fingerprints(64, "cpu")
        _probe(fps, ["gone"])
        dd.refresh_vacancies(fps, td.make_table(64, "cpu"), NOW)
        _s2, f2 = _probe(fps, ["fresh-key"])
        assert f2[0]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_engine_level_differential(seed):
    """decide through the port's probed slots == the JAX host-directory
    Engine, request for request."""
    rng = random.Random(seed)
    eng = JEngine(capacity=512, min_width=8, max_width=64)
    fps = dd.make_fingerprints(2048, "cpu")
    table = td.make_table(2048, "cpu")
    keys = [f"dk{i}" for i in range(24)]
    now = NOW
    for _round in range(25):
        now += rng.choice([0, 1, 997, 10_000, 3_600_000])
        batch_keys = sorted({rng.choice(keys) for _ in range(8)})
        fields = [dict(name="t", unique_key=k, hits=rng.randint(0, 3),
                       limit=rng.choice([5, 100]), duration=rng.choice([10_000, 3_600_000]))
                  for k in batch_keys]
        host = eng.get_rate_limits([JReq(**f) for f in fields], now_ms=now)
        reqs = [RateLimitReq(**f) for f in fields]
        hashes = torch.tensor([dd.key_fingerprint(r.hash_key()) for r in reqs],
                              dtype=torch.int64)
        slot, fresh = dd.probe_assign(fps, hashes)
        assert (slot >= 0).all()
        packed = np.zeros((9, 8), np.int64)
        packed[0, :] = -1
        n = len(reqs)
        packed[0, :n] = slot.numpy()
        for j, r in enumerate(reqs):
            packed[1:6, j] = (r.hits, r.limit, r.duration, int(r.algorithm), int(r.behavior))
        packed[8, :n] = fresh.numpy()
        out = td.decide_packed(table, torch.from_numpy(packed), now).numpy()
        for j, hr in enumerate(host):
            assert (out[0, j], out[1, j], out[2, j], out[3, j]) == (
                int(hr.status), hr.limit, hr.remaining, hr.reset_time)


# --------------------------- tests/test_devdir_engine.py, port against JAX

def _fields(key, hits=1, limit=20, duration=60_000, behavior=0, algo=0):
    return dict(name="dd", unique_key=key, hits=hits, limit=limit, duration=duration,
                algorithm=algo, behavior=behavior)


def _random_batch(rng, keys):
    out = []
    for _ in range(rng.randrange(1, 24)):
        beh = 0
        if rng.random() < 0.08:
            beh |= RESET
        if rng.random() < 0.05:
            beh |= GREG
        out.append(_fields(
            rng.choice(keys), hits=rng.randrange(0, 4), limit=rng.choice([3, 10, 25]),
            duration=rng.choice([500, 60_000, 3_600_000]), behavior=beh,
            algo=0 if rng.random() < 0.7 else 1))
    return out


def _resp(rs):
    return [(int(r.status), r.limit, r.remaining, r.reset_time, r.error) for r in rs]


def _same_state(j, t):
    assert_tensor(t.fps, j.fps)
    assert_tensor(t.touch, j.touch)
    assert_tensor(t.state, j.state)
    assert t._probe_seq == j._probe_seq
    assert t._rounds_since_sweep == j._rounds_since_sweep


def _pair(capacity, min_width, max_width):
    j = JDevDirEngine(capacity=capacity, min_width=min_width, max_width=max_width)
    t = DevDirEngine(capacity=capacity, min_width=min_width, max_width=max_width,
                     device="cpu")
    j.warmup()
    t.warmup()
    return j, t


def _both(j, t, fields, now):
    a = j.get_rate_limits([JReq(**f) for f in fields], now_ms=now)
    b = t.get_rate_limits([RateLimitReq(**f) for f in fields], now_ms=now)
    assert _resp(a) == _resp(b)
    _same_state(j, t)
    return b


@pytest.mark.parametrize("trial", range(6))
def test_differential_vs_jax_devdir_engine(trial):
    """The reference's six trials: the port's DevDirEngine against the JAX
    DevDirEngine on the same stream, state after every step."""
    rng = random.Random(9100 + trial)
    j, t = _pair(512, 16, 64)
    _same_state(j, t)  # warmup advanced both epochs alike
    keys = [f"k{i}" for i in range(rng.choice([4, 12]))]
    now = NOW + rng.randrange(10**9)
    for _step in range(40):
        now += rng.choice(JUMPS)
        _both(j, t, _random_batch(rng, keys), now)
    js, ts = j.stats.as_dict(), t.stats.as_dict()
    for c in ("requests", "batches", "rounds", "over_limit", "errors"):
        assert js[c] == ts[c], c


def test_eviction_under_capacity_pressure():
    """More live keys than capacity: aged eviction recycles slots and never
    routes two keys to one live bucket; 400 rounds run the sweep. Equal to
    the JAX engine throughout."""
    j, t = _pair(64, 16, 64)
    for i in range(200):
        r1 = _both(j, t, [_fields(f"ev{i}", limit=10)], NOW + i)[0]
        r2 = _both(j, t, [_fields(f"ev{i}", limit=10)], NOW + i)[0]
        assert r1.error == "" and r2.error == ""
        assert (r1.remaining, r2.remaining) == (9, 8), i
    assert t.stats.rounds > 256  # the sweep ran at least once


def test_in_batch_distinct_key_claims_never_share_a_slot():
    j, t = _pair(128, 64, 128)
    batch = [_fields(f"clash{i}", limit=5) for i in range(60)]
    out1 = _both(j, t, batch, NOW)
    assert all(r.error == "" and r.remaining == 4 for r in out1)
    out2 = _both(j, t, batch, NOW + 1)
    assert all(r.remaining == 3 for r in out2)


def test_contention_exhaustion_error_matches_jax():
    """A table of 16 positions and a batch of 40 distinct keys: lanes that
    still find nothing after PROBE_RETRIES retries get the reference's error,
    character for character, and count as errors."""
    j, t = _pair(16, 16, 16)
    batch = [_fields(f"x{i}") for i in range(40)]
    out = _both(j, t, batch, NOW)
    errs = [r.error for r in out if r.error]
    assert errs and set(errs) == {
        "device directory contention: probe window exhausted after retries"}
    assert t.stats.errors == j.stats.errors == len(errs)


def test_store_and_snapshot_refused():
    with pytest.raises(ValueError, match="keeps no key strings"):
        DevDirEngine(capacity=64, store=MockStore(), device="cpu")
    eng = DevDirEngine(capacity=64, min_width=16, max_width=64, device="cpu")
    with pytest.raises(RuntimeError, match="keeps no key strings"):
        eng.snapshot()
    with pytest.raises(RuntimeError, match="cannot seed from snapshots"):
        eng.load_snapshot([object()])
    assert eng.load_snapshot([]) == 0
    assert not eng.supports_columnar() and not eng.supports_pipeline()
    assert eng.global_registry_size() == 0


def test_lone_path_misses():
    """The host directory stays empty: decide_native_single misses and
    seed_mirror finds nothing, as in the reference; the batch path still
    answers, and key_count counts the card's fingerprints."""
    eng = DevDirEngine(capacity=64, min_width=16, max_width=64, device="cpu")
    req = RateLimitReq(**_fields("lone"))
    assert eng.get_rate_limits([req], now_ms=NOW)[0].remaining == 19
    assert eng.decide_native_single(req, now_ms=NOW) is None
    assert eng.seed_mirror(req.hash_key()) is False
    assert eng.key_count() == 1 and len(eng.directory) == 0


def test_carry_state_mid_run():
    """A JAX engine's state carried into a fresh port engine mid-run
    (convert.carry_devdir_state): from there both continue bit for bit."""
    rng = random.Random(77)
    j = JDevDirEngine(capacity=96, min_width=16, max_width=64)
    j.warmup()
    keys = [f"c{i}" for i in range(150)]
    now = NOW
    for _ in range(30):
        now += rng.choice(JUMPS)
        j.get_rate_limits([JReq(**f) for f in _random_batch(rng, keys)], now_ms=now)
    t = DevDirEngine(capacity=96, min_width=16, max_width=64, device="cpu")
    convert.carry_devdir_state(t, j.fps, j.touch, j.state, j._probe_seq,
                               j._rounds_since_sweep)
    _same_state(j, t)
    for _ in range(30):
        now += rng.choice(JUMPS)
        _both(j, t, _random_batch(rng, keys), now)
    with pytest.raises(ValueError, match="fps and touch"):
        convert.carry_devdir_state(t, np.zeros(5, np.int64), j.touch, j.state, 1, 0)


def test_fingerprints_match():
    keys = ["api_k1", "a", "", "ключ", "api_key17" * 9]
    want = [jdd.key_fingerprint(k) for k in keys]
    assert [dd.key_fingerprint(k) for k in keys] == want
    assert native.fingerprint_batch(keys).tolist() == want
    assert all(w & 1 and 0 < w < (1 << 63) for w in want)


def test_no_native_takes_the_python_fingerprints(monkeypatch):
    monkeypatch.setenv("GUBER_NO_NATIVE", "1")
    eng = DevDirEngine(capacity=64, min_width=16, max_width=64, device="cpu")
    assert eng._fingerprints(["a", "b"]).tolist() == [jdd.key_fingerprint("a"),
                                                      jdd.key_fingerprint("b")]


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DevDirEngine(capacity=64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dd.make_fingerprints(8)


# --------------------------------------- the CUDA wrappers, with no card and no nvcc

def _fake_cuda(dtype=torch.int64, shape=(64,), index=0, contiguous=True):
    """What _launch.check and the devdir wrappers read of a tensor on a card."""
    return SimpleNamespace(is_cuda=True, is_cpu=False, get_device=lambda: index,
                           device=f"cuda:{index}", dtype=dtype, shape=shape,
                           is_contiguous=lambda: contiguous, data_ptr=lambda: 4096)


def _library(calls):
    def probe(*args):
        calls.append(("probe", args))
        return 0

    def refresh(*args):
        calls.append(("refresh", args))
        return 0

    return SimpleNamespace(devdir_probe_launch=probe, devdir_refresh_launch=refresh,
                           stream=lambda index: 7)


_B = torch.bool
_OUT = (_fake_cuda(torch.int32, (16,)), _fake_cuda(_B, (16,)), _fake_cuda(_B, (16,)))


@pytest.mark.parametrize("args,match", [
    ((torch.zeros(64, dtype=torch.int64), None, _fake_cuda(shape=(16,))),
     "probe_cuda needs CUDA tensors"),
    ((_fake_cuda(dtype=torch.int32), None, _fake_cuda(shape=(16,))),
     "fingerprints must be torch.int64"),
    ((_fake_cuda(shape=(0,)), None, _fake_cuda(shape=(16,))), "empty directory"),
    ((_fake_cuda(), _fake_cuda(shape=(63,)), _fake_cuda(shape=(16,))),
     r"touch must be \[64\]"),
    ((_fake_cuda(), None, _fake_cuda(shape=(16,), index=1)),
     "hashes is on cuda:1, expected cuda:0"),
    ((_fake_cuda(), None, _fake_cuda(shape=(4, 4))), r"hashes must be \[n\]"),
    ((_fake_cuda(), None, _fake_cuda(shape=(1 << 20,))), "fewer than"),
    ((_fake_cuda(), _fake_cuda(), _fake_cuda(shape=(16,)), _fake_cuda(shape=(8, 16))),
     r"staging must be \[9, 16\]"),
    ((_fake_cuda(), _fake_cuda(), _fake_cuda(shape=(16,)), None,
      (_OUT[0], _fake_cuda(torch.int32, (16,)), _OUT[2])), "fresh must be torch.bool"),
    ((_fake_cuda(), _fake_cuda(), _fake_cuda(shape=(16,)), None, (None, None, _OUT[2])),
     "needs a slot output when no staging is given"),
    ((_fake_cuda(), _fake_cuda(), _fake_cuda(shape=(16,)), _fake_cuda(shape=(9, 16)),
      (None, None, None)), "needs a retry output"),
])
def test_probe_wrapper_refuses(monkeypatch, args, match):
    """probe_cuda refuses, through _launch.check, columns, hashes, staging
    and outputs of a wrong device, dtype or shape; nothing is launched or
    counted."""
    calls = []
    monkeypatch.setattr(dd, "_kernels", _library(calls))
    dd.reset_launch_counts()
    fps, touch, hashes = args[:3]
    packed = args[3] if len(args) > 3 else None
    out = args[4] if len(args) > 4 else None
    with pytest.raises(ValueError, match=match):
        dd.probe_cuda(fps, touch, hashes, 5, packed, out)
    assert calls == [] and not any(dd.launch_counts.values())


@pytest.mark.parametrize("evict", [True, False])
def test_probe_wrapper_counts_its_launch(monkeypatch, evict):
    """One launch, one count under probe_assign_evict or probe_assign; the
    entry point gets the card, C, B, the epoch, the eviction flag, the
    card's claim scratch with its next tag, and the raw stream; the caller's
    outputs come back. With a staging, as the engine probes, slot and fresh
    may be left out: the kernel gets null for them."""
    calls = []
    monkeypatch.setattr(dd, "_kernels", _library(calls))
    sc = SimpleNamespace(claims=_fake_cuda(shape=(64,)), tag=40, lanes=_fake_cuda(shape=(48,)))
    monkeypatch.setitem(dd._scratch, 0, sc)
    dd.reset_launch_counts()
    out = (None, None, _OUT[2]) if evict else _OUT
    got = dd.probe_cuda(_fake_cuda(), _fake_cuda() if evict else None,
                        _fake_cuda(shape=(16,)), 41, _fake_cuda(shape=(9, 16)), out)
    assert got is out
    key = "probe_assign_evict" if evict else "probe_assign"
    assert {k: v for k, v in dd.launch_counts.items() if v} == {key: 1}
    (what, (index, _f, touch, C, _h, B, seq, ev, _sc, tag, _ln, slot, fresh, *_rest,
            stream)), = calls
    assert (what, index, C, B, seq, ev, tag, stream) == (
        "probe", 0, 64, 16, 41, int(evict), 41, 7)
    assert (touch is None) == (not evict)
    assert (slot is None, fresh is None) == (evict, evict)
    dd.probe_cuda(_fake_cuda(), None, _fake_cuda(shape=(16,)), 0, None, _OUT)
    assert calls[-1][1][9] == 42 and sc.tag == 42


def test_refresh_wrapper_checks_and_counts(monkeypatch):
    calls = []
    monkeypatch.setattr(dd, "_kernels", _library(calls))
    dd.reset_launch_counts()
    with pytest.raises(ValueError, match=r"table must be \[64, 8\]"):
        dd.refresh_cuda(_fake_cuda(), _fake_cuda(shape=(63, 8)), NOW)
    with pytest.raises(ValueError, match="refresh_cuda needs CUDA tensors"):
        dd.refresh_cuda(torch.zeros(4, dtype=torch.int64), td.make_table(4, "cpu"), NOW)
    assert calls == []
    dd.refresh_cuda(_fake_cuda(), _fake_cuda(shape=(64, 8)), NOW)
    (what, (index, _f, _t, C, now, stream)), = calls
    assert (what, index, C, now, stream) == ("refresh", 0, 64, NOW, 7)
    assert dd.launch_counts == {"probe_assign_evict": 0, "probe_assign": 0,
                                "refresh_vacancies": 1}


def test_claim_scratch_grows_and_is_kept():
    """The claim scratch is allocated zeroed, at tag 0, at the first probe
    on a card, kept (with its tag) for smaller directories and replaced by
    a larger one, at tag 0 again, for a larger directory; the lane words
    grow with the widest probe."""
    saved = dict(dd._scratch)
    try:
        dd._scratch.clear()
        like = torch.zeros(1, dtype=torch.int64)
        a = dd._probe_scratch(0, 16, 4, like)
        assert a.claims.shape == (16,) and not a.claims.any() and a.tag == 0
        assert a.lanes.shape[0] >= 12
        a.tag = 5
        assert dd._probe_scratch(0, 8, 64, like) is a and a.tag == 5
        assert a.lanes.shape[0] >= 192
        b = dd._probe_scratch(0, 32, 4, like)
        assert b.claims.shape == (32,) and b is not a and b.tag == 0
    finally:
        dd._scratch.clear()
        dd._scratch.update(saved)


def test_engine_cpu_never_reaches_a_wrapper(monkeypatch):
    """On the CPU the engine's dispatch takes the plain versions alone."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA wrapper was called on the CPU")

    monkeypatch.setattr("gubernator_tpu_torch.models.devdir_engine.probe_cuda", refuse)
    monkeypatch.setattr("gubernator_tpu_torch.models.devdir_engine.decide_cuda", refuse)
    eng = DevDirEngine(capacity=64, min_width=16, max_width=64, device="cpu")
    eng.warmup()
    assert eng.get_rate_limits([RateLimitReq(**_fields("z"))], now_ms=NOW)[0].remaining == 19
