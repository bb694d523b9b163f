"""The port's sharded engine against the JAX package's, bit for bit.

Each case runs a JAX ShardedEngine on the virtual CPU mesh that
tests/conftest.py forces (8 host devices) beside the port's
ShardedEngine(device="cpu") of the same geometry, on the same stimuli (the
cases of tests/test_parallel.py, parametrised), and after every step holds
equal: the responses, the whole table, the GLOBAL mirror and registry (keys
in LRU order, gidx, owner, seen, last touch, the free list, the high-water
mark and the queued hits), the counters, and, with a Store, the Store's
rows and calls. Tolerance: none, every field is an integer.

Also here: the three native routing bindings against the JAX natives, each
sharded kernel's plain version against the JAX make_*_sharded program with
the edge lanes (lanes past each shard's table beside a lane that writes the
shard's last row, the lean sign bit, injects of algo/status past int32, the
last slot of every shard under padding), the wrappers' checks and launch
counts with a fake library, the pipelined and columnar paths through the
port's BackendCombiner against the JAX combiner, the carry of a JAX
engine's state (convert.carry_sharded_state), and the port's lock witness.
"""

import random
import time
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gubernator_tpu.native as jnative
from gubernator_tpu_torch import convert
from gubernator_tpu_torch import native as tnative
from gubernator_tpu_torch.obs import witness
from gubernator_tpu_torch.ops import decide as dk
from gubernator_tpu_torch.ops import rows as rk
from gubernator_tpu_torch.parallel import ShardedEngine, shard_of_key
from gubernator_tpu_torch.service.combiner import BackendCombiner
from gubernator_tpu_torch.store import BucketSnapshot, FileLoader, MockStore
from gubernator_tpu_torch.types import Algorithm, Behavior, RateLimitReq, Status

NOW = 1_700_000_000_000
GLOBAL = int(Behavior.GLOBAL)
GREG = int(Behavior.DURATION_IS_GREGORIAN)
RESET = int(Behavior.RESET_REMAINING)


@pytest.fixture
def jax_lib(monkeypatch):
    """The JAX package's native library, for one test (as in
    tests/test_torch_interned.py): its build writes to one temporary
    name, so a load that raced another process's build is tried again; the
    module's _LIB and _LIB_ERR are put back when the test ends."""
    monkeypatch.setattr(jnative, "_LIB", jnative._LIB)
    monkeypatch.setattr(jnative, "_LIB_ERR", jnative._LIB_ERR)
    for _ in range(10):
        try:
            return jnative.load_library()
        except RuntimeError:
            monkeypatch.setattr(jnative, "_LIB_ERR", None)
            time.sleep(0.5)
    return jnative.load_library()


def _f(key, hits=1, limit=10, duration=60_000, algo=0, behavior=0, name="test"):
    return dict(name=name, unique_key=key, hits=hits, limit=limit,
                duration=duration, algorithm=int(algo), behavior=int(behavior))


def _resp(r):
    return (int(r.status), r.limit, r.remaining, r.reset_time, r.error)


def _snap(s):
    return (s.key, s.algo, s.limit, s.remaining, s.duration, s.stamp,
            s.expire_at, s.status)


class Pair:
    """A JAX ShardedEngine and a port ShardedEngine(device="cpu") driven in
    lock step and held equal after every call."""

    def __init__(self, store=False, loader_paths=None, **kw):
        from gubernator_tpu.parallel import ShardedEngine as JaxSharded
        from gubernator_tpu import store as jstore

        self.jstore = jstore.MockStore() if store else None
        self.tstore = MockStore() if store else None
        jl = tl = None
        if loader_paths is not None:
            jl, tl = jstore.FileLoader(loader_paths[0]), FileLoader(loader_paths[1])
        self.j = JaxSharded(store=self.jstore, loader=jl, **kw)
        self.t = ShardedEngine(device="cpu", store=self.tstore, loader=tl, **kw)
        self.check()

    def get(self, fields, now):
        from gubernator_tpu import RateLimitReq as JReq

        a = self.j.get_rate_limits([JReq(**f) for f in fields], now_ms=now)
        b = self.t.get_rate_limits([RateLimitReq(**f) for f in fields], now_ms=now)
        assert [_resp(r) for r in a] == [_resp(r) for r in b]
        self.check()
        return b

    def sync(self, now):
        assert self.j.global_sync(now_ms=now) == self.t.global_sync(now_ms=now)
        self.check()

    def check(self):
        j, t = self.j, self.t
        np.testing.assert_array_equal(np.asarray(j.state), convert.table_to_numpy(t.state))
        for f in ("status", "limit", "remaining", "reset_time"):
            want, got = np.asarray(getattr(j._mirror, f)), getattr(t._mirror, f)
            assert want.dtype == got.dtype, f
            np.testing.assert_array_equal(want, got, err_msg=f)
        assert [(k, e.gidx, e.owner, e.seen, e.last_ms,
                 None if e.req is None else _resp_req(e.req))
                for k, e in j._globals.items()] == \
            [(k, e.gidx, e.owner, e.seen, e.last_ms,
              None if e.req is None else _resp_req(e.req))
             for k, e in t._globals.items()]
        assert (j._gfree, j._gnext) == (t._gfree, t._gnext)
        np.testing.assert_array_equal(j._gdelta, t._gdelta)
        assert _counters(j.stats) == _counters(t.stats)
        assert [len(d) for d in j.directories] == [len(d) for d in t.directories]
        if self.jstore is not None:
            assert {k: _snap(v) for k, v in self.jstore.data.items()} == \
                {k: _snap(v) for k, v in self.tstore.data.items()}
            assert dict(self.jstore.called) == dict(self.tstore.called)


def _resp_req(r):
    return (r.name, r.unique_key, int(r.hits), int(r.limit), int(r.duration),
            int(r.algorithm), int(r.behavior))


def _counters(stats):
    return {k: v for k, v in stats.items() if not k.endswith("_ns")}


# ------------------------------------------------------------------ scenarios
# Each takes a fresh Pair maker and drives both engines; the Pair holds them
# equal after every call. The names follow tests/test_parallel.py.

def sc_token_across_shards(mk):
    p = mk(n_shards=8, capacity_per_shard=512, min_width=8, max_width=64)
    p.get([_f(f"tb{i}") for i in range(100)], NOW)
    for j in range(9):
        p.get([_f("tb0")], NOW + j)
    assert p.get([_f("tb0")], NOW + 10)[0].status == Status.OVER_LIMIT
    assert [r.remaining for r in p.get([_f("dup", hits=3)] * 3, NOW)] == [7, 4, 1]
    rs = p.get([_f("x", name=""), _f("")], NOW)
    assert "namespace" in rs[0].error and "unique_key" in rs[1].error


def sc_leaky_drain(mk):
    p = mk(n_shards=8, capacity_per_shard=512, min_width=8, max_width=32)
    leak = dict(limit=10, duration=10_000, algo=Algorithm.LEAKY_BUCKET)
    assert p.get([_f("leak", hits=10, **leak)], NOW)[0].remaining == 0
    assert p.get([_f("leak", hits=0, **leak)], NOW + 3_000)[0].remaining == 3


def _random_batches(seed, keys, steps, behaviors=(0, RESET)):
    rng = random.Random(seed)
    for step in range(steps):
        yield NOW + step * 1_000, [
            _f(rng.choice(keys), hits=rng.randint(0, 4), limit=rng.choice([5, 10, 20]),
               duration=rng.choice([10_000, 60_000]), algo=rng.randint(0, 1),
               behavior=rng.choice(behaviors))
            for _ in range(rng.randint(1, 20))]


def sc_mixed_4x2(mk):
    p = mk(n_shards=4, n_regions=2, capacity_per_shard=256, min_width=8, max_width=32)
    for now, batch in _random_batches(7, [f"key{i}" for i in range(40)], 20):
        p.get(batch, now)


def sc_lean_mesh_wire(mk):
    p = mk(n_shards=2, capacity_per_shard=512, min_width=8, max_width=32)
    rng = random.Random(9)
    keys = [f"lk{i}" for i in range(60)]
    for step in range(6):
        p.get([_f(rng.choice(keys), limit=rng.choice([5, 10, 20]))
               for _ in range(rng.randint(4, 24))], NOW + step * 500)
    assert p.t.stats["lean_windows"] > 0
    for step in range(4):
        p.get([_f(rng.choice(keys), hits=rng.choice([0, 3]))
               for _ in range(rng.randint(4, 16))], NOW + 10_000 + step * 500)
    p.get([_f(f"cfg{i}", limit=1000 + i) for i in range(140)], NOW + 50_000)


def sc_herd(mk):
    p = mk(n_shards=8, capacity_per_shard=2048, min_width=8, max_width=64)
    rs = p.get([_f("hot", limit=50)] * 100, NOW)
    assert [r.remaining for r in rs[:50]] == list(range(49, -1, -1))
    assert [r.status for r in rs[50:]] == [Status.OVER_LIMIT] * 50
    rs = p.get([_f("h33", limit=20)] * 33, NOW)
    assert [r.status for r in rs] == [0] * 20 + [1] * 13


def sc_scan_dups(mk):
    p = mk(n_shards=4, capacity_per_shard=2048, min_width=8, max_width=64)
    rnd = random.Random(11)
    keys = [f"ssc{i}" for i in range(10)]
    for k in range(5):
        p.get([_f(rnd.choice(keys), hits=rnd.randint(0, 4), algo=rnd.randint(0, 1))
               for _ in range(rnd.randint(2, 40))], NOW + k * 1000)


def sc_per_round(mk):
    """The scan's stimulus with the scan turned off in both engines: the
    per-round path alone."""
    p = mk(n_shards=4, capacity_per_shard=256, min_width=8, max_width=64)
    for e in (p.j, p.t):
        e._split_scannable = lambda windows: (windows, [])
    rnd = random.Random(11)
    keys = [f"ssc{i}" for i in range(10)]
    for k in range(5):
        p.get([_f(rnd.choice(keys), hits=rnd.randint(0, 4), algo=rnd.randint(0, 1))
               for _ in range(rnd.randint(2, 40))], NOW + k * 1000)


def _g(key, hits=1, limit=100, **kw):
    return _f(key, hits=hits, limit=limit, behavior=GLOBAL | kw.pop("behavior", 0), **kw)


def sc_global_first_touch(mk):
    p = mk(n_shards=8, capacity_per_shard=512, min_width=8, max_width=32)
    r = p.get([_g("g1", hits=5)], NOW)[0]
    assert r.remaining == 95 and p.t.global_pending_hits() == 0


def sc_global_psum(mk):
    p = mk(n_shards=8, capacity_per_shard=512, min_width=8, max_width=32)
    p.get([_g("hot", hits=5)], NOW)
    p.sync(NOW + 1)
    assert p.get([_g("hot", hits=10)], NOW + 2)[0].remaining == 85
    assert [r.remaining for r in p.get([_g("hot", hits=10)] * 2, NOW + 3)] == [75, 65]
    p.sync(NOW + 4)
    assert p.get([_g("hot", hits=0)], NOW + 5)[0].remaining == 65


def sc_global_optimistic(mk):
    p = mk(n_shards=4, capacity_per_shard=512, min_width=8, max_width=32)
    p.get([_g("opt", hits=0, limit=10)], NOW)
    p.sync(NOW + 1)
    rs = p.get([_g("opt", hits=4, limit=10)] * 5, NOW + 2)
    assert [r.status for r in rs] == [0, 0, 1, 1, 1]


def sc_global_converges(mk):
    p = mk(n_shards=4, capacity_per_shard=512, min_width=8, max_width=32)
    p.get([_g("burst", limit=10)], NOW)
    p.sync(NOW + 1)
    for _ in range(4):
        p.get([_g("burst", hits=5, limit=10)], NOW + 2)
    p.sync(NOW + 3)
    assert p.get([_g("burst", hits=0, limit=10)], NOW + 4)[0].status == Status.OVER_LIMIT


def sc_global_two_regions(mk):
    p = mk(n_shards=4, n_regions=2, capacity_per_shard=512, min_width=8, max_width=32)
    p.get([_g("xdc", hits=10, limit=50)], NOW)
    p.sync(NOW + 1)
    p.get([_g("xdc", hits=15, limit=50)], NOW + 2)
    p.sync(NOW + 3)
    assert p.get([_g("xdc", hits=0, limit=50)], NOW + 4)[0].remaining == 25


def _life(mk, cap, idle_ms):
    return mk(n_shards=2, capacity_per_shard=512, min_width=8, max_width=32,
              global_capacity=cap, global_idle_ms=idle_ms)


def sc_global_idle_sweep(mk):
    p = _life(mk, 4, 100)
    for i in range(4):
        p.get([_g(f"a{i}")], NOW)
    p.sync(NOW + 1)
    p.sync(NOW + 500)
    assert p.t.global_registry_size() == 0 and p.t.stats["global_evictions"] == 4
    for i in range(4):
        p.get([_g(f"b{i}")], NOW + 501)
    assert p.t.stats["global_registry_fallbacks"] == 0


def sc_global_lru(mk):
    p = _life(mk, 4, 10_000_000)
    for i in range(4):
        p.get([_g(f"k{i}")], NOW + i)
    p.sync(NOW + 10)
    p.get([_g("k4")], NOW + 20)
    assert "test_k0" not in p.t._globals and "test_k4" in p.t._globals


def sc_global_fallback(mk):
    p = _life(mk, 2, 10_000_000)
    p.get([_g("p0"), _g("p1")], NOW)
    p.sync(NOW + 1)
    p.get([_g("p0"), _g("p1")], NOW + 2)
    assert p.get([_g("p2", hits=5)], NOW + 3)[0].remaining == 95
    assert p.t.stats["global_registry_fallbacks"] == 1
    p.sync(NOW + 4)
    p.get([_g("p2")], NOW + 5)
    assert "test_p2" in p.t._globals


def sc_global_eviction_keeps_state(mk):
    p = _life(mk, 2, 100)
    p.get([_g("keep", hits=3, limit=10)], NOW)
    p.sync(NOW + 1)
    p.get([_g("keep", hits=2, limit=10)], NOW + 2)
    p.sync(NOW + 3)
    p.sync(NOW + 500)
    assert p.get([_g("keep", hits=1, limit=10)], NOW + 501)[0].remaining == 4


def sc_global_gregorian(mk):
    p = mk(n_shards=4, capacity_per_shard=256, min_width=8, max_width=32)
    g = lambda h: _g("gcal", hits=h, duration=2, behavior=GREG)  # noqa: E731
    p.get([g(5)], NOW)
    p.sync(NOW + 1)
    assert p.get([g(10)], NOW + 2)[0].remaining == 85
    p.sync(NOW + 3)
    assert p.get([g(0)], NOW + 4)[0].remaining == 85


def sc_global_soak(mk):
    """test_soak_rolling_keyset_10x_capacity at its own key count."""
    cap = 16
    p = _life(mk, cap, 50)
    now = NOW
    for phase in range(10):
        keys = [f"soak{phase}_{j}" for j in range(cap)]
        before = p.t.stats["global_mirror_answers"]
        for _ in range(3):
            now += 10
            p.get([_g(k, limit=1000) for k in keys], now)
            p.sync(now)
        assert p.t.stats["global_mirror_answers"] > before
        now += 200
        p.sync(now)
    assert p.t._gnext <= cap and p.t.stats["global_registry_fallbacks"] == 0


def sc_rewarm(mk):
    p = mk(n_shards=4, capacity_per_shard=256, min_width=8, max_width=32)
    g = lambda h: _g("rw", hits=h, duration=3_600_000)  # noqa: E731
    p.get([g(5)], NOW)
    p.sync(NOW + 1)
    p.get([g(10)], NOW + 2)
    p.j.warmup()
    p.t.warmup()
    p.check()
    p.sync(NOW + 3)
    assert p.get([g(0)], NOW + 4)[0].remaining == 85


def sc_fast_slow_mixed(mk):
    """TestShardedNativeFastWindow's mixed lanes (invalid, gregorian,
    GLOBAL, duplicates) through both engines' fast paths, and again with
    both fast paths off."""
    for fast in (True, False):
        p = mk(n_shards=4, capacity_per_shard=128, min_width=8, max_width=64)
        assert p.t._prep_fast is not None
        if not fast:
            p.j._prep_fast = p.t._prep_fast = None
        rng = random.Random(23)
        now = NOW
        for step in range(12):
            now += rng.randint(0, 2000)
            batch = []
            for _ in range(rng.randint(1, 20)):
                kind = rng.random()
                if kind < 0.06:
                    batch.append(_f(""))
                elif kind < 0.16:
                    batch.append(_f(f"g{rng.randint(0, 2)}", hits=rng.randint(0, 2),
                                    duration=rng.choice([0, 1]), behavior=GREG))
                elif kind < 0.24:
                    batch.append(_g(f"gl{rng.randint(0, 3)}", hits=rng.randint(0, 2)))
                else:
                    batch.append(_f(f"k{rng.randint(0, 15)}", hits=rng.randint(0, 3),
                                    limit=rng.choice([5, 10]), algo=rng.randint(0, 1)))
            p.get(batch, now)
            if step % 4 == 3:
                p.sync(now + 1)


SCENARIOS = {f.__name__[3:]: f for f in [
    sc_token_across_shards, sc_leaky_drain, sc_mixed_4x2, sc_lean_mesh_wire,
    sc_herd, sc_scan_dups, sc_per_round, sc_global_first_touch, sc_global_psum,
    sc_global_optimistic, sc_global_converges, sc_global_two_regions,
    sc_global_idle_sweep, sc_global_lru, sc_global_fallback,
    sc_global_eviction_keeps_state, sc_global_gregorian, sc_global_soak, sc_rewarm, sc_fast_slow_mixed]}


@pytest.mark.usefixtures("jax_lib")
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_matches_jax(name):
    SCENARIOS[name](lambda **kw: Pair(**kw))


def test_wide_pin_ships_no_lean(monkeypatch):
    """GUBER_STAGING=wide pins the wide wire in both packages."""
    monkeypatch.setenv("GUBER_STAGING", "wide")
    p = Pair(n_shards=2, capacity_per_shard=512, min_width=8, max_width=32)
    p.get([_f("wp")], NOW)
    assert p.t.stats["lean_windows"] == 0


def test_stage_clocks_accumulate():
    eng = ShardedEngine(n_shards=4, capacity_per_shard=1024, min_width=8,
                        max_width=64, device="cpu")
    eng.get_rate_limits([RateLimitReq(**_f(f"sc{i}")) for i in range(10)], now_ms=NOW)
    eng.get_rate_limits([RateLimitReq(**_f("hot2"))] * 6, now_ms=NOW)
    for stage in ("prep", "lookup", "pack", "device", "demux"):
        assert eng.stats[f"{stage}_ns"] > 0, stage


def test_owner_routing_matches_mesh_hash():
    eng = ShardedEngine(n_shards=4, capacity_per_shard=128, min_width=8,
                        max_width=64, device="cpu")
    keys = [f"rt{i}" for i in range(60)]
    eng.get_rate_limits([RateLimitReq(**_f(k)) for k in keys], now_ms=NOW)
    for k in keys:
        owner = shard_of_key(f"test_{k}", eng.plan.n_owners)
        assert eng.owner_of(f"test_{k}") == owner
        assert eng.directories[owner].peek_slot(f"test_{k}") >= 0, k


# ------------------------------------------------------------------ the Store

def st_read_write_through(p):
    p.get([_f("ss1")], NOW)
    p.get([_f("ss1", hits=2)], NOW + 1)
    assert p.tstore.data["test_ss1"].remaining == 7 and p.tstore.called["get"] == 1


def st_read_through_restores(p):
    for s, Snap in ((p.jstore, _jax_snapshot()), (p.tstore, BucketSnapshot)):
        s.data["test_ss2"] = Snap(key="test_ss2", algo=0, limit=10, remaining=3,
                                  duration=60_000, stamp=NOW - 1000, expire_at=NOW + 59_000)
    assert p.get([_f("ss2")], NOW)[0].remaining == 2


def st_reset_removes(p):
    p.get([_f("ss3")], NOW)
    p.get([_f("ss3", hits=0, behavior=RESET)], NOW + 1)
    assert "test_ss3" not in p.tstore.data


def st_algorithm_switch(p):
    p.get([_f("ss4")], NOW)
    assert p.get([_f("ss4", algo=1)], NOW + 1)[0].remaining == 9


def st_scan_batched_hooks(p):
    assert [r.remaining for r in p.get([_f("sscan", hits=2)] * 4, NOW)] == [8, 6, 4, 2]
    assert p.tstore.called["on_change"] == 1


def st_differential(p):
    rng = random.Random(7)
    now = NOW
    for _ in range(15):
        now += rng.randint(0, 1500)
        p.get([_f(f"d{rng.randint(0, 9)}", hits=rng.randint(0, 3),
                  limit=rng.choice([5, 10]), duration=rng.choice([1000, 60_000]),
                  algo=rng.randint(0, 1))
               for _ in range(rng.randint(1, 6))], now)


def st_global_writes_through(p):
    g = lambda h: _g("sg1", hits=h, duration=3_600_000)  # noqa: E731
    p.get([g(5)], NOW)
    p.sync(NOW + 1)
    p.get([g(10)], NOW + 2)
    assert p.tstore.data["test_sg1"].remaining == 95
    p.sync(NOW + 3)
    assert p.tstore.data["test_sg1"].remaining == 85


def st_wide_store_rows(p):
    """Store rows whose algo or status lie past int32: the sharded inject
    writes all seven fields as given, in both packages (the single-table
    inject truncates them). A peek leaves the injected status in the row;
    a row whose algo matches no request is re-created by the decision."""
    big = (1 << 33) + 5
    for s, Snap in ((p.jstore, _jax_snapshot()), (p.tstore, BucketSnapshot)):
        s.data["test_wide"] = Snap(key="test_wide", algo=0, limit=10, remaining=3,
                                   duration=60_000, stamp=NOW, expire_at=NOW + 60_000,
                                   status=-big)
        s.data["test_algo"] = Snap(key="test_algo", algo=big, limit=10, remaining=3,
                                   duration=60_000, stamp=NOW, expire_at=NOW + 60_000,
                                   status=big)
    p.get([_f("wide", hits=0), _f("algo")], NOW)
    assert _key_row(p.t, "test_wide")[6] == -big


def _key_row(eng, key):
    owner = eng.owner_of(key)
    r_, s_ = eng.plan.owner_coords(owner)
    return eng.state[r_, s_, eng.directories[owner].peek_slot(key)].tolist()


def _jax_snapshot():
    from gubernator_tpu.store import BucketSnapshot as JSnap

    return JSnap


STORE_CASES = {f.__name__[3:]: f for f in [
    st_read_write_through, st_read_through_restores, st_reset_removes,
    st_algorithm_switch, st_scan_batched_hooks, st_differential,
    st_global_writes_through, st_wide_store_rows]}


@pytest.mark.usefixtures("jax_lib")
@pytest.mark.parametrize("name", sorted(STORE_CASES))
def test_store_path_matches_jax(name):
    STORE_CASES[name](Pair(store=True, n_shards=4, capacity_per_shard=64,
                           min_width=8, max_width=32))


@pytest.mark.usefixtures("jax_lib")
@pytest.mark.parametrize("geom", [(2, 512, 16, 24), (2, 1024, 16, 60)])
def test_store_scan_union_cases(geom):
    """test_store_scan_chunked_round0_keeps_fresh (24 requests over
    max_width 16) and test_store_scan_union_wider_than_max_width (60
    keys)."""
    shards, cap, width, n = geom
    p = Pair(store=True, n_shards=shards, capacity_per_shard=cap,
             min_width=width, max_width=width)
    reqs = [_f(f"sf{i}", hits=2) for i in range(min(n, 20) if n == 24 else n)]
    if n == 24:
        reqs += [_f(f"sf{i}", hits=3) for i in range(4)]
    p.get(reqs, NOW)


@pytest.mark.usefixtures("jax_lib")
def test_inject_padding_never_clobbers_last_slot():
    """Every shard full, then a read-through inject on padded [R, S, w]
    buffers: no shard's last row may change but the injected key's."""
    p = Pair(store=True, n_shards=4, capacity_per_shard=8, min_width=8, max_width=8)
    p.get([_f(f"fill{i}", duration=3_600_000) for i in range(32)], NOW)
    before = {s.key: s.remaining for s in p.t.snapshot(include_expired=True)}
    for s, Snap in ((p.jstore, _jax_snapshot()), (p.tstore, BucketSnapshot)):
        s.data["test_inj"] = Snap(key="test_inj", algo=0, limit=10, remaining=4,
                                  duration=3_600_000, stamp=NOW, expire_at=NOW + 3_600_000)
    assert p.get([_f("inj", duration=3_600_000)], NOW + 1)[0].remaining == 3
    after = {s.key: s.remaining for s in p.t.snapshot(include_expired=True)}
    for k, v in after.items():
        if k in before and k != "test_inj":
            assert v == before[k], k


@pytest.mark.usefixtures("jax_lib")
def test_store_close_flushes_and_warmup():
    p = Pair(store=True, n_shards=4, capacity_per_shard=64, min_width=8, max_width=32)
    p.j.warmup()
    p.t.warmup()
    p.check()
    from gubernator_tpu_torch.utils.interval import millisecond_now

    now = millisecond_now()
    g = lambda h: _g("sg2", hits=h, duration=3_600_000)  # noqa: E731
    p.get([g(5)], now)
    p.sync(now + 1)
    p.get([g(10)], now + 2)
    p.j.close()
    p.t.close()
    assert p.tstore.data["test_sg2"].remaining == 85
    assert p.jstore.data["test_sg2"].remaining == 85


# ------------------------------------------------------------- persistence

def _paths(tmp_path, name):
    return str(tmp_path / f"{name}.jax.jsonl"), str(tmp_path / f"{name}.port.jsonl")


@pytest.mark.usefixtures("jax_lib")
@pytest.mark.parametrize("case", ["roundtrip", "owner_routing", "oversized", "close_flush"])
def test_snapshot_cases_match_jax(tmp_path, case):
    """The snapshot round trip, the reload into fewer shards, a snapshot
    larger than the shards, and close() flushing queued GLOBAL hits: each
    package writes its own file, and both files hold the same rows; the
    reloaded engines then answer alike."""
    from gubernator_tpu_torch.utils.interval import millisecond_now

    now = millisecond_now()
    paths = _paths(tmp_path, case)
    kw = dict(n_shards=8, capacity_per_shard=256, min_width=8, max_width=32)
    if case == "oversized":
        from gubernator_tpu.store import BucketSnapshot as JSnap, FileLoader as JFile

        rows = [dict(key=f"test_ov{i}", algo=0, limit=10, remaining=5, duration=3_600_000,
                     stamp=now, expire_at=now + 3_600_000) for i in range(300)]
        JFile(paths[0]).save([JSnap(**r) for r in rows])
        FileLoader(paths[1]).save([BucketSnapshot(**r) for r in rows])
        p = Pair(loader_paths=paths, n_shards=4, capacity_per_shard=32, min_width=8,
                 max_width=16)
        assert sum(d.evictions for d in p.t.directories) > 0
        p.get([_f("fresh")], now)
        return
    p = Pair(loader_paths=paths, **kw)
    if case == "close_flush":
        g = lambda h: _g("gk", hits=h, duration=3_600_000)  # noqa: E731
        p.get([g(5)], now)
        p.sync(now + 1)
        p.get([g(10)], now + 2)
    else:
        p.get([_f(f"sn{i}", hits=3 if case == "roundtrip" else 4, duration=3_600_000)
               for i in range(20)], now)
    p.j.close()
    p.t.close()
    assert open(paths[0]).read() == open(paths[1]).read()
    if case == "owner_routing":
        kw["n_shards"] = 4
    q = Pair(loader_paths=paths, **kw)
    keys = ["gk"] if case == "close_flush" else [f"sn{i}" for i in range(20)]
    rs = q.get([_f(k, hits=0, limit=100 if case == "close_flush" else 10,
                   duration=3_600_000) for k in keys], now + 1000)
    assert rs[0].remaining == {"close_flush": 85, "roundtrip": 7,
                               "owner_routing": 6}[case]


# ------------------------------------------------------- native bindings

def _cols(fields):
    names = [f["name"].encode() for f in fields]
    ukeys = [f["unique_key"].encode() for f in fields]
    off = np.zeros(len(fields) + 1, np.int32)
    np.cumsum([len(a) + len(b) for a, b in zip(names, ukeys)], out=off[1:])
    return dict(
        keys=b"".join(a + b for a, b in zip(names, ukeys)), key_off=off,
        name_len=np.array([len(a) for a in names], np.int32),
        hits=np.array([f["hits"] for f in fields], np.int64),
        limit=np.array([f["limit"] for f in fields], np.int64),
        duration=np.array([f["duration"] for f in fields], np.int64),
        algorithm=np.array([f["algorithm"] for f in fields], np.int32),
        behavior=np.array([f["behavior"] for f in fields], np.int32))


def _route_workload(rng, n):
    out = []
    for _ in range(n):
        kind = rng.random()
        if kind < 0.05:
            out.append(_f(""))
        elif kind < 0.12:
            out.append(_f(f"g{rng.randint(0, 3)}", duration=1, behavior=GREG))
        elif kind < 0.2:
            out.append(_g(f"gl{rng.randint(0, 3)}"))
        else:
            out.append(_f(f"k{rng.randint(0, 60)}", hits=rng.randint(0, 3),
                          limit=rng.choice([5, 10]), algo=rng.randint(0, 1)))
    return out


@pytest.mark.usefixtures("jax_lib")
@pytest.mark.parametrize("columnar", [False, True])
def test_route_preps_match_jax(columnar):
    """prep_route_sharded and prep_route_columnar: the same columns,
    lanes, owner counts and leftovers as the JAX natives, window after
    window on evolving directories, with an over-commit at the end."""
    from gubernator_tpu import RateLimitReq as JReq

    n_owners, cap = 4, 32
    jd = [jnative.NativeKeyDirectory(cap) for _ in range(n_owners)]
    td = [tnative.NativeKeyDirectory(cap) for _ in range(n_owners)]
    rng = random.Random(5)
    for it in range(10):
        fields = _route_workload(rng, rng.randint(1, 40))
        if it == 9:
            fields = [_f(f"over{i}") for i in range(200)]
        if columnar:
            c = _cols(fields)
            args = (len(fields), c["keys"], c["key_off"], c["name_len"], c["hits"],
                    c["limit"], c["duration"], c["algorithm"], c["behavior"], GLOBAL | GREG)
            want = jnative.prep_route_columnar(jd, *args)
            got = tnative.prep_route_columnar(td, *args)
        else:
            want = jnative.prep_route_sharded(jd, [JReq(**f) for f in fields], GLOBAL | GREG)
            got = tnative.prep_route_sharded(td, [RateLimitReq(**f) for f in fields],
                                             GLOBAL | GREG)
        assert want[0] == got[0]
        for a, b in zip(want[1:], got[1:]):
            if a is None:
                assert b is None
            else:
                np.testing.assert_array_equal(a, b)
        assert [d.items() for d in jd] == [d.items() for d in td]
    assert got[0] == tnative.PREP_OVERCOMMIT


@pytest.mark.usefixtures("jax_lib")
@pytest.mark.parametrize("n_owners", [1, 3, 8])
def test_owner_batch_matches_jax(n_owners):
    keys = [f"ob_{i}" for i in range(300)] + ["", "ünï_ç"]
    np.testing.assert_array_equal(jnative.owner_batch(keys, n_owners),
                                  tnative.owner_batch(keys, n_owners))
    assert tnative.owner_batch(keys, n_owners).tolist() == [
        shard_of_key(k, n_owners) for k in keys]


# ------------------------------------------- kernels' plain versions vs JAX

def _jplan(R, S, C):
    from gubernator_tpu.parallel.mesh import MeshPlan as JPlan, make_mesh

    return JPlan(mesh=make_mesh(n_shards=S, n_regions=R), capacity_per_shard=C)


def _edge_table(rng, R, S, C):
    """A populated [R, S, C, 8] table: token and leaky rows, some vacant or
    expired, every shard's last row live."""
    t = np.zeros((R, S, C, 8), np.int64)
    t[..., 0] = rng.choice([-1, 0, 1], (R, S, C))
    t[..., 1] = rng.choice([5, 10, 50], (R, S, C))
    t[..., 2] = rng.randint(0, 10, (R, S, C))
    t[..., 3] = rng.choice([1000, 60_000], (R, S, C))
    t[..., 4] = NOW - rng.randint(0, 5000, (R, S, C))
    t[..., 5] = NOW + rng.randint(-2000, 60_000, (R, S, C))
    t[..., 6] = rng.randint(0, 2, (R, S, C))
    t[..., 7] = rng.randint(0, 100, (R, S, C))
    t[:, :, C - 1, 0] = 0
    t[:, :, C - 1, 5] = NOW + 60_000
    return t


def _edge_packed(rng, R, S, C, W, K=None, lean_ok=False):
    """Wide staging [R, S, (K,) 9, W] with the edge lanes: in every window
    of every shard, lane 0 past the table (reads the shard's row C-1) and,
    in even shards, lane 1 writing row C-1 in the same window; odd shards
    write their own row C-1 only in later windows; the rest distinct
    slots, some padding. lean_ok keeps every live lane lean-eligible."""
    lead = (R, S) if K is None else (R, S, K)
    p = np.zeros(lead + (9, W), np.int64)
    for idx in np.ndindex(*lead):
        o = idx[0] * S + idx[1]
        k = 0 if K is None else idx[2]
        slots = rng.choice(C - 1, W, replace=False).astype(np.int64)
        slots[0] = C + o  # past this shard's table
        if o % 2 == 0 or k % 2 == 1:
            slots[1] = C - 1
        slots[W - 1] = -1  # padding on the last lane
        p[idx + (0,)] = slots
        p[idx + (1,)] = 1 if lean_ok else rng.randint(0, 3, W)
        p[idx + (2,)] = rng.choice([5, 10, 50], W)
        p[idx + (3,)] = rng.choice([1000, 60_000], W)
        p[idx + (4,)] = rng.randint(0, 2, W)
        p[idx + (5,)] = 0 if lean_ok else rng.choice([0, 0, RESET], W)
        p[idx + (8,)] = rng.rand(W) < 0.2
    return p


def _hold_decide_sharded(R, S, C, fmt, scan, table, packed):
    """One sharded decide of `packed` (wide staging) on `table` through the
    JAX make_decide_sharded* program and the port's plain version, in the
    wide or lean format: responses and tables bit-equal."""
    from gubernator_tpu.parallel import sharded as js

    plan = _jplan(R, S, C)
    tstate = convert.table_to_torch(table, "cpu")
    if fmt == "wide":
        make = js.make_decide_sharded_scan if scan else js.make_decide_sharded
        jstate, jout = make(plan)(jnp.asarray(table), jnp.asarray(packed), NOW)
        tout = dk.decide_sharded(dk.WIDE, tstate, torch.from_numpy(packed), None, NOW,
                                 scan=scan)
    else:
        lanes, cfg = dk.lean_window(packed, C)
        # config ids 64..127 set the lane word's sign bit
        cfg = np.roll(cfg, 100, axis=0)
        lanes = np.where(lanes == dk._LEAN_PAD, lanes,
                         (((lanes.view(np.uint32) >> 25) + 100) % 128 << 25
                          | (lanes.view(np.uint32) & ((1 << 25) - 1))).view(np.int32))
        assert (lanes < 0).any()
        make = js.make_decide_sharded_scan_lean if scan else js.make_decide_sharded_lean
        jstate, jout = make(plan)(jnp.asarray(table), jnp.asarray(lanes), jnp.asarray(cfg), NOW)
        tout = dk.decide_sharded(dk.LEAN, tstate, torch.from_numpy(lanes),
                                 torch.from_numpy(cfg), NOW, scan=scan)
    assert np.asarray(jout).dtype == convert.to_numpy(tout).dtype
    np.testing.assert_array_equal(np.asarray(jout), convert.to_numpy(tout))
    np.testing.assert_array_equal(np.asarray(jstate), convert.table_to_numpy(tstate))


@pytest.mark.parametrize("R,S", [(1, 8), (2, 4)])
@pytest.mark.parametrize("fmt", ["wide", "lean"])
@pytest.mark.parametrize("scan", [False, True])
def test_decide_sharded_plain_matches_jax(R, S, fmt, scan):
    rng = np.random.RandomState(R * 10 + S + scan)
    C, W, K = 64, 16, 3
    table = _edge_table(rng, R, S, C)
    packed = _edge_packed(rng, R, S, C, W, K if scan else None, lean_ok=fmt == "lean")
    _hold_decide_sharded(R, S, C, fmt, scan, table, packed)


@pytest.mark.parametrize("R,S", [(1, 8), (2, 4)])
@pytest.mark.parametrize("fmt", ["wide", "lean"])
@pytest.mark.parametrize("scan", [False, True])
def test_decide_sharded_padded_windows_match_jax(R, S, fmt, scan):
    """Windows with no live lane, which decide_sharded_plain answers without
    a call: owner 3's window (a scan: its window 1) all padding, and in a
    scan every window of owner 5, beside the edge lanes of the others."""
    rng = np.random.RandomState(R * 10 + S + scan + 7)
    C, W, K = 64, 16, 3
    table = _edge_table(rng, R, S, C)
    packed = _edge_packed(rng, R, S, C, W, K if scan else None, lean_ok=fmt == "lean")
    blank = [divmod(3, S) + ((1,) if scan else ())]
    if scan:
        blank.append(divmod(5, S))
    for idx in blank:
        packed[idx + (Ellipsis, 0, slice(None))] = -1
        packed[idx + (Ellipsis, slice(1, None), slice(None))] = 0
    _hold_decide_sharded(R, S, C, fmt, scan, table, packed)


@pytest.mark.parametrize("R,S", [(1, 8), (2, 4)])
def test_gather_inject_sharded_plain_match_jax(R, S):
    from gubernator_tpu.parallel import sharded as js

    rng = np.random.RandomState(R + S)
    C, W = 32, 16
    table = _edge_table(rng, R, S, C)
    plan = _jplan(R, S, C)
    slot = rng.randint(-3, C + 3, (R, S, W)).astype(np.int32)
    slot[..., 0] = C - 1
    slot[..., 1] = -1
    slot[..., 2] = C + 7
    want = js.make_gather_sharded(plan)(jnp.asarray(table), jnp.asarray(slot))
    got = rk.gather_sharded(convert.table_to_torch(table, "cpu"), torch.from_numpy(slot))
    np.testing.assert_array_equal(np.asarray(want), convert.to_numpy(got))
    # the inject: distinct slots a shard, padding (-1) and past-table lanes
    # beside the last slot, algo and status past int32
    islot = np.stack([rng.permutation(C - 1)[:W] for _ in range(R * S)]).reshape(
        R, S, W).astype(np.int32)
    islot[..., :3] = (-1, C, C + 5)
    islot[0, 0, 3] = C - 1
    rows = rng.randint(-(1 << 40), 1 << 40, (R, S, 7, W)).astype(np.int64)
    rows[:, :, 0, :] = (1 << 33) + 1
    rows[:, :, 6, :] = -(1 << 35)
    jstate = js.make_inject_sharded(plan)(jnp.asarray(table), jnp.asarray(islot),
                                          jnp.asarray(rows))
    tstate = convert.table_to_torch(table, "cpu")
    rk.inject_sharded(tstate, torch.from_numpy(islot), torch.from_numpy(rows))
    np.testing.assert_array_equal(np.asarray(jstate), convert.table_to_numpy(tstate))
    assert (convert.table_to_numpy(tstate)[:, :, C - 1] == table[:, :, C - 1]).all(
        axis=-1).sum() == R * S - 1


# ------------------------------------- the CUDA wrappers, with a fake library

def _fake(dtype=torch.int64, shape=(1, 8, 64, 8), index=0, contiguous=True):
    """What _launch.check and the sharded wrappers read of a card tensor."""
    return SimpleNamespace(
        is_cuda=True, is_cpu=False, get_device=lambda: index, device=f"cuda:{index}",
        dtype=dtype, shape=torch.Size(shape), is_contiguous=lambda: contiguous,
        data_ptr=lambda: 4096,
        new_empty=lambda dims, dtype=dtype: _fake(dtype, tuple(dims), index))


def _decide_library(calls):
    def launch(*args):
        calls.append(args)
        return 0

    return SimpleNamespace(decide_launch=launch, stream=lambda index: 7,
                           max_owners=64, scratch_words=1024)


@pytest.mark.parametrize("fmt,scan,packed,cfg", [
    (dk.WIDE, False, (1, 8, 9, 16), None),
    (dk.WIDE, True, (1, 8, 4, 9, 16), None),
    (dk.LEAN, False, (1, 8, 16), (128, 4)),
    (dk.LEAN, True, (1, 8, 4, 16), (128, 4)),
])
def test_decide_sharded_wrapper_counts_one_launch(monkeypatch, fmt, scan, packed, cfg):
    """One launch for all eight owners, counted once under its own name and
    shape; the entry point gets C, the owner count, K, B, the card's
    scratch and the raw stream; the response is [R, S, (K,) 4, B]."""
    calls = []
    monkeypatch.setattr(dk, "_kernels", _decide_library(calls))
    monkeypatch.setitem(dk._scratch, 0, _fake(shape=(1024,)))
    dk.reset_launch_counts()
    dtype = torch.int64 if fmt == dk.WIDE else torch.int32
    out = dk.decide_sharded_cuda(fmt, _fake(), _fake(dtype, packed),
                                 None if cfg is None else _fake(shape=cfg), NOW, scan=scan)
    K = packed[2] if scan else 1
    assert tuple(out.shape) == ((1, 8, K, 4, 16) if scan else (1, 8, 4, 16))
    assert out.dtype == (torch.int64 if fmt == dk.WIDE else torch.int32)
    name = dk._SHARDED_COUNT_NAMES[fmt, scan]
    assert {k: v for k, v in dk.launch_counts.items() if v} == {name: 1}
    assert dk.launch_shapes == {(name, K, 16): 1}
    (index, f, _t, C, owners, _p, c, _o, k, B, now, sc, _scr, stream), = calls
    assert (index, f, C, owners, k, B, now, sc, stream) == (
        0, fmt, 64, 8, K, 16, NOW, int(scan), 7)
    assert (c is None) == (cfg is None)


@pytest.mark.parametrize("args,match", [
    ((torch.zeros((1, 8, 64, 8), dtype=torch.int64), _fake(shape=(1, 8, 9, 16))),
     "needs CUDA tensors"),
    ((_fake(shape=(8, 64, 8)), _fake(shape=(1, 8, 9, 16))), r"table must be \[n, n, n, 8\]"),
    ((_fake(), _fake(shape=(1, 4, 9, 16))), r"staging must be \[1, 8, 9, n\]"),
    ((_fake(), _fake(torch.int32, (1, 8, 9, 16))), "staging must be torch.int64"),
    ((_fake(), _fake(shape=(1, 8, 9, 16), index=1)), "staging is on cuda:1"),
    ((_fake(shape=(1, 8, 0, 8)), _fake(shape=(1, 8, 9, 16))), "empty table"),
    ((_fake(shape=(1, 65, 8, 8)), _fake(shape=(1, 65, 9, 16))), "at most 64"),
])
def test_decide_sharded_wrapper_refuses(monkeypatch, args, match):
    calls = []
    monkeypatch.setattr(dk, "_kernels", _decide_library(calls))
    monkeypatch.setitem(dk._scratch, 0, _fake(shape=(1024,)))
    dk.reset_launch_counts()
    with pytest.raises(ValueError, match=match):
        dk.decide_sharded_cuda(dk.WIDE, *args, None, NOW)
    assert calls == [] and not any(dk.launch_counts.values())
    with pytest.raises(ValueError, match="wide and lean formats only"):
        dk.decide_sharded_cuda(dk.COMPACT, _fake(), _fake(torch.int32, (1, 8, 5, 16)),
                               None, NOW)


def test_rows_sharded_wrappers(monkeypatch):
    """The sharded gather and inject: one launch each for all owners, the
    shapes they check, counted under gather_sharded and inject_sharded."""
    calls = []

    def rec(name):
        def launch(*args):
            calls.append((name, args))
            return 0
        return launch

    monkeypatch.setattr(rk, "_kernels", SimpleNamespace(
        gather_sharded_launch=rec("gather"), inject_sharded_launch=rec("inject"),
        stream=lambda index: 7))
    rk.reset_launch_counts()
    out = rk.gather_sharded_cuda(_fake(shape=(2, 4, 64, 8)),
                                 _fake(torch.int32, (2, 4, 16)))
    assert tuple(out.shape) == (2, 4, 7, 16)
    rk.inject_sharded_cuda(_fake(shape=(2, 4, 64, 8)), _fake(torch.int32, (2, 4, 16)),
                           _fake(shape=(2, 4, 7, 16)))
    assert [(n, a[2], a[3]) for n, a in calls] == [("gather", 64, 8), ("inject", 64, 8)]
    assert rk.launch_counts["gather_sharded"] == rk.launch_counts["inject_sharded"] == 1
    with pytest.raises(ValueError, match=r"slots must be \[2, 4, n\]"):
        rk.gather_sharded_cuda(_fake(shape=(2, 4, 64, 8)), _fake(torch.int32, (1, 8, 16)))
    with pytest.raises(ValueError, match=r"rows must be \[2, 4, 7, 16\]"):
        rk.inject_sharded_cuda(_fake(shape=(2, 4, 64, 8)), _fake(torch.int32, (2, 4, 16)),
                               _fake(shape=(2, 4, 8, 16)))
    with pytest.raises(ValueError, match="slots must be torch.int32"):
        rk.inject_sharded_cuda(_fake(shape=(2, 4, 64, 8)), _fake(shape=(2, 4, 16)),
                               _fake(shape=(2, 4, 7, 16)))
    assert len(calls) == 2


def test_global_step_takes_one_sharded_decide(monkeypatch):
    """The port's GLOBAL step decides every owner in one sharded decide."""
    from gubernator_tpu_torch.parallel import global_sync as gs

    seen = []
    real = gs.decide_sharded

    def spy(fmt, state, packed, cfg, now, scan=False):
        seen.append(tuple(packed.shape))
        return real(fmt, state, packed, cfg, now, scan)

    monkeypatch.setattr(gs, "decide_sharded", spy)
    eng = ShardedEngine(n_shards=4, capacity_per_shard=64, min_width=8, max_width=16,
                        global_capacity=32, device="cpu")
    eng.get_rate_limits([RateLimitReq(**_g(f"s{i}")) for i in range(6)], now_ms=NOW)
    assert eng.global_sync(now_ms=NOW + 1) == 6
    assert seen == [(1, 4, 9, 32)]


# ------------------------------------------------ pipeline and columnar

def _pipe_kw():
    return dict(n_shards=4, capacity_per_shard=512, min_width=8, max_width=16)


def _pipe_subs(seed):
    rng = np.random.RandomState(seed)
    subs = []
    for i in range(40):
        reqs = [_f(f"m{int(rng.randint(10))}", limit=100, hits=int(rng.randint(0, 3)))
                for _ in range(int(rng.randint(1, 12)))]
        if rng.rand() < 0.2:
            reqs.append(_f("g", duration=1, behavior=GREG))
        if rng.rand() < 0.2:
            reqs.append(reqs[0])
        subs.append(reqs)
    return subs


@pytest.mark.usefixtures("jax_lib")
@pytest.mark.parametrize("depth,scan", [(3, 4), (1, 1)])
def test_combiner_over_sharded_matches_jax(depth, scan):
    """tests/test_pipeline.py's sharded stimuli through the port's
    BackendCombiner over the port's ShardedEngine and the JAX combiner over
    the JAX one: equal responses and equal tables."""
    from gubernator_tpu import RateLimitReq as JReq
    from gubernator_tpu.parallel import ShardedEngine as JaxSharded
    from gubernator_tpu.service.combiner import BackendCombiner as JaxCombiner

    subs = _pipe_subs(5)
    results = []
    for eng, comb, req in ((JaxSharded(**_pipe_kw()), JaxCombiner, JReq),
                           (ShardedEngine(device="cpu", **_pipe_kw()), BackendCombiner,
                            RateLimitReq)):
        assert eng.supports_pipeline()
        c = comb(eng, depth=depth, scan=scan)
        try:
            assert c.pipelined == (depth > 1)
            futs = [c.submit_async([req(**f) for f in s], NOW + i) for i, s in enumerate(subs)]
            got = [[_resp(r) for r in f.result(timeout=60)] for f in futs]
        finally:
            c.close()
        results.append((got, np.asarray(eng.state) if req is JReq
                        else convert.table_to_numpy(eng.state)))
    assert results[0][0] == results[1][0]
    np.testing.assert_array_equal(results[0][1], results[1][1])


@pytest.mark.usefixtures("jax_lib")
def test_launch_collect_direct_matches_jax():
    """launch_windows / collect_windows and launch_noop, called directly."""
    from gubernator_tpu import RateLimitReq as JReq
    from gubernator_tpu.parallel import ShardedEngine as JaxSharded

    j, t = JaxSharded(**_pipe_kw()), ShardedEngine(device="cpu", **_pipe_kw())
    rng = np.random.RandomState(5)
    for step in range(8):
        wins = [[_f(f"m{int(rng.randint(10))}", limit=100)
                 for _ in range(int(rng.randint(1, 12)))] for _ in range(2)]
        a = j.collect_windows(j.launch_windows([[JReq(**f) for f in w] for w in wins],
                                               now_ms=NOW + step))
        b = t.collect_windows(t.launch_windows([[RateLimitReq(**f) for f in w] for w in wins],
                                               now_ms=NOW + step))
        assert [[_resp(r) for r in w] for w in a] == [[_resp(r) for r in w] for w in b]
        np.testing.assert_array_equal(np.asarray(j.state), convert.table_to_numpy(t.state))
    j.collect_noop(j.launch_noop())
    t.collect_noop(t.launch_noop())
    assert _counters(j.stats) == _counters(t.stats)


@pytest.mark.usefixtures("jax_lib")
@pytest.mark.parametrize("pipelined", [False, True])
def test_columnar_matches_jax(pipelined):
    """tests/test_columnar.py's and tests/test_columnar_pipeline.py's
    sharded stimuli: submit/complete_columnar (or the pipelined
    launch/collect_columnar_windows at scan 2) on both engines, leftovers
    through the object path; equal columns and tables."""
    from gubernator_tpu import RateLimitReq as JReq
    from gubernator_tpu.parallel import ShardedEngine as JaxSharded

    kw = dict(n_shards=4, capacity_per_shard=512, min_width=16, max_width=256)
    engines = [(JaxSharded(**kw), JReq), (ShardedEngine(device="cpu", **kw), RateLimitReq)]
    rng = np.random.default_rng(31)
    slow = GLOBAL | GREG
    for it in range(8):
        n = int(rng.integers(1, 150))
        fields = [_f(f"k{rng.integers(0, 40)}", hits=int(rng.integers(0, 3)), limit=25,
                     algo=int(rng.random() >= .7),
                     behavior=RESET if rng.random() < 0.1 else 0, name="sc")
                  for _ in range(n)]
        c = _cols(fields)
        got = []
        for eng, req in engines:
            cols = [np.zeros(n, np.int32)] + [np.zeros(n, np.int64) for _ in range(3)]
            now = NOW + it * 700
            if pipelined:
                half = n // 2 or n
                wins = []
                for lo, hi in ((0, half), (half, n)):
                    if lo == hi:
                        continue
                    sub = _cols(fields[lo:hi])
                    wins.append((hi - lo, sub["keys"], sub["key_off"], sub["name_len"],
                                 sub["hits"], sub["limit"], sub["duration"],
                                 sub["algorithm"], sub["behavior"]))
                h = eng.launch_columnar_windows(wins, slow, now_ms=now)
                outs = []
                for (lo, hi) in ((0, half), (half, n))[:len(h[0])]:
                    outs.append(tuple(col[lo:hi] for col in cols))
                lefts = eng.collect_columnar_windows(h, outs)
                left = []
                for (lo, _hi), lf in zip(((0, half), (half, n)), lefts):
                    left += [lo + i for i in lf.tolist()]
                done = sum(len(o[0]) for o in outs)
                left += list(range(done, n))
            else:
                h = eng.submit_columnar(n, c["keys"], c["key_off"], c["name_len"],
                                        c["hits"], c["limit"], c["duration"], c["algorithm"],
                                        c["behavior"], slow, now_ms=now)
                left = eng.complete_columnar(h, *cols).tolist()
            for i in left:
                r = eng.get_rate_limits([req(**fields[i])], now_ms=now)[0]
                for col, v in zip(cols, (r.status, r.limit, r.remaining, r.reset_time)):
                    col[i] = v
            got.append([col.tolist() for col in cols])
        assert got[0] == got[1], it
        np.testing.assert_array_equal(np.asarray(engines[0][0].state),
                                      convert.table_to_numpy(engines[1][0].state))


# --------------------------------------------------------------- the carry

@pytest.mark.usefixtures("jax_lib")
def test_carry_sharded_state_mid_stream():
    """A JAX engine runs 6 windows (GLOBAL keys registered, hits queued, an
    eviction); convert.carry_sharded_state gives its state to a fresh port
    engine; 4 further windows and syncs are bit-equal."""
    from gubernator_tpu import RateLimitReq as JReq
    from gubernator_tpu.parallel import ShardedEngine as JaxSharded

    kw = dict(n_shards=4, capacity_per_shard=16, min_width=8, max_width=16,
              global_capacity=4, global_idle_ms=1500)
    j = JaxSharded(**kw)
    rng = random.Random(3)

    def batch():
        return [_g(f"c{rng.randint(0, 6)}", hits=rng.randint(0, 2))
                if rng.random() < 0.3 else
                _f(f"k{rng.randint(0, 200)}", hits=rng.randint(0, 3), algo=rng.randint(0, 1))
                for _ in range(rng.randint(20, 40))]

    for step in range(6):
        j.get_rate_limits([JReq(**f) for f in batch()], now_ms=NOW + step * 400)
        if step % 2:
            j.global_sync(now_ms=NOW + step * 400 + 1)
    assert any(sum(1 for _ in d.items()) == 16 for d in j.directories)  # evicting
    t = ShardedEngine(device="cpu", **kw)
    convert.carry_sharded_state(t, np.asarray(j.state), [d.items() for d in j.directories],
                                j._globals.items(), j._gfree, j._gnext, j._gdelta, j._mirror)
    p = Pair.__new__(Pair)
    p.j, p.t, p.jstore, p.tstore = j, t, None, None
    j.stats = dict(t.stats)  # counters start from the carry
    p.check()
    for step in range(6, 10):
        p.get(batch(), NOW + step * 400)
        p.sync(NOW + step * 400 + 1)
    with pytest.raises(ValueError, match="table must be"):
        convert.carry_sharded_state(ShardedEngine(device="cpu", **kw), np.zeros((4, 16, 8)),
                                    [[]] * 4, [], [], 0, j._gdelta, j._mirror)


# ------------------------------------------------------------- the witness

def test_port_witness_resolves_sharded_engine():
    """The engine's lock is the witness lock `sharded.engine`, which
    lockmap.json declares; a run through the fast window, the python
    pipeline, a sync and a combiner records no unknown edge and no
    inversion."""
    if not witness.witness_enabled():
        pytest.skip("GUBER_LOCK_WITNESS is off")
    eng = ShardedEngine(device="cpu", **_pipe_kw())
    assert "sharded.engine" in repr(eng._lock)
    eng.get_rate_limits([RateLimitReq(**_f("w")), RateLimitReq(**_g("wg"))], now_ms=NOW)
    eng.global_sync(now_ms=NOW + 1)
    c = BackendCombiner(eng, depth=3, scan=4)
    try:
        c.submit([RateLimitReq(**_f("w"))], NOW + 2)
    finally:
        c.close()
    snap = witness.the_witness().snapshot()
    assert snap["unknown"] == [] and snap["inversions"] == [], snap
