"""The mesh form of the port's sharded backend against the JAX package's,
bit for bit, on the CPU.

A mesh (parallel/mesh.py make_mesh) gives each owner its own table on its
own device; here every entry is torch.device("cpu"), where the kernels'
plain versions run. Held here:

- the plain cross-card ring (ops/ring.py ring_all_reduce_mesh_plain, one
  tensor an entry) against the JAX Pallas ring in interpret mode under
  jax.shard_map, as tests/test_ring.py drives it, at n = 2, 4 and 8 with a
  sum that wraps, and the masked broadcast;
- every case of tests/test_torch_sharded.py::test_engine_matches_jax and
  of its Store cases, each through ONE JAX ShardedEngine (the 8-device CPU
  mesh of tests/conftest.py) beside the port's one-tensor engine and the
  port's mesh engine of one CPU entry an owner, all held equal after every
  step (responses, tables, mirrors, registries, counters, Stores);
- the GLOBAL sync over a mesh, "ring" and "psum", against the JAX "psum"
  sync (the JAX "ring" sync raises NameError: ROADMAP lists it);
- convert.carry_sharded_state, a snapshot written and restored, and
  hbm_bytes and the keyspace harvest on a mesh engine;
- the daemon's choice with four cards: one owner a card, stopped before
  any card is touched;
- make_mesh's contract, the CUDA wrapper of the cross-card all-reduce
  with a stand-in library (the grouping by card, one entry-point call an
  all-reduce, its arguments, the launch count, the epoch, the flag buffers,
  the peer-access rule, the limits), and make_mesh's counterpart in the
  public names.
Tolerance: none, every field is an integer.
"""

import collections.abc
import contextlib
import dataclasses
import inspect
import random
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, PartitionSpec as P

import test_torch_sharded as ts
from gubernator_tpu_torch import convert
from gubernator_tpu_torch.obs.keyspace import KeyspaceCartographer, hbm_bytes
from gubernator_tpu_torch.ops import ring as rk
from gubernator_tpu_torch.parallel import (
    MeshPlan,
    ShardedEngine,
    make_global_sync,
    make_mesh,
    make_sharded_table,
)
from gubernator_tpu_torch.store import FileLoader, MockStore
from gubernator_tpu_torch.types import RateLimitReq
from test_torch_global import _global_setup
from test_torch_interned import jax_lib  # noqa: F401  (the JAX library)

NOW = ts.NOW


def _cpu_mesh(n_shards, n_regions=1):
    return make_mesh(n_shards=n_shards, n_regions=n_regions,
                     devices=["cpu"] * (n_shards * n_regions))


# --------------------------------------------------------------- the ring

def _pallas_ring(n, x):
    from gubernator_tpu.ops.ring import make_ring_all_reduce

    mesh = JMesh(np.array(jax.devices()[:n]), ("shard",))
    ring = make_ring_all_reduce(n, x.shape[1], axis_name="shard")
    fn = jax.jit(jax.shard_map(
        lambda v: ring(v.reshape(-1)).reshape(1, -1),
        mesh=mesh, in_specs=P("shard", None), out_specs=P("shard", None),
        check_vma=False))
    return np.asarray(fn(jnp.asarray(x)))


@pytest.mark.parametrize("n,length", [(2, 8), (4, 16), (8, 64)])
def test_mesh_ring_matches_pallas_ring(n, length):
    """One tensor an entry through the plain mesh ring: each entry's sum
    equals the Pallas kernel's on that device, wrapping included."""
    rng = np.random.RandomState(n)
    x = rng.randint(-1000, 1000, (n, length)).astype(np.int64)
    x[0, 0] = np.iinfo(np.int64).max  # the sum wraps
    x[1, 1] = np.iinfo(np.int64).min
    want = _pallas_ring(n, x)
    got = rk.ring_all_reduce_mesh([torch.from_numpy(x[d].copy()) for d in range(n)])
    assert len(got) == n
    for d in range(n):
        np.testing.assert_array_equal(got[d].numpy(), want[d], err_msg=f"entry {d}")
    # the single-card form agrees on the same stimulus
    np.testing.assert_array_equal(rk.ring_all_reduce_plain(torch.from_numpy(x)).numpy(), want)


def test_mesh_ring_masked_broadcast():
    """The GLOBAL mirror's broadcast: each entry contributes its owned
    values, zero elsewhere; every entry ends with all of them, as the Pallas
    ring gives them (tests/test_ring.py::test_masked_broadcast_equivalence)."""
    n, G = 4, 12
    rng = np.random.RandomState(7)
    owners = rng.randint(0, n, G)
    values = rng.randint(1, 100, G)
    x = np.stack([np.where(owners == d, values, 0) for d in range(n)]).astype(np.int64)
    want = _pallas_ring(n, x)
    got = rk.ring_all_reduce_mesh([torch.from_numpy(x[d].copy()) for d in range(n)])
    for d in range(n):
        np.testing.assert_array_equal(want[d], values)
        np.testing.assert_array_equal(got[d].numpy(), values)


def test_mesh_ring_single_entry_and_inputs_untouched():
    x = torch.arange(5, dtype=torch.int64)
    (out,) = rk.ring_all_reduce_mesh([x])
    assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()
    xs = [torch.full((3,), d, dtype=torch.int64) for d in range(3)]
    before = [t.clone() for t in xs]
    outs = rk.ring_all_reduce_mesh(xs)
    assert all(torch.equal(a, b) for a, b in zip(xs, before))
    assert all(o.tolist() == [3, 3, 3] for o in outs)


def test_mesh_ring_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        rk.ring_all_reduce_mesh_cuda([torch.zeros(4, dtype=torch.int64)] * 2)


def test_peer_access_for_every_pair_of_neighbours(monkeypatch):
    """Distinct cards: every ordered pair of the set's distinct cards asked
    once and enabled once (each card's kernel reads every other card's
    inputs and flags, not only its left neighbour's); a card repeated needs
    nothing; a pair that cannot reach raises, naming both cards (no copy
    through the host)."""
    monkeypatch.setattr(rk, "_peers", set())
    asked, enabled = [], []

    def can(a, b, out, allow=lambda a, b: True):
        asked.append((a, b))
        out._obj.value = int(allow(a, b))
        return 0

    k = types.SimpleNamespace(ring_can_access_peer=can,
                              ring_enable_peer=lambda a, b: enabled.append((a, b)) or 0)
    rk._enable_peers(k, [0, 1, 2, 3])
    want = {(a, b) for a in range(4) for b in range(4) if a != b}
    assert set(enabled) == want and len(enabled) == len(want) == 12
    rk._enable_peers(k, [0, 1, 2, 3])  # once a pair
    assert len(enabled) == len(want)
    asked.clear()
    rk._enable_peers(k, [5])
    assert asked == []
    k.ring_can_access_peer = lambda a, b, out: can(a, b, out, allow=lambda a, b: b != 7)
    with pytest.raises(RuntimeError, match="cuda:6 cannot read cuda:7"):
        rk._enable_peers(k, [6, 7])


class _FakeStream:
    """A stand-in torch.cuda.Stream: its card and a distinct handle."""

    handles = iter(range(0x1000, 0x100000, 0x10))

    def __init__(self, device):
        self.device = torch.device("cuda", device)
        self.cuda_stream = next(self.handles)


@pytest.fixture
def fake_mesh(monkeypatch):
    """ring_all_reduce_mesh_cuda on CPU tensors that say which card they
    stand for (t.card), with a stand-in library whose entry point records
    its arguments and, as csrc/ring.cu does, increments the card set's
    epoch; flag buffers and streams made by stand-ins."""
    calls, flags_made = [], []

    def launch(n, x, out, streams, c, devices, card_of, flags, L, epoch):
        epoch._obj.value += 1
        calls.append(dict(n=n, x=list(x[:n]), out=list(out[:n]), streams=list(streams[:n]),
                          c=c, devices=list(devices[:c]), card_of=list(card_of[:n]),
                          flags=None if flags is None else list(flags[:c]), L=L,
                          epoch=epoch._obj.value))
        return 0

    k = types.SimpleNamespace(ring_mesh_launch=launch, max_mesh_entries=64, flag_words=512,
                              ring_can_access_peer=lambda a, b, out: setattr(out._obj, "value", 1)
                              or 0,
                              ring_enable_peer=lambda a, b: 0)
    monkeypatch.setattr(rk, "_kernels", k)
    for name, fresh in (("_streams", {}), ("_sets", {}), ("_peers", set())):
        monkeypatch.setattr(rk, name, fresh)
    monkeypatch.setattr(rk._launch, "cuda_index", lambda t, what: t.card)
    monkeypatch.setattr(rk._launch, "check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "stream", lambda st: contextlib.nullcontext())
    monkeypatch.setattr(rk, "_new_flags", lambda card, st, words: flags_made.append(
        (card, st)) or torch.zeros(words, dtype=torch.int64))
    return types.SimpleNamespace(calls=calls, flags_made=flags_made)


def _entries(layout, length=6, seed=0):
    rng = np.random.RandomState(seed)
    xs = []
    for card in layout:
        x = torch.from_numpy(rng.randint(-9, 9, length).astype(np.int64))
        x.card = card
        xs.append(x)
    return xs


@pytest.mark.parametrize("layout,cards,entries", [
    ([0] * 8, (0,), ((0, 1, 2, 3, 4, 5, 6, 7),)),
    ([0, 1, 2, 3], (0, 1, 2, 3), ((0,), (1,), (2,), (3,))),
    ([0, 1, 0, 1], (0, 1), ((0, 2), (1, 3))),
    ([3, 1, 3], (3, 1), ((0, 2), (1,))),
])
def test_mesh_allreduce_one_launch_a_card(fake_mesh, layout, cards, entries):
    """The entries grouped by card (cards in order of first appearance);
    one C call an all-reduce with the n inputs and outputs in entry order,
    each card's launch on its first entry's stream; the launch count grows
    by the number of cards; the epoch strictly increases; a card set's
    flag buffers (two cards or more) are made once, on the launch
    streams."""
    assert rk.group_by_card(layout) == (cards, entries)
    c = len(cards)
    epochs = []
    for call in range(3):
        xs = _entries(layout, seed=call)
        before = rk.launch_counts["ring_all_reduce_mesh"]
        outs = rk.ring_all_reduce_mesh_cuda(xs)
        assert rk.launch_counts["ring_all_reduce_mesh"] - before == c
        assert len(fake_mesh.calls) == call + 1
        got = fake_mesh.calls[-1]
        streams = rk.entry_streams(layout)
        assert got["n"] == len(layout) and got["c"] == c and got["L"] == 6
        assert got["x"] == [x.data_ptr() for x in xs]
        assert got["out"] == [o.data_ptr() for o in outs]
        assert got["streams"] == [s.cuda_stream for s in streams]
        assert got["devices"] == list(cards)
        assert got["card_of"] == [cards.index(i) for i in layout]
        cs = rk._sets[tuple(layout)]
        assert cs.launch == tuple(streams[e[0]] for e in entries)
        assert [s.device.index for s in cs.launch] == list(cards)
        assert got["flags"] == (None if c == 1 else [f.data_ptr() for f in cs.flags])
        assert len(outs) == len(layout) and len({o.data_ptr() for o in outs}) == len(layout)
        epochs.append(got["epoch"])
    assert epochs == sorted(set(epochs)) and epochs[0] >= 1
    assert fake_mesh.flags_made == ([] if c == 1 else list(zip(cards, cs.launch)))


def test_mesh_allreduce_flag_buffers_a_card_set(fake_mesh):
    """Two card sets over the same cards in another order (or fewer) are
    two sets: each its own streams, flag buffers and epoch."""
    rk.ring_all_reduce_mesh_cuda(_entries([0, 1]))
    rk.ring_all_reduce_mesh_cuda(_entries([1, 0]))
    rk.ring_all_reduce_mesh_cuda(_entries([0, 1]))
    assert [card for card, _ in fake_mesh.flags_made] == [0, 1, 1, 0]
    assert [c["epoch"] for c in fake_mesh.calls] == [1, 1, 2]
    assert rk._sets[(0, 1)].flags[0] is not rk._sets[(1, 0)].flags[1]


def test_mesh_allreduce_refuses_more_than_64_entries(fake_mesh):
    rk.ring_all_reduce_mesh_cuda(_entries([0] * 64, length=2))
    with pytest.raises(ValueError, match="at most 64 entries, got 65"):
        rk.ring_all_reduce_mesh_cuda(_entries([0] * 65, length=2))
    assert len(fake_mesh.calls) == 1


def test_mesh_allreduce_refuses_other_streams(fake_mesh):
    """A card set's flags keep their epochs in the launch order of its own
    streams: an all-reduce whose entry streams are no longer the card
    set's raises, and launches nothing."""
    rk.ring_all_reduce_mesh_cuda(_entries([0, 1]))
    rk._streams[(0, 1)] = (_FakeStream(0), _FakeStream(1))
    with pytest.raises(ValueError, match="other streams than its card set's own"):
        rk.ring_all_reduce_mesh_cuda(_entries([0, 1]))
    assert len(fake_mesh.calls) == 1


def test_mesh_allreduce_empty_and_single_entry(fake_mesh):
    """L = 0 reaches the entry point (which launches nothing) and counts no
    launch; one entry is a copy on its stream, with no call at all."""
    before = rk.launch_counts["ring_all_reduce_mesh"]
    outs = rk.ring_all_reduce_mesh_cuda(_entries([0, 1], length=0))
    assert [o.shape[0] for o in outs] == [0, 0]
    assert fake_mesh.calls[-1]["L"] == 0
    (one,) = rk.ring_all_reduce_mesh_cuda(_entries([2]))
    assert len(fake_mesh.calls) == 1 and one.shape[0] == 6
    assert rk.launch_counts["ring_all_reduce_mesh"] == before


# -------------------------------------------------------------- the engine

class _Both:
    """The one-tensor and the mesh port engines seen as one by a scenario:
    a set goes to both, a method runs on both (the one-tensor engine's
    result returned), a read comes from the one-tensor engine."""

    def __init__(self, one, mesh):
        object.__setattr__(self, "_pair", (one, mesh))

    def __getattr__(self, name):
        one, mesh = self._pair
        v = getattr(one, name)
        if not inspect.ismethod(v):
            return v

        def both(*a, **kw):
            got = v(*a, **kw)
            getattr(mesh, name)(*a, **kw)
            return got
        return both

    def __setattr__(self, name, value):
        for e in self._pair:
            setattr(e, name, value)


class _StoreData(collections.abc.MutableMapping):
    """The one-tensor engine's Store rows as a case sets them: a row the
    case sets (or deletes) goes to the mesh engine's Store too (a copy),
    a read comes from the one-tensor engine's. The engines write their own
    Stores."""

    def __init__(self, one, mesh):
        self._one, self._mesh = one, mesh

    def __getitem__(self, key):
        return self._one[key]

    def __setitem__(self, key, row):
        self._one[key] = row
        self._mesh[key] = dataclasses.replace(row)

    def __delitem__(self, key):
        del self._one[key]
        del self._mesh[key]

    def __iter__(self):
        return iter(self._one)

    def __len__(self):
        return len(self._one)


class _Stores:
    """The two port engines' Stores seen as one by a case (_StoreData)."""

    def __init__(self, one, mesh):
        self.data = _StoreData(one.data, mesh.data)
        self.called = one.called


class Triple(ts.Pair):
    """One JAX ShardedEngine beside the port's one-tensor engine and its mesh
    engine (one CPU entry an owner), driven in lock step: one JAX run per
    step serves both comparisons."""

    def __init__(self, store=False, **kw):
        from gubernator_tpu import store as jstore
        from gubernator_tpu.parallel import ShardedEngine as JaxSharded

        self.jstore = jstore.MockStore() if store else None
        self.ostore = MockStore() if store else None
        self.mstore = MockStore() if store else None
        self.tstore = _Stores(self.ostore, self.mstore) if store else None
        self.j = JaxSharded(store=self.jstore, **kw)
        self.one = ShardedEngine(device="cpu", store=self.ostore, **kw)
        geom = {k: kw.pop(k) for k in ("n_shards", "n_regions") if k in kw}
        self.mesh = ShardedEngine(mesh=_cpu_mesh(geom["n_shards"], geom.get("n_regions", 1)),
                                  store=self.mstore, **kw)
        assert isinstance(self.mesh.state, list)
        self.t = _Both(self.one, self.mesh)
        self.check()

    def get(self, fields, now):
        from gubernator_tpu import RateLimitReq as JReq

        want = [ts._resp(r) for r in
                self.j.get_rate_limits([JReq(**f) for f in fields], now_ms=now)]
        for eng in (self.one, self.mesh):
            got = eng.get_rate_limits([RateLimitReq(**f) for f in fields], now_ms=now)
            assert [ts._resp(r) for r in got] == want
        self.check()
        return got

    def sync(self, now):
        n = self.j.global_sync(now_ms=now)
        assert self.one.global_sync(now_ms=now) == n == self.mesh.global_sync(now_ms=now)
        self.check()

    def check(self):
        for eng, store in ((self.one, self.ostore), (self.mesh, self.mstore)):
            ts.Pair.check(types.SimpleNamespace(j=self.j, t=eng, jstore=self.jstore,
                                                tstore=store))


@pytest.mark.usefixtures("jax_lib")
@pytest.mark.parametrize("name", sorted(ts.SCENARIOS))
def test_mesh_engine_matches_jax(name):
    ts.SCENARIOS[name](lambda **kw: Triple(**kw))


@pytest.mark.usefixtures("jax_lib")
@pytest.mark.parametrize("name", sorted(ts.STORE_CASES))
def test_mesh_store_path_matches_jax(name):
    ts.STORE_CASES[name](Triple(store=True, n_shards=4, capacity_per_shard=64,
                                min_width=8, max_width=32))


@pytest.mark.usefixtures("jax_lib")
@pytest.mark.parametrize("depth,scan", [(3, 4), (1, 1)])
def test_mesh_combiner_matches_one_tensor(depth, scan):
    """tests/test_torch_sharded.py's combiner stimuli through BackendCombiner
    over the mesh engine and over the one-tensor engine (which that file
    holds to the JAX combiner): equal responses and tables."""
    from gubernator_tpu_torch.service.combiner import BackendCombiner

    kw = ts._pipe_kw()
    subs = ts._pipe_subs(5)
    results = []
    for eng in (ShardedEngine(device="cpu", **kw),
                ShardedEngine(mesh=_cpu_mesh(kw.pop("n_shards")), **kw)):
        c = BackendCombiner(eng, depth=depth, scan=scan)
        try:
            assert c.pipelined == (depth > 1)
            futs = [c.submit_async([RateLimitReq(**f) for f in sub], NOW + i)
                    for i, sub in enumerate(subs)]
            results.append(([[ts._resp(r) for r in f.result(timeout=60)] for f in futs],
                            eng.table_numpy()))
        finally:
            c.close()
    assert results[0][0] == results[1][0]
    np.testing.assert_array_equal(results[0][1], results[1][1])


@pytest.mark.usefixtures("jax_lib")
@pytest.mark.parametrize("pipelined", [False, True])
def test_mesh_launch_collect_and_columnar_match_one_tensor(pipelined):
    """launch_windows / collect_windows, launch_noop, and the wire columns
    (submit/complete_columnar, or launch/collect_columnar_windows) on the
    mesh engine and the one-tensor engine: equal answers, tables and
    counters."""
    kw = dict(capacity_per_shard=512, min_width=8, max_width=64)
    one = ShardedEngine(n_shards=4, device="cpu", **kw)
    mesh = ShardedEngine(mesh=_cpu_mesh(4), **kw)
    rng = np.random.default_rng(31)
    for it in range(6):
        now = NOW + it * 700
        wins = [[ts._f(f"m{int(rng.integers(10))}", limit=100)
                 for _ in range(int(rng.integers(1, 12)))] for _ in range(2)]
        got = [e.collect_windows(e.launch_windows(
            [[RateLimitReq(**f) for f in w] for w in wins], now_ms=now)) for e in (one, mesh)]
        assert [[ts._resp(r) for r in w] for w in got[0]] == \
            [[ts._resp(r) for r in w] for w in got[1]]
        n = int(rng.integers(1, 60))
        fields = [ts._f(f"k{rng.integers(0, 40)}", hits=int(rng.integers(0, 3)), limit=25,
                        algo=int(rng.random() >= .7), name="sc") for _ in range(n)]
        c = ts._cols(fields)
        cols = (n, c["keys"], c["key_off"], c["name_len"], c["hits"], c["limit"],
                c["duration"], c["algorithm"], c["behavior"])
        answers = []
        for eng in (one, mesh):
            outs = (np.zeros(n, np.int32), np.zeros(n, np.int64), np.zeros(n, np.int64),
                    np.zeros(n, np.int64))
            if pipelined:
                h = eng.launch_columnar_windows([cols], ts.GLOBAL | ts.GREG, now_ms=now)
                left = eng.collect_columnar_windows(h, [outs])[0].tolist()
            else:
                h = eng.submit_columnar(*cols, ts.GLOBAL | ts.GREG, now_ms=now)
                left = eng.complete_columnar(h, *outs).tolist()
            for i in left:  # duplicate keys: the object path, after the window
                r = eng.get_rate_limits([RateLimitReq(**fields[i])], now_ms=now)[0]
                for o, v in zip(outs, (r.status, r.limit, r.remaining, r.reset_time)):
                    o[i] = v
            answers.append([o.tolist() for o in outs])
        assert answers[0] == answers[1], it
        np.testing.assert_array_equal(one.table_numpy(), mesh.table_numpy())
    for eng in (one, mesh):
        eng.collect_noop(eng.launch_noop())
    assert ts._counters(one.stats) == ts._counters(mesh.stats)


def test_mesh_engine_layout():
    eng = ShardedEngine(mesh=_cpu_mesh(4, 2), capacity_per_shard=32, min_width=8,
                        max_width=16)
    assert (eng.plan.n_regions, eng.plan.n_shards, eng.plan.mesh) == (2, 4, eng.mesh)
    assert len(eng.state) == 8
    assert all(tuple(t.shape) == (1, 1, 32, 8) for t in eng.state)
    assert len({t.data_ptr() for t in eng.state}) == 8  # a table an entry
    assert eng.table_numpy().shape == (2, 4, 32, 8)
    assert (eng.table_numpy(0) == -1).all()


# --------------------------------------------------------------- GLOBAL

@pytest.mark.parametrize("collectives", ["ring", "psum"])
@pytest.mark.parametrize("S", [4, 8])
def test_mesh_global_sync_matches_jax_psum(collectives, S):
    """The step over a mesh of S CPU entries (one i64[G] delta and one copy
    of the config an entry) against the JAX psum step on a 1 x S mesh:
    equal mirrors and tables over four steps, deltas zeroed."""
    from gubernator_tpu.parallel import global_sync as jgs
    from gubernator_tpu.parallel.mesh import MeshPlan as JPlan, make_mesh as jmake_mesh

    rng = np.random.RandomState(S)
    C, G = 64, 32
    table, cfg = _global_setup(rng, S, C, G)
    jplan = JPlan(mesh=jmake_mesh(n_shards=S), capacity_per_shard=C)
    jsync = jgs.make_global_sync(jplan, collectives="psum")
    jstate = jax.device_put(table, jplan.state_sharding())
    plan = MeshPlan(n_shards=S, capacity_per_shard=C, mesh=_cpu_mesh(S))
    tsync = make_global_sync(plan, collectives=collectives)
    states = make_sharded_table(plan)
    for s, t in enumerate(states):
        t.copy_(torch.from_numpy(table[:, s:s + 1]))
    for step in range(4):
        now = NOW + step * 3_000
        delta = rng.randint(0, 4, (1, S, G)).astype(np.int64)
        jcfg = jgs.GlobalConfig(**{k: jnp.asarray(v) for k, v in cfg.items()})
        jstate, jmirror, _ = jsync(jstate, delta, jcfg, now)
        cfgs = [convert.global_config_to_torch(jgs.GlobalConfig(**cfg), "cpu")
                for _ in range(S)]
        out, tmirror, zeroed = tsync(states, [torch.from_numpy(delta[0, s].copy())
                                              for s in range(S)], cfgs, now)
        assert out is states  # updated in place
        want, got = convert.fields_to_numpy(jmirror), convert.fields_to_numpy(tmirror)
        for f in want:
            assert want[f].dtype == got[f].dtype, f
            np.testing.assert_array_equal(want[f], got[f], err_msg=f)
        np.testing.assert_array_equal(np.asarray(jstate)[0],
                                      np.stack([t[0, 0].numpy() for t in states]))
        assert len(zeroed) == S and not any(z.any() for z in zeroed)
        cfg["fresh"] = np.zeros(G, np.bool_)


def test_mesh_global_sync_contract():
    plan = MeshPlan(n_shards=2, capacity_per_shard=8, mesh=_cpu_mesh(2))
    with pytest.raises(ValueError, match="its own device"):
        make_global_sync(plan, device="cpu")
    with pytest.raises(ValueError, match="single-region"):
        make_global_sync(MeshPlan(n_shards=1, capacity_per_shard=8, n_regions=2,
                                  mesh=_cpu_mesh(1, 2)), collectives="ring")
    with pytest.raises(ValueError, match="its entry's device"):
        make_sharded_table(plan, device="cpu")


# --------------------------------------------- state carried, kept, counted

@pytest.mark.usefixtures("jax_lib")
def test_carry_sharded_state_into_a_mesh_engine():
    """A JAX engine's state mid-stream (GLOBAL keys registered, hits queued,
    an evicting directory) carried into a fresh mesh engine: 4 further
    windows and syncs are bit-equal."""
    from gubernator_tpu import RateLimitReq as JReq
    from gubernator_tpu.parallel import ShardedEngine as JaxSharded

    kw = dict(capacity_per_shard=16, min_width=8, max_width=16, global_capacity=4,
              global_idle_ms=1500)
    j = JaxSharded(n_shards=4, **kw)
    rng = random.Random(3)

    def batch():
        return [ts._g(f"c{rng.randint(0, 6)}", hits=rng.randint(0, 2))
                if rng.random() < 0.3 else
                ts._f(f"k{rng.randint(0, 200)}", hits=rng.randint(0, 3), algo=rng.randint(0, 1))
                for _ in range(rng.randint(20, 40))]

    for step in range(6):
        j.get_rate_limits([JReq(**f) for f in batch()], now_ms=NOW + step * 400)
        if step % 2:
            j.global_sync(now_ms=NOW + step * 400 + 1)
    t = ShardedEngine(mesh=_cpu_mesh(4), **kw)
    convert.carry_sharded_state(t, np.asarray(j.state), [d.items() for d in j.directories],
                                j._globals.items(), j._gfree, j._gnext, j._gdelta, j._mirror)
    p = ts.Pair.__new__(ts.Pair)
    p.j, p.t, p.jstore, p.tstore = j, t, None, None
    j.stats = dict(t.stats)  # counters start from the carry
    p.check()
    for step in range(6, 10):
        p.get(batch(), NOW + step * 400)
        p.sync(NOW + step * 400 + 1)
    with pytest.raises(ValueError, match="table must be"):
        convert.carry_sharded_state(ShardedEngine(mesh=_cpu_mesh(4), **kw),
                                    np.zeros((4, 16, 8)), [[]] * 4, [], [], 0,
                                    j._gdelta, j._mirror)


@pytest.mark.usefixtures("jax_lib")
def test_mesh_snapshot_round_trip(tmp_path):
    """A mesh engine's snapshot holds the rows the one-tensor engine's holds
    (the files are equal), a mesh engine restores it (close flushes the
    queued GLOBAL hits first), and the restored engines answer alike."""
    from gubernator_tpu_torch.utils.interval import millisecond_now

    now = millisecond_now()
    paths = [str(tmp_path / f"{n}.jsonl") for n in ("one", "mesh")]
    kw = dict(capacity_per_shard=256, min_width=8, max_width=32)
    one = ShardedEngine(n_shards=8, device="cpu", loader=FileLoader(paths[0]), **kw)
    mesh = ShardedEngine(mesh=_cpu_mesh(8), loader=FileLoader(paths[1]), **kw)
    reqs = [RateLimitReq(**ts._f(f"sn{i}", hits=3, duration=3_600_000)) for i in range(20)]
    reqs.append(RateLimitReq(**ts._g("gk", hits=5, duration=3_600_000)))
    for eng in (one, mesh):
        eng.get_rate_limits(reqs, now_ms=now)
        eng.global_sync(now_ms=now + 1)
        eng.get_rate_limits([RateLimitReq(**ts._g("gk", hits=10, duration=3_600_000))],
                            now_ms=now + 2)
        eng.close()
    assert open(paths[0]).read() == open(paths[1]).read()
    back = ShardedEngine(mesh=_cpu_mesh(4), loader=FileLoader(paths[1]), **kw)
    ref = ShardedEngine(n_shards=4, device="cpu", loader=FileLoader(paths[0]), **kw)
    np.testing.assert_array_equal(back.table_numpy(), ref.table_numpy())
    probe = [RateLimitReq(**ts._f(f"sn{i}", hits=0, duration=3_600_000)) for i in range(20)]
    probe.append(RateLimitReq(**ts._f("gk", hits=0, limit=100, duration=3_600_000)))
    got = back.get_rate_limits(probe, now_ms=now + 1000)
    assert [ts._resp(r) for r in got] == \
        [ts._resp(r) for r in ref.get_rate_limits(probe, now_ms=now + 1000)]
    assert got[0].remaining == 7 and got[-1].remaining == 85


def test_mesh_hbm_bytes_and_harvest():
    """hbm_bytes lists one entry a mesh entry with its device and its
    C * 64 bytes, as the one-tensor engine lists one an owner; the harvest
    reads every entry's counters and reports as the one-tensor engine."""
    kw = dict(capacity_per_shard=256, min_width=8, max_width=32)
    one = ShardedEngine(n_shards=4, n_regions=2, device="cpu", **kw)
    mesh = ShardedEngine(mesh=_cpu_mesh(4, 2), **kw)
    assert hbm_bytes(mesh) == hbm_bytes(one)
    assert hbm_bytes(mesh)["per_device"] == [{"device": "cpu", "state_bytes": 256 * 64}] * 8
    assert hbm_bytes(mesh)["arrays"] == {"state": 8 * 256 * 64}
    reqs = [RateLimitReq(name="h", unique_key=f"k{i % 11}", hits=1 + i % 3, limit=1000,
                         duration=60_000) for i in range(60)]
    reports = []
    for eng in (one, mesh):
        eng.get_rate_limits(reqs, now_ms=NOW)
        carto = KeyspaceCartographer(types.SimpleNamespace(backend=eng))
        reports.append(carto.harvest())
        assert carto.errors == 0
    assert reports[1]["hit_mass"] == reports[0]["hit_mass"]
    assert reports[1]["top_keys"] == reports[0]["top_keys"]
    assert reports[1]["hit_mass"]["tracked_hits"] == sum(r.hits for r in reqs)


# ------------------------------------------------------ the daemon, the mesh

class _Stop(Exception):
    pass


def test_daemon_builds_one_owner_a_card(monkeypatch):
    """With four cards visible, GUBER_BACKEND=auto builds the sharded
    backend over a mesh of cuda:0 .. cuda:3, one owner each, with
    cache_size / 4 slots each: the engine is stopped at its constructor,
    before any card is touched."""
    import gubernator_tpu_torch.parallel.sharded as sharded_mod
    from gubernator_tpu_torch.cmd.daemon import build_backend
    from gubernator_tpu_torch.cmd.envconf import config_from_env

    seen = {}

    def stop(**kw):
        seen.update(kw)
        raise _Stop

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(sharded_mod, "ShardedEngine", stop)
    monkeypatch.delenv("GUBER_DEVICE", raising=False)
    monkeypatch.setenv("GUBER_BACKEND", "auto")
    monkeypatch.setenv("GUBER_CACHE_SIZE", "4000000")
    with pytest.raises(_Stop):
        build_backend(config_from_env([]))
    mesh = seen["mesh"]
    assert mesh.entries == tuple(torch.device("cuda", i) for i in range(4))
    assert mesh.shape == (1, 4)
    assert seen["capacity_per_shard"] == 1_000_000
    assert "device" not in seen and "n_shards" not in seen


def test_daemon_one_card_keeps_the_engine(monkeypatch):
    """On the CPU (one device) auto builds the single-table engine; sharded
    gives a one-entry mesh."""
    from gubernator_tpu_torch.cmd.daemon import build_backend
    from gubernator_tpu_torch.cmd.envconf import config_from_env
    from gubernator_tpu_torch.models.engine import Engine

    for k, v in dict(GUBER_DEVICE="cpu", GUBER_CACHE_SIZE="4096", GUBER_MIN_BATCH_WIDTH="32",
                     GUBER_MAX_BATCH_WIDTH="128", GUBER_BACKEND="auto").items():
        monkeypatch.setenv(k, v)
    assert type(build_backend(config_from_env([]))) is Engine
    monkeypatch.setenv("GUBER_BACKEND", "sharded")
    eng = build_backend(config_from_env([]))
    assert isinstance(eng, ShardedEngine) and eng.mesh.entries == (torch.device("cpu"),)
    assert len(eng.state) == 1
    eng.close()


def test_make_mesh_contract(monkeypatch):
    m = make_mesh(n_shards=4, devices=["cuda"] * 4)  # no card touched
    assert m.entries == (torch.device("cuda", 0),) * 4 and m.shape == (1, 4)
    m = make_mesh(n_regions=2, devices=[f"cuda:{i}" for i in range(6)])
    assert m.shape == (2, 3) and m.devices[1][0] == torch.device("cuda", 3)
    assert make_mesh(n_shards=2, devices=["cpu"] * 5).entries == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="need 4 devices"):
        make_mesh(n_shards=4, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(n_regions=2, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="unsupported device"):
        make_mesh(devices=["meta"])
    with pytest.raises(ValueError, match="not on both"):
        make_mesh(devices=["cpu", "cuda:0"]).streams()
    with pytest.raises(ValueError, match="the mesh is"):
        MeshPlan(n_shards=3, capacity_per_shard=8, mesh=make_mesh(devices=["cpu"] * 2))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no card is visible"):
        make_mesh()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert make_mesh().entries == tuple(torch.device("cuda", i) for i in range(3))


def test_make_mesh_has_a_counterpart():
    """make_mesh left NO_COUNTERPART: the port exports it beside the JAX
    package's."""
    from test_torch_copies import NO_COUNTERPART

    import gubernator_tpu_torch.parallel as tparallel

    assert "make_mesh" not in NO_COUNTERPART
    assert "make_mesh" in tparallel.__all__ and tparallel.make_mesh is make_mesh
