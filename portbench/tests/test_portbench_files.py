"""BENCHMARK.json and every file it names, and the traffic generator."""

import json
import re

import numpy as np
import pytest

from portbench import cell, generator

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return cell.load_benchmark()


def test_benchmark_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]] + \
        [w["name"] for w in bench["workloads"]] + \
        [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert set(e2e) == {"decisions_per_s", "setup_s"}
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())


def test_every_traffic_file_is_a_mix_the_generator_reads():
    cfg = dict(cell.find(cell.load_benchmark(), "owner_10m.zipf")[2],
               keys=3000)
    fleet = generator.make_fleet(cfg, 1)
    for path in sorted((cell.HERE / "traffic").glob("*.json")):
        with open(path) as f:
            mix = json.load(f)
        assert mix["pool_items"] > 0 and mix["why"]
        pool = generator.make_pool(mix, cfg, 1, 5000, fleet)
        assert len(pool.ids) == 5000 and pool.ids.max() < 3000


def test_every_cell_finds_its_files(bench):
    for w in bench["workloads"]:
        c, entry, cfg, mix = cell.find(bench, w["name"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert entry["file"].startswith("portbench/")
        assert cfg["name"] == entry["name"]
        assert cfg["reduced"] == entry["reduced"]
        assert cell.system(cfg["system"]).System
        assert cell.reference(cfg["reference"]).decide
        assert mix["keys"] in generator.DISTRIBUTIONS


def test_every_per_layer_metric_has_a_reader(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert callable(cell.reader(m["name"]))
        assert m["moves"] in e2e and m["layer"]
        if m["unit"] == "%":
            assert m["name"].endswith("_roofline")


def test_configs_state_their_source_and_guarantees(bench):
    for entry in bench["configs"]:
        with open(cell.ROOT / entry["file"]) as f:
            cfg = json.load(f)
        assert cfg["source"] == entry["source"] and len(entry["source"]) <= 200
        assert cfg["guarantees"] and cfg["assumed"]
        assert cfg["capacity"] > cfg["keys"]


def test_fleet_and_pool_repeat_for_a_seed():
    cfg = dict(cell.find(cell.load_benchmark(), "owner_10m.zipf")[2],
               keys=5000, capacity=5001)
    mix = {"keys": "uniform", "pool_items": 40000}
    seed = 2 ** 40 + 7  # seeds past 32 bits
    a = generator.make_fleet(cfg, seed)
    b = generator.make_fleet(cfg, seed)
    assert np.array_equal(a.key_rows, b.key_rows)
    assert np.array_equal(a.limit, b.limit)
    assert bytes(a.key_rows[42]) == b"ycsbuser000000000042"
    blob, off = a.joined()
    assert blob[off[42]:off[43]] == b"ycsb_user000000000042"
    p = generator.make_pool(mix, cfg, seed, 40000, a)
    q = generator.make_pool(mix, cfg, seed, 40000, b)
    assert np.array_equal(p.ids, q.ids) and np.array_equal(p.hits, q.hits)
    assert p.ids.min() >= 0 and p.ids.max() < 5000
    # the wire columns are the fleet's, item by item
    assert np.array_equal(p.keys, a.key_rows[p.ids])
    assert np.array_equal(p.limit, a.limit[p.ids])
    assert np.array_equal(p.duration, a.duration[p.ids])
    assert np.array_equal(p.algorithm, a.algorithm[p.ids])
    share_one = np.mean(p.hits == 1)
    assert 0.88 < share_one < 0.92 and p.hits.max() == 5
    rows = generator.initial_rows(a, seed, 10 ** 12)
    assert np.all(rows[:, 2] <= rows[:, 1]) and np.all(rows[:, 5] > 10 ** 12)


def _java_fnvhash64(val):
    """YCSB's Utils.fnvhash64, step by step with Python integers."""
    h = 0xCBF29CE484222325
    for _ in range(8):
        h ^= val & 0xFF
        val >>= 8
        h = (h * 1099511628211) % 2 ** 64
    h = h - 2 ** 64 if h >= 2 ** 63 else h
    return abs(h) if h != -2 ** 63 else h


def test_fnvhash64_is_ycsbs():
    vals = [0, 1, 2, 255, 256, 12345, 10 ** 10, 2 ** 40 + 3]
    got = generator.fnvhash64(np.array(vals, np.int64)).tolist()
    assert got == [_java_fnvhash64(v) for v in vals]
    assert got[0] == 6284781860667377211


def test_zeta_matches_ycsbs_constant():
    z = generator.zeta(generator.YCSB_ITEM_COUNT, 0.99)
    assert z == pytest.approx(generator.YCSB_ZETAN, rel=1e-11)
    n = 150_000  # past the exact head: the Euler-Maclaurin tail
    exact = np.sum(np.arange(1, n + 1, dtype=np.float64) ** -1.2)
    assert generator.zeta(n, 1.2) == pytest.approx(exact, rel=1e-12)


def test_zipfian_values_follow_constant_099():
    n, theta = 100_000, 0.99
    zetan = generator.zeta(n, theta)
    v = generator.ycsb_zipfian(n, theta, zetan, 4_000_000,
                               np.random.default_rng(5))
    freq = np.bincount(v, minlength=n) / len(v)
    assert freq[0] == pytest.approx(1 / zetan, rel=0.02)
    assert freq[1] == pytest.approx(2 ** -theta / zetan, rel=0.03)
    r = np.arange(2, 200)
    slope = np.polyfit(np.log(r + 1), np.log(freq[r]), 1)[0]
    assert slope == pytest.approx(-theta, abs=0.05)


def test_scrambled_zipfian_is_ycsbs_law():
    """The ScrambledZipfianGenerator's law: value v of the zipfian over
    1e10 + 1 items lands on record fnvhash64(v) mod (records + 1), and
    the record past the last is drawn again. Values 0 and 1 come with
    P = (v + 1)^-0.99 / ZETAN; from 2 on Gray's closed form gives
    P(v < x) = ((x / items)^(1 - theta) - 1 + eta) / eta."""
    records, theta = 10_000_000, 0.99
    keys = generator.ycsb_scrambled_zipfian(records, theta, 4_000_000,
                                            np.random.default_rng(7))
    assert keys.min() >= 0 and keys.max() < records
    freq = np.bincount(keys, minlength=records) / len(keys)
    z = generator.YCSB_ZETAN
    items = generator.YCSB_ITEM_COUNT + 1
    eta = (1 - (2 / items) ** (1 - theta)) / (1 - (1 + 0.5 ** theta) / z)
    p2 = ((3 / items) ** (1 - theta) - 1 + eta) / eta - (1 + 0.5 ** theta) / z
    for v, p in ((0, 1 / z), (1, 2 ** -theta / z), (2, p2)):
        rec = _java_fnvhash64(v) % (records + 1)
        assert freq[rec] == pytest.approx(p, rel=0.05)
    # the hottest record is value 0's, and far colder than the plain
    # zipfian over the records would make it (1 / zeta(1e7) = 0.055)
    assert freq.argmax() == _java_fnvhash64(0) % (records + 1)
    assert freq.max() < 0.04
    # in-run duplicates, the share the columnar prep hands back
    runs = keys[:3_000_000].reshape(-1, 1000)
    dup = 1 - np.mean([len(np.unique(r)) for r in runs]) / 1000
    assert 0.14 < dup < 0.17


def test_power_law_over_a_key_span():
    """A herd as data alone: a power law with its own exponent over a
    span of the fleet's keys."""
    cfg = dict(cell.find(cell.load_benchmark(), "owner_10m.zipf")[2],
               keys=5000)
    fleet = generator.make_fleet(cfg, 3)
    mix = {"keys": "power", "exponent": 1.1, "key_span": 1000}
    pool = generator.make_pool(mix, cfg, 3, 400_000, fleet)
    counts = np.bincount(pool.ids, minlength=5000)
    assert np.count_nonzero(counts) <= 1000
    z = np.sum(np.arange(1, 1001, dtype=np.float64) ** -1.1)
    assert counts.max() / len(pool.ids) == pytest.approx(1 / z, rel=0.03)
    with pytest.raises(ValueError):
        generator.make_pool({"keys": "power", "exponent": 1.1,
                             "key_span": 6000}, cfg, 3, 10, fleet)
    with pytest.raises(ValueError):
        generator.make_pool({"keys": "hotspot"}, cfg, 3, 10, fleet)


def test_reads_and_behaviors_are_columns_of_the_pool():
    cfg = dict(cell.find(cell.load_benchmark(), "owner_10m.zipf")[2],
               keys=5000)
    fleet = generator.make_fleet(cfg, 4)
    plain = generator.make_pool({"keys": "uniform"}, cfg, 4, 200_000, fleet)
    assert not np.any(plain.behavior) and np.all(plain.hits > 0)
    mix = {"keys": "uniform", "read_share": 0.5, "behaviors": [[4, 0.1]]}
    pool = generator.make_pool(mix, cfg, 4, 200_000, fleet)
    assert np.mean(pool.hits == 0) == pytest.approx(0.5, abs=0.01)
    assert np.mean(pool.behavior == 4) == pytest.approx(0.1, abs=0.01)
    assert set(np.unique(pool.behavior).tolist()) == {0, 4}
    # the reads and flags leave the keys and the other hits as they were
    assert np.array_equal(pool.ids, plain.ids)
    rmw = pool.hits > 0
    assert np.array_equal(pool.hits[rmw], plain.hits[rmw])


def test_zipfian_mix_permutes_hot_keys_by_seed():
    cfg = dict(cell.find(cell.load_benchmark(), "owner_10m.zipf")[2],
               keys=50_000)
    mix = {"keys": "zipfian", "zipfian_constant": 0.99, "read_share": 0.5}
    hot = [np.bincount(generator.make_pool(
        mix, cfg, s, 100_000, generator.make_fleet(cfg, s)).ids).argmax()
        for s in (1, 2)]
    assert hot[0] != hot[1]
