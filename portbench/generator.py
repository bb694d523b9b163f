"""The one traffic generator: a configuration's key fleet and request mix
and a traffic file's key distribution, made from the seed as NumPy columns.

Nothing here builds a per-request object. The fleet is `keys` keys, key k
named `<key_name>_<key_prefix><k, zero-padded to key_digits>`; each key has
one algorithm, limit and duration for its whole life, drawn from the seed.
The traffic is a pool of `pool_items` requests, served in order and from
its start again when a run reaches its end, made before the window as the
wire columns themselves: each request's key bytes, hits, limit, duration,
algorithm and behavior in contiguous arrays, so that handing a pull
to the owner is a copy of contiguous slices and touches no per-key table.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# independent streams of one seed
_FLEET, _ROWS, _KEYS, _HITS, _SAMPLE, _READS, _BEHAVIORS = range(7)


def stream(seed: int, which: int) -> np.random.Generator:
    """The seed's generator for one purpose (any seed up to 2**64 - 1)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), which]))


@dataclass
class Fleet:
    """Every key of a configuration: its bytes and its bucket settings."""

    name_len: int
    key_rows: np.ndarray   # u8[keys, L]: name + unique key, as the wire sends
    algorithm: np.ndarray  # i32[keys]
    limit: np.ndarray      # i64[keys]
    duration: np.ndarray   # i64[keys], ms
    code: np.ndarray       # u8[keys]: row of `settings` holding the three
    settings: np.ndarray   # i64[codes, 3]: (algorithm, limit, duration)

    @property
    def n(self) -> int:
        return len(self.algorithm)

    def joined(self) -> tuple:
        """The engine keys (name + '_' + unique key) as one byte blob and
        i64[keys + 1] offsets: the restore's input."""
        n, width = self.key_rows.shape
        out = np.empty((n, width + 1), np.uint8)
        out[:, :self.name_len] = self.key_rows[:, :self.name_len]
        out[:, self.name_len] = ord("_")
        out[:, self.name_len + 1:] = self.key_rows[:, self.name_len:]
        return out.tobytes(), np.arange(n + 1, dtype=np.int64) * (width + 1)


# the ASCII digits of 0000..9999, four bytes each, and as one u32 each
_DIGITS4 = np.frombuffer("".join(f"{i:04d}" for i in range(10_000)).encode(),
                         np.uint8).reshape(10_000, 4)
_DIGITS4_U32 = _DIGITS4.copy().view(np.uint32).ravel()


def key_bytes(cfg: dict, ids: np.ndarray) -> np.ndarray:
    """u8[len(ids), L]: name + unique key of each key id, as the wire
    carries them (the unique key zero-padded to key_digits digits)."""
    head = (cfg["key_name"] + cfg["key_prefix"]).encode()
    digits = int(cfg["key_digits"])
    if digits % 4 or len(head) % 4 or int(cfg["keys"]) > 10 ** digits:
        raise ValueError("key_digits and the name and prefix's length must "
                         f"be multiples of 4, and hold {cfg['keys']} keys")
    ids = np.asarray(ids, np.int64)
    h, g = len(head) // 4, digits // 4
    rows = np.empty((len(ids), h + g), np.uint32)
    rows[:, :h] = np.frombuffer(head, np.uint32)
    for k in range(g):
        part = (ids // 10 ** (digits - 4 * (k + 1))) % 10_000
        rows[:, h + k] = _DIGITS4_U32[part]
    return rows.view(np.uint8)


def make_fleet(cfg: dict, seed: int) -> Fleet:
    n = int(cfg["keys"])
    name = cfg["key_name"].encode()
    rows = key_bytes(cfg, np.arange(n, dtype=np.int64))
    rng = stream(seed, _FLEET)
    limits = np.asarray(cfg["limits"], np.int64)
    durations = np.asarray(cfg["durations_ms"], np.int64)
    algorithm = (rng.random(n) < float(cfg["leaky_share"])).astype(np.int32)
    li = rng.integers(0, len(limits), n)
    di = rng.integers(0, len(durations), n)
    code = ((algorithm * len(limits) + li) * len(durations) + di)
    a, l_, d = np.meshgrid(np.arange(2), limits, durations, indexing="ij")
    settings = np.stack([a.ravel(), l_.ravel(), d.ravel()], 1)
    return Fleet(len(name), rows, algorithm, limits[li], durations[di],
                 code.astype(np.uint8), settings)


def initial_rows(fleet: Fleet, seed: int, now_ms: int) -> np.ndarray:
    """Every key's bucket as a restarted owner restores it: i64[keys, 7]
    (algo, limit, remaining, duration, stamp, expire_at, status), each
    bucket part spent and part way through its duration at `now_ms`."""
    rng = stream(seed, _ROWS)
    n = fleet.n
    rows = np.empty((n, 7), np.int64)
    rows[:, 0] = fleet.algorithm
    rows[:, 1] = fleet.limit
    rows[:, 2] = (rng.random(n) * (fleet.limit + 1)).astype(np.int64)
    rows[:, 3] = fleet.duration
    rows[:, 4] = now_ms - (rng.random(n) * fleet.duration).astype(np.int64)
    rows[:, 5] = rows[:, 4] + fleet.duration
    # a token bucket that reached zero carries the sticky over-limit status
    rows[:, 6] = ((fleet.algorithm == 0) & (rows[:, 2] == 0)).astype(np.int64)
    return rows


# YCSB's ScrambledZipfianGenerator (core/src/main/java/site/ycsb/generator/
# ScrambledZipfianGenerator.java) draws a zipfian over ITEM_COUNT items, with
# the zeta it states for the default constant, and folds each draw onto the
# records by Utils.fnvhash64 modulo the item count.
YCSB_ITEM_COUNT = 10_000_000_000
YCSB_ZETAN = 26.46902820178302
YCSB_USED_ZIPFIAN_CONSTANT = 0.99
FNV_OFFSET_BASIS_64 = 0xCBF29CE484222325
FNV_PRIME_64 = 1099511628211


def zeta(n: int, theta: float) -> float:
    """sum_{i=1..n} i^-theta: exact to 1e5 terms, the rest by
    Euler-Maclaurin (relative error below 1e-12 at theta 0.99)."""
    m = min(int(n), 100_000)
    head = float(np.sum(np.arange(1, m + 1, dtype=np.float64) ** -theta))
    if n <= m:
        return head
    t = theta

    def f(x, k):  # the k-th derivative of x^-t, k in (0, 1, 3)
        c = {0: 1.0, 1: -t, 3: -t * (t + 1) * (t + 2)}[k]
        return c * float(x) ** (-t - k)

    integral = (float(n) ** (1 - t) - float(m) ** (1 - t)) / (1 - t)
    return head + integral + (f(n, 0) - f(m, 0)) / 2 \
        + (f(n, 1) - f(m, 1)) / 12 - (f(n, 3) - f(m, 3)) / 720


def ycsb_zipfian(items: int, theta: float, zetan: float, count: int,
                 rng: np.random.Generator) -> np.ndarray:
    """`count` draws of YCSB's ZipfianGenerator(0, items - 1, theta, zetan)
    (Gray et al., "Quickly generating billion-record synthetic
    databases"): value 0 the most frequent, P(v) close to
    (v + 1)^-theta / zetan."""
    zeta2 = 1.0 + 0.5 ** theta
    alpha = 1.0 / (1.0 - theta)
    eta = (1.0 - (2.0 / items) ** (1.0 - theta)) / (1.0 - zeta2 / zetan)
    u = rng.random(count)
    uz = u * zetan
    v = (items * np.power(eta * u - eta + 1.0, alpha)).astype(np.int64)
    v = np.where(uz < 1.0 + 0.5 ** theta, 1, v)
    return np.where(uz < 1.0, 0, v)


def fnvhash64(v: np.ndarray) -> np.ndarray:
    """YCSB's Utils.fnvhash64 of each i64: FNV-1 over the eight low-first
    bytes, wrapping at 64 bits, then Java's Math.abs."""
    v = np.asarray(v, np.int64).view(np.uint64)
    h = np.full(v.shape, FNV_OFFSET_BASIS_64, np.uint64)
    prime = np.uint64(FNV_PRIME_64)
    for k in range(8):
        h ^= (v >> np.uint64(8 * k)) & np.uint64(0xFF)
        h *= prime
    return np.abs(h.view(np.int64))


def ycsb_scrambled_zipfian(records: int, theta: float, count: int,
                           rng: np.random.Generator) -> np.ndarray:
    """`count` record numbers in [0, records) as YCSB's CoreWorkload draws
    them under requestdistribution=zipfian with no inserts: a
    ScrambledZipfianGenerator(0, records) (records + 1 items, so
    fnvhash64 modulo records + 1) with the draws past the last record
    drawn again."""
    if theta == YCSB_USED_ZIPFIAN_CONSTANT:
        zetan = YCSB_ZETAN
    else:
        zetan = zeta(YCSB_ITEM_COUNT + 1, theta)
    itemcount = records + 1
    out = np.empty(count, np.int64)
    todo = np.arange(count)
    while len(todo):
        v = ycsb_zipfian(YCSB_ITEM_COUNT + 1, theta, zetan, len(todo), rng)
        keys = np.fmod(fnvhash64(v), itemcount)  # Java's remainder
        out[todo] = keys
        todo = todo[(keys < 0) | (keys >= records)]
    return out


def power_law(span: int, exponent: float, count: int,
              rng: np.random.Generator) -> np.ndarray:
    """`count` ranks in [0, span), P(r) = (r + 1)^-exponent / zeta(span,
    exponent) exactly (any exponent > 0), by the inverse CDF."""
    cdf = np.cumsum(np.arange(1, span + 1, dtype=np.float64) ** -exponent)
    cdf /= cdf[-1]
    return np.minimum(np.searchsorted(cdf, rng.random(count), "right"),
                      span - 1)


# key distributions a mix names under "keys": (mix, span, count, rng) ->
# ranks in [0, span); rank r is the r-th key of the seed's order of keys
DISTRIBUTIONS = {
    "uniform": lambda mix, span, count, rng: rng.integers(
        0, span, count, dtype=np.int64),
    "zipfian": lambda mix, span, count, rng: ycsb_scrambled_zipfian(
        span, float(mix["zipfian_constant"]), count, rng),
    "power": lambda mix, span, count, rng: power_law(
        span, float(mix["exponent"]), count, rng),
}


@dataclass
class Pool:
    """The requests a run may serve, in order, as wire columns."""

    ids: np.ndarray        # i32[items]: key id
    hits: np.ndarray       # i64[items]
    keys: np.ndarray       # u8[items, L]: name + unique key
    limit: np.ndarray      # i32[items]
    duration: np.ndarray   # i32[items], ms
    algorithm: np.ndarray  # i8[items]
    behavior: np.ndarray   # i32[items]: the request's behavior flags


def make_pool(mix: dict, cfg: dict, seed: int, items: int,
              fleet: Fleet) -> Pool:
    """A mix's parameters (every one but "keys" may be left out):
    - keys: a name in DISTRIBUTIONS, with its own parameters
      (zipfian_constant, exponent);
    - key_span: how many of the fleet's keys the mix draws from (all);
    - read_share: the share of requests that only read their bucket, sent
      as hits 0 (0);
    - behaviors: [[flags, share], ...], the share of requests sent with
      those behavior flags (none).
    The other requests take their hits from the configuration's mix. Rank
    r is the r-th key of an order of the whole fleet drawn from the seed,
    so the hot keys, and a span's keys, lie spread over the table."""
    n = int(cfg["keys"])
    span = int(mix.get("key_span", n))
    if mix["keys"] not in DISTRIBUTIONS or not 0 < span <= n:
        raise ValueError(f"unknown key distribution {mix['keys']!r} or "
                         f"key_span {span} outside 1..{n}")
    rng = stream(seed, _KEYS)
    ranks = DISTRIBUTIONS[mix["keys"]](mix, span, items, rng)
    ids = rng.permutation(n)[ranks].astype(np.int32)
    h = stream(seed, _HITS)
    hits = np.where(h.random(items) < float(cfg["hits_one_share"]), 1,
                    h.integers(int(cfg["hits_other"][0]),
                               int(cfg["hits_other"][1]) + 1, items))
    hits[stream(seed, _READS).random(items) < float(mix.get("read_share", 0))] = 0
    behavior = np.zeros(items, np.int32)
    u = stream(seed, _BEHAVIORS).random(items)
    lo = 0.0
    for flags, share in mix.get("behaviors", []):
        behavior[(u >= lo) & (u < lo + float(share))] = int(flags)
        lo += float(share)
    per = fleet.settings[fleet.code[ids]]
    return Pool(ids, hits.astype(np.int64), key_bytes(cfg, ids),
                per[:, 1].astype(np.int32), per[:, 2].astype(np.int32),
                per[:, 0].astype(np.int8), behavior)


def sample_stream(seed: int) -> np.random.Generator:
    return stream(seed, _SAMPLE)
