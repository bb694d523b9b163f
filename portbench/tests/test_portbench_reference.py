"""The plain reference against hand-worked buckets and against the port's
own sequential oracle (the test may import the port; the reference may
not)."""

import numpy as np
import pytest

from portbench.references import buckets


def decide(rows, reqs, lost=False):
    """reqs: (key, pull, now, hits, limit, duration, algorithm) tuples."""
    a = np.array(reqs, np.int64).T
    return np.stack(buckets.decide(np.array(rows, np.int64), a[0], a[1],
                                   a[2], a[3], a[4], a[5], a[6],
                                   lost_updates=lost)).T.tolist()


VACANT = [-1, 0, 0, 0, 0, 0, 0]


def test_token_bucket_by_hand():
    reqs = [(0, 0, 0, 3, 10, 1000, 0),    # new: 10 - 3
            (0, 1, 10, 8, 10, 1000, 0),   # 8 > 7: refused, nothing taken
            (0, 2, 20, 7, 10, 1000, 0),   # to zero
            (0, 3, 30, 1, 10, 1000, 0),   # at zero: over, sticky
            (0, 4, 1000, 1, 10, 1000, 0),  # t <= expire_at: still over
            (0, 5, 1001, 1, 10, 1000, 0)]  # expired: a new bucket
    assert decide([VACANT], reqs) == [
        [0, 10, 7, 1000], [1, 10, 7, 1000], [0, 10, 0, 1000],
        [1, 10, 0, 1000], [1, 10, 0, 1000], [0, 10, 9, 2001]]


def test_leaky_bucket_by_hand():
    # limit 10 over 1000 ms: a token every 100 ms
    reqs = [(0, 0, 0, 4, 10, 1000, 1),     # new: 6 left, reset now + rate
            (0, 1, 50, 6, 10, 1000, 1),    # no leak yet: 6 - 6
            (0, 2, 120, 1, 10, 1000, 1),   # 70 ms since: still empty
            (0, 3, 250, 2, 10, 1000, 1),   # 200 ms since 50: two leaked
            (0, 4, 260, 5, 10, 1000, 1)]   # empty again: refused
    assert decide([VACANT], reqs) == [
        [0, 10, 6, 100], [0, 10, 0, 150], [1, 10, 0, 220],
        [0, 10, 0, 350], [1, 10, 0, 360]]


def test_restored_bucket_is_used():
    row = [0, 100, 5, 60000, -1000, 59000, 0]
    assert decide([row], [(0, 0, 0, 1, 100, 60000, 0)]) == [[0, 100, 4, 59000]]
    expired = [0, 100, 5, 60000, -70000, -10000, 0]
    assert decide([expired], [(0, 0, 0, 1, 100, 60000, 0)]) == \
        [[0, 100, 99, 60000]]


def test_peeks_take_nothing():
    reqs = [(0, 0, 0, 0, 10, 1000, 0),     # a peek creates a full bucket
            (0, 1, 10, 10, 10, 1000, 0),   # to zero
            (0, 2, 20, 0, 10, 1000, 0),    # a peek at zero: status kept
            (1, 0, 0, 10, 10, 1000, 1),    # leaky: empty
            (1, 1, 50, 0, 10, 1000, 1),    # a peek before the next token
            (1, 2, 100, 0, 10, 1000, 1)]   # a peek sees the leaked token
    assert decide([VACANT, VACANT], reqs) == [
        [0, 10, 10, 1000], [0, 10, 0, 1000], [0, 10, 0, 1000],
        [0, 10, 0, 100], [1, 10, 0, 150], [0, 10, 1, 200]]


def test_behavior_flags_are_refused():
    with pytest.raises(ValueError):
        buckets.decide(np.array([VACANT], np.int64), np.array([0]),
                       np.array([0]), np.array([0]), np.array([1]),
                       np.array([10]), np.array([1000]), np.array([0]),
                       behavior=np.array([4]))


def test_lost_updates_control_differs_on_a_duplicate():
    reqs = [(0, 0, 0, 1, 10, 1000, 0), (0, 0, 0, 1, 10, 1000, 0)]
    assert decide([VACANT], reqs) == [[0, 10, 9, 1000], [0, 10, 8, 1000]]
    assert decide([VACANT], reqs, lost=True) == \
        [[0, 10, 9, 1000], [0, 10, 9, 1000]]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_reference_equals_the_ports_oracle(seed):
    from gubernator_tpu_torch.ops.oracle import Row, oracle_decide

    rng = np.random.default_rng(seed)
    n_keys, m = 40, 6000
    algo = rng.integers(0, 2, n_keys)
    limit = rng.choice([1, 3, 10, 100], n_keys)
    dur = rng.choice([5, 50, 1000, 60000], n_keys)
    rows = []
    for k in range(n_keys):
        if rng.random() < 0.3:
            rows.append(VACANT)
            continue
        rem = int(rng.integers(0, limit[k] + 1))
        stamp = -int(rng.integers(0, dur[k]))
        status = int(algo[k] == 0 and rem == 0)
        rows.append([int(algo[k]), int(limit[k]), rem, int(dur[k]), stamp,
                     stamp + int(dur[k]), status])
    # a few hot keys, pulls of ~20 requests at one clock each
    key = np.where(rng.random(m) < 0.5, rng.integers(0, 4, m),
                   rng.integers(0, n_keys, m))
    pull = np.arange(m) // 20
    now = np.cumsum(rng.integers(0, 4, m // 20 + 1))[pull]
    hits = np.where(rng.random(m) < 0.8, 1, rng.integers(2, 6, m))
    hits[rng.random(m) < 0.4] = 0  # reads: peeks at the bucket
    got = np.stack(buckets.decide(np.array(rows, np.int64), key, pull, now,
                                  hits, limit[key], dur[key], algo[key])).T
    table = {k: Row(*r) for k, r in enumerate(rows) if r[0] >= 0}
    want = []
    for i in range(m):
        k = int(key[i])
        r = oracle_decide(table, k, hits=int(hits[i]), limit=int(limit[k]),
                          duration=int(dur[k]), algorithm=int(algo[k]),
                          behavior=0, now=int(now[i]))
        want.append([int(r.status), r.limit, r.remaining, r.reset_time])
    assert got.tolist() == want
