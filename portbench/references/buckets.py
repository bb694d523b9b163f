"""Plain reference of the rate limiter's token and leaky buckets.

Written from the published semantics of gubernator's algorithms.go (token
bucket: a request for more than remains is refused without deducting, and
a bucket at zero carries OVER_LIMIT until it expires; leaky bucket: integer
leak of elapsed // (duration // limit) tokens, the stamp moving to `now` on
any request against a non-empty bucket), with the port's stated departures
(leaky expiry now + duration; leaky reset_time now + rate on creation; rate
at least 1 ms a token). It covers the behaviors the configurations state:
no flags (no gregorian durations, no RESET_REMAINING, no GLOBAL).

Keys are independent, so each key's requests are decided alone, in the
order they were served, from the key's restored bucket. A bucket that can
change no more until a later clock (a token bucket at zero before its
expiry, a leaky bucket at zero before its next token) answers the requests
that follow in one step. Imports numpy only.
"""

from __future__ import annotations

from bisect import bisect_right

import numpy as np

TOKEN, LEAKY = 0, 1
UNDER, OVER = 0, 1


def decide(rows0: np.ndarray, key: np.ndarray, pull: np.ndarray,
           now: np.ndarray, hits: np.ndarray, limit: np.ndarray,
           duration: np.ndarray, algorithm: np.ndarray,
           behavior: np.ndarray = None, lost_updates: bool = False):
    """Decide requests in served order.

    rows0: i64[K, 7] restored buckets (algo, limit, remaining, duration,
    stamp, expire_at, status; algo -1 = no bucket) of the K keys; key:
    each request's index into rows0; pull: the pull that carried it (one
    clock a pull); now, hits, limit, duration, algorithm, behavior: the
    request. A request with a behavior flag raises ValueError: this
    reference covers none.

    `lost_updates` breaks exact per-key order: every request of a pull is
    decided against its key's bucket as the pull found it, and the last
    one's bucket is kept (what deciding a pull's duplicates in one round
    would give). Returns (status, limit, remaining, reset_time) i64[m]."""
    if behavior is not None and np.any(np.asarray(behavior) != 0):
        raise ValueError("the buckets reference covers no behavior flags")
    m = len(key)
    out = np.zeros((4, m), np.int64)
    if m == 0:
        return tuple(out)
    order = np.argsort(key, kind="stable")
    ks = key[order]
    bounds = np.flatnonzero(np.diff(ks)) + 1
    starts = np.concatenate([[0], bounds]).tolist()
    ends = np.concatenate([bounds, [m]]).tolist()
    cols = [a[order].tolist() for a in (pull, now, hits, limit, duration,
                                        algorithm)]
    # one-step answers need clocks that never go back and one
    # configuration a key; a peek (hits 0) at an empty bucket answers as a
    # hit does, so peeks may be among them
    fast = not lost_updates and bool(np.all(np.diff(now) >= 0))
    same = np.ones(m, bool)
    for a_ in (limit, duration, algorithm):
        s_ = a_[order]
        same[1:] &= s_[1:] == s_[:-1]
    same[bounds] = True
    mixed = set(np.unique(ks[~same]).tolist()) if fast else set()
    st = [0] * m
    rm = [0] * m
    rs = [0] * m
    rows = rows0.tolist()
    kl = ks.tolist()
    for a, b in zip(starts, ends):
        _one_key(rows[kl[a]], a, b, cols, st, rm, rs, lost_updates,
                 fast and kl[a] not in mixed)
    out[0, order] = st
    out[1, order] = np.asarray(cols[3], np.int64)
    out[2, order] = rm
    out[3, order] = rs
    return tuple(out)


def _one_key(row, a, b, cols, st, rm, rs, lost_updates, fast):
    pull, now, hits, limit, duration, algorithm = cols
    algo, r_limit, rem, r_dur, stamp, exp, status = row
    base = None
    cur_pull = None
    i = a
    while i < b:
        t = now[i]
        h = hits[i]
        lim = limit[i]
        dur = duration[i]
        alg = algorithm[i]
        if lost_updates:
            if pull[i] != cur_pull:
                cur_pull = pull[i]
                base = (algo, r_limit, rem, r_dur, stamp, exp, status)
            algo, r_limit, rem, r_dur, stamp, exp, status = base
        alive = algo == alg and t <= exp
        if alg == TOKEN:
            if alive and r_dur == dur:
                if r_limit != lim:
                    rem = min(rem, lim)
                s = status
                if h != 0:
                    if rem == 0:
                        s = status = OVER
                    elif h > rem:
                        s = OVER
                    else:
                        rem -= h
                r_limit = lim
                st[i], rm[i], rs[i] = s, rem, exp
                i += 1
                if fast and rem == 0 and status == OVER:
                    # nothing changes this bucket before it expires
                    j = bisect_right(now, exp, i, b)
                    if j > i:
                        st[i:j] = [OVER] * (j - i)
                        rm[i:j] = [0] * (j - i)
                        rs[i:j] = [exp] * (j - i)
                        i = j
                continue
            if alive:  # the duration changed: expiry from the creation
                new_exp = stamp + dur
                if new_exp >= t:
                    r_dur = dur
                    exp = new_exp
                    continue  # decide again against the changed bucket
            exp = t + dur
            over = h > lim
            rem = lim if over else lim - h
            algo, r_limit, r_dur, stamp, status = TOKEN, lim, dur, t, UNDER
            st[i], rm[i], rs[i] = (OVER if over else UNDER), rem, exp
            i += 1
            continue
        # leaky bucket
        rate = max(dur // max(lim, 1), 1)
        if alive:
            elapsed = max(t - stamp, 0)
            rem = min(lim, rem + elapsed // rate)
            rem_zero = rem == 0
            over = h > rem
            if not rem_zero and h != 0:
                stamp = t
            if h != 0 and not rem_zero and not over:
                exp = t + dur
                rem -= h
            r_limit, r_dur = lim, dur
            st[i] = OVER if (rem_zero or (h != 0 and over)) else UNDER
            rm[i], rs[i] = rem, t + rate
            i += 1
            if fast and rem_zero:
                # empty until stamp + rate (or gone after exp)
                j = bisect_right(now, min(stamp + rate - 1, exp), i, b)
                if j > i:
                    st[i:j] = [OVER] * (j - i)
                    rm[i:j] = [0] * (j - i)
                    rs[i:j] = [x + rate for x in now[i:j]]
                    i = j
            continue
        over = h > lim
        rem = 0 if over else lim - h
        algo, r_limit, r_dur, stamp, exp, status = LEAKY, lim, dur, t, t + dur, UNDER
        st[i] = OVER if over else UNDER
        rm[i], rs[i] = rem, t + rate
        i += 1
    row[:] = [algo, r_limit, rem, r_dur, stamp, exp, status]

