"""How `correct` is decided: the served answers of a sample of keys, drawn
from the seed, against the plain reference, answer by answer.

Keys are independent, so a key's answers follow from its restored bucket
and its own requests alone: the reference decides every request of every
sampled key, in served order, at the clock of the pull that carried it.
The sample is (a) the keys of SAMPLE_ITEMS requests drawn at random from
the first SAMPLE_SPAN requests of the pool, so hot keys come in by their
share of the traffic, and (b) the keys of up to DUP_ITEMS requests that
repeat a key within their run of the pull (the requests the columnar prep
hands to the leftover path). Every number compared has its limit here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

SAMPLE_SPAN = 2_000_000
SAMPLE_ITEMS = 16_384
DUP_ITEMS = 4_096
MIN_COMPARED = 1_000
# the limits, each with the readings it was set from in PERF.md
LIMITS = {"mismatched_answers": 0, "error_rows": 0}


def run_ids(n: int, pull_items: int, run_items: int) -> np.ndarray:
    """Each pool position's run: the pull cut in runs of run_items, as the
    owner cuts a pull into batches."""
    pos = np.arange(n, dtype=np.int64)
    per_pull = -(-pull_items // run_items)
    return (pos // pull_items) * per_pull + (pos % pull_items) // run_items


def choose_sample(ids: np.ndarray, n_keys: int, pull_items: int,
                  run_items: int, rng: np.random.Generator) -> np.ndarray:
    """bool[n_keys]: the keys whose answers are compared."""
    span = min(len(ids), SAMPLE_SPAN)
    head = ids[:span].astype(np.int64)
    chosen = [head[rng.integers(0, span, SAMPLE_ITEMS)]]
    run_key = run_ids(span, pull_items, run_items) * n_keys + head
    order = np.argsort(run_key, kind="stable")
    rep = np.zeros(span, bool)
    rep[order[1:]] = run_key[order[1:]] == run_key[order[:-1]]
    dup = np.flatnonzero(rep)
    if len(dup) > DUP_ITEMS:
        dup = rng.choice(dup, DUP_ITEMS, replace=False)
    chosen.append(head[dup])
    mask = np.zeros(n_keys, bool)
    mask[np.concatenate(chosen)] = True
    return mask


@dataclass
class Served:
    """What the program served: every pull (its clock) and the answers to
    the sampled keys' requests, in served order. `sampled` marks the pool
    items whose key is in the sample."""

    sampled: np.ndarray
    pull_items: int
    clocks: List[int] = field(default_factory=list)
    pos: List[np.ndarray] = field(default_factory=list)
    answers: List[np.ndarray] = field(default_factory=list)
    errors: List[np.ndarray] = field(default_factory=list)
    error_rows: int = 0

    def record(self, start: int, got: int, clock: int, b: dict) -> int:
        """Keep the sampled answers of a pull of pool items start..start +
        got; returns its error rows."""
        pull = len(self.clocks)
        self.clocks.append(clock)
        sel = np.flatnonzero(self.sampled[start:start + got])
        self.pos.append(pull * self.pull_items + sel)
        self.answers.append(np.stack([b["status"][sel], b["r_limit"][sel],
                                      b["r_remaining"][sel],
                                      b["r_reset"][sel]]).astype(np.int64))
        err_len = np.diff(b["err_off"][:got + 1])
        self.errors.append(err_len[sel] > 0)
        bad = int(np.count_nonzero(err_len))
        self.error_rows += bad
        return bad


def compare(served: Served, pool, fleet, rows0: np.ndarray, reference,
            lost_updates: bool = False) -> dict:
    """The numbers that decide `correct`, each beside its limit."""
    pos = (np.concatenate(served.pos) if served.pos
           else np.zeros(0, np.int64))
    got = (np.concatenate(served.answers, axis=1) if served.answers
           else np.zeros((4, 0), np.int64))
    err = (np.concatenate(served.errors) if served.errors
           else np.zeros(0, bool))
    n_pool = len(pool.ids)
    ids = pool.ids[pos % n_pool].astype(np.int64)
    keys, local = np.unique(ids, return_inverse=True)
    clocks = np.asarray(served.clocks, np.int64)
    pull = pos // served.pull_items
    want = reference.decide(
        rows0[keys], local, pull, clocks[pull], pool.hits[pos % n_pool],
        fleet.limit[ids], fleet.duration[ids],
        fleet.algorithm[ids].astype(np.int64),
        behavior=pool.behavior[pos % n_pool], lost_updates=lost_updates)
    diff = np.any(np.stack(want) != got, axis=0) | err
    return {
        "mismatched_answers": {"value": int(np.count_nonzero(diff)),
                               "limit": LIMITS["mismatched_answers"],
                               "rule": "<="},
        "error_rows": {"value": served.error_rows,
                       "limit": LIMITS["error_rows"], "rule": "<="},
        "compared_answers": {"value": int(len(pos)), "limit": MIN_COMPARED,
                             "rule": ">="},
    }


def holds(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] if c["rule"] == "<="
               else c["value"] >= c["limit"] for c in checks.values())
