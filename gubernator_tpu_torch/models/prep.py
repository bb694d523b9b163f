"""Host-side request preprocessing (a copy of the JAX package's
models/prep.py): validation, gregorian precomputation and duplicate-key
*round* splitting.

Rounds preserve the reference's same-key sequential semantics: the reference
serializes every request under one cache mutex (reference: gubernator.go:328),
so two hits to one key in a window observe each other. A scatter with
duplicate indices cannot express that, so occurrence k of every key goes to
round k and rounds run back-to-back; almost all real windows are round-1-only.
"""

from __future__ import annotations

import datetime as _dt
from typing import Dict, List, Optional, Sequence, Tuple

from gubernator_tpu_torch.types import (
    ERR_EMPTY_NAME,
    ERR_EMPTY_UNIQUE_KEY,
    Behavior,
    RateLimitReq,
    RateLimitResp,
)
from gubernator_tpu_torch.utils.gregorian import (
    GregorianError,
    gregorian_duration,
    gregorian_expiration,
)

# (original batch index, request, greg_expire_ms, greg_interval_ms)
WorkItem = Tuple[int, RateLimitReq, int, int]

_GREG = int(Behavior.DURATION_IS_GREGORIAN)


def bucket_width(n: int, lo: int, hi: int) -> int:
    """Round a batch width up to a power-of-two bucket in [lo, hi], so the
    staging buffers come in a handful of shapes."""
    w = lo
    while w < n:
        w *= 2
    return min(w, hi)


def bucket_pow2(n: int) -> int:
    """Next power of two ≥ n — bounds the number of scan depths."""
    k = 1
    while k < n:
        k *= 2
    return k


def bucket_splits(n: int, lo: int, hi: int) -> List[int]:
    """Sub-window item counts for an n-item columnar chunk.

    Chunks wider than one engine window (n > hi) must split. Every piece
    but the last is the largest pow2 bucket width ≤ hi, so each sub-window,
    and every scan stack built over them, keeps to the shapes the engine
    warms (a capacity-capped engine, hi not a power of two, never mints its
    capped terminal width per piece); the remainder rides as one final
    piece (bucket_width pads it)."""
    cap = lo
    while cap * 2 <= hi:
        cap *= 2
    out = []
    while n > cap:
        out.append(cap)
        n -= cap
    if n:
        out.append(n)
    return out


def preprocess(
    requests: Sequence[RateLimitReq], now_ms: int
) -> Tuple[List[Optional[RateLimitResp]], List[List[WorkItem]], int]:
    """Validate + precompute calendar fields + split into collision-free rounds.

    Returns (responses, rounds, n_errors): `responses` is the output list with
    error entries already filled (None elsewhere); each round is a list of
    WorkItems whose keys are distinct within the round.
    """
    responses: List[Optional[RateLimitResp]] = [None] * len(requests)
    rounds: List[List[WorkItem]] = []
    occurrence: Dict[str, int] = {}
    occ_get = occurrence.get
    n_errors = 0
    local_now = None  # lazily computed once per batch
    for i, r in enumerate(requests):
        if not r.unique_key:
            responses[i] = RateLimitResp(error=ERR_EMPTY_UNIQUE_KEY)
            n_errors += 1
            continue
        if not r.name:
            responses[i] = RateLimitResp(error=ERR_EMPTY_NAME)
            n_errors += 1
            continue
        ge = gi = 0
        if int(r.behavior) & _GREG:
            try:
                if local_now is None:
                    local_now = _dt.datetime.fromtimestamp(now_ms / 1000.0)
                ge = gregorian_expiration(local_now, r.duration)
                gi = gregorian_duration(local_now, r.duration)
            except GregorianError as e:
                responses[i] = RateLimitResp(error=str(e))
                n_errors += 1
                continue
        k = r.name + "_" + r.unique_key  # hash_key(), inlined
        j = occ_get(k, 0)
        occurrence[k] = j + 1
        if len(rounds) <= j:
            rounds.append([])
        rounds[j].append((i, r, ge, gi))
    return responses, rounds, n_errors
