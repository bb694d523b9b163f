"""The batched rate-limit decision: plain PyTorch version and CUDA kernel.

The counterpart of the JAX package's ops/decide.py. State is one row-major
i64[C, 8] tensor, 64 bytes per key slot (~640 MB at 10M keys). A window of
requests is one gather of rows, a branchless token/leaky lattice, and one
scatter of rows back.

Every packed entry point (decide_packed, decide_packed_compact,
decide_packed_interned, decide_packed_lean and their decide_scan_* forms)
takes tensors on either device:

- on the CPU it runs the plain PyTorch version, decide() below;
- on CUDA it launches the hand-written kernels of csrc/decide.cu through
  the shared launch path (ops/_launch.py), or raises. It never falls back
  to the plain version there.

Unlike the JAX functions, which return a new table, these update `state` IN
PLACE and return only the response rows.

The numpy host packers (pack_window, compact_window, intern_window,
InternCache, lean_window, widen_compact_out, ...) are copies of the JAX
package's, so both packages stage a window identically.
"""

from __future__ import annotations

import ctypes
import os
from types import SimpleNamespace
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gubernator_tpu_torch.ops import _launch
from gubernator_tpu_torch.types import Algorithm, Behavior, Status
from gubernator_tpu_torch.utils.platform import resolve_device

I32 = torch.int32
I64 = torch.int64

# State-column algorithm codes: table slots hold -1 when vacant.
_VACANT = -1

# Row field indices of the i64[..., C, TABLE_ROW_FIELDS] bucket table
# (the same layout as the JAX package's, decide.py:211-218). `stamp` is the
# token bucket's CreatedAt and the leaky bucket's UpdatedAt; `status`
# persists the token bucket's sticky OVER_LIMIT; field 7 counts every hit
# a key was asked for (admitted or not) and pads the row to 64 bytes.
ROW_ALGO = 0  # -1 vacant, 0 token, 1 leaky
ROW_LIMIT = 1
ROW_REMAINING = 2
ROW_DURATION = 3  # ms
ROW_STAMP = 4  # unix ms
ROW_EXPIRE = 5  # unix ms (doubles as token ResetTime)
ROW_STATUS = 6
TABLE_ROW_FIELDS = 8

# Launches of the CUDA kernels, by staging format, one window and scan:
# decide_cuda adds one where it launches, and nowhere else.
# reset_launch_counts() sets them to 0.
launch_counts: Dict[str, int] = {
    f"decide_{form}{fmt}": 0 for form in ("", "scan_")
    for fmt in ("wide", "compact", "lean", "interned")}
# decide_sharded's launches (one for all owners), by format and form
launch_counts.update({f"decide_sharded_{form}{fmt}": 0 for form in ("", "scan_")
                      for fmt in ("wide", "lean")})
# The same launches by (launch_counts key, K, B): K = 1 for one window (B
# is each owner's lanes for a sharded launch).
launch_shapes: Dict[Tuple[str, int, int], int] = {}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0
    launch_shapes.clear()


class ReqBatch(NamedTuple):
    """One batch window of requests, as tensors on one device.

    `slot` is the table row the host key directory assigned; -1 marks padding
    lanes. `fresh` is True when the directory newly assigned (or recycled)
    the slot. `greg_expire`/`greg_interval` are host-precomputed calendar
    values, only read when the DURATION_IS_GREGORIAN bit is set."""

    slot: torch.Tensor  # i32[B]
    hits: torch.Tensor  # i64[B]
    limit: torch.Tensor  # i64[B]
    duration: torch.Tensor  # i64[B]
    algorithm: torch.Tensor  # i32[B]
    behavior: torch.Tensor  # i32[B]
    greg_expire: torch.Tensor  # i64[B]
    greg_interval: torch.Tensor  # i64[B]
    fresh: torch.Tensor  # bool[B]


class RespBatch(NamedTuple):
    status: torch.Tensor  # i32[B]
    limit: torch.Tensor  # i64[B]
    remaining: torch.Tensor  # i64[B]
    reset_time: torch.Tensor  # i64[B]


def make_table(capacity: int, device=None) -> torch.Tensor:
    """Fresh vacant table: i64[capacity, 8] rows with algo = -1, on the card
    unless `device` says otherwise."""
    state = torch.zeros((capacity, TABLE_ROW_FIELDS), dtype=I64,
                        device=resolve_device(device))
    state[:, ROW_ALGO] = _VACANT
    return state


def _sel(default: torch.Tensor, *pairs) -> torch.Tensor:
    """Chained masked select; later pairs win over earlier ones."""
    out = default
    for mask, val in pairs:
        out = torch.where(mask, val, out)
    return out


def decide(state: torch.Tensor, reqs: ReqBatch, now_ms) -> RespBatch:
    """Apply one collision-free batch of requests to the table: the plain
    PyTorch version of the JAX package's decide() (decide.py:277), and of
    the kernel in csrc/decide.cu.

    Updates `state` IN PLACE and returns the per-request responses. All
    requests must target distinct slots (the engine guarantees that through
    rounds); padding lanes carry slot == -1. A slot >= capacity reads the
    last row, as XLA's gather clamps, and its store is dropped."""
    now = int(now_ms)
    C = state.shape[-2]
    slot = reqs.slot.to(I64)
    active = slot >= 0
    gslot = slot.clamp(0, C - 1)

    rows = state.index_select(0, gslot)  # i64[B, 8]
    st_algo = rows[:, ROW_ALGO]
    st_limit = rows[:, ROW_LIMIT]
    st_rem = rows[:, ROW_REMAINING]
    st_dur = rows[:, ROW_DURATION]
    st_stamp = rows[:, ROW_STAMP]
    st_exp = rows[:, ROW_EXPIRE]
    st_status = rows[:, ROW_STATUS]

    r_hits = reqs.hits
    r_limit = reqs.limit
    r_dur = reqs.duration
    r_algo = reqs.algorithm.to(I64)
    is_tok = r_algo == int(Algorithm.TOKEN_BUCKET)
    greg = (reqs.behavior & int(Behavior.DURATION_IS_GREGORIAN)) != 0
    reset_rem = (reqs.behavior & int(Behavior.RESET_REMAINING)) != 0
    peek = r_hits == 0

    OVER = int(Status.OVER_LIMIT)
    UNDER = int(Status.UNDER_LIMIT)

    # A slot is a hit only if occupied, unexpired and running the same
    # algorithm (cache.go:140-165, algorithms.go:54-62,195-203).
    occupied = active & ~reqs.fresh & (st_algo >= 0)
    alive = occupied & (st_exp >= now) & (st_algo == r_algo)

    # ---------------- token bucket, existing row (algorithms.go:35-134) ----
    tok_reset = alive & is_tok & reset_rem
    lim_changed = st_limit != r_limit
    t_rem0 = torch.where(lim_changed, torch.minimum(st_rem, r_limit), st_rem)
    dur_changed = st_dur != r_dur
    t_new_exp = torch.where(greg, reqs.greg_expire, st_stamp + r_dur)
    tok_recreate = alive & is_tok & ~reset_rem & dur_changed & (t_new_exp < now)
    tok_exists = alive & is_tok & ~reset_rem & ~tok_recreate
    te_exp = torch.where(dur_changed, t_new_exp, st_exp)
    t_rem_zero = t_rem0 == 0
    t_over_req = r_hits > t_rem0
    t_deduct = ~peek & ~t_rem_zero & ~t_over_req
    te_rem = torch.where(t_deduct, t_rem0 - r_hits, t_rem0)
    te_status_resp = torch.where(~peek & (t_rem_zero | t_over_req), OVER, st_status)
    te_status_store = torch.where(~peek & t_rem_zero, OVER, st_status)

    # ---------------- token bucket, vacant/recreate (algorithms.go:136-178) -
    tok_miss = active & is_tok & (~alive | tok_recreate)
    m_exp = torch.where(greg, reqs.greg_expire, now + r_dur)
    m_over = r_hits > r_limit
    m_rem = torch.where(m_over, r_limit, r_limit - r_hits)

    # ---------------- leaky bucket, existing row (algorithms.go:194-289) ----
    leak_exists = alive & ~is_tok
    l_rem0 = torch.where(reset_rem, r_limit, st_rem)
    l_dur = torch.where(greg, reqs.greg_expire - now, r_dur)
    l_rate = (torch.where(greg, reqs.greg_interval, r_dur)
              // r_limit.clamp(min=1)).clamp(min=1)
    elapsed = (now - st_stamp).clamp(min=0)
    l_rem1 = torch.minimum(r_limit, l_rem0 + elapsed // l_rate)
    l_rem_zero = l_rem1 == 0
    l_over_req = r_hits > l_rem1
    l_deduct = ~peek & ~l_rem_zero & ~l_over_req
    le_rem = torch.where(l_deduct, l_rem1 - r_hits, l_rem1)
    le_stamp = torch.where(~l_rem_zero & ~peek, now, st_stamp)
    le_status = torch.where(l_rem_zero | (~peek & l_over_req), OVER, UNDER)
    le_exp = torch.where(l_deduct, now + l_dur, st_exp)

    # ---------------- leaky bucket, vacant (algorithms.go:291-336) ----------
    leak_miss = active & ~is_tok & ~alive
    lm_dur = torch.where(greg, reqs.greg_expire - now, r_dur)
    lm_rate = (lm_dur // r_limit.clamp(min=1)).clamp(min=1)
    lm_over = r_hits > r_limit
    lm_rem = torch.where(lm_over, 0, r_limit - r_hits)

    # ---------------- select new state ------------------------------------
    n_algo = _sel(
        st_algo,
        (tok_exists | tok_miss, int(Algorithm.TOKEN_BUCKET)),
        (leak_exists | leak_miss, int(Algorithm.LEAKY_BUCKET)),
        (tok_reset, _VACANT),
    )
    touched = tok_exists | tok_miss | leak_exists | leak_miss
    n_limit = torch.where(touched, r_limit, st_limit)
    n_rem = _sel(st_rem, (tok_exists, te_rem), (tok_miss, m_rem),
                 (leak_exists, le_rem), (leak_miss, lm_rem))
    n_dur = _sel(st_dur, (tok_exists | tok_miss, r_dur),
                 (leak_exists, l_dur), (leak_miss, lm_dur))
    n_stamp = _sel(st_stamp, (tok_miss | leak_miss, now),
                   (leak_exists, le_stamp))
    n_exp = _sel(st_exp, (tok_exists, te_exp), (tok_miss, m_exp),
                 (leak_exists, le_exp), (leak_miss, now + lm_dur))
    n_status = _sel(st_status, (tok_exists, te_status_store),
                    (tok_miss | leak_miss, UNDER))
    new_rows = torch.stack(
        [n_algo, n_limit, n_rem, n_dur, n_stamp, n_exp, n_status,
         rows[:, 7] + torch.where(active, r_hits, 0)],
        dim=1,
    )
    # ONE row scatter back; padding and out-of-range lanes are dropped
    keep = active & (slot < C)
    state.index_copy_(0, slot[keep], new_rows[keep])

    # ---------------- select response --------------------------------------
    z64 = torch.zeros_like(r_limit)
    status = _sel(
        torch.zeros_like(st_status),
        (tok_exists, te_status_resp),
        (tok_miss, torch.where(m_over, OVER, UNDER)),
        (leak_exists, le_status),
        (leak_miss, torch.where(lm_over, OVER, UNDER)),
        (tok_reset, UNDER),
    ).to(I32)
    return RespBatch(
        status=status,
        limit=torch.where(active, r_limit, z64),
        remaining=_sel(z64, (tok_exists, te_rem), (tok_miss, m_rem),
                       (leak_exists, le_rem), (leak_miss, lm_rem),
                       (tok_reset, r_limit)),
        reset_time=_sel(z64, (tok_exists, te_exp), (tok_miss, m_exp),
                        (leak_exists, now + l_rate),
                        (leak_miss, now + lm_rate), (tok_reset, z64)),
    )


# ------------------------------------------------------------ staging formats
# Wide: i64[9, B] up, i64[4, B] back (decide.py:464). Compact: i32[5, B] up
# (slot, hits, limit, duration, meta), i32[4, B] back with reset as a delta
# from now (decide.py:518-586). Lean: one i32 lane word per request plus an
# i64[128, 4] config table of (limit, duration, algorithm, behavior), hits = 1
# implied, compact response (decide.py:797-883). Interned: i32[2, B] up (slot
# and a meta word) plus an i64[256, 2] config table of (limit, duration),
# compact response (decide.py:619-820).

WIDE, COMPACT, LEAN, INTERNED = 0, 1, 2, 3
# launch_counts' key of each (format, scan)
_COUNT_NAMES = {(f, scan): f"decide_{'scan_' if scan else ''}{name}"
                for f, name in ((WIDE, "wide"), (COMPACT, "compact"), (LEAN, "lean"),
                                (INTERNED, "interned"))
                for scan in (False, True)}

COMPACT_ROWS = 5
_META_BEHAVIOR_SHIFT = 1
_META_BEHAVIOR_MASK = 0x3F
_META_FRESH = 1 << 7
_I32_MAX = (1 << 31) - 1

LEAN_MAX_CFG = 128
_LEAN_SLOT_MASK = (1 << 24) - 1
_LEAN_PAD = _LEAN_SLOT_MASK  # slot sentinel: capacity must stay below it
_LEAN_FRESH_SHIFT = 24
_LEAN_CFG_SHIFT = 25

# The interned meta word (bit 31 clear for every word the packers emit):
#   [14:0]  hits        (eligibility: 0 <= hits < 2^15)
#   [15]    algorithm
#   [21:16] behavior    (6 bits, same mask as compact)
#   [22]    fresh
#   [30:23] config id   (eligibility: <= 256 distinct pairs per stack)
INTERN_ROWS = 2
INTERN_MAX_CFG = 256
_INT_HITS_BITS = 15
_INT_HITS_MAX = (1 << _INT_HITS_BITS) - 1
_INT_ALGO_SHIFT = 15
_INT_BEHAVIOR_SHIFT = 16
_INT_FRESH_SHIFT = 22
_INT_CFG_SHIFT = 23


def _reqs_wide(packed: torch.Tensor, cfg=None) -> ReqBatch:
    return ReqBatch(
        slot=packed[0].to(I32),
        hits=packed[1],
        limit=packed[2],
        duration=packed[3],
        algorithm=packed[4].to(I32),
        behavior=packed[5].to(I32),
        greg_expire=packed[6],
        greg_interval=packed[7],
        fresh=packed[8] != 0,
    )


def _reqs_compact(packed: torch.Tensor, cfg=None) -> ReqBatch:
    meta = packed[4]
    zero64 = torch.zeros(packed.shape[-1], dtype=I64, device=packed.device)
    return ReqBatch(
        slot=packed[0],
        hits=packed[1].to(I64),
        limit=packed[2].to(I64),
        duration=packed[3].to(I64),
        algorithm=meta & 1,
        behavior=(meta >> _META_BEHAVIOR_SHIFT) & _META_BEHAVIOR_MASK,
        greg_expire=zero64,
        greg_interval=zero64,
        fresh=(meta & _META_FRESH) != 0,
    )


def _reqs_lean(lane: torch.Tensor, cfg: torch.Tensor) -> ReqBatch:
    slot24 = lane & _LEAN_SLOT_MASK
    # bits 25-31 include the sign bit: shift, then mask
    cfgid = ((lane >> _LEAN_CFG_SHIFT) & (LEAN_MAX_CFG - 1)).to(I64)
    rows = cfg.index_select(0, cfgid)
    zero64 = torch.zeros(lane.shape[-1], dtype=I64, device=lane.device)
    return ReqBatch(
        slot=torch.where(slot24 == _LEAN_PAD, -1, slot24),
        hits=torch.ones(lane.shape[-1], dtype=I64, device=lane.device),
        limit=rows[:, 0],
        duration=rows[:, 1],
        algorithm=rows[:, 2].to(I32),
        behavior=rows[:, 3].to(I32),
        greg_expire=zero64,
        greg_interval=zero64,
        fresh=((lane >> _LEAN_FRESH_SHIFT) & 1) != 0,
    )


def _reqs_interned(packed: torch.Tensor, cfg: torch.Tensor) -> ReqBatch:
    meta = packed[1]
    # a config id past the table reads its last row, as XLA's gather clamps
    cfgid = ((meta >> _INT_CFG_SHIFT) & (INTERN_MAX_CFG - 1)).to(I64).clamp(
        max=cfg.shape[0] - 1)
    rows = cfg.index_select(0, cfgid)
    zero64 = torch.zeros(packed.shape[-1], dtype=I64, device=packed.device)
    return ReqBatch(
        slot=packed[0],
        hits=(meta & _INT_HITS_MAX).to(I64),
        limit=rows[:, 0],
        duration=rows[:, 1],
        algorithm=(meta >> _INT_ALGO_SHIFT) & 1,
        behavior=(meta >> _INT_BEHAVIOR_SHIFT) & _META_BEHAVIOR_MASK,
        greg_expire=zero64,
        greg_interval=zero64,
        fresh=(meta & (1 << _INT_FRESH_SHIFT)) != 0,
    )


_DECODERS = {WIDE: _reqs_wide, COMPACT: _reqs_compact, LEAN: _reqs_lean,
             INTERNED: _reqs_interned}


def _wide_response(resp: RespBatch, now_ms) -> torch.Tensor:
    return torch.stack([resp.status.to(I64), resp.limit, resp.remaining,
                        resp.reset_time])


def _compact_response(resp: RespBatch, now_ms) -> torch.Tensor:
    """The compact i32[4, B] wire rows: status, limit, remaining, reset as a
    delta from now (an absolute-zero reset encodes as -1)."""
    now = int(now_ms)
    delta = torch.where(resp.reset_time == 0, -1, resp.reset_time - now)
    return torch.stack([resp.status, resp.limit.to(I32),
                        resp.remaining.to(I32), delta.to(I32)])


def decide_plain(fmt: int, state: torch.Tensor, packed: torch.Tensor,
                 cfg: Optional[torch.Tensor], now_ms,
                 scan: bool = False) -> torch.Tensor:
    """The plain PyTorch version of every packed entry point, on any device:
    one window (`scan` False) or K windows applied in order, window k+1
    observing window k's writes. Updates `state` in place; returns the
    response rows (i64[.., 4, B] wide, i32[.., 4, B] otherwise)."""
    decode = _DECODERS[fmt]
    respond = _wide_response if fmt == WIDE else _compact_response

    def window(pk):
        return respond(decide(state, decode(pk, cfg), now_ms), now_ms)

    if not scan:
        return window(packed)
    return torch.stack([window(pk) for pk in packed.unbind(0)])


# ------------------------------------------------------------- CUDA kernel

_kernels: Optional[SimpleNamespace] = None
# The published-copy scratch of csrc/decide.cu, one per card, allocated
# (zeroed) at the first launch there and never written by the host again.
_scratch: Dict[int, torch.Tensor] = {}

_PACKED_DTYPE = {WIDE: I64, COMPACT: I32, LEAN: I32, INTERNED: I32}
# the staging's dims for _launch.check, one window and a scan (B free)
_PACKED_DIMS = {(WIDE, False): (9, None), (WIDE, True): (None, 9, None),
                (COMPACT, False): (COMPACT_ROWS, None),
                (COMPACT, True): (None, COMPACT_ROWS, None),
                (LEAN, False): (None,), (LEAN, True): (None, None),
                (INTERNED, False): (INTERN_ROWS, None),
                (INTERNED, True): (None, INTERN_ROWS, None)}
# the config table a format takes: (rows, columns)
_CFG_DIMS = {LEAN: (LEAN_MAX_CFG, 4), INTERNED: (INTERN_MAX_CFG, 2)}


def _load() -> SimpleNamespace:
    global _kernels
    if _kernels is None:
        V, I, LL = _launch.VOID_P, _launch.INT, _launch.LONGLONG
        k = _launch.load("decide", {
            "decide_launch": (I, I, V, LL, I, V, V, V, I, I, LL, I, V, V),
            "decide_tune": (I, I),
            "decide_scan_chunk": (I, I, I, I, V),
        })
        k.max_owners = k.lib.decide_max_owners()
        k.scratch_words = k.lib.decide_scratch_words()
        _kernels = k
    return _kernels


def decide_cuda(fmt: int, state: torch.Tensor, packed: torch.Tensor,
                cfg: Optional[torch.Tensor], now_ms, scan: bool = False,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch csrc/decide.cu on `state`'s card (same contract as
    decide_plain), its responses into `out` when given (on that card, of
    the response's dtype and shape). Raises on a tensor it does not take
    or a refused launch."""
    return _launch_decide(fmt, state, packed, cfg, now_ms, scan, out, sharded=False)


def _launch_decide(fmt, state, packed, cfg, now_ms, scan, out, sharded):
    """decide_cuda (one table i64[C, 8], `sharded` False) and
    decide_sharded_cuda (i64[R, S, C, 8], one launch for the R * S owners,
    each dim of the staging and response led by R, S): the checks, the
    launch of csrc/decide.cu's decide_launch and its count."""
    index = _launch.cuda_index(state, "decide_sharded_cuda" if sharded else "decide_cuda")
    _launch.check(state, "table", I64, (None,) * (3 if sharded else 1) + (TABLE_ROW_FIELDS,),
                  index)
    lead = tuple(state.shape[:2]) if sharded else ()
    owners = lead[0] * lead[1] if sharded else 1
    C = state.shape[-2]
    if C == 0 or owners == 0:
        raise ValueError("decide on an empty table")
    if state.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned")
    _launch.check(packed, "staging", _PACKED_DTYPE[fmt], lead + _PACKED_DIMS[fmt, scan], index)
    if fmt == INTERNED and cfg is not None and cfg.shape[0] < INTERN_MAX_CFG:
        cfg = _pad_interned_cfg(cfg)
    if fmt in _CFG_DIMS:
        _launch.check(cfg, "config table", I64, _CFG_DIMS[fmt], index)
    B = packed.shape[-1]
    K = packed.shape[len(lead)] if scan else 1
    dims = lead + ((K, 4, B) if scan else (4, B))
    dtype = I64 if fmt == WIDE else I32
    if out is None:
        out = state.new_empty(dims, dtype=dtype)
    else:
        _launch.check(out, "out", dtype, dims, index)
    if K == 0 or B == 0:
        return out
    k = _kernels or _load()
    if owners > k.max_owners:
        raise ValueError(f"{owners} owners in one sharded launch: at most {k.max_owners}")
    scratch = _scratch.get(index)
    if scratch is None:
        scratch = _scratch[index] = state.new_zeros(k.scratch_words)
    _launch.raise_on(k.decide_launch(
        index, fmt, state.data_ptr(), C, owners, packed.data_ptr(),
        cfg.data_ptr() if fmt in _CFG_DIMS else None, out.data_ptr(), K, B, int(now_ms),
        int(scan), scratch.data_ptr(), k.stream(index)),
        "decide_sharded" if sharded else "decide")
    _count((_SHARDED_COUNT_NAMES if sharded else _COUNT_NAMES)[fmt, scan], K, B)
    return out


def _count(name: str, K: int, B: int) -> None:
    launch_counts[name] += 1
    shape_key = (name, K, B)
    launch_shapes[shape_key] = launch_shapes.get(shape_key, 0) + 1


# ------------------------------------------------------------ sharded decide
# The R x S owner shards of the sharded engine are slices of one
# i64[R, S, C, 8] table. decide_sharded decides one window (or K in order)
# for every owner: wide staging i64[R, S, (K,) 9, W] -> i64[R, S, (K,) 4, W],
# lean lane words i32[R, S, (K,) W] + one i64[128, 4] config table for all
# owners -> i32[R, S, (K,) 4, W] (the JAX package's make_decide_sharded and
# its scan and lean forms, parallel/sharded.py:95-213). Each owner applies
# its own lanes to its own table: a slot >= C reads the owner's own row C-1.

_SHARDED_FORMATS = (WIDE, LEAN)
_SHARDED_COUNT_NAMES = {(f, scan): f"decide_sharded_{'scan_' if scan else ''}{name}"
                        for f, name in ((WIDE, "wide"), (LEAN, "lean"))
                        for scan in (False, True)}


def decide_sharded_plain(fmt: int, state: torch.Tensor, packed: torch.Tensor,
                         cfg: Optional[torch.Tensor], now_ms,
                         scan: bool = False) -> torch.Tensor:
    """The plain PyTorch version of decide_sharded, on any device: each
    owner's view of the table and each of its windows through decide_plain,
    owner after owner, window after window. A window with no live lane
    (most owners' windows in a scan of duplicate-key rounds) touches no row
    and answers every lane as padding (status, limit, remaining and reset
    0; a compact reset delta -1), so it is answered so without a call.
    Updates `state` in place."""
    R, S, C = state.shape[:3]
    n = R * S
    tables = state.view(n, C, TABLE_ROW_FIELDS)
    stage = packed.reshape(n, *packed.shape[2:])
    if not scan:
        stage = stage.unsqueeze(1)  # one window an owner
    K, B = stage.shape[1], stage.shape[-1]
    slots = stage[:, :, 0, :] if fmt == WIDE else stage
    if fmt == LEAN:
        live = ((slots & _LEAN_SLOT_MASK) != _LEAN_PAD).any(-1)
    else:
        live = (slots >= 0).any(-1)  # [n, K]
    out = torch.zeros((n, K, 4, B), dtype=I64 if fmt == WIDE else I32,
                      device=state.device)
    if fmt != WIDE:
        out[:, :, 3, :] = -1
    for o, k in live.nonzero().tolist():
        out[o, k] = decide_plain(fmt, tables[o], stage[o, k], cfg, now_ms)
    return out.view(R, S, 4, B) if not scan else out.view(R, S, K, 4, B)


def decide_sharded_cuda(fmt: int, state: torch.Tensor, packed: torch.Tensor,
                        cfg: Optional[torch.Tensor], now_ms,
                        scan: bool = False,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch csrc/decide.cu on `state`'s card: ONE launch for every owner
    (same contract as decide_sharded_plain), its responses into `out` when
    given. Raises on a tensor it does not take or a refused launch."""
    if fmt not in _SHARDED_FORMATS:
        raise ValueError("the sharded decide takes the wide and lean formats only")
    return _launch_decide(fmt, state, packed, cfg, now_ms, scan, out, sharded=True)


def decide_sharded(fmt: int, state: torch.Tensor, packed: torch.Tensor,
                   cfg: Optional[torch.Tensor], now_ms,
                   scan: bool = False) -> torch.Tensor:
    """Decide one window (`scan` False) or K windows in order for every
    owner shard of the i64[R, S, C, 8] table `state`, IN PLACE, in the
    wide (cfg None) or lean format. The CPU takes the plain version; CUDA
    takes the one-launch kernel, or raises."""
    if state.is_cpu:
        return decide_sharded_plain(fmt, state, packed, cfg, now_ms, scan)
    return decide_sharded_cuda(fmt, state, packed, cfg, now_ms, scan)


def _pad_interned_cfg(cfg: torch.Tensor) -> torch.Tensor:
    """An interned config table of N < 256 rows as the kernel's 256: the rows
    past N repeat row N - 1, where XLA's gather clamps a config id past the
    table (the packers always ship 256 rows; nothing on the engine's path
    pads)."""
    if cfg.dim() != 2 or cfg.shape[0] == 0:
        return cfg  # check() names the fault
    pad = cfg[-1:].expand(INTERN_MAX_CFG - cfg.shape[0], cfg.shape[1])
    return torch.cat([cfg, pad]).contiguous()


def scan_chunk(index: int, fmt: int, K: int, B: int) -> int:
    """The windows a chunk of csrc/decide.cu's scan kernel takes for a scan
    of K windows of B lanes in format `fmt` on card `index`, by the rule
    decide_launch applies; 0 when the scan runs one launch a window
    instead. Launches nothing."""
    k = _kernels or _load()
    kc = ctypes.c_int(0)
    _launch.raise_on(k.decide_scan_chunk(index, fmt, K, B, ctypes.byref(kc)),
                     "decide_scan_chunk")
    return kc.value


def _decide(fmt, state, packed, cfg, now_ms, scan):
    """The CPU takes the plain version; CUDA takes the kernel, or raises."""
    if state.is_cpu:
        return decide_plain(fmt, state, packed, cfg, now_ms, scan)
    return decide_cuda(fmt, state, packed, cfg, now_ms, scan)


def decide_packed(state: torch.Tensor, packed: torch.Tensor, now_ms) -> torch.Tensor:
    """decide() over one wide i64[9, B] staging buffer -> i64[4, B]
    (decide.py:464 of the JAX package). Updates `state` in place."""
    return _decide(WIDE, state, packed, None, now_ms, False)


def decide_scan_packed(state: torch.Tensor, packed_k: torch.Tensor, now_ms) -> torch.Tensor:
    """K wide windows i64[K, 9, B] in order, window k+1 observing window k's
    writes -> i64[K, 4, B] (decide.py:495). Updates `state` in place."""
    return _decide(WIDE, state, packed_k, None, now_ms, True)


def decide_packed_compact(state: torch.Tensor, packed: torch.Tensor, now_ms) -> torch.Tensor:
    """decide() over one compact i32[5, B] staging buffer -> i32[4, B]
    (decide.py:536). Updates `state` in place."""
    return _decide(COMPACT, state, packed, None, now_ms, False)


def decide_scan_packed_compact(state: torch.Tensor, packed_k: torch.Tensor, now_ms) -> torch.Tensor:
    """K compact windows i32[K, 5, B] in order -> i32[K, 4, B]
    (decide.py:575). Updates `state` in place."""
    return _decide(COMPACT, state, packed_k, None, now_ms, True)


def decide_packed_interned(state: torch.Tensor, packed: torch.Tensor,
                           cfg: torch.Tensor, now_ms) -> torch.Tensor:
    """decide() over one interned i32[2, B] staging buffer + i64[N <= 256, 2]
    config table -> i32[4, B] (decide.py:650). Updates `state` in place."""
    return _decide(INTERNED, state, packed, cfg, now_ms, False)


def decide_scan_packed_interned(state: torch.Tensor, packed_k: torch.Tensor,
                                cfg: torch.Tensor, now_ms) -> torch.Tensor:
    """K interned windows i32[K, 2, B] + one shared config table, in order
    -> i32[K, 4, B] (decide.py:675). Updates `state` in place."""
    return _decide(INTERNED, state, packed_k, cfg, now_ms, True)


def decide_packed_lean(state: torch.Tensor, packed: torch.Tensor,
                       cfg: torch.Tensor, now_ms) -> torch.Tensor:
    """decide() over one lean i32[B] lane word per request + i64[128, 4]
    config table -> i32[4, B] (decide.py:844). Updates `state` in place."""
    return _decide(LEAN, state, packed, cfg, now_ms, False)


def decide_scan_packed_lean(state: torch.Tensor, packed_k: torch.Tensor,
                            cfg: torch.Tensor, now_ms) -> torch.Tensor:
    """K lean windows i32[K, B] + one shared config table, in order
    -> i32[K, 4, B] (decide.py:872). Updates `state` in place."""
    return _decide(LEAN, state, packed_k, cfg, now_ms, True)


# ------------------------------------------------------------ host packers
# Copies of the JAX package's numpy packers (decide.py:588-618, 689-820,
# 821-982).


def compact_window(packed):
    """Wide i64[9, W] (or [K, 9, W]) staging -> compact i32, or None when
    any lane is ineligible (gregorian, or a value outside [0, 2^31))."""
    vals = packed[..., 1:4, :]
    if (vals < 0).any() or (vals > _I32_MAX).any():
        return None
    if (packed[..., 5, :] & int(Behavior.DURATION_IS_GREGORIAN)).any():
        return None
    out = np.empty(packed.shape[:-2] + (COMPACT_ROWS, packed.shape[-1]),
                   np.int32)
    out[..., 0, :] = packed[..., 0, :]
    out[..., 1:4, :] = vals
    out[..., 4, :] = (
        (packed[..., 4, :] & 1)
        | ((packed[..., 5, :] & _META_BEHAVIOR_MASK) << _META_BEHAVIOR_SHIFT)
        | ((packed[..., 8, :] != 0) << 7)
    )
    return out


def _intern_pairs(packed):
    """Shared eligibility gate for the two interners: the
    (limit << 31) | duration pair per lane, or None when any lane cannot
    ride the interned format (gregorian, hits outside [0, 2^15),
    limit/duration outside [0, 2^31))."""
    hits = packed[..., 1, :]
    if (hits < 0).any() or (hits > _INT_HITS_MAX).any():
        return None
    vals = packed[..., 2:4, :]
    if (vals < 0).any() or (vals > _I32_MAX).any():
        return None
    if (packed[..., 5, :] & int(Behavior.DURATION_IS_GREGORIAN)).any():
        return None
    # both < 2^31: injective, fits i64
    return (packed[..., 2, :] << 31) | packed[..., 3, :]


def _emit_interned(packed, inv):
    """Shared meta-word emission: wide staging + per-lane config ids ->
    interned i32 rows. The bit layout has three writers (here and
    keydir.cpp keydir_prep_pack_interned, the callers' id assignment
    aside) and one reader (_reqs_interned, csrc/decide.cu's decode)."""
    out = np.empty(packed.shape[:-2] + (INTERN_ROWS, packed.shape[-1]),
                   np.int32)
    out[..., 0, :] = packed[..., 0, :]
    out[..., 1, :] = (
        packed[..., 1, :]
        | ((packed[..., 4, :] & 1) << _INT_ALGO_SHIFT)
        | ((packed[..., 5, :] & _META_BEHAVIOR_MASK) << _INT_BEHAVIOR_SHIFT)
        | ((packed[..., 8, :] != 0).astype(np.int64) << _INT_FRESH_SHIFT)
        | (inv.astype(np.int64) << _INT_CFG_SHIFT)
    )
    return out


def intern_window(packed):
    """Wide i64[9, W] (or [K, 9, W]) staging -> (interned i32 rows,
    i64[INTERN_MAX_CFG, 2] config table), or None when any lane is
    ineligible (see _intern_pairs) or the stack holds more than
    INTERN_MAX_CFG distinct (limit, duration) pairs. Padding lanes
    (slot == -1) intern like any other (their zero config occupies one
    table row)."""
    pair = _intern_pairs(packed)
    if pair is None:
        return None
    cfg_vals, inv = np.unique(pair, return_inverse=True)
    if cfg_vals.size > INTERN_MAX_CFG:
        return None
    cfg = np.zeros((INTERN_MAX_CFG, 2), np.int64)
    cfg[: cfg_vals.size, 0] = cfg_vals >> 31
    cfg[: cfg_vals.size, 1] = cfg_vals & _I32_MAX
    return _emit_interned(packed, inv.reshape(pair.shape)), cfg


class InternCache:
    """Stateful interner for a serving loop: the config table persists
    across windows, so the per-window cost is one searchsorted against the
    (tiny, sorted) known-pair array instead of np.unique's full sort of
    every lane. New pairs grow the table (stable ids: already-issued meta
    words stay valid); overflow past INTERN_MAX_CFG or any ineligible lane
    returns None for that window (the caller falls back to wide/compact
    staging), leaving the cache intact."""

    def __init__(self):
        self._sorted_pairs = np.empty(0, np.int64)  # sorted for searchsorted
        self._sorted_ids = np.empty(0, np.int64)  # pair -> stable config id
        self.cfg = np.zeros((INTERN_MAX_CFG, 2), np.int64)
        self.n_cfg = 0

    def intern(self, packed):
        """Wide i64[..., 9, W] staging -> interned i32 rows (the shared
        self.cfg table ships alongside), or None when ineligible."""
        pair = _intern_pairs(packed)
        if pair is None:
            return None
        flat = pair.ravel()
        pos = np.searchsorted(self._sorted_pairs, flat)
        pos_c = np.minimum(pos, max(self._sorted_pairs.size - 1, 0))
        known = (self._sorted_pairs.size > 0) \
            and bool((self._sorted_pairs[pos_c] == flat).all())
        if not known:
            new = np.unique(flat) if self._sorted_pairs.size == 0 else \
                np.setdiff1d(np.unique(flat), self._sorted_pairs,
                             assume_unique=True)
            if self.n_cfg + new.size > INTERN_MAX_CFG:
                return None
            ids = np.arange(self.n_cfg, self.n_cfg + new.size)
            self.cfg[ids, 0] = new >> 31
            self.cfg[ids, 1] = new & _I32_MAX
            self.n_cfg += new.size
            self._sorted_pairs = np.concatenate([self._sorted_pairs, new])
            self._sorted_ids = np.concatenate([self._sorted_ids, ids])
            order = np.argsort(self._sorted_pairs, kind="stable")
            self._sorted_pairs = self._sorted_pairs[order]
            self._sorted_ids = self._sorted_ids[order]
            pos = np.searchsorted(self._sorted_pairs, flat)
        inv = self._sorted_ids[pos].reshape(pair.shape)
        return _emit_interned(packed, inv)


def widen_compact_out(out, now_ms: int):
    """Compact i32[..., 4, B] responses -> the wide i64 rows decide_packed
    returns (reset_delta -1 decodes to absolute 0)."""
    wide = np.asarray(out).astype(np.int64)
    delta = wide[..., 3, :]
    wide[..., 3, :] = np.where(delta < 0, 0, now_ms + delta)
    return wide


def staging_policy() -> str:
    """GUBER_STAGING resolution: 'auto' ships each window on the leanest
    eligible wire format, 'wide' pins the i64[9] format."""
    s = os.environ.get("GUBER_STAGING", "auto")
    if s not in ("auto", "wide"):
        raise ValueError(
            f"GUBER_STAGING={s!r}: must be 'auto' or 'wide'"
            " (lean/compact cannot be pinned — ineligible windows need"
            " the wide format)")
    return s


def lean_capacity_ok(capacity: int) -> bool:
    """Slots must fit the 24-bit lane field with 0xFFFFFF reserved for
    padding — a deployment-time property, checked once per engine."""
    return capacity <= _LEAN_SLOT_MASK


def lean_window(packed, capacity: int):
    """Wide i64[9, W] (or [K, 9, W]) staging -> (lean i32[W] / [K, W] lane
    words, i64[LEAN_MAX_CFG, 4] config table), or None when any non-padding
    lane is ineligible: hits != 1, gregorian, limit/duration outside
    [0, 2^31), behavior past 6 bits, algorithm past 1 bit, slot too wide
    for 24 bits, or > LEAN_MAX_CFG distinct (limit, duration, algorithm,
    behavior) tuples. Padding lanes emit the 0xFFFFFF sentinel and occupy
    no config row."""
    if not lean_capacity_ok(capacity):
        return None
    slot = packed[..., 0, :]
    live = slot >= 0
    if (slot >= _LEAN_PAD).any():
        return None
    hits = packed[..., 1, :]
    limit = packed[..., 2, :]
    dur = packed[..., 3, :]
    algo = packed[..., 4, :]
    beh = packed[..., 5, :]
    bad = (
        (hits != 1)
        | (limit < 0) | (limit > _I32_MAX)
        | (dur < 0) | (dur > _I32_MAX)
        | ((algo & ~1) != 0)
        | ((beh & ~_META_BEHAVIOR_MASK) != 0)
        | ((beh & int(Behavior.DURATION_IS_GREGORIAN)) != 0)
    )
    if bool((bad & live).any()):
        return None
    # intern the (limit, duration, algorithm, behavior) tuples via two 1-D
    # uniques over injective packed keys
    pair = (limit[live] << 31) | dur[live]  # both < 2^31: injective
    meta7 = algo[live] | (beh[live] << 1)  # 7 bits
    u1, inv1 = np.unique(pair, return_inverse=True)
    u2, inv = np.unique(inv1.astype(np.int64) * 128 + meta7,
                        return_inverse=True)
    if u2.size > LEAN_MAX_CFG:
        return None
    cfg = np.zeros((LEAN_MAX_CFG, 4), np.int64)
    pairs = u1[u2 >> 7]
    cfg[: u2.size, 0] = pairs >> 31
    cfg[: u2.size, 1] = pairs & _I32_MAX
    cfg[: u2.size, 2] = u2 & 1
    cfg[: u2.size, 3] = (u2 & 127) >> 1
    lanes = np.full(slot.shape, _LEAN_PAD, np.int64)
    lanes[live] = (
        slot[live]
        | ((packed[..., 8, :][live] != 0).astype(np.int64)
           << _LEAN_FRESH_SHIFT)
        | (inv.reshape(-1).astype(np.int64) << _LEAN_CFG_SHIFT)
    )
    # bit 31 of the cfgid field lands in the i32 sign bit — wrap the bit
    # pattern through uint32 (every reader masks, so negatives are fine)
    return lanes.astype(np.uint32).view(np.int32), cfg


def pack_window(items, slots, fresh, width: int, out=None):
    """Host-side packer for decide_packed: i64[9, width] from one window.

    `items` are prep WorkItems (resp_index, req, greg_expire, greg_interval);
    lanes beyond len(items) are padding (slot = -1). `out`, when given, must
    be a zero-filled i64[9, width] view and is filled in place."""
    n = len(items)
    packed = np.zeros((9, width), np.int64) if out is None else out
    packed[0, :n] = slots
    packed[0, n:] = -1
    if n:
        packed[1:8, :n] = np.array(
            [
                (r.hits, r.limit, r.duration, int(r.algorithm),
                 int(r.behavior), ge, gi)
                for _i, r, ge, gi in items
            ],
            np.int64,
        ).T
    packed[8, :n] = fresh
    return packed
