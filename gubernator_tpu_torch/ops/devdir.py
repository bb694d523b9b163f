"""The device-resident key directory: plain PyTorch versions and CUDA kernels.

The counterpart of the JAX package's ops/devdir.py. The host ships an 8-byte
fingerprint per request and the card resolves (or claims, or evicts) its
slot with an open-addressing probe; the slot never goes back to the host.

- The directory is an i64[C] fingerprint column (0 = empty) and an i64[C]
  column of last-use stamps. A slot IS its probe position, so directory and
  bucket table share indexing.
- A key's candidates are PROBE_DEPTH positions (|h| + d) % C, read as they
  stood before the batch. A lane takes its first match; failing that, it
  claims its first empty candidate, or else (with eviction) the least
  recently touched candidate, if that one is older than this batch.
- Positions matched in the batch are stamped `seq` before any victim is
  chosen, so a victim is never a position another lane of the batch uses.
- Among the lanes claiming one position, only the highest lane index wins;
  losers and lanes with nothing to claim come back as `retry`.

Every entry point takes tensors on either device: on the CPU it runs the
plain PyTorch version; on CUDA it launches the hand-written kernels of
csrc/devdir.cu through ops/_launch.py, or raises. It never falls back to the
plain version there. Unlike the JAX functions, which return new columns,
these update `fps` and `touch` IN PLACE and return the per-lane outputs.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import torch

from gubernator_tpu_torch.ops import _launch
from gubernator_tpu_torch.ops.decide import I32, I64, ROW_ALGO, ROW_EXPIRE, TABLE_ROW_FIELDS
from gubernator_tpu_torch.utils.fnv import fnv1a_64_str
from gubernator_tpu_torch.utils.platform import resolve_device

PROBE_DEPTH = 16  # candidate positions per key; none usable = retry lane

# Launches of the CUDA kernels by entry point: each wrapper adds one where it
# launches, and nowhere else. reset_launch_counts() sets them to 0.
launch_counts: Dict[str, int] = {
    "probe_assign_evict": 0, "probe_assign": 0, "refresh_vacancies": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def key_fingerprint(key: str) -> int:
    """63-bit nonzero fingerprint of a key (0 is the empty sentinel)."""
    return (fnv1a_64_str(key) & ((1 << 63) - 1)) | 1


def make_fingerprints(capacity: int, device=None) -> torch.Tensor:
    """An empty i64[capacity] fingerprint column, on the card unless
    `device` says otherwise."""
    return torch.zeros(capacity, dtype=I64, device=resolve_device(device))


def make_touch(capacity: int, device=None) -> torch.Tensor:
    """An i64[capacity] last-use stamp column, all 0."""
    return torch.zeros(capacity, dtype=I64, device=resolve_device(device))


# ---------------------------------------------------------------- plain

def _candidates(C: int, hashes: torch.Tensor) -> torch.Tensor:
    """i64[B, D]: the probe positions of every lane."""
    base = hashes.abs() % C  # floor modulo, as JAX's: in [0, C) for any hash
    d = torch.arange(PROBE_DEPTH, dtype=I64, device=hashes.device)
    return (base[:, None] + d[None, :]) % C


def _first(mask: torch.Tensor) -> torch.Tensor:
    """i32[B]: the first d where `mask` holds, PROBE_DEPTH + 1 where none."""
    d = torch.arange(PROBE_DEPTH, dtype=I32, device=mask.device)[None, :]
    return torch.where(mask, d, PROBE_DEPTH + 1).amin(dim=1)


def _at(pos: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """pos[b, min(d[b], D - 1)] for every lane b."""
    return pos.gather(1, d.clamp(max=PROBE_DEPTH - 1).to(I64)[:, None])[:, 0]


def claim_winners(claim_ok: torch.Tensor, cslot: torch.Tensor) -> torch.Tensor:
    """bool[B]: among the lanes claiming one position, the highest lane
    index wins (the JAX package's _claim_winners, ops/devdir.py:65: a sort
    of (position, lane) keys, the last of each position's run winning)."""
    B = cslot.shape[0]
    lane = torch.arange(B, dtype=I64, device=cslot.device)
    sent = torch.iinfo(torch.int64).max // 2
    key = torch.where(claim_ok, cslot.to(I64) * B + lane, sent + lane)
    order = torch.argsort(key, stable=True)
    sorted_pos = key[order] // B
    is_last = torch.cat([sorted_pos[1:] != sorted_pos[:-1],
                         torch.ones(1, dtype=torch.bool, device=cslot.device)])
    won = torch.zeros(B, dtype=torch.bool, device=cslot.device)
    won[order] = is_last
    return won & claim_ok


def probe_assign_plain(fps: torch.Tensor, hashes: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of probe_assign (the JAX package's :83): resolve or
    claim, no eviction. Updates `fps` in place; returns (slot i32[B], fresh
    bool[B]); slot -1 for padding lanes, exhausted probes and claim losers."""
    C = fps.shape[0]
    active = hashes != 0
    pos = _candidates(C, hashes)
    cand = fps[pos]
    first_match = _first(cand == hashes[:, None])
    first_empty = _first(cand == 0)
    matched = first_match <= PROBE_DEPTH
    claimable = ~matched & (first_empty <= PROBE_DEPTH)
    slot64 = _at(pos, torch.where(matched, first_match, first_empty))
    won = claim_winners(active & claimable, slot64)
    ok = active & (matched | won)
    slot = torch.where(ok, slot64, -1).to(I32)
    fps[slot64[won]] = hashes[won]
    return slot, won


def probe_assign_evict_plain(fps: torch.Tensor, touch: torch.Tensor,
                             hashes: torch.Tensor, seq
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of probe_assign_evict (the JAX package's :131):
    probe_assign plus aged eviction of the least recently touched
    candidate. `seq` is the dispatch's epoch. Updates `fps` and `touch` in
    place; returns (slot i32[B], fresh bool[B], retry bool[B])."""
    C = fps.shape[0]
    now = int(seq)
    active = hashes != 0
    pos = _candidates(C, hashes)
    cand = fps[pos]
    first_match = _first((cand == hashes[:, None]) & active[:, None])
    first_empty = _first(cand == 0)
    matched = active & (first_match <= PROBE_DEPTH)
    mslot = _at(pos, first_match)
    # matched positions are stamped before any victim is chosen
    touch[mslot[matched]] = now
    has_empty = first_empty <= PROBE_DEPTH
    eslot = _at(pos, first_empty)
    ctouch = touch[pos]
    oldest = torch.argmin(ctouch, dim=1)  # the first minimum
    vslot = pos.gather(1, oldest[:, None])[:, 0]
    can_evict = ctouch.gather(1, oldest[:, None])[:, 0] < now
    cslot = torch.where(has_empty, eslot, vslot)
    claim_ok = active & ~matched & (has_empty | can_evict)
    won = claim_winners(claim_ok, cslot)
    slot = torch.where(matched, mslot, torch.where(won, cslot, -1)).to(I32)
    retry = active & (slot < 0)
    fps[cslot[won]] = hashes[won]
    touch[cslot[won]] = now
    return slot, won, retry


def refresh_vacancies_plain(fps: torch.Tensor, table: torch.Tensor, now_ms) -> None:
    """The plain version of refresh_vacancies (the JAX package's :196):
    clear, in place, the fingerprint of every vacant or expired row."""
    dead = (table[:, ROW_ALGO] < 0) | (int(now_ms) > table[:, ROW_EXPIRE])
    fps.masked_fill_(dead, 0)


# ---------------------------------------------------------------- CUDA

_kernels: Optional[SimpleNamespace] = None
# The probe's scratch on each card (csrc/devdir.cu), made and grown here
# alone: `claims`, u64 words, at least as many as the largest directory
# probed there, zeroed when allocated; `tag`, the probes launched on those
# words; `lanes`, at least 3 * B i64 words of per-lane state between the
# kernel's phases. Each launch tags its claims with the next tag, larger
# than any earlier launch's on the words, so no launch clears them.
_scratch: Dict[int, SimpleNamespace] = {}
_MAX_LANES = 1 << 20  # a claim's tag keeps the lane in 20 bits


def _load() -> SimpleNamespace:
    global _kernels
    if _kernels is None:
        V, I, LL = _launch.VOID_P, _launch.INT, _launch.LONGLONG
        _kernels = _launch.load("devdir", {
            "devdir_probe_launch": (I, V, V, LL, V, I, LL, I, V, LL, V, V, V, V, V, V),
            "devdir_refresh_launch": (I, V, V, LL, LL, V),
        })
    return _kernels


def _probe_scratch(index: int, C: int, B: int, like: torch.Tensor) -> SimpleNamespace:
    """Card `index`'s probe scratch, grown to C claim words and 3 * B lane
    words. New claim words start over at tag 0."""
    sc = _scratch.get(index)
    if sc is None or sc.claims.shape[0] < C:
        sc = _scratch[index] = SimpleNamespace(claims=like.new_zeros(C), tag=0,
                                               lanes=like.new_empty(0))
    if sc.lanes.shape[0] < 3 * B:
        sc.lanes = like.new_empty(3 * B)
    return sc


def probe_cuda(fps: torch.Tensor, touch: Optional[torch.Tensor], hashes: torch.Tensor,
               seq, packed: Optional[torch.Tensor] = None,
               out: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None):
    """Launch csrc/devdir.cu's probe on `fps`' card: probe_assign_evict when
    `touch` is given, probe_assign (no eviction, `seq` unused) when it is
    None. Updates `fps` (and `touch`) in place and returns (slot i32[B],
    fresh bool[B], retry bool[B]), into `out` when given. With `packed`, a
    wide i64[9, B] staging on the card, the kernel also writes each lane's
    slot into its row 0 and fresh into its row 8, and `out` may then hold
    None for slot and fresh, which are written nowhere else. Raises on a
    tensor it does not take or a refused launch."""
    index = _launch.cuda_index(fps, "probe_cuda")
    _launch.check(fps, "fingerprints", I64, (None,), index)
    C = fps.shape[0]
    if C == 0:
        raise ValueError("probe on an empty directory")
    if touch is not None:
        _launch.check(touch, "touch", I64, (C,), index)
    _launch.check(hashes, "hashes", I64, (None,), index)
    B = hashes.shape[0]
    if B >= _MAX_LANES:
        raise ValueError(f"a probe takes fewer than {_MAX_LANES} lanes, got {B}")
    if packed is not None:
        _launch.check(packed, "staging", I64, (9, B), index)
    if out is None:
        out = (fps.new_empty(B, dtype=I32), fps.new_empty(B, dtype=torch.bool),
               fps.new_empty(B, dtype=torch.bool))
    else:
        for t, what, dtype in zip(out, ("slot", "fresh", "retry"), (I32, torch.bool, torch.bool)):
            if t is None and (packed is None or what == "retry"):
                raise ValueError(f"probe_cuda needs a {what} output"
                                 + ("" if what == "retry" else " when no staging is given"))
            if t is not None:
                _launch.check(t, what, dtype, (B,), index)
    if B == 0:
        return out
    k = _kernels or _load()
    sc = _probe_scratch(index, C, B, fps)
    sc.tag += 1
    slot, fresh, retry = out
    _launch.raise_on(k.devdir_probe_launch(
        index, fps.data_ptr(), None if touch is None else touch.data_ptr(), C,
        hashes.data_ptr(), B, int(seq), int(touch is not None), sc.claims.data_ptr(), sc.tag,
        sc.lanes.data_ptr(), None if slot is None else slot.data_ptr(),
        None if fresh is None else fresh.data_ptr(), retry.data_ptr(),
        None if packed is None else packed.data_ptr(), k.stream(index)), "devdir_probe")
    launch_counts["probe_assign_evict" if touch is not None else "probe_assign"] += 1
    return out


def refresh_cuda(fps: torch.Tensor, table: torch.Tensor, now_ms) -> None:
    """Launch csrc/devdir.cu's vacancy sweep on `fps`' card (same contract
    as refresh_vacancies_plain). Raises on a tensor it does not take or a
    refused launch."""
    index = _launch.cuda_index(fps, "refresh_cuda")
    _launch.check(fps, "fingerprints", I64, (None,), index)
    C = fps.shape[0]
    _launch.check(table, "table", I64, (C, TABLE_ROW_FIELDS), index)
    if C == 0:
        return
    k = _kernels or _load()
    _launch.raise_on(k.devdir_refresh_launch(
        index, fps.data_ptr(), table.data_ptr(), C, int(now_ms), k.stream(index)),
        "devdir_refresh")
    launch_counts["refresh_vacancies"] += 1


# ------------------------------------------------------------ entry points

def probe_assign(fps: torch.Tensor, hashes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resolve or claim a slot for every key hash, no eviction (the JAX
    package's ops/devdir.py:83). fps: i64[C]; hashes: i64[B], 0 for padding
    lanes. Updates `fps` in place; returns (slot i32[B], fresh bool[B])."""
    if fps.is_cpu:
        return probe_assign_plain(fps, hashes)
    slot, fresh, _retry = probe_cuda(fps, None, hashes, 0)
    return slot, fresh


def probe_assign_evict(fps: torch.Tensor, touch: torch.Tensor, hashes: torch.Tensor, seq,
                       packed: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """probe_assign plus aged eviction (the JAX package's :131). `seq` is a
    per-dispatch monotone epoch. Updates `fps` and `touch` in place; returns
    (slot i32[B], fresh bool[B], retry bool[B]). With `packed` (a wide
    i64[9, B] staging on the same device), rows 0 and 8 take each lane's
    slot and fresh flag, as the device-directory engine feeds decide."""
    if fps.is_cpu:
        slot, fresh, retry = probe_assign_evict_plain(fps, touch, hashes, seq)
        if packed is not None:
            packed[0] = slot
            packed[8] = fresh
        return slot, fresh, retry
    return probe_cuda(fps, touch, hashes, seq, packed)


def refresh_vacancies(fps: torch.Tensor, table: torch.Tensor, now_ms) -> None:
    """Clear, in place, the fingerprints whose bucket row is vacant or
    expired (the JAX package's :196): the lazy recycling sweep."""
    if fps.is_cpu:
        refresh_vacancies_plain(fps, table, now_ms)
    else:
        refresh_cuda(fps, table, now_ms)
