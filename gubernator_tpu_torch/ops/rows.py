"""Row access over the key table: plain PyTorch versions and CUDA kernels.

Three functions, each with a plain version and a kernel in csrc/rows.cu:

- inject_rows(state, inject): scatter host rows i64[m, 8] (slot, algo,
  limit, remaining, duration, stamp, expire_at, status) into the i64[C, 8]
  table IN PLACE. The counterpart of the JAX package's engine
  `_inject_rows` (models/engine.py:74) fed through `_apply_inject_rows`
  (:1123): algo and status are truncated through int32, field 7 is zeroed,
  and a slot outside [0, C) is dropped. The rows of one call must target
  distinct slots (the key directory emits each dirty mirror once).
- gather_rows(state, slot, out=None) -> i64[7, m]: the first 7 fields of
  the rows at `slot` clamped to [0, C-1], as the JAX `_gather_rows` (:86)
  reads them, into `out` when given. On the card, `slot` and `out` may
  both lie in page-locked host memory instead: the kernel reads and writes
  them through their mapped addresses, and the caller waits on the stream
  (sync_stream) before it reads `out`. That is the engine's lone path.
- row_bump(table, slots) -> i32[1]: the row-access probe of the JAX
  package's scripts/bench_pallas_rows.py (its Pallas `kernel`, :36): +1 to
  every element of the rows at `slots` of an int32[N, 128] table, in place,
  returning slots[0]. The slots must be distinct, as the probe draws them
  (replace=False): the plain version checks that, the kernel trusts it. A
  slot outside [0, N) is dropped by both.

Each dispatcher takes tensors on either device: the CPU runs the plain
version, CUDA launches the kernel or raises; it never falls back. The CUDA
wrappers share the launch path of ops/_launch.py.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Optional

import torch

from gubernator_tpu_torch.ops import _launch

I32 = torch.int32
I64 = torch.int64
ROW_FIELDS = 8
GATHER_FIELDS = 7
BUMP_ROW = 128  # int32 lanes of a probe row: 512 bytes

# Launches of the CUDA kernels: each wrapper adds one where it launches.
launch_counts: Dict[str, int] = {"inject_rows": 0, "gather_rows": 0,
                                 "row_bump": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ------------------------------------------------------------ plain versions

def inject_rows_plain(state: torch.Tensor, inject: torch.Tensor) -> None:
    slot = inject[:, 0]
    rows = torch.cat([inject[:, 1:2].to(I32).to(I64), inject[:, 2:7],
                      inject[:, 7:8].to(I32).to(I64),
                      torch.zeros_like(inject[:, :1])], dim=1)
    keep = (slot >= 0) & (slot < state.shape[0])
    state.index_copy_(0, slot[keep], rows[keep])


def gather_rows_plain(state: torch.Tensor, slot: torch.Tensor,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    g = slot.to(I64).clamp(0, state.shape[0] - 1)
    rows = state.index_select(0, g)[:, :GATHER_FIELDS].t()
    if out is None:
        return rows.contiguous()
    return out.copy_(rows)


def row_bump_plain(table: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    s = slots.to(I64)
    if torch.unique(s).numel() != s.numel():
        raise ValueError("row_bump needs distinct slots")
    s = s[(s >= 0) & (s < table.shape[0])]
    table[s] = table[s] + 1  # int32 adds wrap
    return slots[:1].clone()


# ------------------------------------------------------------- CUDA kernels

_kernels: Optional[SimpleNamespace] = None


def _load() -> SimpleNamespace:
    global _kernels
    if _kernels is None:
        V, I, LL = _launch.VOID_P, _launch.INT, _launch.LONGLONG
        _kernels = _launch.load("rows", {
            "inject_rows_launch": (I, V, LL, V, I, V),
            "gather_rows_launch": (I, V, LL, V, I, V, V),
            "gather_rows_pinned_launch": (I, V, LL, V, I, V, V),
            "row_bump_launch": (I, V, LL, V, I, V, V),
            "rows_stream_synchronize": (V,),
        })
    return _kernels


def inject_rows_cuda(state: torch.Tensor, inject: torch.Tensor) -> None:
    index = _launch.cuda_index(state, "inject_rows_cuda")
    _launch.check(state, "table", I64, (None, ROW_FIELDS), index)
    _launch.check(inject, "inject rows", I64, (None, ROW_FIELDS), index)
    m = inject.size(0)
    if m == 0:
        return
    k = _kernels or _load()
    _launch.raise_on(k.inject_rows_launch(index, state.data_ptr(), state.size(0),
                                          inject.data_ptr(), m, k.stream(index)),
                     "inject_rows")
    launch_counts["inject_rows"] += 1


def gather_rows_cuda(state: torch.Tensor, slot: torch.Tensor,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gather on state's card into `out` (allocated there when None). Either
    `slot` lies on that card, and so does `out` when given, or both lie in
    page-locked host memory (pin_memory=True): then the kernel reads the
    slots and writes the rows through their mapped addresses, and the caller
    must wait on the stream (sync_stream) before reading `out`. Raises on
    anything else; an unpinned CPU tensor is refused by the entry point,
    whose cudaHostGetDevicePointer finds no device address for it."""
    index = _launch.cuda_index(state, "gather_rows_cuda")
    _launch.check(state, "table", I64, (None, ROW_FIELDS), index)
    C = state.size(0)
    if C == 0:
        raise ValueError("gather from an empty table")
    pinned = not slot.is_cuda
    where = _launch.HOST if pinned else index
    _launch.check(slot, "slots", I32, (None,), where)
    m = slot.size(0)
    if out is None:
        if pinned:
            raise ValueError("a gather of page-locked slots needs a page-locked out")
        out = state.new_empty((GATHER_FIELDS, m))
    else:
        _launch.check(out, "out", I64, (GATHER_FIELDS, m), where)
    if m == 0:
        return out
    k = _kernels or _load()
    launch = k.gather_rows_pinned_launch if pinned else k.gather_rows_launch
    err = launch(index, state.data_ptr(), C, slot.data_ptr(), m, out.data_ptr(),
                 k.stream(index))
    if err and pinned:  # CUDA found no device address: name the operand
        _launch.require_pinned(slot, "slots")
        _launch.require_pinned(out, "out")
    _launch.raise_on(err, "gather_rows")
    launch_counts["gather_rows"] += 1
    return out


def sync_stream(index: int) -> None:
    """Wait for the work queued on card `index`'s current stream (not the
    whole card): what a pinned gather's caller does before reading out."""
    k = _kernels or _load()
    err = k.rows_stream_synchronize(k.stream(index))
    if err != 0:
        raise RuntimeError(f"stream synchronize failed: CUDA error {err}")


def row_bump_cuda(table: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    index = _launch.cuda_index(table, "row_bump_cuda")
    _launch.check(table, "probe table", I32, (None, BUMP_ROW), index)
    _launch.check(slots, "slots", I32, (None,), index)
    if table.data_ptr() % 16:
        raise ValueError("probe table must be 16-byte aligned")
    B = slots.size(0)
    if B == 0:
        raise ValueError("row_bump needs at least one slot")
    out = slots.new_empty(1)
    k = _kernels or _load()
    _launch.raise_on(k.row_bump_launch(index, table.data_ptr(), table.size(0),
                                       slots.data_ptr(), B, out.data_ptr(),
                                       k.stream(index)), "row_bump")
    launch_counts["row_bump"] += 1
    return out


# ------------------------------------------------------------- dispatchers
# The CPU takes the plain version; CUDA takes the kernel, or raises.

def inject_rows(state: torch.Tensor, inject: torch.Tensor) -> None:
    if state.is_cpu:
        return inject_rows_plain(state, inject)
    return inject_rows_cuda(state, inject)


def gather_rows(state: torch.Tensor, slot: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    if state.is_cpu:
        return gather_rows_plain(state, slot, out)
    return gather_rows_cuda(state, slot, out)


def row_bump(table: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    if table.is_cpu:
        return row_bump_plain(table, slots)
    return row_bump_cuda(table, slots)
