"""Row access over the key table: plain PyTorch versions and CUDA kernels.

Three functions, each with a plain version and a kernel in csrc/rows.cu:

- inject_rows(state, inject): scatter host rows i64[m, 8] (slot, algo,
  limit, remaining, duration, stamp, expire_at, status) into the i64[C, 8]
  table IN PLACE. The counterpart of the JAX package's engine
  `_inject_rows` (models/engine.py:74) fed through `_apply_inject_rows`
  (:1123): algo and status are truncated through int32, field 7 is zeroed,
  and a slot outside [0, C) is dropped. The rows of one call must target
  distinct slots (the key directory emits each dirty mirror once). On the
  card, `inject` may lie in page-locked host memory instead: the kernel
  reads it through its mapped address. InjectStaging is the engine's
  reused page-locked buffer for that form, with the rule that keeps the
  host from rewriting rows a launched inject may still read.
- gather_rows(state, slot, out=None) -> i64[7, m]: the first 7 fields of
  the rows at `slot` clamped to [0, C-1], as the JAX `_gather_rows` (:86)
  reads them, into `out` when given. On the card, `slot` and `out` may
  both lie in page-locked host memory instead: the kernel reads and writes
  them through their mapped addresses, and the caller waits on the stream
  (sync_stream) before it reads `out`. That is the engine's lone path.
- row_bump(table, slots, out=None) -> i32[1]: the row-access probe of the
  JAX package's scripts/bench_pallas_rows.py (its Pallas `kernel`, :36):
  +1 to every element of the rows at `slots` of an int32[N, 128] table, in
  place, returning slots[0] (in `out` when given). The slots must be
  distinct, as the probe draws them (replace=False): the plain version
  checks that, the kernel trusts it. A slot outside [0, N) is dropped by
  both.

Each dispatcher takes tensors on either device: the CPU runs the plain
version, CUDA launches the kernel or raises; it never falls back. The CUDA
wrappers share the launch path of ops/_launch.py.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np
import torch

from gubernator_tpu_torch.ops import _launch

I32 = torch.int32
I64 = torch.int64
ROW_FIELDS = 8
GATHER_FIELDS = 7
BUMP_ROW = 128  # int32 lanes of a probe row: 512 bytes

# Launches of the CUDA kernels: each wrapper adds one where it launches;
# pinned_counts counts those of them that went through the pinned entry
# point (operands in page-locked host memory).
launch_counts: Dict[str, int] = {"inject_rows": 0, "gather_rows": 0,
                                 "row_bump": 0}
pinned_counts: Dict[str, int] = {"inject_rows": 0, "gather_rows": 0}


def reset_launch_counts() -> None:
    for counts in (launch_counts, pinned_counts):
        for k in counts:
            counts[k] = 0


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


def row_bump_plain(table: torch.Tensor, slots: torch.Tensor,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    s = slots.to(I64)
    if torch.unique(s).numel() != s.numel():
        raise ValueError("row_bump needs distinct slots")
    s = s[(s >= 0) & (s < table.shape[0])]
    table[s] = table[s] + 1  # int32 adds wrap
    if out is None:
        return slots[:1].clone()
    return out.copy_(slots[:1])


# ------------------------------------------------------------- CUDA kernels

_kernels: Optional[SimpleNamespace] = None


def _load() -> SimpleNamespace:
    global _kernels
    if _kernels is None:
        V, I, LL = _launch.VOID_P, _launch.INT, _launch.LONGLONG
        _kernels = _launch.load("rows", {
            "inject_rows_launch": (I, V, LL, V, I, V),
            "inject_rows_pinned_launch": (I, V, LL, V, I, V, V),
            "gather_rows_launch": (I, V, LL, V, I, V, V),
            "gather_rows_pinned_launch": (I, V, LL, V, I, V, V),
            "row_bump_launch": (I, V, LL, V, I, V, V),
            "rows_stream_synchronize": (V,),
        })
    return _kernels


def inject_rows_cuda(state: torch.Tensor, inject: torch.Tensor) -> None:
    """Inject on state's card. `inject` lies on that card, or in page-locked
    host memory (pin_memory=True), which the kernel reads through its
    mapped address (the caller must not rewrite those rows before the
    launch has run). Raises on anything else; an unpinned CPU tensor is
    refused by the entry point, whose cudaHostGetDevicePointer finds no
    device address for it."""
    index = _launch.cuda_index(state, "inject_rows_cuda")
    _launch.check(state, "table", I64, (None, ROW_FIELDS), index)
    pinned = not inject.is_cuda
    _launch.check(inject, "inject rows", I64, (None, ROW_FIELDS),
                  _launch.HOST if pinned else index)
    m = inject.shape[0]
    if m == 0:
        return
    if pinned:
        _launch_pinned(index, state, inject, m, None)
        return
    k = _kernels or _load()
    _launch.raise_on(k.inject_rows_launch(index, state.data_ptr(), state.shape[0],
                                          inject.data_ptr(), m, k.stream(index)),
                     "inject_rows")
    launch_counts["inject_rows"] += 1


def inject_rows_pinned(state: torch.Tensor, rows: torch.Tensor, m: int,
                       done: Optional[torch.cuda.Event]) -> None:
    """inject_rows_cuda of the first m rows of `rows`, a page-locked
    i64[R, 8] its owner checked once (InjectStaging, at construction): per
    call only the table is checked, and no view of `rows` is made. `done`,
    when not None (a torch.cuda.Event already recorded once, so that it
    exists), is recorded on the stream right after the launch. Both this
    and inject_rows_cuda's page-locked branch reach one entry point: that
    branch is the checked public form for any page-locked i64[m, 8]; this
    one is the staging's, which skips the per-call checks of its buffer and
    records the staging's event."""
    index = _launch.cuda_index(state, "inject_rows_pinned")
    _launch.check(state, "table", I64, (None, ROW_FIELDS), index)
    if m:
        _launch_pinned(index, state, rows, m, done)


def _launch_pinned(index: int, state: torch.Tensor, rows: torch.Tensor, m: int,
                   done: Optional[torch.cuda.Event]) -> None:
    """Launch the inject of the first m page-locked `rows` (checked)."""
    k = _kernels or _load()
    err = k.inject_rows_pinned_launch(index, state.data_ptr(), state.shape[0],
                                      rows.data_ptr(), m, k.stream(index),
                                      None if done is None else done.cuda_event)
    if err:  # CUDA found no device address: name the operand
        _launch.require_pinned(rows, "inject rows")
    _launch.raise_on(err, "inject_rows")
    launch_counts["inject_rows"] += 1
    pinned_counts["inject_rows"] += 1


class InjectStaging:
    """The engine's page-locked inject rows on CUDA: one i64[R, 8] buffer,
    reused by every inject.

    The key directory writes dirty-mirror rows straight into `free()`;
    `launch(state, m)` scatters the first m of them into the table through
    the buffer's mapped address, with no copy up; `inject(state, rows)`
    copies other rows in first. The reuse rule: each launch
    records the event `done`, and `free()` waits on it before it hands the
    buffer out again, so the host never rewrites rows that a launched
    inject may still be reading (a scan group looks up, and may inject, up
    to 32 windows before its one wait). `inject` cuts rows longer than R
    into chunks of R rows, each copied in and launched in turn."""

    def __init__(self, rows: torch.Tensor, done: torch.cuda.Event):
        """`rows`: the page-locked i64[R, 8] buffer; `done`: an event that
        exists (recorded once) on the card of the tables it injects into."""
        _launch.check(rows, "inject staging", I64, (None, ROW_FIELDS), _launch.HOST)
        self.rows = rows
        self.rows_np = rows.numpy()
        self.done = done
        self._pending = False

    @classmethod
    def allocate(cls, rows: int, device: torch.device) -> "InjectStaging":
        """R = `rows` page-locked rows and an event on `device`, allocated
        once; a failed allocation raises."""
        buf = torch.empty((rows, ROW_FIELDS), dtype=I64, pin_memory=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))  # creates the event
        return cls(buf, done)

    def free(self) -> np.ndarray:
        """The buffer's numpy view, once no launched inject reads it."""
        if self._pending:
            self.done.synchronize()
            self._pending = False
        return self.rows_np

    def launch(self, state: torch.Tensor, m: int) -> None:
        """Scatter the buffer's first m rows into `state` in place, as the key
        directory's binding wrote them into free()."""
        if m > len(self.rows_np):
            raise ValueError(f"{m} inject rows exceed the staging's {len(self.rows_np)}")
        inject_rows_pinned(state, self.rows, m, self.done)
        self._pending = True

    def inject(self, state: torch.Tensor, rows: np.ndarray) -> None:
        """Scatter `rows` (i64[m, 8]) into `state`: copied into the buffer
        and launched from there, R rows at a time."""
        R = len(self.rows_np)
        for start in range(0, len(rows), R):
            chunk = rows[start:start + R]
            self.free()[:len(chunk)] = chunk
            self.launch(state, len(chunk))


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
    C = state.shape[0]
    if C == 0:
        raise ValueError("gather from an empty table")
    pinned = not slot.is_cuda
    where = _launch.HOST if pinned else index
    _launch.check(slot, "slots", I32, (None,), where)
    m = slot.shape[0]
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
    if pinned:
        pinned_counts["gather_rows"] += 1
    return out


def sync_stream(index: int) -> None:
    """Wait for the work queued on card `index`'s current stream (not the
    whole card): what a pinned gather's caller does before reading out."""
    k = _kernels or _load()
    err = k.rows_stream_synchronize(k.stream(index))
    if err != 0:
        raise RuntimeError(f"stream synchronize failed: CUDA error {err}")


def row_bump_cuda(table: torch.Tensor, slots: torch.Tensor,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """row_bump on table's card, slots[0] written into `out` (an i32[1] on
    that card; allocated there when None)."""
    index = _launch.cuda_index(table, "row_bump_cuda")
    _launch.check(table, "probe table", I32, (None, BUMP_ROW), index)
    _launch.check(slots, "slots", I32, (None,), index)
    if table.data_ptr() % 16:
        raise ValueError("probe table must be 16-byte aligned")
    B = slots.shape[0]
    if B == 0:
        raise ValueError("row_bump needs at least one slot")
    if out is None:
        out = slots.new_empty(1)
    else:
        _launch.check(out, "out", I32, (1,), index)
    k = _kernels or _load()
    _launch.raise_on(k.row_bump_launch(index, table.data_ptr(), table.shape[0],
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


def row_bump(table: torch.Tensor, slots: torch.Tensor,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    if table.is_cpu:
        return row_bump_plain(table, slots, out)
    return row_bump_cuda(table, slots, out)
