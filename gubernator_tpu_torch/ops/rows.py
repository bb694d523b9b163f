"""Row access over the key table: plain PyTorch versions and CUDA kernels.

Three functions, each with a plain version and a kernel in csrc/rows.cu:

- inject_rows(state, inject): scatter host rows i64[m, 8] (slot, algo,
  limit, remaining, duration, stamp, expire_at, status) into the i64[C, 8]
  table IN PLACE. The counterpart of the JAX package's engine
  `_inject_rows` (models/engine.py:74) fed through `_apply_inject_rows`
  (:1123): algo and status are truncated through int32, field 7 is zeroed,
  and a slot outside [0, C) is dropped. The rows of one call must target
  distinct slots (the key directory emits each dirty mirror once). On the
  card, `inject` may lie in page-locked host memory instead, in one of
  three forms chosen by m alone (pinned_form): by value (m up to the
  library's by_value_max), the rows copied into the launch's parameters on
  the host; mapped, the kernel reading them through their mapped address;
  or copy (m from the library's copy_min up), one copy of the rows into a
  device scratch and the kernel there. InjectStaging is the engine's
  reused page-locked buffer, with its device scratch, and the rule that
  keeps the host from rewriting rows a launched mapped inject or copy may
  still read.
- gather_rows(state, slot, out=None) -> i64[7, m]: the first 7 fields of
  the rows at `slot` clamped to [0, C-1], as the JAX `_gather_rows` (:86)
  reads them, into `out` when given. On the card, `slot` and `out` may
  both lie in page-locked host memory instead: the kernel writes the rows
  through out's mapped address, and the caller waits on the stream
  (sync_stream) before it reads `out`. The slots go by value (m up to
  by_value_max: read on the host into the launch's parameters) or mapped
  (the kernel reads them through their mapped address), by m alone.
  That is the engine's lone path and its Store path (gather_rows_pinned,
  over the engine's own buffers).
- row_bump(table, slots, out=None) -> i32[1]: the row-access probe of the
  JAX package's scripts/bench_pallas_rows.py (its Pallas `kernel`, :36):
  +1 to every element of the rows at `slots` of an int32[N, 128] table, in
  place, returning slots[0] (in `out` when given). The slots must be
  distinct, as the probe draws them (replace=False): the plain version
  checks that, the kernel trusts it. A slot outside [0, N) is dropped by
  both.

- gather_sharded(state, slot) -> i64[R, S, 7, W] and
  inject_sharded(state, slot, rows): the sharded engine's Store path over
  the i64[R, S, C, 8] table, one launch for every owner shard (the JAX
  package's make_gather_sharded and make_inject_sharded,
  parallel/sharded.py:216, :243). Owner o's slot i32[W] indexes its own C
  rows: the gather clamps it to [0, C-1] of that shard; the inject drops a
  lane with slot < 0 or >= C and writes all seven fields of its row as
  given (no int32 truncation, unlike inject_rows), field 7 zeroed. The
  gather's kernel is gather_rows' (one launch, owners on the grid);
  floor_cuda launches an empty kernel on their grid, to time the launch
  alone.

SlabStaging is the streamed snapshot's slab read: no kernel, one
contiguous copy of table rows into page-locked host memory.

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
# the pinned launches also add one to their form's key (<name>_by_value,
# <name>_mapped, inject_rows_copy), and pinned_counts counts them all
# (operands in page-locked host memory).
launch_counts: Dict[str, int] = {"inject_rows": 0, "gather_rows": 0,
                                 "row_bump": 0, "gather_sharded": 0,
                                 "inject_sharded": 0,
                                 "inject_rows_by_value": 0, "inject_rows_mapped": 0,
                                 "inject_rows_copy": 0,
                                 "gather_rows_by_value": 0, "gather_rows_mapped": 0}
pinned_counts: Dict[str, int] = {"inject_rows": 0, "gather_rows": 0}


def by_value_max(name: str) -> int:
    """The largest m a pinned launch of slots ("gather_rows") or rows
    ("inject_rows") takes by value: csrc/rows.cu's largest size class,
    read from the library (64 slots; 448 rows, 28 KB of the launch's
    32,764-byte parameter block)."""
    return (_kernels or _load()).by_value_max[name]


def copy_min() -> int:
    """The least m of rows a pinned inject copies up to the card instead of
    reading them mapped: csrc/rows.cu's kInjectCopyMin, read from the
    library, measured (PERF.md §6)."""
    return (_kernels or _load()).copy_min


def pinned_form(name: str, m: int) -> str:
    """The pinned form a launch of m slots ("gather_rows") or rows
    ("inject_rows") takes, by m alone: "by_value" up to by_value_max, else
    "mapped", except an inject of copy_min rows or more: "copy"."""
    if m <= by_value_max(name):
        return "by_value"
    return "copy" if name == "inject_rows" and m >= copy_min() else "mapped"


# the form codes of csrc/rows.cu's inject_rows_pinned_launch (kForm*)
_INJECT_FORM = {"mapped": 0, "by_value": 1, "copy": 2}


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
        k = _launch.load("rows", {
            "inject_rows_launch": (I, V, LL, V, I, V),
            "inject_rows_pinned_launch": (I, V, LL, V, I, V, V, I, I, V),
            "gather_rows_launch": (I, V, LL, V, I, V, V),
            "gather_rows_pinned_launch": (I, V, LL, V, I, V, V, I, I),
            "rows_by_value_max": (I,),
            "rows_inject_copy_min": (),
            "rows_pinned_floor_launch": (I, I, I, I, V),
            "row_bump_launch": (I, V, LL, V, I, V, V),
            "gather_sharded_launch": (I, V, LL, I, V, I, V, V),
            "inject_sharded_launch": (I, V, LL, I, V, V, I, V),
            "rows_floor_launch": (I, I, I, V),
            "rows_stream_synchronize": (V,),
        })
        # the by-value limits, from the library whose size classes set them
        k.by_value_max = {"gather_rows": k.rows_by_value_max(0),
                          "inject_rows": k.rows_by_value_max(1)}
        k.copy_min = k.rows_inject_copy_min()
        _kernels = k
    return _kernels


def inject_rows_cuda(state: torch.Tensor, inject: torch.Tensor) -> None:
    """Inject on state's card. `inject` lies on that card, or in page-locked
    host memory (pin_memory=True): then up to by_value_max rows go by
    value, consumed when this call returns, more are read by the kernel
    through their mapped address, and from copy_min up they are copied into
    a scratch allocated on the card for this call (the caller must not
    rewrite those rows before the launch or the copy has run). Raises on
    anything else; an unpinned
    CPU tensor is refused by the entry point, whose cudaHostGetDevicePointer
    finds no device address for it."""
    index = _launch.cuda_index(state, "inject_rows_cuda")
    _launch.check(state, "table", I64, (None, ROW_FIELDS), index)
    pinned = not inject.is_cuda
    _launch.check(inject, "inject rows", I64, (None, ROW_FIELDS),
                  _launch.HOST if pinned else index)
    m = inject.shape[0]
    if m == 0:
        return
    if pinned:
        _launch_pinned(index, state, inject, m, None, 0, None)
        return
    k = _kernels or _load()
    _launch.raise_on(k.inject_rows_launch(index, state.data_ptr(), state.shape[0],
                                          inject.data_ptr(), m, k.stream(index)),
                     "inject_rows")
    launch_counts["inject_rows"] += 1


def inject_rows_pinned(state: torch.Tensor, rows: torch.Tensor, m: int,
                       done: Optional[torch.cuda.Event], checked: bool = False,
                       scratch: Optional[torch.Tensor] = None) -> Optional[str]:
    """inject_rows_cuda of the first m rows of `rows`, an i64[R, 8] in host
    memory that its owner checked once (InjectStaging): per call only the
    table is checked and no view of `rows` is made. `checked`: the owner
    found the rows page-locked, so the entry point looks up no address
    where the card's unified addressing makes the host address the device
    address; else it looks the address up and refuses memory that is not
    page-locked. `done`, when not None (a torch.cuda.Event already recorded
    once, so that it exists), is recorded on the stream right after a
    mapped launch, or right after the copy up of the copy form; a by-value
    launch has consumed the rows when this returns and records nothing.
    `scratch`: the owner's i64[R', 8] on the table's card that the copy
    form copies the rows into (allocated for the call when None); it is
    reused in stream order only. Returns the form launched ("by_value",
    "mapped", "copy"), None for m = 0. Both this and inject_rows_cuda's
    page-locked branch reach one entry point: that branch is the checked
    public form for any page-locked i64[m, 8]; this one is the staging's."""
    index = _launch.cuda_index(state, "inject_rows_pinned")
    _launch.check(state, "table", I64, (None, ROW_FIELDS), index)
    return _launch_pinned(index, state, rows, m, done, int(checked), scratch) if m else None


def _launch_pinned(index: int, state: torch.Tensor, rows: torch.Tensor, m: int,
                   done: Optional[torch.cuda.Event], checked: int,
                   scratch: Optional[torch.Tensor]) -> str:
    """Launch the inject of the first m page-locked `rows` in the form m
    picks, and return the form; `checked`: the caller vouches that they are
    page-locked; `scratch`: the copy form's device rows, or None."""
    k = _kernels or _load()
    form = pinned_form("inject_rows", m)
    scratch_ptr = None
    if form == "copy":
        if scratch is None:  # the caching allocator reuses it in stream order
            scratch = state.new_empty((m, ROW_FIELDS))
        elif scratch.shape[0] < m or scratch.get_device() != index:
            raise ValueError(f"a copy of {m} inject rows does not fit the scratch "
                             f"{tuple(scratch.shape)} on {scratch.device}")
        scratch_ptr = scratch.data_ptr()
    err = k.inject_rows_pinned_launch(index, state.data_ptr(), state.shape[0],
                                      rows.data_ptr(), m, k.stream(index),
                                      None if done is None or form == "by_value"
                                      else done.cuda_event,
                                      _INJECT_FORM[form], checked, scratch_ptr)
    if err:  # CUDA found no device address: name the operand
        _launch.require_pinned(rows, "inject rows")
    _launch.raise_on(err, "inject_rows")
    launch_counts["inject_rows"] += 1
    launch_counts["inject_rows_" + form] += 1
    pinned_counts["inject_rows"] += 1
    return form


class InjectStaging:
    """The engine's page-locked inject rows on CUDA: one i64[R, 8] buffer,
    reused by every inject, and a device scratch of the same shape.

    The key directory writes dirty-mirror rows straight into `free()`;
    `launch(state, m)` scatters the first m of them into the table in the
    form m picks (pinned_form): up to by_value_max rows by value (copied
    into the launch's parameters), more through the buffer's mapped
    address, and from copy_min rows up by one copy into the scratch and the
    kernel there (on an H100 the copy beats the mapped read from
    kInjectCopyMin rows, csrc/rows.cu; PERF.md §6); `inject(state, rows)`
    copies other rows in first. The reuse rule: a by-value launch has
    consumed the rows when launch() returns, so it leaves nothing pending; a
    mapped launch records the event `done` after its kernel, a copy right
    after its copy up, and `free()` waits on it before it hands the buffer
    out again, so the host never rewrites rows that a launched mapped
    inject, or a queued copy, may still be reading (a scan group looks up,
    and may inject, up to 32 windows before its one wait). The scratch
    needs no wait: every copy into it queues behind the kernels that read
    it, on one stream. `inject` cuts rows longer than R into chunks of R
    rows, each copied in and launched in turn."""

    def __init__(self, rows: torch.Tensor, done: torch.cuda.Event,
                 scratch: Optional[torch.Tensor] = None):
        """`rows`: the page-locked i64[R, 8] buffer (allocate() makes it so;
        whether it is, is read once here, and a launch from a buffer that
        is not refuses it with a ValueError); `done`: an event that exists
        (recorded once) on the card of the tables it injects into;
        `scratch`: an i64[R, 8] on that card for the copy form (None: each
        copy-form launch allocates its own)."""
        _launch.check(rows, "inject staging", I64, (None, ROW_FIELDS), _launch.HOST)
        if scratch is not None:
            _launch.check(scratch, "inject scratch", I64, (rows.shape[0], ROW_FIELDS),
                          _launch.cuda_index(scratch, "inject scratch"))
        self.rows = rows
        self.checked = rows.is_pinned()
        self.rows_np = rows.numpy()
        self.done = done
        self.scratch = scratch
        self._pending = False
        self.waits = 0  # free() calls that found a launched mapped inject or copy to wait on

    @classmethod
    def allocate(cls, rows: int, device: torch.device) -> "InjectStaging":
        """R = `rows` page-locked rows, their device scratch and an event on
        `device`, allocated once; a failed allocation raises."""
        buf = torch.empty((rows, ROW_FIELDS), dtype=I64, pin_memory=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))  # creates the event
        return cls(buf, done, torch.empty((rows, ROW_FIELDS), dtype=I64, device=device))

    def free(self) -> np.ndarray:
        """The buffer's numpy view, once no launched mapped inject or copy
        reads it."""
        if self._pending:
            self.waits += 1
            self.done.synchronize()
            self._pending = False
        return self.rows_np

    def launch(self, state: torch.Tensor, m: int) -> None:
        """Scatter the buffer's first m rows into `state` in place, as the key
        directory's binding wrote them into free()."""
        if m > len(self.rows_np):
            raise ValueError(f"{m} inject rows exceed the staging's {len(self.rows_np)}")
        form = inject_rows_pinned(state, self.rows, m, self.done, self.checked, self.scratch)
        self._pending = form in ("mapped", "copy")

    def inject(self, state: torch.Tensor, rows: np.ndarray) -> None:
        """Scatter `rows` (i64[m, 8]) into `state`: copied into the buffer
        and launched from there, R rows at a time."""
        R = len(self.rows_np)
        for start in range(0, len(rows), R):
            chunk = rows[start:start + R]
            self.free()[:len(chunk)] = chunk
            self.launch(state, len(chunk))


class SlabStaging:
    """The engine's page-locked snapshot slab on CUDA: one i64[S, 8] buffer
    and an event, allocated at the engine's first snapshot.

    `read(state, start)` copies the table rows start..start+S into the
    buffer (one contiguous device-to-host copy on the current stream: the
    JAX package's `_jit_slab`, models/engine.py:142, a dynamic slice),
    waits on the buffer's own event, not the whole card, and returns the
    buffer's numpy view. The view is valid until the next read: the caller
    copies out what it keeps before it lets go of the engine lock."""

    def __init__(self, rows: torch.Tensor, done: torch.cuda.Event):
        _launch.check(rows, "snapshot slab", I64, (None, ROW_FIELDS), _launch.HOST)
        self.rows = rows
        self.rows_np = rows.numpy()
        self.done = done
        self.reads = 0  # slabs copied down

    @classmethod
    def allocate(cls, rows: int, device: torch.device) -> "SlabStaging":
        """S = `rows` page-locked rows and an event on `device`; a failed
        allocation raises."""
        return cls(torch.empty((rows, ROW_FIELDS), dtype=I64, pin_memory=True),
                   torch.cuda.Event())

    def read(self, state: torch.Tensor, start: int) -> np.ndarray:
        """Table rows start..start+S, through the buffer."""
        self.rows.copy_(state.narrow(0, start, len(self.rows_np)), non_blocking=True)
        self.done.record(torch.cuda.current_stream(state.device))
        self.done.synchronize()
        self.reads += 1
        return self.rows_np

def gather_rows_cuda(state: torch.Tensor, slot: torch.Tensor,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gather on state's card into `out` (allocated there when None). Either
    `slot` lies on that card, and so does `out` when given, or both lie in
    page-locked host memory (pin_memory=True): then the kernel writes the
    rows through out's mapped address, the slots going by value up to
    by_value_max and through their mapped address above, and the
    caller must wait on the stream (sync_stream) before reading `out`.
    Raises on anything else; an unpinned CPU tensor is refused by the entry
    point, whose cudaHostGetDevicePointer finds no device address for it."""
    index = _launch.cuda_index(state, "gather_rows_cuda")
    _launch.check(state, "table", I64, (None, ROW_FIELDS), index)
    C = state.shape[0]
    if C == 0:
        raise ValueError("gather from an empty table")
    if state.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned")
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
    if pinned:
        _gather_pinned(index, state, slot, out, m, 0)
        return out
    k = _kernels or _load()
    _launch.raise_on(k.gather_rows_launch(index, state.data_ptr(), C, slot.data_ptr(), m,
                                          out.data_ptr(), k.stream(index)), "gather_rows")
    launch_counts["gather_rows"] += 1
    return out


def gather_rows_pinned(state: torch.Tensor, slot: torch.Tensor, out: torch.Tensor,
                       m: int) -> None:
    """gather_rows_cuda of slot[:m] into the first 7m elements of `out`, as
    i64[7, m]: `slot` a page-locked i32[R] and `out` a page-locked i64[7R]
    that their owner made page-locked (the engine's lone and Store
    gathers, from the buffers it allocates once): per call only the table
    is checked, no view is made, and the entry point looks up no address
    where the card's unified addressing makes the host address the device
    address. The caller waits on the stream (sync_stream) before it reads
    `out`. Raises ValueError when m slots or 7m rows do not fit."""
    index = _launch.cuda_index(state, "gather_rows_pinned")
    _launch.check(state, "table", I64, (None, ROW_FIELDS), index)
    if state.shape[0] == 0:
        raise ValueError("gather from an empty table")
    if m > slot.numel() or GATHER_FIELDS * m > out.numel():
        raise ValueError(f"a gather of {m} slots does not fit {slot.numel()} slots "
                         f"and {out.numel()} row elements")
    if m:
        _gather_pinned(index, state, slot, out, m, 1)


def _gather_pinned(index: int, state: torch.Tensor, slot: torch.Tensor, out: torch.Tensor,
                   m: int, checked: int) -> None:
    """Launch the gather of m page-locked slots into page-locked `out` in
    the form m picks; `checked`: the caller vouches that both are
    page-locked."""
    k = _kernels or _load()
    form = pinned_form("gather_rows", m)
    err = k.gather_rows_pinned_launch(index, state.data_ptr(), state.shape[0], slot.data_ptr(),
                                      m, out.data_ptr(), k.stream(index),
                                      form == "by_value", checked)
    if err:  # CUDA found no device address: name the operand
        _launch.require_pinned(slot, "slots")
        _launch.require_pinned(out, "out")
    _launch.raise_on(err, "gather_rows")
    launch_counts["gather_rows"] += 1
    launch_counts["gather_rows_" + form] += 1
    pinned_counts["gather_rows"] += 1


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


# ----------------------------------------------------- sharded row access

def _owners(state: torch.Tensor) -> torch.Tensor:
    R, S, C = state.shape[:3]
    return state.view(R * S, C, ROW_FIELDS)


def gather_sharded_plain(state: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    R, S, W = slot.shape
    tables, slots = _owners(state), slot.reshape(R * S, W)
    return torch.stack([gather_rows_plain(tables[o], slots[o])
                        for o in range(R * S)]).view(R, S, GATHER_FIELDS, W)


def inject_sharded_plain(state: torch.Tensor, slot: torch.Tensor,
                         rows: torch.Tensor) -> None:
    R, S, W = slot.shape
    tables = _owners(state)
    C = tables.shape[1]
    slots = slot.reshape(R * S, W).to(I64)
    full = torch.cat([rows.reshape(R * S, GATHER_FIELDS, W).transpose(1, 2),
                      rows.new_zeros((R * S, W, 1))], dim=2)
    for o in range(R * S):
        keep = (slots[o] >= 0) & (slots[o] < C)
        tables[o].index_copy_(0, slots[o][keep], full[o][keep])


def _sharded_operands(state: torch.Tensor, slot: torch.Tensor, what: str):
    index = _launch.cuda_index(state, what)
    _launch.check(state, "table", I64, (None, None, None, ROW_FIELDS), index)
    R, S, C = state.shape[:3]
    if C == 0:
        raise ValueError("an empty table")
    if state.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned")
    _launch.check(slot, "slots", I32, (R, S, None), index)
    return index, R * S, C, slot.shape[2]


def gather_sharded_cuda(state: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """The sharded gather on state's card: ONE launch for every owner."""
    index, n, C, W = _sharded_operands(state, slot, "gather_sharded_cuda")
    out = state.new_empty((state.shape[0], state.shape[1], GATHER_FIELDS, W))
    if W == 0:
        return out
    k = _kernels or _load()
    _launch.raise_on(k.gather_sharded_launch(index, state.data_ptr(), C, n,
                                             slot.data_ptr(), W, out.data_ptr(),
                                             k.stream(index)), "gather_sharded")
    launch_counts["gather_sharded"] += 1
    return out


def inject_sharded_cuda(state: torch.Tensor, slot: torch.Tensor,
                        rows: torch.Tensor) -> None:
    """The sharded inject on state's card: ONE launch for every owner."""
    index, n, C, W = _sharded_operands(state, slot, "inject_sharded_cuda")
    _launch.check(rows, "rows", I64, (state.shape[0], state.shape[1], GATHER_FIELDS, W),
                  index)
    if W == 0:
        return
    k = _kernels or _load()
    _launch.raise_on(k.inject_sharded_launch(index, state.data_ptr(), C, n,
                                             slot.data_ptr(), rows.data_ptr(), W,
                                             k.stream(index)), "inject_sharded")
    launch_counts["inject_sharded"] += 1


def pinned_floor_cuda(index: int, name: str, m: int) -> None:
    """An empty kernel on card `index`, on the grid, and with the parameter
    block, of a pinned launch of m slots (name "gather_rows") or rows
    ("inject_rows") in the form m picks (for the copy form, its kernel's
    grid: the copy up is not counted in): the floor under its device time.
    Counted nowhere."""
    k = _kernels or _load()
    _launch.raise_on(k.rows_pinned_floor_launch(index, name == "inject_rows", m,
                                                pinned_form(name, m) == "by_value",
                                                k.stream(index)), "rows_pinned_floor")


def floor_cuda(index: int, W: int, owners: int = 1) -> None:
    """An empty kernel on card `index`, on the grid the gather and the
    sharded inject take for `owners` owners of W lanes: the floor under
    their device times. Counted nowhere: it is no kernel of any path."""
    k = _kernels or _load()
    _launch.raise_on(k.rows_floor_launch(index, W, owners, k.stream(index)), "rows_floor")


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


def gather_sharded(state: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    if state.is_cpu:
        return gather_sharded_plain(state, slot)
    return gather_sharded_cuda(state, slot)


def inject_sharded(state: torch.Tensor, slot: torch.Tensor, rows: torch.Tensor) -> None:
    if state.is_cpu:
        return inject_sharded_plain(state, slot, rows)
    return inject_sharded_cuda(state, slot, rows)
