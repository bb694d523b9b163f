"""Row access over the key table: plain PyTorch versions and CUDA kernels.

Three functions, each with a plain version and a kernel in csrc/rows.cu:

- inject_rows(state, inject): scatter host rows i64[m, 8] (slot, algo,
  limit, remaining, duration, stamp, expire_at, status) into the i64[C, 8]
  table IN PLACE. The counterpart of the JAX package's engine
  `_inject_rows` (models/engine.py:74) fed through `_apply_inject_rows`
  (:1123): algo and status are truncated through int32, field 7 is zeroed,
  and a slot outside [0, C) is dropped. The rows of one call must target
  distinct slots (the key directory emits each dirty mirror once).
- gather_rows(state, slot) -> i64[7, m]: the first 7 fields of the rows at
  `slot` clamped to [0, C-1], as the JAX `_gather_rows` (:86) reads them.
- row_bump(table, slots) -> i32[1]: the row-access probe of the JAX
  package's scripts/bench_pallas_rows.py (its Pallas `kernel`, :36): +1 to
  every element of the rows at `slots` of an int32[N, 128] table, in place,
  returning slots[0]. The slots must be distinct, as the probe draws them
  (replace=False): the plain version checks that, the kernel trusts it. A
  slot outside [0, N) is dropped by both.

Each dispatcher takes tensors on either device: the CPU runs the plain
version, CUDA launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

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


def gather_rows_plain(state: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    g = slot.to(I64).clamp(0, state.shape[0] - 1)
    return state.index_select(0, g)[:, :GATHER_FIELDS].t().contiguous()


def row_bump_plain(table: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    s = slots.to(I64)
    if torch.unique(s).numel() != s.numel():
        raise ValueError("row_bump needs distinct slots")
    s = s[(s >= 0) & (s < table.shape[0])]
    table[s] = table[s] + 1  # int32 adds wrap
    return slots[:1].clone()


# ------------------------------------------------------------- CUDA kernels

_lib_handle: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        from gubernator_tpu_torch.ops import _build

        lib = _build.load("rows")
        c = ctypes
        lib.inject_rows_launch.argtypes = [
            c.c_int, c.c_void_p, c.c_longlong, c.c_void_p, c.c_int, c.c_void_p]
        lib.gather_rows_launch.argtypes = [
            c.c_int, c.c_void_p, c.c_longlong, c.c_void_p, c.c_int, c.c_void_p,
            c.c_void_p]
        lib.row_bump_launch.argtypes = [
            c.c_int, c.c_void_p, c.c_longlong, c.c_void_p, c.c_int, c.c_void_p,
            c.c_void_p]
        for fn in (lib.inject_rows_launch, lib.gather_rows_launch,
                   lib.row_bump_launch):
            fn.restype = c.c_int
        _lib_handle = lib
    return _lib_handle


def _check(t: torch.Tensor, what: str, dtype, width: Optional[int], device) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what} must be {dtype}, got {t.dtype}")
    if width is None and t.dim() != 1:
        raise ValueError(f"{what} must be 1-D, got {tuple(t.shape)}")
    if width is not None and (t.dim() != 2 or t.shape[1] != width):
        raise ValueError(f"{what} must be [n, {width}], got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _cuda_args(t: torch.Tensor, what: str):
    dev = t.device
    if dev.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {dev}")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return dev, index, torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def inject_rows_cuda(state: torch.Tensor, inject: torch.Tensor) -> None:
    dev, index, stream = _cuda_args(state, "inject_rows_cuda")
    _check(state, "table", I64, ROW_FIELDS, dev)
    _check(inject, "inject rows", I64, ROW_FIELDS, dev)
    m = inject.shape[0]
    if m == 0:
        return
    _raise_on(_lib().inject_rows_launch(index, state.data_ptr(), state.shape[0],
                                        inject.data_ptr(), m, stream), "inject_rows")
    launch_counts["inject_rows"] += 1


def gather_rows_cuda(state: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    dev, index, stream = _cuda_args(state, "gather_rows_cuda")
    _check(state, "table", I64, ROW_FIELDS, dev)
    _check(slot, "slots", I32, None, dev)
    if state.shape[0] == 0:
        raise ValueError("gather from an empty table")
    m = slot.shape[0]
    out = torch.empty((GATHER_FIELDS, m), dtype=I64, device=dev)
    if m == 0:
        return out
    _raise_on(_lib().gather_rows_launch(index, state.data_ptr(), state.shape[0],
                                        slot.data_ptr(), m, out.data_ptr(), stream),
              "gather_rows")
    launch_counts["gather_rows"] += 1
    return out


def row_bump_cuda(table: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    dev, index, stream = _cuda_args(table, "row_bump_cuda")
    _check(table, "probe table", I32, BUMP_ROW, dev)
    _check(slots, "slots", I32, None, dev)
    if table.data_ptr() % 16:
        raise ValueError("probe table must be 16-byte aligned")
    B = slots.shape[0]
    if B == 0:
        raise ValueError("row_bump needs at least one slot")
    out = torch.empty(1, dtype=I32, device=dev)
    _raise_on(_lib().row_bump_launch(index, table.data_ptr(), table.shape[0],
                                     slots.data_ptr(), B, out.data_ptr(), stream),
              "row_bump")
    launch_counts["row_bump"] += 1
    return out


# ------------------------------------------------------------- dispatchers
# The CPU takes the plain version; CUDA takes the kernel, or raises.

def inject_rows(state: torch.Tensor, inject: torch.Tensor) -> None:
    if state.device.type == "cpu":
        return inject_rows_plain(state, inject)
    return inject_rows_cuda(state, inject)


def gather_rows(state: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    if state.device.type == "cpu":
        return gather_rows_plain(state, slot)
    return gather_rows_cuda(state, slot)


def row_bump(table: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    if table.device.type == "cpu":
        return row_bump_plain(table, slots)
    return row_bump_cuda(table, slots)
