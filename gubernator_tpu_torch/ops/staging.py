"""One pipeline slot's staging for the engine's launch/collect split.

Engine.launch_windows and launch_columnar_windows stage a group of up to kb
windows of w lanes: the key directory's prep writes the wide i64[kb, 9, w]
rows, the engine derives the compact i32[kb, 5, w] or lean i32[kb, w] (+ one
i64[128, 4] config table a dispatch) form from them, uploads one of the
three, launches the decide kernel and copies its response back, and collect
reads that response later, from another thread. WindowStaging holds every
one of those host buffers for one slot and one (kb, w) shape.

On CUDA the buffers are page-locked and nothing between launch and collect
waits on the card:

- the upload is a non_blocking copy from page-locked memory on the current
  stream (a copy from pageable memory would make the host wait for every
  launch queued before it, and the pipeline would run in lock step);
- the response is copied, non_blocking, into the slot's page-locked
  response buffer, and the slot's event `done` is recorded after it;
- collect waits on that event alone (a .cpu() would wait for the whole
  stream, every later launch included);
- acquire(), which hands the wide rows to the next prep, first waits on
  the same event: the host never rewrites a buffer that a queued copy may
  still read, nor a response that the card may still write.

The windows of one launch that a cut splits into segments use disjoint
rows of the buffers (each segment's windows, each segment's own config
table), so no segment rewrites what an earlier one queued. A scan
segment is padded on the device to kb2 = pow2(m) windows.

On the CPU the same code runs on plain host tensors with no event: every
copy is synchronous and the plain versions decide at once.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gubernator_tpu_torch.ops.decide import (
    COMPACT_ROWS,
    LEAN_MAX_CFG,
    _LEAN_PAD,
    widen_compact_out,
)

I32 = torch.int32
I64 = torch.int64

# (staging, first window, windows, scanned, compact now or None, generation)
SlotHandle = Tuple["WindowStaging", int, int, bool, Optional[int], int]


class WindowStaging:
    """A slot's host buffers for groups of kb windows of w lanes, and the
    event that orders their reuse (None on the CPU)."""

    def __init__(self, kb: int, w: int, device: torch.device, pinned: bool,
                 done=None):
        def buf(shape, dtype):
            return torch.zeros(shape, dtype=dtype, pin_memory=pinned)

        self.kb, self.w = kb, w
        self.device = device
        self.bufs = {
            "wide": buf((kb, 9, w), I64),
            "compact": buf((kb, COMPACT_ROWS, w), I32),
            "lean": buf((kb, w), I32),
            "cfg": buf((kb, LEAN_MAX_CFG, 4), I64),
            "resp_wide": buf((kb, 4, w), I64),
            "resp_compact": buf((kb, 4, w), I32),
        }
        self.np = {k: t.numpy() for k, t in self.bufs.items()}
        self.wide_np = self.np["wide"]
        self.done = done
        self._launched = False
        self.gen = 0  # acquisitions so far: a handle names the one it used
        self.waits = 0  # acquisitions that found a launch not yet collected

    @classmethod
    def allocate(cls, kb: int, w: int, device: torch.device) -> "WindowStaging":
        """Page-locked buffers and an event on CUDA (a failed allocation
        raises), plain host buffers on the CPU."""
        if device.type != "cuda":
            return cls(kb, w, device, False)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))  # creates the event
        return cls(kb, w, device, True, done)

    def acquire(self) -> np.ndarray:
        """The zeroed wide rows i64[kb, 9, w] for the next group's prep, once
        no copy or launch queued from this slot can still touch them."""
        if self._launched:
            self.waits += 1
            self.done.synchronize()
            self._launched = False
        self.gen += 1
        self.wide_np.fill(0)  # the prep contract: zeroed staging rows
        return self.wide_np

    def up(self, name: str, s: int, m: int, kb2: int) -> torch.Tensor:
        """Windows s..s+m of buffer `name` on the device: one window when
        kb2 is 0, else a scan stack of kb2 >= m windows whose last kb2 - m
        are all padding. On CUDA a non_blocking copy on the current stream."""
        src = self.bufs[name][s:s + m]
        if not kb2:
            return src[0].to(self.device, non_blocking=True)
        if kb2 == m:
            return src.to(self.device, non_blocking=True)
        dev = torch.empty((kb2,) + tuple(src.shape[1:]), dtype=src.dtype,
                          device=self.device)
        dev[:m].copy_(src, non_blocking=True)
        if name == "lean":
            dev[m:].fill_(_LEAN_PAD)
        else:  # wide and compact pads: slot -1, every other row 0
            dev[m:].zero_()
            dev[m:, 0].fill_(-1)
        return dev

    def up_cfg(self, s: int) -> torch.Tensor:
        """Segment s's lean config table on the device."""
        return self.bufs["cfg"][s].to(self.device, non_blocking=True)

    def keep(self, out: torch.Tensor, s: int, m: int, scan: bool,
             compact_now: Optional[int]) -> SlotHandle:
        """Queue the copy of a launch's response (windows s..s+m) into the
        slot's response buffer, record the event after it, and return the
        handle fetch() reads it by."""
        resp = self.bufs["resp_wide" if compact_now is None else "resp_compact"]
        if scan:
            resp[s:s + m].copy_(out[:m], non_blocking=True)
        else:
            resp[s].copy_(out, non_blocking=True)
        if self.done is not None:
            self.done.record(torch.cuda.current_stream(self.device)
                             if self.device.type == "cuda" else None)
            self._launched = True
        return (self, s, m, scan, compact_now, self.gen)

    @staticmethod
    def fetch(handle: SlotHandle) -> np.ndarray:
        """Wait for a kept response (on its slot's event only) and return
        the wide i64 response rows, [m, 4, w] for a scan, else [4, w]: a
        copy, whatever format carried them."""
        st, s, m, scan, compact_now, gen = handle
        if st.gen != gen:
            raise RuntimeError("a pipeline slot's staging was reused before "
                               "its launch was collected")
        if st._launched:
            st.done.synchronize()
            st._launched = False
        if compact_now is None:
            rows = st.np["resp_wide"]
            return (rows[s:s + m] if scan else rows[s]).copy()
        rows = st.np["resp_compact"]
        return widen_compact_out(rows[s:s + m] if scan else rows[s], compact_now)

