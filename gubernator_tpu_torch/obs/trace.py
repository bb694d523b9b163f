"""Lightweight span tracing with W3C trace-context propagation.

One request entering the public surface (gRPC, HTTP, or the peerlink lean
link) gets a trace; every hot-path stage it crosses — ingress, the
combiner's batch window wait, the device kernel dispatch, the peer hop to
the owner — records a span under that trace's id. The context rides
outbound hops as a W3C `traceparent` (gRPC metadata on peer forwards; a
reserved carrier item in peerlink frames, service/peerlink.py), so the
owner daemon's spans share the ingress daemon's trace id and the chain
reconstructs end to end from the daemons' /v1/debug/traces ring buffers.

Design constraints, in order:

1. Sample-rate 0 is a hard no-op: `maybe_trace` returns None before any
   allocation, surfaces skip metadata scans entirely, and every
   instrumentation site guards on `span is None`. The only per-request
   cost with tracing off is one ContextVar read on the routing path.
2. No background machinery: finished spans land in a bounded ring buffer
   (newest wins); the debug endpoint groups them by trace id on demand.
3. Spans cross thread pools explicitly (the combiner and forward pool run
   on their own threads): callers capture the current span and attach
   completed child spans via `record_span` — no context copying on the
   hot path.

Slow-request logging: when a ROOT span ends over `slow_ms`, one structured
JSON line (logger `gubernator_tpu_torch.slow`) carries the trace id and its
phase spans — grep-able without a trace UI.
"""

from __future__ import annotations

import contextvars
import json
import logging
import random
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from gubernator_tpu_torch.obs import witness

slow_log = logging.getLogger("gubernator_tpu_torch.slow")


def install_slow_log_file(path: str, max_mb: float = 64.0,
                          backups: int = 2) -> Optional[object]:
    """Attach a size-rotated file sink to the slow-request logger
    (GUBER_SLOW_LOG_PATH / GUBER_SLOW_LOG_MAX_MB). Without a bound the
    one-line-per-slow-request log grows without limit on a node that is
    slow BECAUSE it is sick — exactly when disk is the wrong thing to
    exhaust. Returns the handler (tests close it), None when disabled or
    the path is unwritable (stderr logging still works)."""
    if not path or max_mb <= 0:
        return None
    from logging.handlers import RotatingFileHandler

    try:
        handler = RotatingFileHandler(
            path, maxBytes=int(max_mb * 1024 * 1024), backupCount=backups)
    except OSError:
        logging.getLogger(__name__).exception(
            "slow-log file sink unavailable: %s", path)
        return None
    handler.setFormatter(logging.Formatter("%(message)s"))
    slow_log.addHandler(handler)
    return handler

# W3C traceparent: version "00" - 16-byte trace id - 8-byte span id - flags
_SAMPLED_FLAG = 0x01


def format_traceparent(span: "Span") -> str:
    return f"00-{span.trace_id}-{span.span_id}-01"


def parse_traceparent(header: str):
    """-> (trace_id, span_id, sampled) or None for anything malformed.
    Unknown versions parse leniently (the spec's forward-compat rule)."""
    try:
        parts = header.strip().split("-")
        if len(parts) < 4:
            return None
        version, trace_id, span_id, flags = parts[0], parts[1], parts[2], parts[3]
        if len(version) != 2 or version == "ff":
            return None
        if len(trace_id) != 32 or len(span_id) != 16:
            return None
        int(version, 16), int(trace_id, 16), int(span_id, 16)  # hex or bust
        if trace_id == "0" * 32 or span_id == "0" * 16:
            return None
        return trace_id, span_id, bool(int(flags, 16) & _SAMPLED_FLAG)
    except (ValueError, AttributeError):
        return None


def traceparent_from_metadata(metadata) -> Optional[str]:
    """Pull `traceparent` out of gRPC invocation metadata (a sequence of
    (key, value) pairs). Callers gate on tracer.active first."""
    if metadata is None:
        return None
    for key, value in metadata:
        if key == "traceparent":
            return value
    return None


class Span:
    """One phase of one traced request. Mutable until finish()."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "start_ns",
                 "end_ns", "attrs")

    def __init__(self, trace_id: str, span_id: str, parent_id: str,
                 name: str, start_ns: int):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id  # "" = root of its process's view
        self.name = name
        self.start_ns = start_ns
        self.end_ns = 0
        self.attrs: Optional[Dict[str, object]] = None

    def set(self, key: str, value) -> None:
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value

    def as_dict(self) -> dict:
        d = {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start_ns": self.start_ns,
            "duration_ms": round((self.end_ns - self.start_ns) / 1e6, 4),
        }
        if self.attrs:
            d["attrs"] = self.attrs
        return d


# The active span for the current thread of execution. Surfaces set it for
# the duration of a handler call; the combiner reads it at submit().
_current: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
    "guber_trace_span", default=None)


def current() -> Optional[Span]:
    return _current.get()


def use(span: Optional[Span]):
    """Install `span` as the calling context's active span; returns the
    reset token. None is allowed (explicitly clears)."""
    return _current.set(span)


def reset(token) -> None:
    _current.reset(token)


class Tracer:
    """Per-daemon span recorder + sampler (one per Instance, like the
    per-daemon Metrics registry)."""

    def __init__(self, sample: float = 0.0, slow_ms: float = 0.0,
                 ring: int = 2048, service: str = ""):
        self.sample = float(sample)
        self.slow_ms = float(slow_ms)
        self.service = service
        self._ring: "deque[Span]" = deque(maxlen=ring)
        self._lock = witness.make_lock("trace.ring")
        self._rand = random.Random()
        self.stats = {"started": 0, "continued": 0, "spans": 0,
                      "slow_logged": 0}
        # optional hook (wired by the Instance): zero-arg callable giving
        # the profiler's recent serving-cycle decomposition, attached to
        # slow-request log entries so "this request was slow" arrives with
        # "and here is where the last minute's cycle time went"
        self.profile_snapshot = None

    # ------------------------------------------------------------- sampling

    @property
    def active(self) -> bool:
        """False = tracing is fully off; surfaces skip even the header
        scan, so rate 0 adds nothing to the hot path."""
        return self.sample > 0.0

    def maybe_trace(self, name: str,
                    traceparent: Optional[str] = None) -> Optional[Span]:
        """Ingress: continue a remote sampled trace, else sample a new
        one. Returns None (no allocation) when the request is untraced."""
        if not self.active:
            return None
        if traceparent:
            parsed = parse_traceparent(traceparent)
            if parsed is not None and parsed[2]:
                self.stats["continued"] += 1
                return self._new_span(parsed[0], parsed[1], name)
        if self.sample >= 1.0 or self._rand.random() < self.sample:
            self.stats["started"] += 1
            return self._new_span(self._hex(16), "", name)
        return None

    def continue_trace(self, name: str,
                       traceparent: Optional[str]) -> Optional[Span]:
        """Peer surfaces: record ONLY when the remote hop is part of a
        sampled trace — never originate a trace at an internal surface
        (forwarded traffic would double-sample)."""
        if not self.active or not traceparent:
            return None
        parsed = parse_traceparent(traceparent)
        if parsed is None or not parsed[2]:
            return None
        self.stats["continued"] += 1
        return self._new_span(parsed[0], parsed[1], name)

    # ------------------------------------------------------------ recording

    def start_span(self, name: str, parent: Span) -> Span:
        return Span(parent.trace_id, self._hex(8), parent.span_id, name,
                    time.time_ns())

    def record_span(self, name: str, parent: Span, start_ns: int,
                    end_ns: int, attrs: Optional[dict] = None) -> Span:
        """Attach an already-measured interval as a completed child span —
        the cross-thread idiom (combiner windows, forward-pool hops)."""
        span = Span(parent.trace_id, self._hex(8), parent.span_id, name,
                    start_ns)
        span.end_ns = end_ns
        if attrs:
            span.attrs = dict(attrs)
        self._push(span)
        return span

    def finish(self, span: Optional[Span]) -> None:
        if span is None:
            return
        span.end_ns = time.time_ns()
        self._push(span)
        if not span.parent_id and self.slow_ms > 0:
            dur_ms = (span.end_ns - span.start_ns) / 1e6
            if dur_ms >= self.slow_ms:
                self._log_slow(span, dur_ms)

    # ---------------------------------------------------------- inspection

    def traces(self, trace_id: str = "") -> Dict[str, List[dict]]:
        """Ring-buffer dump grouped by trace id (optionally one trace),
        spans in start order — the /v1/debug/traces payload."""
        with self._lock:
            spans = list(self._ring)
        out: Dict[str, List[dict]] = {}
        for s in sorted(spans, key=lambda s: s.start_ns):
            if trace_id and s.trace_id != trace_id:
                continue
            out.setdefault(s.trace_id, []).append(s.as_dict())
        return out

    # ------------------------------------------------------------ internals

    def _new_span(self, trace_id: str, parent_id: str, name: str) -> Span:
        return Span(trace_id, self._hex(8), parent_id, name, time.time_ns())

    def _hex(self, nbytes: int) -> str:
        return f"{self._rand.getrandbits(nbytes * 8):0{nbytes * 2}x}"

    def _push(self, span: Span) -> None:
        with self._lock:
            self._ring.append(span)
            self.stats["spans"] += 1

    def _log_slow(self, root: Span, dur_ms: float) -> None:
        self.stats["slow_logged"] += 1
        phases = self.traces(root.trace_id).get(root.trace_id, [])
        entry = {
            "event": "slow_request",
            "service": self.service,
            "trace_id": root.trace_id,
            "name": root.name,
            "duration_ms": round(dur_ms, 3),
            "threshold_ms": self.slow_ms,
            "spans": phases,
        }
        snap = self.profile_snapshot
        if snap is not None:
            try:
                entry["profile"] = snap()
            except Exception:  # noqa: BLE001 — a slow log must still land
                pass
        slow_log.warning(json.dumps(entry, separators=(",", ":")))
