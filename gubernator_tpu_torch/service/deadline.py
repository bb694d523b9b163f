"""End-to-end deadline budgets for overload-safe serving.

The reference has no concept of a request deadline past gRPC's own RPC
timeout: a saturated node queues work it can no longer finish in time, and
overload shows up as queue-wait stalls instead of fast rejection. This
module is the budget half of the overload discipline (Dean & Barroso, "The
Tail at Scale": work that is already late is the cheapest work to drop —
drop it before the device dispatch, not after):

- a per-request **budget** is captured once at ingress (the client's gRPC
  context deadline, the HTTP `X-Request-Deadline-Ms` header, or the
  `GUBER_DEFAULT_DEADLINE_MS` env default) as a `Deadline` — an absolute
  monotonic expiry, so every later read is implicitly decremented by the
  time already spent;
- the active deadline rides a ContextVar exactly like the trace span
  (obs/trace.py): surfaces install it for the handler call, the combiner
  reads it at submit, and thread pools receive it explicitly;
- forwarded hops re-encode the REMAINING budget on the wire — gRPC
  metadata (`guber-deadline-ms`) on the stub, a reserved carrier item
  behind a second method-byte flag on peerlink (service/peerlink.py
  `METHOD_DEADLINE`, the same trick as `METHOD_TRACED`) — so each hop
  receives a strictly smaller budget than its caller captured;
- the three serving choke points enforce it: peer forwards send
  `min(remaining, batch_timeout)` with a `GUBER_MIN_HOP_BUDGET_MS` floor
  instead of a fixed timeout (service/peer_client.py), the combiner sheds
  expired tickets at dequeue time before they occupy a device window
  (service/combiner.py), and the admission controller rejects new work
  outright when pending work crosses `GUBER_MAX_PENDING`
  (service/instance.py AdmissionController).

With no budget present (no client deadline, default 0) every site is a
`None` check and the serving path is bit-identical to the pre-deadline
code; `GUBER_MAX_PENDING=0` likewise disables admission entirely.
"""

from __future__ import annotations

import contextvars
import math
import time
from typing import Optional

# gRPC metadata key carrying the remaining hop budget, milliseconds (a
# decimal string; rides next to `traceparent` on peer forwards)
METADATA_KEY = "guber-deadline-ms"
# HTTP ingress header: the client's total budget for this request, ms
HTTP_HEADER = "X-Request-Deadline-Ms"

# Budgets at/above this are "no deadline" sentinels, not real budgets:
# grpcio's context.time_remaining() reports ~int64-max seconds (not None)
# when the client set no deadline, and a budget past a day means nobody
# is actually waiting — treat both as unbudgeted.
MAX_BUDGET_MS = 86_400_000.0  # one day

# deadline_expired_total{stage} label values (docs/observability.md):
# ingress = surface pre-dispatch, queue = combiner dequeue shed,
# forward = router/peer-call pre-send, batch = micro-batch flush shed
STAGE_INGRESS = "ingress"
STAGE_QUEUE = "queue"
STAGE_FORWARD = "forward"
STAGE_BATCH = "batch"


class DeadlineExceededError(RuntimeError):
    """The request's budget died before (or while) we could serve it.
    Maps to gRPC DEADLINE_EXCEEDED / HTTP 504. Never raised for requests
    that carry no budget."""

    code = "DEADLINE_EXCEEDED"


class AdmissionRejectedError(RuntimeError):
    """The node refused new work: pending work crossed GUBER_MAX_PENDING.
    Maps to gRPC RESOURCE_EXHAUSTED / HTTP 429 + Retry-After. Raised
    PRE-dispatch, so callers may safely retry elsewhere (nothing was
    applied)."""

    code = "RESOURCE_EXHAUSTED"

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class Deadline:
    """One request's remaining time budget, as an absolute monotonic
    expiry: `remaining_ms()` self-decrements by elapsed wall time, which
    is exactly the per-hop decrement the issue's budget chain needs —
    no explicit bookkeeping at stage boundaries."""

    __slots__ = ("expires_at", "budget_ms")

    def __init__(self, budget_ms: float, _expires_at: Optional[float] = None):
        self.budget_ms = float(budget_ms)
        self.expires_at = (_expires_at if _expires_at is not None
                           else time.monotonic() + budget_ms / 1e3)

    def remaining_ms(self) -> float:
        return (self.expires_at - time.monotonic()) * 1e3

    def remaining_s(self) -> float:
        return self.expires_at - time.monotonic()

    def expired(self) -> bool:
        return time.monotonic() >= self.expires_at

    def __repr__(self) -> str:  # pragma: no cover — debug aid
        return f"Deadline(remaining={self.remaining_ms():.1f}ms)"


def capture(budget_ms: Optional[float]) -> Optional[Deadline]:
    """Budget -> Deadline; None/0/negative/absurd (>= MAX_BUDGET_MS, see
    above) mean 'no budget' — the request serves exactly as before this
    layer existed."""
    if budget_ms is None or budget_ms <= 0 or budget_ms >= MAX_BUDGET_MS \
            or not math.isfinite(budget_ms):
        return None
    return Deadline(budget_ms)


def hop_budget_ms(remaining_ms: float, batch_timeout_s: float,
                  floor_ms: float) -> float:
    """The budget a forwarded hop is granted:
    `min(remaining, batch_timeout)` floored at GUBER_MIN_HOP_BUDGET_MS —
    a hop never gets MORE time than the caller has left or than the
    configured RPC timeout, but always enough to do non-zero work (a
    microsecond-scale timeout would burn the wire round trip for
    nothing; the floor sheds those at the caller instead)."""
    return max(min(remaining_ms, batch_timeout_s * 1e3), floor_ms)


def from_metadata(metadata) -> Optional[float]:
    """Pull the hop budget (ms) out of gRPC invocation metadata; None for
    absent/garbage (a malformed header must never fail the call — it
    just serves without a budget, like every pre-deadline peer)."""
    if metadata is None:
        return None
    for key, value in metadata:
        if key == METADATA_KEY:
            try:
                budget = float(value)
            except (TypeError, ValueError):
                return None
            return budget if budget > 0 and math.isfinite(budget) else None
    return None


# The active deadline for the current thread of execution — the same
# explicit-handoff discipline as obs.trace's span ContextVar: surfaces
# set it around handler calls, pools receive it as an argument.
_current: "contextvars.ContextVar[Optional[Deadline]]" = \
    contextvars.ContextVar("guber_deadline", default=None)


def current() -> Optional[Deadline]:
    return _current.get()


def use(deadline: Optional[Deadline]):
    """Install `deadline` as the calling context's active budget; returns
    the reset token. None is allowed (explicitly clears)."""
    return _current.set(deadline)


def reset(token) -> None:
    _current.reset(token)
