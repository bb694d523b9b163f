"""Wall-clock helper (a copy of millisecond_now from the JAX package's
utils/interval.py; the interval timer there waits for the serving tier)."""

from __future__ import annotations

import time


def millisecond_now() -> int:
    """Unix time in milliseconds (reference: client.go:62-65)."""
    return time.time_ns() // 1_000_000
