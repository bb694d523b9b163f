"""Public wire-level types.

A copy of the JAX package's types (gubernator_tpu/types.py), which mirror
the reference proto contract (reference: proto/gubernator.proto:56-220).
Field numbers and enum values are part of the wire contract and must match
the JAX package's; the port keeps its own copy so that it never imports the
JAX package.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict


class Algorithm(enum.IntEnum):
    """Bucket algorithm selector (reference: proto/gubernator.proto:56-62)."""

    TOKEN_BUCKET = 0
    LEAKY_BUCKET = 1


class Behavior(enum.IntFlag):
    """Per-request behavior bitflags (reference: proto/gubernator.proto:65-131)."""

    BATCHING = 0  # default; no-op flag
    NO_BATCHING = 1
    GLOBAL = 2
    DURATION_IS_GREGORIAN = 4
    RESET_REMAINING = 8
    MULTI_REGION = 16


# Behaviors the native lone-request path (Engine.decide_native_single) hands
# to the request-object pipeline: gregorian needs host calendar math; GLOBAL
# and MULTI_REGION peel off to the host managers before the backend sees them.
SLOW_PATH_BEHAVIOR_MASK = (int(Behavior.DURATION_IS_GREGORIAN)
                           | int(Behavior.GLOBAL)
                           | int(Behavior.MULTI_REGION))


class Status(enum.IntEnum):
    """Rate limit decision (reference: proto/gubernator.proto:161-164)."""

    UNDER_LIMIT = 0
    OVER_LIMIT = 1


def hash_key(name: str, unique_key: str) -> str:
    """The canonical rate-limit key: ``name + "_" + unique_key``
    (reference: client.go:33-35)."""
    return name + "_" + unique_key


@dataclasses.dataclass(slots=True)
class RateLimitReq:
    """One rate-limit request (reference: proto/gubernator.proto:134-159)."""

    name: str = ""
    unique_key: str = ""
    hits: int = 0
    limit: int = 0
    duration: int = 0  # milliseconds, or a Gregorian interval code when
    # Behavior.DURATION_IS_GREGORIAN is set
    algorithm: int = Algorithm.TOKEN_BUCKET
    behavior: int = 0

    def hash_key(self) -> str:
        return hash_key(self.name, self.unique_key)


@dataclasses.dataclass(slots=True)
class RateLimitResp:
    """One rate-limit decision (reference: proto/gubernator.proto:166-180)."""

    status: int = Status.UNDER_LIMIT
    limit: int = 0
    remaining: int = 0
    reset_time: int = 0  # unix ms when the limit span resets
    error: str = ""
    metadata: Dict[str, str] = dataclasses.field(default_factory=dict)


ERR_EMPTY_UNIQUE_KEY = "field 'unique_key' cannot be empty"
ERR_EMPTY_NAME = "field 'namespace' cannot be empty"
