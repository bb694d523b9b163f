"""FNV-1 / FNV-1a 64-bit hashes (pure Python, C++ fast path in native/).

The reference picks peers with fnv1/fnv1a 64-bit (reference:
replicated_hash.go:24,31, cmd/gubernator/config.go:144-162). We use the same
family for deterministic key -> shard ownership so a key's owner is stable
across hosts and restarts.
"""

from __future__ import annotations

_OFFSET = 14695981039346656037
_PRIME = 1099511628211
_MASK = (1 << 64) - 1


def fnv1_64(data: bytes) -> int:
    h = _OFFSET
    for b in data:
        h = ((h * _PRIME) & _MASK) ^ b
    return h


def fnv1a_64(data: bytes) -> int:
    h = _OFFSET
    for b in data:
        h = ((h ^ b) * _PRIME) & _MASK
    return h


def fnv1a_64_str(s: str) -> int:
    return fnv1a_64(s.encode("utf-8"))
