"""Gregorian calendar bucket math.

When a request sets Behavior.DURATION_IS_GREGORIAN, the `duration` field is a
calendar-interval code and buckets reset at the end of the current calendar
interval (reference: interval.go:71-145, proto/gubernator.proto:99-119).

The kernel needs two host-precomputed numbers per gregorian request:
- the *expiration*: unix-ms of the last millisecond of the current interval;
- the *full interval duration* in ms (used as the leaky-bucket drain window).

Deviation from the reference (documented in PARITY.md): the reference's
month/year `GregorianDuration` has an operator-precedence bug
(`end.UnixNano() - begin.UnixNano()/1000000`, interval.go:94-102) returning
nanosecond-scale garbage; we return the correct millisecond span.
Weeks are unimplemented in the reference (interval.go:89-90); we implement
them (ISO weeks ending Sunday 23:59:59.999) rather than erroring.
"""

from __future__ import annotations

import datetime as _dt

GREGORIAN_MINUTES = 0
GREGORIAN_HOURS = 1
GREGORIAN_DAYS = 2
GREGORIAN_WEEKS = 3
GREGORIAN_MONTHS = 4
GREGORIAN_YEARS = 5

_MS_MINUTE = 60_000
_MS_HOUR = 3_600_000
_MS_DAY = 86_400_000
_MS_WEEK = 7 * _MS_DAY


class GregorianError(ValueError):
    """Raised when `duration` is not a valid gregorian interval code."""


def _to_ms(dt: _dt.datetime) -> int:
    return int(dt.timestamp() * 1000)


def _next_boundary(now: _dt.datetime, code: int) -> _dt.datetime:
    """Start of the next calendar interval after `now` (local time)."""
    if code == GREGORIAN_MINUTES:
        base = now.replace(second=0, microsecond=0)
        return base + _dt.timedelta(minutes=1)
    if code == GREGORIAN_HOURS:
        base = now.replace(minute=0, second=0, microsecond=0)
        return base + _dt.timedelta(hours=1)
    if code == GREGORIAN_DAYS:
        base = now.replace(hour=0, minute=0, second=0, microsecond=0)
        return base + _dt.timedelta(days=1)
    if code == GREGORIAN_WEEKS:
        base = now.replace(hour=0, minute=0, second=0, microsecond=0)
        return base + _dt.timedelta(days=7 - now.weekday())
    if code == GREGORIAN_MONTHS:
        if now.month == 12:
            return now.replace(
                year=now.year + 1, month=1, day=1, hour=0, minute=0, second=0, microsecond=0
            )
        return now.replace(month=now.month + 1, day=1, hour=0, minute=0, second=0, microsecond=0)
    if code == GREGORIAN_YEARS:
        return now.replace(
            year=now.year + 1, month=1, day=1, hour=0, minute=0, second=0, microsecond=0
        )
    raise GregorianError(
        "behavior DURATION_IS_GREGORIAN is set; but `duration` is not a valid gregorian interval"
    )


def _start_boundary(now: _dt.datetime, code: int) -> _dt.datetime:
    """Start of the current calendar interval containing `now`."""
    if code == GREGORIAN_MINUTES:
        return now.replace(second=0, microsecond=0)
    if code == GREGORIAN_HOURS:
        return now.replace(minute=0, second=0, microsecond=0)
    if code == GREGORIAN_DAYS:
        return now.replace(hour=0, minute=0, second=0, microsecond=0)
    if code == GREGORIAN_WEEKS:
        base = now.replace(hour=0, minute=0, second=0, microsecond=0)
        return base - _dt.timedelta(days=now.weekday())
    if code == GREGORIAN_MONTHS:
        return now.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
    if code == GREGORIAN_YEARS:
        return now.replace(month=1, day=1, hour=0, minute=0, second=0, microsecond=0)
    raise GregorianError(
        "behavior DURATION_IS_GREGORIAN is set; but `duration` is not a valid gregorian interval"
    )


def gregorian_expiration(now: _dt.datetime, code: int) -> int:
    """Unix-ms of the final millisecond of the current interval.

    Matches the reference convention of "end of interval minus epsilon"
    (reference: interval.go:114-145): e.g. for minutes at 11:20:10 the
    expiry is 11:20:59.999.
    """
    return _to_ms(_next_boundary(now, code)) - 1


def gregorian_duration(now: _dt.datetime, code: int) -> int:
    """Full span of the current calendar interval, in ms.

    Fixed-width for minute/hour/day/week; month/year depend on the calendar
    (reference: interval.go:81-106, with the precedence bug corrected).
    """
    if code == GREGORIAN_MINUTES:
        return _MS_MINUTE
    if code == GREGORIAN_HOURS:
        return _MS_HOUR
    if code == GREGORIAN_DAYS:
        return _MS_DAY
    if code == GREGORIAN_WEEKS:
        return _MS_WEEK
    if code in (GREGORIAN_MONTHS, GREGORIAN_YEARS):
        return _to_ms(_next_boundary(now, code)) - _to_ms(_start_boundary(now, code))
    raise GregorianError(
        "behavior DURATION_IS_GREGORIAN is set; but `duration` is not a valid gregorian interval"
    )
