from gubernator_tpu_torch.utils.gregorian import (
    GREGORIAN_DAYS,
    GREGORIAN_HOURS,
    GREGORIAN_MINUTES,
    GREGORIAN_MONTHS,
    GREGORIAN_WEEKS,
    GREGORIAN_YEARS,
    GregorianError,
    gregorian_duration,
    gregorian_expiration,
)
from gubernator_tpu_torch.utils.interval import millisecond_now
from gubernator_tpu_torch.utils.platform import resolve_device

__all__ = [
    "GREGORIAN_MINUTES",
    "GREGORIAN_HOURS",
    "GREGORIAN_DAYS",
    "GREGORIAN_WEEKS",
    "GREGORIAN_MONTHS",
    "GREGORIAN_YEARS",
    "GregorianError",
    "gregorian_duration",
    "gregorian_expiration",
    "millisecond_now",
    "resolve_device",
]
