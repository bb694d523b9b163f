"""The yardstick's constants: the card's published peaks and the bytes a
decided lane needs, whatever format, form or kernel decides it."""

# NVIDIA H100 SXM (NVIDIA's data sheet): HBM3 bandwidth, bytes/s, at the
# full 700 W power limit
HBM_BYTES_PER_S = 3.35e12

TABLE_ROW_BYTES = 64      # one i64[8] bucket row
REQUEST_BYTES = 9 * 8     # the wide staging format's i64[9] lane
RESPONSE_BYTES = 4 * 8    # the i64[4] response lane


def bytes_per_lane() -> int:
    """A decided lane reads and writes its table row once, reads its
    request once and writes its response once: 232 B."""
    return 2 * TABLE_ROW_BYTES + REQUEST_BYTES + RESPONSE_BYTES


def roofline_share(lanes: int, kernel_s: float) -> float:
    """The least time the lanes need at the HBM peak over the time the
    kernels took, in %."""
    return 100.0 * lanes * bytes_per_lane() / HBM_BYTES_PER_S / kernel_s
