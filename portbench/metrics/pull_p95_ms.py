"""owner loop: the 95th percentile (nearest rank) of every pull's time in
the window, from its first launch to its last answer, leftovers included;
host clock, the benchmark's span around each pull."""

import math


def read(run):
    ms = sorted(run.pull_ms)
    if not ms:
        return None
    return ms[max(math.ceil(0.95 * len(ms)) - 1, 0)]
