"""decide kernels: the least time the window's decided lanes need at the
HBM peak (232 B a lane, portbench/peaks.py) over the profiler's device
time of every decide kernel, in %."""

from portbench import peaks


def read(run):
    if not run.trace:
        return None
    s = sum(v for k, v in run.trace["device_ops"].items()
            if "decide_kernel" in k)
    if s <= 0 or not run.decisions:
        return None
    return peaks.roofline_share(run.decisions, s)
