"""device: the share of the traced window in which no kernel, copy or set
ran on the card (torch.profiler)."""


def read(run):
    if not run.trace or run.trace["window_s"] <= 0:
        return None
    return 1.0 - run.trace["busy_s"] / run.trace["window_s"]
