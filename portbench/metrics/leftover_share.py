"""leftover path: the share of the window's decisions that the columnar
prep handed to the request-object path, counted where the owner calls it."""


def read(run):
    return run.leftover_items / run.decisions if run.decisions else None
