"""window prep + key directory: the engine's prep, lookup and pack stage
clocks (Engine.stats.stage_ns; the columnar C prep counts all three as
prep) over the window's decisions."""


def read(run):
    ns = sum(run.stage_ns.get(s, 0) for s in ("prep", "lookup", "pack"))
    return ns / run.decisions if run.decisions and ns else None
