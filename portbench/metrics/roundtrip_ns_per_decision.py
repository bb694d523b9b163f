"""round trip: the engine's device (dispatch, copies, the wait for the
response) and demux (the scatter of answers) stage clocks over the
window's decisions."""


def read(run):
    ns = run.stage_ns.get("device", 0) + run.stage_ns.get("demux", 0)
    return ns / run.decisions if run.decisions and ns else None
