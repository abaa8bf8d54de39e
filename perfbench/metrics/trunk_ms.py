"""trunk_ms: milliseconds a unit of work (map or step) spends in the B5
trunk, the program's span "AdaBins trunk" (utils.profiling.stage, read
through StageTimes); the spans' sum over the window's units. Nothing
where the cell has no such span."""

SPAN = "trunk"


def read(obs):
    total, n = obs.spans.ms_sum(SPAN)
    if not n or not obs.units:
        return None
    return total / obs.units
