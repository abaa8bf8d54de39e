"""host_issue_ms: milliseconds a unit of work (map or step) spends
in host clock from the program's forward call to its return, before any
synchronisation (a hook on Magnet); the spans' sum over the window's
units. Nothing where the cell has no such span."""

SPAN = "host_issue"


def read(obs):
    total, n = obs.spans.ms_sum(SPAN)
    if not n or not obs.units:
        return None
    return total / obs.units
