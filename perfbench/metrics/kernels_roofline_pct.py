"""kernels_roofline_pct: the port's kernel operators' share of their
roofline over the profiled sub-window: the sum of each operator call's
least time (``counts.least_s`` of its bytes and operations) over the sum of
its kernels' device time, in percent. Nothing where no operator ran, or
where one ran whose work is not counted."""

from perfbench import counts


def read(obs):
    calls = obs.trace.op_calls if obs.trace else []
    if not calls or any(c.get("uncounted") for c in calls):
        return None
    device = sum(c["device_s"] for c in calls)
    if device <= 0:
        return None
    return 100.0 * sum(counts.least_s(c) for c in calls) / device
