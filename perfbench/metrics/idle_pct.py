"""idle_pct: the share of the profiled sub-window in which no kernel, copy
or fill ran on the device (the union of their intervals), in percent."""


def read(obs):
    if not obs.trace or not obs.trace.window_s:
        return None
    return 100.0 * (1.0 - obs.trace.busy_s / obs.trace.window_s)
