"""bins_ms: milliseconds a unit of work (map or step) spends in the bins
head (conv3x3, the dot product with the queries, conv_out, the softmax
and the weighted sum of the centres), the program's span "bins head"
(utils.profiling.stage, read through StageTimes); the spans' sum over
the window's units. Nothing where the cell has no such span."""

SPAN = "bins"


def read(obs):
    total, n = obs.spans.ms_sum(SPAN)
    if not n or not obs.units:
        return None
    return total / obs.units
