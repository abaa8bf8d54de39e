"""vit_ms: milliseconds a unit of work (map or step) spends in the mini-ViT
from the patch embedding to the bin edges, the program's span "mViT"
(utils.profiling.stage, read through StageTimes); the spans' sum over
the window's units. Nothing where the cell has no such span."""

SPAN = "vit"


def read(obs):
    total, n = obs.spans.ms_sum(SPAN)
    if not n or not obs.units:
        return None
    return total / obs.units
