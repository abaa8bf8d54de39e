"""fnet_ms: milliseconds a unit of work (map or step) spends in CUDA
events around the F-Net's forward (hooks on Magnet.f_net); the spans'
sum over the window's units. Nothing where the cell has no such span."""

SPAN = "fnet"


def read(obs):
    total, n = obs.spans.ms_sum(SPAN)
    if not n or not obs.units:
        return None
    return total / obs.units
