"""mfu_pct: the model FLOPs of all the work completed in the window
(``counts.model_flops`` on the plain reference at the cell's shapes, per
unit), over the window's length times the H100's 989 TFLOP/s, in
percent."""

from perfbench import counts


def read(obs):
    if not obs.units or not obs.window_s or not obs.model_flops_per_unit:
        return None
    return 100.0 * obs.model_flops_per_unit * obs.units / (
        obs.window_s * counts.PEAK_BF16_FLOPS)
