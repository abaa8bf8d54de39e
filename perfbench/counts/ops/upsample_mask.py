"""Convex upsampling of n maps through one mask: per output pixel a softmax
over 9 weights (3 operations each) and a weighted sum of C channels."""

from perfbench.counts import nbytes


def work(maps, mask, k):
    B, H, W, C = maps[0].shape
    n = len(maps)
    out_bytes = n * B * H * W * k * k * C * maps[0].element_size()
    return {"bytes": nbytes(maps, mask) + out_bytes,
            "f32_flops": n * B * H * W * k * k * (9 * 3.0 + 9 * 2 * C)}
