"""The backward of convex upsampling: the gradients of the maps and of the
mask, about twice the forward's arithmetic."""

from perfbench.counts import nbytes


def work(grads, maps, mask, k):
    B, H, W, C = maps[0].shape
    n = len(maps)
    out_bytes = nbytes(maps, mask)
    return {"bytes": nbytes(grads, maps, mask) + out_bytes,
            "f32_flops": 2 * n * B * H * W * k * k * (9 * 3.0 + 9 * 2 * C)}
