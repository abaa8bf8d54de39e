"""A stride-1 depthwise KxK conv of the D-Net trunk."""

from perfbench.counts import nbytes


def work(x, w):
    N, H, W, C = x.shape
    K = w.shape[0]
    return {"bytes": nbytes(x, w) + nbytes(x),
            "f32_flops": 2.0 * N * H * W * C * K * K}
