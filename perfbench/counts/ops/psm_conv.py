"""An F-Net conv (3x3 or 1x1, stride 1 or 2, dilation) with folded
BatchNorm, an optional residual and ReLU."""

from perfbench.counts import nbytes, products


def work(x, w, scale, shift, res, k, stride, dil, relu, counter):
    N, H, W, Ci = x.shape
    Co = scale.shape[0]
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    out_bytes = N * Ho * Wo * Co * x.element_size()
    return {"bytes": nbytes(x, w, scale, shift, res) + out_bytes,
            **products(x, 2.0 * N * Ho * Wo * Co * k * k * Ci)}
