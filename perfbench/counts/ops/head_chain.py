"""A head: a 3x3 conv C0 -> 128, then 1x1 convs 128 -> 128, the last one
128 -> c_out, ReLU between them (depth and mask heads, G-Net's feature
term)."""

from perfbench.counts import nbytes, products


def work(x, ws, bs, c_out, relu_mask):
    N, H, W, C0 = x.shape
    widths = [128] * (len(ws) - 1) + [c_out]
    macs = 9 * C0 * widths[0] + sum(a * b for a, b in zip(widths[:-1],
                                                          widths[1:]))
    out_bytes = N * H * W * c_out * x.element_size()
    return {"bytes": nbytes(x, ws, bs) + out_bytes,
            **products(x, 2.0 * N * H * W * macs)}
