"""The G-Net update: the cost volume's 3x3 conv D -> 128 added to the
feature term, then 1x1 convs 128 -> 128 -> 128 -> 2 and the Gaussian
update."""

from perfbench.counts import nbytes, products


def work(cv, feat, prev, ws, bs):
    B, H, W, D = cv.shape
    macs = 9 * D * 128 + 2 * 128 * 128 + 128 * 2
    out_bytes = B * H * W * 2 * feat.element_size()
    return {"bytes": nbytes(cv, feat, prev, ws, bs) + out_bytes,
            **products(feat, 2.0 * B * H * W * macs)}
