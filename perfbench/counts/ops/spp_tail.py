"""PSM-Net's tail: a 3x3 conv over [raw | skip | branches] with folded
BatchNorm and ReLU, then the 1x1 projection."""

from perfbench.counts import nbytes, products


def work(raw, skip, br, w0, scale0, shift0, w1, cout):
    N, H, W, C0 = raw.shape
    cin = C0 + skip.shape[-1] + br.shape[-1]
    mid = scale0.shape[0]
    out_bytes = N * H * W * cout * raw.element_size()
    return {"bytes": nbytes(raw, skip, br, w0, scale0, shift0, w1)
            + out_bytes,
            **products(raw, 2.0 * N * H * W * (9 * cin * mid + mid * cout))}
