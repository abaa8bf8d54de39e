"""Decoder conv (up2, up3): a 3x3 conv over [upsampled x | skip], folded
BatchNorm and LeakyReLU."""

from perfbench.counts import nbytes, products


def work(x, skip, w, w_skip, scale, shift, upsample, act):
    N, Hs, Ws, Cx = x.shape
    Cs = 0 if skip is None else skip.shape[-1]
    H, W = (skip.shape[1], skip.shape[2]) if skip is not None else (Hs, Ws)
    Cout = scale.shape[0]
    out_bytes = N * H * W * Cout * x.element_size()
    return {"bytes": nbytes(x, skip, w, w_skip, scale, shift) + out_bytes,
            **products(x, 2.0 * N * H * W * Cout * 9 * (Cx + Cs))}
