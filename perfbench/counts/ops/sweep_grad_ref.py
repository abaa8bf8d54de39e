"""The reference features' gradient of the sweep: per (pixel, plane, view)
sample the projection (about 30 operations) and a multiply-add per channel
at each of 4 corners (all corners counted, as for the source gradient); the
inputs read once and the (B, H, W, C) f32 output written once."""

from perfbench.counts import nbytes


def work(depth, src, gbar, R, t, valid, K, rays):
    B, V, H, W, C = src.shape
    D = depth.shape[0]
    samples = B * H * W * D * V
    out_bytes = B * H * W * C * 4
    return {"bytes": nbytes(depth, src, gbar, R, t, valid, K, rays)
            + out_bytes,
            "f32_flops": 2.0 * C * 4 * samples + 30.0 * samples}
