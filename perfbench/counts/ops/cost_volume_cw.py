"""The consistency-weighted cost volume: per (pixel, candidate, view) a
projection (about 60 operations with the consistency test) and a bilinear
sample of C + 2 channels at 4 corners, dotted with the reference feature
(chip_smoke's row-4 count, every view valid as the traffic has them)."""

from perfbench.counts import nbytes


def work(d, ref, src, ms, R, t, valid, K, rays, kappa, v_total):
    B, H, W, D = d.shape
    V, C = src.shape[1], src.shape[-1]
    samples = B * H * W * D * V
    out_bytes = B * H * W * D * 4
    return {"bytes": nbytes(d, ref, src, ms, R, t, valid, K, rays)
            + out_bytes,
            "f32_flops": samples * (2.0 * 4 * (C + 2) + 60)}
