"""The source features' gradient of the sweep: per (pixel, plane, view)
sample the projection (about 30 operations) and a multiply-add per channel
at each of 4 corners (chip_smoke's row-10 count, all corners counted)."""

from perfbench.counts import nbytes


def work(depth, ref, gbar, R, t, valid, K, rays):
    B, H, W, C = ref.shape
    V, D = R.shape[1], depth.shape[0]
    samples = B * H * W * D * V
    out_bytes = B * V * H * W * C * 4
    return {"bytes": nbytes(depth, ref, gbar, R, t, valid, K, rays)
            + out_bytes,
            "f32_flops": 2.0 * C * 4 * samples + 30.0 * samples}
