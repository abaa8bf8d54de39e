"""Each operator's bytes and operations against hand arithmetic, keyed by
the operation and its shapes; the model's FLOPs counted on the reference
on the meta device."""

import pytest
import torch

from perfbench import counts
from perfbench.counts import model_flops

BF = torch.bfloat16
F32 = torch.float32
META = torch.device("meta")


def t(*shape, dtype=F32):
    return torch.empty(*shape, dtype=dtype, device=META)


def test_cost_volume_at_the_scannet_frame():
    """Row 4 as MaGNet's frame calls it: 120x160, D = 5, V = 4, C = 64,
    bf16 features (chip_smoke's row-4 count: every input once, the output
    once; per sample 2 * 4 * (C + 2) + 60 operations)."""
    B, H, W, D, V, C = 1, 120, 160, 5, 4, 64
    args = (t(B, H, W, D), t(B, H, W, C, dtype=BF),
            t(B, V, H, W, C, dtype=BF), t(B, V, H, W, 2, dtype=BF),
            t(B, V, 3, 3), t(B, V, 3), t(B, V), t(B, 3, 3),
            t(B, 3, H * W), 5.0, V)
    w = counts.work("cost_volume_cw", args)
    inputs = (H * W * D * 4 + H * W * C * 2 + V * H * W * C * 2
              + V * H * W * 2 * 2 + V * 9 * 4 + V * 3 * 4 + V * 4 + 9 * 4
              + 3 * H * W * 4)
    assert w["bytes"] == inputs + H * W * D * 4
    assert w["f32_flops"] == H * W * D * V * (2 * 4 * 66 + 60)
    assert w["mma_flops"] == 0
    # bound by its bytes: 24.2 MB at 3.35 TB/s
    assert counts.least_s(w) == pytest.approx(w["bytes"] / 3.35e12)


def test_sweep_gradient_at_the_training_step():
    """Row 10 at the stage-2 step: B = 2, V = 4, 120x160, D = 80, C = 64
    (chip_smoke.sweep_work with every corner counted)."""
    B, V, H, W, C, D = 2, 4, 120, 160, 64, 80
    args = (t(D), t(B, H, W, C, dtype=BF), t(B, H, W, D), t(B, V, 3, 3),
            t(B, V, 3), t(B, V), t(B, 3, 3), t(B, 3, H * W))
    w = counts.work("sweep_grad_src", args)
    samples = B * H * W * D * V
    assert w["f32_flops"] == 2 * C * 4 * samples + 30 * samples
    assert w["bytes"] == (D * 4 + B * H * W * C * 2 + B * H * W * D * 4
                          + B * V * 48 + B * V * 4 + B * 36 + B * 3 * H * W * 4
                          + B * V * H * W * C * 4)


def test_decoder_conv_and_head():
    x, skip = t(5, 60, 80, 512, dtype=BF), t(5, 120, 160, 40, dtype=BF)
    w = counts.work("conv3x3_bnact", (x, skip, t(100, dtype=BF), None,
                                      t(256), t(256), True, True))
    assert w["mma_flops"] == 2 * 5 * 120 * 160 * 256 * 9 * (512 + 40)
    h = counts.work("head_chain", (t(1, 120, 160, 256, dtype=BF),
                                   [t(10, dtype=BF)] * 4, [t(128)] * 4,
                                   144, 7))
    assert h["mma_flops"] == 2 * 120 * 160 * (9 * 256 * 128 + 128 * 128 * 2
                                              + 128 * 144)


def test_float32_convs_count_outside_the_tensor_cores():
    w = counts.work("psm_conv", (t(2, 10, 10, 32), t(3, 3, 32, 64), t(64),
                                 t(64), None, 3, 2, 1, True,
                                 "downsample_block"))
    assert w["mma_flops"] == 0
    assert w["f32_flops"] == 2 * 2 * 5 * 5 * 64 * 9 * 32


def test_an_operator_without_a_count_says_so():
    assert counts.work("mbconv_block", ()) == {"uncounted": True}


def test_model_flops_on_the_meta_device():
    shape = dict(H=64, W=96, h=16, w=24, V=2, n_samples=5, n_iters=3, k=4,
                 fnet_feature_dim=64)
    frame = model_flops.frame_flops(shape)
    # G-Net alone: 3 updates at 16 x 24 of a 3x3 (5 + 256 -> 128) conv and
    # 1x1 convs 128 -> 128 -> 128 -> 2
    gnet = 3 * 2 * 16 * 24 * (9 * 261 * 128 + 2 * 128 * 128 + 128 * 2)
    assert frame > 10 * gnet
    bigger = model_flops.frame_flops(dict(shape, H=128, W=192, h=32, w=48))
    assert bigger == pytest.approx(4 * frame, rel=0.02)
    train = model_flops.train_flops(shape, 2)
    assert train > 0


# each cell's model FLOPs a unit as the harness counted them before the
# drivers brought their own count
CELL_FLOPS = {"scannet.video_b4": 2018706407040.0,
              "kitti.video_b4": 1716458530432.0,
              "scannet.train_fnet": 4079612805120.0}


@pytest.mark.parametrize("cell", sorted(CELL_FLOPS))
def test_each_driver_counts_its_cells_model_flops(cell):
    from perfbench import harness
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    _, cfg, mix, _ = harness.find(bench, cell)
    driver = harness.driver_for(cfg, mix, 1, "cpu")
    if mix["driver"] == "train":
        # the batch the flags state, as set-up parses it
        from magnet_tpu_torch.core import config
        driver.args = config.parse_args(config.build_train_fnet_parser(),
                                        cfg["train_flags"])
    assert driver.model_flops_per_unit() == CELL_FLOPS[cell]
