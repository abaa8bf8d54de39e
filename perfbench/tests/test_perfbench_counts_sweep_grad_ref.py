"""The count of the sweep's reference gradient (``counts/ops/
sweep_grad_ref.py``) at the stage-2 training step: B = 2, V = 4, 120x160,
D = 80, C = 64, bf16 source features."""

import pytest
import torch

from perfbench import counts

F32, BF = torch.float32, torch.bfloat16


def t(*shape, dtype=F32):
    return torch.empty(*shape, dtype=dtype, device="meta")


def test_reference_gradient_at_the_training_step():
    B, V, H, W, C, D = 2, 4, 120, 160, 64, 80
    args = (t(D), t(B, V, H, W, C, dtype=BF), t(B, H, W, D), t(B, V, 3, 3),
            t(B, V, 3), t(B, V), t(B, 3, 3), t(B, 3, H * W))
    w = counts.work("sweep_grad_ref", args)
    samples = B * H * W * D * V
    assert w["f32_flops"] == (2 * 4 * C + 30) * samples == pytest.approx(
        6.66e9, rel=1e-3)
    assert w["bytes"] == (D * 4 + B * V * H * W * C * 2 + B * H * W * D * 4
                          + B * V * 36 + B * V * 12 + B * V * 4 + B * 36
                          + B * 3 * H * W * 4 + B * H * W * C * 4)
    assert w["bytes"] == pytest.approx(42.2e6, rel=0.01)
    assert w["mma_flops"] == 0
    # bound by its operations: 6.66 GFLOP at 67 TFLOP/s
    assert counts.least_s(w) == pytest.approx(w["f32_flops"] / 67e12)
    assert counts.least_s(w) == pytest.approx(0.099e-3, rel=0.01)
