"""The model's FLOPs at a cell's shapes, counted on the plain reference.

``torch.utils.flop_counter.FlopCounterMode`` counts the convolutions and
matrix products of ``reference`` run on the meta device (no memory, no
time): ``frame_flops`` one forward of one reference frame with its V
source views (the D-Net and F-Net on the V + 1 frames, the mask head and
n_iters G-Net updates; the cost volume's gathers and the elementwise work
are not counted, as a model FLOP count leaves them out), ``train_flops``
one stage-2 step of the configured batch, forward and backward. The count
does not change with the implementation under test.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference import nets

META = torch.device("meta")


def _count(fn) -> float:
    mode = FlopCounterMode(display=False)
    with mode:
        fn()
    return float(mode.get_total_flops())


def frame_flops(shape: dict) -> float:
    H, W, h, w, V = (shape[k] for k in ("H", "W", "h", "w", "V"))
    D, n_iters = shape["n_samples"], shape["n_iters"]
    with META:
        model = nets.Magnet(D, shape["fnet_feature_dim"], shape["k"]).eval()
        imgs = torch.empty(V + 1, 3, H, W)
        cv = torch.empty(1, D, h, w)
        prev = torch.empty(1, 2, h, w)

    def run():
        with torch.no_grad():
            _, feat = model.d_net(imgs)
            model.f_net(imgs)
            model.mask_head(feat[:1])
            for _ in range(n_iters):
                model.g_net(cv, feat[:1], prev)
    return _count(run)


def train_flops(shape: dict, batch: int) -> float:
    H, W, V = shape["H"], shape["W"], shape["V"]
    with META:
        model = nets.MagnetF(shape["fnet_feature_dim"]).train()
        imgs = torch.empty(batch * (V + 1), 3, H, W)

    def run():
        model.f_net(imgs).sum().backward()
    return _count(run)
