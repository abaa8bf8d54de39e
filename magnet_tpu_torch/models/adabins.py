"""AdaBins: single-image depth as a softmax over adaptive bins, PyTorch.

The model of Bhat, Alhashim and Wonka (CVPR 2021, arXiv:2011.14141),
``UnetAdaptiveBins`` in the published ``models/unet_adaptive_bins.py``:

* ``encoder``: the ``tf_efficientnet_b5_ap`` trunk, MaGNet's
  (``nn/densedepth.py::Encoder``), whose taps f4, f5, f6, f8 and f11 are
  the published features 4, 5, 6, 8 and 11;
* ``decoder`` (``DecoderBN(num_classes=128)``): a 1x1 ``conv2`` with
  padding 1 as published (its (H/32 + 2) x (W/32 + 2) output has a ring of
  bias alone), up1-up4 (``nn/densedepth.py::UpSampleBN``: up2 and up3 on
  the conv kernel, up1 and up4 plain) and a 3x3 ``conv3``: the feature u,
  (B, H/2, W/2, 128);
* ``adaptive_bins_layer`` (``nn/vit.py::MiniViT``): from u, the
  normalised widths of ``n_bins`` bins and 128 queries;
* the bins head: ``conv3x3`` of u, its dot product with each query at
  every pixel (the range-attention maps), the 1x1 ``conv_out`` to
  ``n_bins`` logits, their softmax, and the depth as the probabilities'
  weighted sum of the bin centres.

``forward(x (B, H, W, 3) NHWC)`` returns ``(bin_edges (B, n_bins + 1),
depth (B, H/2, W/2))``, both float32: the widths times (max - min),
left-padded with min, summed into edges; the centres are their midpoints.
Flip averaging and the resize to the input's size are the evaluation's
(``test_adabins.py``), as in the published ``evaluate.py``.

Precision under a bf16 cast (``models/build.py::cast_for_inference``):
convolutions and matrix products in bf16; LayerNorm's statistics, the
widths, their cumulative sum, the softmax over the bins and the weighted
sum of the centres in float32. The forward reads nothing back to the
host. Spans (``utils/profiling.stage``): "AdaBins forward" around
"AdaBins trunk", "AdaBins decoder" (conv2 to conv3), "mViT" (patch
embedding to bin edges) and "bins head".

Parameter names give the published state-dict keys: ``encoder.
original_model.*``, ``decoder.{conv2, up1..up4._net.{0,1,3,4}, conv3}``,
``adaptive_bins_layer.*`` (``nn/vit.py``) and ``conv_out.0``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from magnet_tpu_torch.nn.densedepth import Encoder, UpSampleBN
from magnet_tpu_torch.nn.layers import conv2d, nchw, nhwc
from magnet_tpu_torch.nn.vit import MiniViT
from magnet_tpu_torch.utils.profiling import stage


class DecoderBN(nn.Module):
    """conv2 (1x1, padding 1), up1-up4, conv3 (3x3): the taps to u."""

    def __init__(self, num_features: int = 2048, num_classes: int = 128,
                 bottleneck_features: int = 2048):
        super().__init__()
        f = num_features
        self.conv2 = nn.Conv2d(bottleneck_features, f, 1, padding=1)
        self.up1 = UpSampleBN(f + 176, f // 2)
        self.up2 = UpSampleBN(f // 2 + 64, f // 4)
        self.up3 = UpSampleBN(f // 4 + 40, f // 8)
        self.up4 = UpSampleBN(f // 8 + 24, f // 16)
        self.conv3 = nn.Conv2d(f // 16, num_classes, 3, padding=1)

    def forward(self, feats: List[torch.Tensor]) -> torch.Tensor:
        """feats: the trunk's taps, NCHW -> u (B, H/2, W/2, num_classes)."""
        f4, f5, f6, f8, f11 = feats
        y = nhwc(conv2d(f11, self.conv2))
        for up, skip in ((self.up1, f8), (self.up2, f6), (self.up3, f5),
                         (self.up4, f4)):
            y = up(y, nhwc(skip))
        return nhwc(conv2d(nchw(y), self.conv3))


class AdaBins(nn.Module):
    def __init__(self, n_bins: int = 256, min_depth: float = 1e-3,
                 max_depth: float = 80.0,
                 mbconv_chain: Union[None, str, Sequence[int]] = None,
                 dw_kernel: bool = False):
        super().__init__()
        self.min_depth, self.max_depth = min_depth, max_depth
        self.encoder = Encoder(mbconv_chain, dw_kernel)
        self.adaptive_bins_layer = MiniViT(128, n_query_channels=128,
                                           patch_size=16, dim_out=n_bins,
                                           embedding_dim=128)
        self.decoder = DecoderBN(num_classes=128)
        self.conv_out = nn.Sequential(nn.Conv2d(128, n_bins, 1))

    def bin_edges(self, normed: torch.Tensor) -> torch.Tensor:
        """(B, n_bins) normalised widths -> (B, n_bins + 1) f32 edges."""
        widths = (self.max_depth - self.min_depth) * normed.float()
        widths = F.pad(widths, (1, 0), value=self.min_depth)
        return torch.cumsum(widths, dim=1)

    def bins_head(self, u: torch.Tensor, queries: torch.Tensor,
                  edges: torch.Tensor) -> torch.Tensor:
        """u (B, h, w, C), queries (B, Q, C), edges (B, n + 1) -> the depth
        (B, h, w) f32."""
        v = nhwc(conv2d(nchw(u), self.adaptive_bins_layer.conv3x3))
        B, h, w, C = v.shape
        r = torch.bmm(v.view(B, h * w, C), queries.transpose(1, 2))
        logits = nhwc(conv2d(nchw(r.view(B, h, w, -1)), self.conv_out[0]))
        p = torch.softmax(logits, dim=-1, dtype=torch.float32)
        centres = 0.5 * (edges[:, :-1] + edges[:, 1:])
        return torch.bmm(p.view(B, h * w, -1), centres[:, :, None]).view(
            B, h, w)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        with stage("AdaBins forward"):
            with stage("AdaBins trunk"):
                feats = self.encoder(nchw(x))
            with stage("AdaBins decoder"):
                u = self.decoder(feats)
            with stage("mViT"):
                normed, queries = self.adaptive_bins_layer(u)
                edges = self.bin_edges(normed)
            with stage("bins head"):
                depth = self.bins_head(u, queries, edges)
        return edges, depth
