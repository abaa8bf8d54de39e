"""MaGNet: the multi-view fusion pipeline, PyTorch.

Counterpart of ``magnet_tpu/models/magnet.py``:
  1. ``encode``: D-Net and F-Net on the reference and source frames in one
     batched pass, frozen (no autograd, eval mode);
  2. ``fuse``: N refinement steps, each sampling per-pixel depth candidates
     mu + sigma * k from the current Gaussian (k from the inverse normal CDF,
     equal-probability bins within +-beta), building the consistency-weighted
     cost volume and applying the G-Net update; then learned convex
     upsampling of every post-initial prediction with one mask predicted
     from the D-Net decoder feature.
On the card each refinement step is two kernel launches
(``kernels.cost_volume_cw``, ``kernels.gnet_update``), the mask head and
G-Net's feature term go through ``kernels.head_chain``, and the upsamplings
of all the iterations are one launch of ``kernels.upsample_mask``.

Training (stage 3) trains G-Net and the mask head alone: ``Magnet.train()``
leaves the D-Net and F-Net in eval mode, so ``encode`` still runs their
kernels; G-Net and the mask head then run plain convs with autograd, the
cost volume (row 4's kernel) sees the previous prediction detached, and the
upsampling's backward is ``kernels.upsample_mask``'s kernel. The streaming
path (``eval/streaming.py``) calls ``encode`` once a frame and ``fuse`` once
a window.

Parameter names give the reference checkpoint layout: ``d_net.d_net.*``,
``f_net.f_net.*``, ``g_net.gnet.{0,2,4,6}``, ``mask_head.{0,2,4,6}``.

``MagnetF`` is the F-Net training head (stage 2): the matching features of
the reference and source frames and the fixed plane-sweep cost volume over
``sid_depth_centers``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from magnet_tpu_torch.kernels import cost_volume_cw as cvk
from magnet_tpu_torch.models.dnet import DNetCoarse
from magnet_tpu_torch.models.fnet import FNet
from magnet_tpu_torch.nn.densedepth import run_head
from magnet_tpu_torch.nn.gnet import GNet
from magnet_tpu_torch.ops.costvolume import cost_volume_sweep
from magnet_tpu_torch.ops.upsample import upsample_via_mask
from magnet_tpu_torch.utils.profiling import stage


def gaussian_sampling_offsets(sampling_range: float,
                              n_samples: int) -> np.ndarray:
    """k_list: bin centres (in sigma units) of n equal-probability bins of
    N(0, 1) truncated to +-sampling_range."""
    from scipy.special import erf
    from scipy.stats import norm
    p_total = erf(sampling_range / np.sqrt(2))
    idx = np.arange(0, n_samples + 1)
    p_list = (1 - p_total) / 2 + (idx / n_samples) * p_total
    k_list = norm.ppf(p_list)
    return ((k_list[1:] + k_list[:-1]) / 2).astype(np.float32)


def parse_weighting(weighting: str) -> float:
    """'CW5' -> kappa = 5.0."""
    if not weighting.startswith("CW"):
        raise ValueError(f"unsupported mvs weighting {weighting!r}")
    return float(weighting[2:])


def magnet_mask_head(in_ch: int, out_ch: int, hidden: int = 128
                     ) -> nn.Sequential:
    """MaGNet's mask head: conv3x3 -> ReLU -> three 1x1 convs with ReLU
    between them (one conv deeper than the D-Net decoder's mask head)."""
    return nn.Sequential(
        nn.Conv2d(in_ch, hidden, 3, padding=1), nn.ReLU(),
        nn.Conv2d(hidden, hidden, 1), nn.ReLU(),
        nn.Conv2d(hidden, hidden, 1), nn.ReLU(),
        nn.Conv2d(hidden, out_ch, 1))


class Magnet(nn.Module):
    """Inputs NHWC; poses and intrinsics as in ``kernels.cost_volume_cw``.
    ``mbconv_chain`` and ``dw_kernel`` switch the D-Net trunk's kernels
    (``nn.efficientnet``), ``stream_blocks`` the F-Net's one-launch
    BasicBlocks (``nn.psmnet``)."""

    def __init__(self, output_dim: int = 2, downsample_ratio: int = 4,
                 fnet_feature_dim: int = 64, sampling_range: float = 3.0,
                 n_samples: int = 5, mvs_weighting: str = "CW5",
                 n_iters: int = 3, dnet_feature_dim: int = 256,
                 mbconv_chain=None, dw_kernel: bool = False,
                 stream_blocks: bool = False):
        super().__init__()
        self.downsample_ratio = downsample_ratio
        self.n_iters = n_iters
        self.kappa = parse_weighting(mvs_weighting)
        self.d_net = DNetCoarse(output_dim, downsample_ratio, mbconv_chain,
                                dw_kernel)
        self.f_net = FNet(feature_dim=fnet_feature_dim,
                          stream_blocks=stream_blocks)
        self.g_net = GNet(n_samples, dnet_feature_dim)
        self.mask_head = magnet_mask_head(dnet_feature_dim,
                                          9 * downsample_ratio ** 2)
        self.register_buffer(
            "k_list", torch.from_numpy(gaussian_sampling_offsets(
                sampling_range, n_samples)), persistent=False)

    def train(self, mode: bool = True) -> "Magnet":
        """G-Net and the mask head follow ``mode``; the D-Net and F-Net stay
        in eval mode, frozen as the JAX package's ``_frozen`` backbones
        are."""
        super().train(mode)
        self.d_net.eval()
        self.f_net.eval()
        return self

    @torch.no_grad()
    def encode(self, imgs: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """imgs: (N, H, W, 3) -> coarse (mu, sigma) (N, h, w, 2), the
        decoder feature (N, h, w, 256), the matching feature (N, h, w, F);
        no gradient reaches the backbones (the JAX package's
        stop_gradient)."""
        gauss, feat_d = self.d_net(imgs)
        return gauss, feat_d, self.f_net(imgs)

    def fuse(self, ref_gauss: torch.Tensor, x_d3: torch.Tensor,
             ref_feat: torch.Tensor, src_gauss: torch.Tensor,
             src_feat: torch.Tensor, src_R: torch.Tensor,
             src_t: torch.Tensor, is_valid: torch.Tensor,
             intM: torch.Tensor, rays2d: torch.Tensor,
             n_iters: Optional[int] = None) -> List[torch.Tensor]:
        """ref_gauss: (B, h, w, 2); x_d3: (B, h, w, 256); ref_feat:
        (B, h, w, F); src_gauss: (B, V, h, w, 2); src_feat: (B, V, h, w, F).
        Returns the n_iters upsampled (B, H, W, 2) (mu, sigma) maps."""
        n_iters = self.n_iters if n_iters is None else n_iters
        src_mu = src_gauss[..., 0].float()
        src_sigma = src_gauss[..., 1].float()
        # the cost volume's (mu, sigma) pairs do not change either
        ops = cvk.cv_operands(src_mu, src_sigma, src_feat.dtype)
        # G-Net's feature term does not change over the iterations.
        feat_contrib = self.g_net.precompute_feature(x_d3)
        preds = [ref_gauss]
        for _ in range(n_iters):
            # the previous prediction is detached, as in the JAX package
            prev = preds[-1].detach()
            d_volume = (prev[..., 0:1].float()
                        + prev[..., 1:2].float() * self.k_list)
            cv = cvk.cost_volume_cw(d_volume, ref_feat, src_feat, src_mu,
                                    src_sigma, src_R, src_t, is_valid, intM,
                                    rays2d, self.kappa, ops)
            preds.append(self.g_net(cv, feat_contrib, prev))
        mask = run_head(self.mask_head, x_d3)
        return upsample_via_mask(preds[1:], mask, self.downsample_ratio)

    def forward(self, ref_img: torch.Tensor, src_imgs: torch.Tensor,
                src_R: torch.Tensor, src_t: torch.Tensor,
                is_valid: torch.Tensor, intM: torch.Tensor,
                rays2d: torch.Tensor, n_iters: Optional[int] = None
                ) -> List[torch.Tensor]:
        """ref_img: (B, H, W, 3); src_imgs: (B, V, H, W, 3); src_R:
        (B, V, 3, 3); src_t: (B, V, 3); is_valid: (B, V); intM: (B, 3, 3);
        rays2d: (B, 3, h*w) at cost-volume resolution."""
        B, V, H, W = src_imgs.shape[:4]
        imgs = torch.cat([ref_img, src_imgs.reshape(B * V, H, W, 3)], 0)
        gauss, feat_d, feat_m = self.encode(imgs)
        return self.fuse(
            gauss[:B], feat_d[:B].contiguous(), feat_m[:B],
            gauss[B:].reshape(B, V, *gauss.shape[1:]),
            feat_m[B:].reshape(B, V, *feat_m.shape[1:]),
            src_R, src_t, is_valid, intM, rays2d, n_iters)


class MagnetF(nn.Module):
    """F-Net training head: features + fixed-sweep cost volume
    (MAGNET.py:179-202). Inputs as in ``Magnet.forward``; d_center: (D,)
    sweep depths. Returns the (B, h, w, D) cost volume, softmaxed over D.
    Train mode trains the F-Net (``nn.psmnet``; ``remat`` recomputes its
    blocks in the backward); eval mode runs its kernels."""

    def __init__(self, fnet_feature_dim: int = 64, remat: bool = False):
        super().__init__()
        self.f_net = FNet(feature_dim=fnet_feature_dim, remat=remat)

    def forward(self, ref_img: torch.Tensor, src_imgs: torch.Tensor,
                src_R: torch.Tensor, src_t: torch.Tensor,
                is_valid: torch.Tensor, intM: torch.Tensor,
                rays2d: torch.Tensor, d_center: torch.Tensor) -> torch.Tensor:
        B, V, H, W = src_imgs.shape[:4]
        with stage("F-Net forward"):
            feat = self.f_net(
                torch.cat([ref_img, src_imgs.reshape(B * V, H, W, 3)], 0))
        with stage("sweep forward + softmax"):
            return cost_volume_sweep(d_center, feat[:B],
                                     feat[B:].reshape(B, V, *feat.shape[1:]),
                                     src_R, src_t, is_valid, intM, rays2d)


def sid_depth_centers(d_min: float, d_max: float, n_bins: int) -> np.ndarray:
    """DORN-style SID sweep depths of F-Net training (train_FNet.py:55-65):
    bin centres of exp(log(d_max + g) * i / N) - g with shift g = 1 - d_min,
    i = 0..N; f32."""
    g = 1.0 - d_min
    idx = np.arange(n_bins + 1)
    edges = np.exp(np.log(d_max + g) * idx / n_bins) - g
    return ((edges[:-1] + edges[1:]) / 2).astype(np.float32)
