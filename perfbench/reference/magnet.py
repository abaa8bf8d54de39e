"""MaGNet's inference forward in plain PyTorch, float32.

From the MaGNet paper (Bae, Budvytis and Cipolla, CVPR 2022) and its
flag files: the D-Net gives each frame a coarse Gaussian (mu, sigma) and a
decoder feature, the F-Net a matching feature; then ``n_iters`` times the
reference frame's depth candidates mu + sigma * k (k the centres of
``n_samples`` equal-probability bins of N(0, 1) within +-``sampling_range``)
are projected into each source view, matched against its feature and
weighted by whether the candidate is consistent with the view's own
Gaussian (|z - mu_src| < kappa * sigma_src), averaged over the views, and
G-Net updates the Gaussian; each update is upsampled by learned convex
upsampling with one mask from the reference frame's decoder feature.

Inputs are NHWC as the program takes them; outputs are the ``n_iters``
upsampled (B, H, W, 2) maps. Sampling is bilinear with zeros outside the
map (``grid_sample``, align_corners False); normalised coordinates are
clipped to +-10 and the projection's divisor carries 1e-10, as MaGNet
computes them.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

EPS_DIV = 1e-10
COORD_CLIP = 10.0


def sampling_offsets(sampling_range: float, n_samples: int) -> torch.Tensor:
    """The bin centres k (in sigma units), float32."""
    r = torch.tensor(float(sampling_range), dtype=torch.float64)
    p_total = torch.erf(r / np.sqrt(2.0))
    p = (1 - p_total) / 2 + torch.arange(n_samples + 1) / n_samples * p_total
    k = torch.special.ndtri(p)
    return ((k[1:] + k[:-1]) / 2).float()


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


def project(K, R, t, rays, d, H, W):
    """K, R (3, 3); t (3,); rays (3, N); d (N, D) -> grid (N, D, 2) in
    normalised coordinates and z (N, D), the depth in the source camera."""
    rr = R @ rays
    p = (K @ t)[:, None, None] + (K @ rr)[:, :, None] * d[None]
    z = t[2] + rr[2][:, None] * d
    denom = p[2] + EPS_DIV
    gx = ((p[0] / denom - W / 2.0) / (W / 2.0)).clamp(-COORD_CLIP, COORD_CLIP)
    gy = ((p[1] / denom - H / 2.0) / (H / 2.0)).clamp(-COORD_CLIP, COORD_CLIP)
    return torch.stack([gx, gy], -1), z


def sample(maps: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """maps (C, H, W) sampled at grid (N, D, 2) -> (N, D, C)."""
    out = F.grid_sample(maps[None], grid[None], mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out[0].permute(1, 2, 0)


def cost_volume(d_volume, ref_feat, src_feat, src_gauss, R, t, is_valid,
                intM, rays2d, kappa):
    """One frame's consistency-weighted cost volume. d_volume (h, w, D);
    ref_feat (C, h, w); src_feat (V, C, h, w); src_gauss (V, 2, h, w);
    R (V, 3, 3); t (V, 3); is_valid (V,); intM (3, 3); rays2d (3, h*w).
    Returns (D, h, w)."""
    h, w, D = d_volume.shape
    V, C = src_feat.shape[:2]
    d = d_volume.reshape(h * w, D)
    q = ref_feat.reshape(C, h * w).t()[:, None, :]
    cost = torch.zeros(h * w, D, device=d.device)
    for v in range(V):
        grid, z = project(intM, R[v], t[v], rays2d, d, h, w)
        s = sample(torch.cat([src_feat[v], src_gauss[v]], 0), grid)
        dot = (s[..., :C] * q).sum(-1)
        consistent = (z - s[..., C]).abs() < kappa * s[..., C + 1]
        cost = cost + dot * consistent * is_valid[v]
    return (cost / V).t().reshape(D, h, w)


def convex_upsample(x: torch.Tensor, mask: torch.Tensor, k: int):
    """x (N, C, h, w), mask (N, 9 k k, h, w) -> (N, C, k h, k w)."""
    N, C, h, w = x.shape
    m = mask.view(N, 1, 9, k, k, h, w).softmax(dim=2)
    u = F.unfold(x, [3, 3], padding=1).view(N, C, 9, 1, 1, h, w)
    out = (m * u).sum(2).permute(0, 1, 4, 2, 5, 3)
    return out.reshape(N, C, k * h, k * w)


@torch.no_grad()
def encode(model, ref_img, src_imgs, feature: bool = True):
    """One frame of the batch: its V + 1 images (reference first), NHWC,
    through the D-Net and the F-Net. Returns the coarse (mu, sigma), the
    decoder feature and the matching feature, NCHW; with ``feature``
    False only the coarse (mu, sigma), from the D-Net alone."""
    imgs = nchw(torch.cat([ref_img[None], src_imgs], 0).float())
    gauss, feat_d = model.d_net(imgs)
    if not feature:
        return gauss
    return gauss, feat_d, model.f_net(imgs)


@torch.no_grad()
def fuse(model, gauss, feat_d, feat_m, R, t, is_valid, intM, rays2d,
         n_iters: int, kappa: float, k_list: torch.Tensor,
         k: int = 4) -> List[torch.Tensor]:
    """One frame's fusion from its encodings (``encode``'s, NCHW, the
    reference frame first) and its geometry as the program takes it.
    Returns the ``n_iters`` upsampled (H, W, 2) maps. Every map and feature
    it keeps between steps is rounded as its convolutions' operands are
    (``model``'s precision): identity in float32."""
    keep = model.g_net.gnet[0].prec
    prev = keep(gauss[:1].float())
    feat_d, feat_m = keep(feat_d.float()), keep(feat_m.float())
    src_gauss = keep(gauss[1:].float())
    mask = keep(model.mask_head(feat_d[:1]))
    outs = []
    for _ in range(n_iters):
        d_volume = (nhwc(prev[:, 0:1]) + nhwc(prev[:, 1:2]) * k_list)[0]
        cv = cost_volume(d_volume, feat_m[0], feat_m[1:], src_gauss,
                         R.float(), t.float(), is_valid.float(),
                         intM.float(), rays2d.float(), kappa)
        prev = keep(model.g_net(keep(cv[None]), feat_d[:1], prev))
        outs.append(keep(nhwc(convex_upsample(prev, mask, k))[0]))
    return outs


def forward(model, ref_img, src_imgs, R, t, is_valid, intM, rays2d,
            n_iters: int, kappa: float, k_list: torch.Tensor,
            k: int = 4) -> List[torch.Tensor]:
    """``nets.Magnet``'s forward, one frame of the batch at a time so that
    it fits. ref_img (B, H, W, 3); src_imgs (B, V, H, W, 3); the geometry as
    the program takes it. Returns the ``n_iters`` (B, H, W, 2) maps."""
    outs = [[] for _ in range(n_iters)]
    for b in range(ref_img.shape[0]):
        maps = fuse(model, *encode(model, ref_img[b], src_imgs[b]), R[b],
                    t[b], is_valid[b], intM[b], rays2d[b], n_iters, kappa,
                    k_list, k)
        for it, m in enumerate(maps):
            outs[it].append(m)
    return [torch.stack(o) for o in outs]
