"""Seeded inputs: frames of a recorded scan, their cameras and depths.

Everything is drawn on the device from one ``torch.Generator`` in a few
large calls:

* images: smooth colour textures (coarse noise at 1/32 and 1/8 of the size,
  upsampled bilinearly and summed), scaled to the spread of
  ImageNet-normalised photographs, NHWC float32;
* each source view's pose relative to its reference frame: a rotation of
  ``rot_rad`` radians' standard deviation about a random axis and a
  translation of ``trans_m`` metres' standard deviation per axis, plus
  ``forward_m`` metres along the optical axis times the view's signed
  distance in frames (a car's motion); every view valid;
* the camera (``fx``, ``fy``, ``cx``, ``cy`` at the input size) as the
  program takes it: ``intM`` scaled to the cost volume's size and
  ``rays2d``, the rays through the cost volume's pixel centres;
* ground-truth depth at the cost volume's size (training): a smooth field
  around a mean drawn per sample between ``depth_m`` bounds.

``frame_set(...)`` gives one batch: B reference frames and their V source
views with the geometry; the same seed gives the same sets.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def _smooth(g, n, c, h, w, device):
    out = 0.0
    for div, amp in ((32, 1.0), (8, 0.5)):
        coarse = torch.randn(n, c, max(2, h // div), max(2, w // div),
                             generator=g, device=device)
        out = out + amp * F.interpolate(coarse, size=(h, w), mode="bilinear",
                                        align_corners=True)
    return out


def images(g, n, h, w, device) -> torch.Tensor:
    """(n, h, w, 3) float32 smooth textures of unit spread."""
    return (_smooth(g, n, 3, h, w, device) / 1.118).permute(0, 2, 3, 1)


def rotations(g, n, rot_rad, device) -> torch.Tensor:
    """(n, 3, 3) rotations (Rodrigues) about random axes."""
    w = torch.randn(n, 3, generator=g, device=device) * rot_rad
    th = w.norm(dim=1).clamp(min=1e-12)[:, None, None]
    z = torch.zeros(n, device=device)
    K = torch.stack([z, -w[:, 2], w[:, 1], w[:, 2], z, -w[:, 0],
                     -w[:, 1], w[:, 0], z], 1).view(n, 3, 3)
    eye = torch.eye(3, device=device).expand(n, 3, 3)
    return eye + torch.sin(th) / th * K + (1 - torch.cos(th)) / th ** 2 * (
        K @ K)


def camera(cam: Dict, H, W, h, w, device):
    """intM (3, 3) at the cost volume's size, rays2d (3, h*w)."""
    sx, sy = w / W, h / H
    intM = torch.tensor([[cam["fx"] * sx, 0, cam["cx"] * sx],
                         [0, cam["fy"] * sy, cam["cy"] * sy], [0, 0, 1.0]],
                        device=device)
    v, u = torch.meshgrid(torch.arange(h, device=device) + 0.5,
                          torch.arange(w, device=device) + 0.5,
                          indexing="ij")
    rays = torch.stack([(u / sx - cam["cx"]) / cam["fx"],
                        (v / sy - cam["cy"]) / cam["fy"],
                        torch.ones_like(u)]).reshape(3, h * w)
    return intM, rays


def frame_set(g, B, V, shape: Dict, cam: Dict, motion: Dict, device,
              depth_m=None) -> Dict[str, torch.Tensor]:
    """One batch as the program's step takes it, float32 on ``device``:
    ref_img (B, H, W, 3), src_imgs (B, V, H, W, 3), R (B, V, 3, 3),
    t (B, V, 3), is_valid (B, V), intM (B, 3, 3), rays2d (B, 3, h*w), and
    with ``depth_m`` = (low, high) depth_dpv (B, h, w)."""
    H, W, h, w = shape["H"], shape["W"], shape["h"], shape["w"]
    imgs = images(g, B * (V + 1), H, W, device)
    R = rotations(g, B * V, motion["rot_rad"], device).view(B, V, 3, 3)
    t = torch.randn(B, V, 3, generator=g, device=device) * motion["trans_m"]
    # source views on both sides of the reference: -1, +1, -2, +2, ...
    step = torch.tensor([(i // 2 + 1) * (1 if i % 2 else -1)
                         for i in range(V)], device=device, dtype=t.dtype)
    t[..., 2] += motion["forward_m"] * step
    intM, rays = camera(cam, H, W, h, w, device)
    out = {"ref_img": imgs[:B].contiguous(),
           "src_imgs": imgs[B:].reshape(B, V, H, W, 3).contiguous(),
           "R": R.contiguous(), "t": t.contiguous(),
           "is_valid": torch.ones(B, V, device=device),
           "intM": intM.expand(B, 3, 3).contiguous(),
           "rays2d": rays.expand(B, 3, h * w).contiguous()}
    if depth_m is not None:
        lo, hi = depth_m
        mean = lo + (hi - lo) * torch.rand(B, 1, 1, generator=g,
                                           device=device)
        field = _smooth(g, B, 1, h, w, device)[:, 0] * 0.25 * mean
        out["depth_dpv"] = (mean + field).clamp(lo / 2, hi)
    return out
