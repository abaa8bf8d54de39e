"""MaGNet's stage-2 training step (the F-Net) in plain PyTorch, float32.

From MaGNet's ``train_FNet.py``: the F-Net (train-mode BatchNorm over the
batch's reference and source frames) gives matching features; every
reference pixel is matched against each source view at the D fixed SID
sweep depths (projected, sampled bilinearly with zeros outside, dotted with
the reference feature), the valid views are summed and divided by their
number, the volume is softmaxed over D, its expectation over the depths is
held to the ground truth by a masked L1; the gradient is clipped
elementwise at 1e6 and then to a global norm, and AdamW (weight decay on
every parameter) takes the step at the one-cycle schedules' learning rate
and beta1 for the step count before it (optax's cosine one-cycle learning
rate with its phase boundaries at int(0.3 T) and T; torch's one-cycle
momentum in anti-phase). ``train_steps`` also returns the first step's
softmaxed cost volume, (B, h, w, D). It starts from the first step with no
moments, or from a later step count and the moments given (a step of a run
under way, followed from that run's state). Every feature that enters the
sweep is rounded as the F-Net's convolutions' operands are (the model's
precision): identity in float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from perfbench.reference.magnet import nchw, project, sample
from perfbench.reference.nets import precision_of

PRE_CLIP = 1e6
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


def sid_centers(d_min: float, d_max: float, n_bins: int) -> torch.Tensor:
    g = 1.0 - d_min
    edges = np.exp(np.log(d_max + g) * np.arange(n_bins + 1) / n_bins) - g
    return torch.from_numpy(((edges[:-1] + edges[1:]) / 2).astype(np.float32))


def onecycle_lr(step: int, peak: float, total: int, div: float,
                final_div: float, pct: float = 0.3) -> float:
    T = max(total, 4)
    bounds = [0, int(pct * T), T]
    vals = [peak / div, peak, peak / (div * final_div)]
    for i in range(2):
        if bounds[i] <= step < bounds[i + 1]:
            f = (step - bounds[i]) / (bounds[i + 1] - bounds[i])
            return vals[i + 1] + (vals[i] - vals[i + 1]) / 2 * (
                math.cos(math.pi * f) + 1)
    return vals[-1]


def onecycle_beta1(step: int, total: int, pct: float = 0.3,
                   base: float = 0.85, top: float = 0.95) -> float:
    up = float(max(pct * max(total, 1) - 1, 1))
    down = float(max(max(total, 1) - 1 - up, 1))

    def anneal(a, b, f):
        f = min(max(f, 0.0), 1.0)
        return b + (a - b) / 2 * (1 + math.cos(math.pi * f))
    if step <= up:
        return anneal(top, base, step / up)
    return anneal(base, top, (step - up) / down)


def sweep_cost(d_center, ref_feat, src_feat, R, t, is_valid, intM, rays2d):
    """(B, D, h, w) pre-softmax sweep cost divided by V. ref_feat
    (B, C, h, w); src_feat (B, V, C, h, w)."""
    B, V, C, h, w = src_feat.shape
    D = d_center.shape[0]
    d = d_center.expand(h * w, D)
    out = []
    for b in range(B):
        q = ref_feat[b].reshape(C, h * w).t()[:, None, :]
        cost = 0.0
        for v in range(V):
            grid, _ = project(intM[b], R[b, v], t[b, v], rays2d[b], d, h, w)
            cost = cost + (sample(src_feat[b, v], grid) * q).sum(-1) \
                * is_valid[b, v]
        out.append((cost / V).t().reshape(D, h, w))
    return torch.stack(out)


def loss_of(model, batch: Dict[str, torch.Tensor], d_center, max_depth,
            min_depth):
    B, V, H, W = batch["src_imgs"].shape[:4]
    imgs = torch.cat([batch["ref_img"],
                      batch["src_imgs"].reshape(B * V, H, W, 3)], 0)
    feat = precision_of(model)(model.f_net(nchw(imgs.float())))
    ref, src = feat[:B], feat[B:].reshape(B, V, *feat.shape[1:])
    cv = torch.softmax(sweep_cost(d_center, ref, src, batch["R"], batch["t"],
                                  batch["is_valid"], batch["intM"],
                                  batch["rays2d"]), 1)
    model.last_cost_volume = cv.detach().permute(0, 2, 3, 1)
    pred = (cv * d_center[None, :, None, None]).sum(1)
    gt = batch["depth_dpv"]
    gt = torch.where(gt > max_depth, torch.zeros_like(gt), gt)
    mask = (gt > min_depth).float()
    return ((pred - gt).abs() * mask).sum() / mask.sum().clamp(min=1.0)


def train_steps(model, batches: List[Dict[str, torch.Tensor]], d_center,
                opt: Dict, start: int = 0,
                moments: Optional[Tuple[Dict, Dict]] = None) -> Dict:
    """Runs one step on each batch, in order, in place on ``model``'s
    parameters, the first at step count ``start`` with Adam's ``moments``
    (first, second; by parameter name; zero where not given). ``opt``: lr,
    total_steps, div_factor, final_div_factor, weight_decay, grad_clip,
    max_depth, min_depth. Returns each step's loss and each parameter's
    first clipped gradient."""
    model.train()
    params = dict(model.named_parameters())
    if moments is None:
        m = {n: torch.zeros_like(p) for n, p in params.items()}
        v = {n: torch.zeros_like(p) for n, p in params.items()}
    else:
        m = {n: moments[0][n].clone() for n in params}
        v = {n: moments[1][n].clone() for n in params}
    losses, first_grad = [], None
    for step, batch in enumerate(batches, start):
        for p in params.values():
            p.grad = None
        loss = loss_of(model, batch, d_center, opt["max_depth"],
                       opt["min_depth"])
        loss.backward()
        losses.append(loss.item())
        if step == start:
            cost_volume = model.last_cost_volume
        grads = {n: p.grad.clamp(-PRE_CLIP, PRE_CLIP)
                 for n, p in params.items()}
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        if norm >= opt["grad_clip"]:
            grads = {n: g / norm * opt["grad_clip"] for n, g in grads.items()}
        if first_grad is None:
            first_grad = {n: g.clone() for n, g in grads.items()}
        lr = onecycle_lr(step, opt["lr"], opt["total_steps"],
                         opt["div_factor"], opt["final_div_factor"])
        b1 = onecycle_beta1(step, opt["total_steps"])
        with torch.no_grad():
            for n, p in params.items():
                g = grads[n]
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
                m_hat = m[n] / (1 - b1 ** (step + 1))
                v_hat = v[n] / (1 - ADAM_B2 ** (step + 1))
                p.mul_(1 - lr * opt["weight_decay"])
                p.sub_(lr * m_hat / (v_hat.sqrt() + ADAM_EPS))
    return {"losses": losses, "first_grad": first_grad,
            "cost_volume": cost_volume}

