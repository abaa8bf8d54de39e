#!/usr/bin/env python3
"""Phase 13 of chip_smoke.py (the stage-3 step against its f32 references)
from several fresh states, on one NVIDIA GPU.

    python3 chip_smoke_phase13.py N [--out readings.json]

Builds the kernels, then N times: phase 8 (F-Net training), phase 12 (D-Net
training) and phase 13's one-step check on a MaGNet built from those two
checkpoints, each time in a new experiment directory (phase 13's own three
training steps, which change no checkpoint the check reads, are left out).
Row 10's atomics and cuDNN's backward make each run's trained state
another, and phase 13's readings depend on that state. Prints each check's
readings as chip_smoke.py does, writes them with the mask head's
cancellation (each gradient's largest sum of |terms| over its max|g|) to
``--out``, and exits 1 if phase 13's check failed in any state.

Each state also places the bf16 step's mask-head gradients and the gate's
f32 reference against f64 steps on the bf16 step's coarse maps and decoder
feature (not a gate): the f64 step alone, then with the bf16 step's
roundings added one by one (the upsampled maps before the loss, the head's
weights and conv outputs, both), and the f64 backward of the head from the
bf16 step's own mask-logit gradient, through the exactly rounded forward
and through the bf16 step's own conv outputs. It also reads how those
outputs differ from the exactly rounded ones, the mask-logit gradients'
differences, and the share of the upstream gradient that the largest
0.01 % and 1 % of the fine pixels carry.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import torch
import torch.nn.functional as F

import chip_smoke as cs
from magnet_tpu_torch.models import magnet as magnet_module


def bf16_step_operands(margs) -> tuple:
    """Phase 13's model, batch and bf16 step (as ``check_magnet_train_step``
    builds them), with what that step gave the mask head and the upsampling:
    its coarse maps, its decoder feature, its mask logits and their
    gradient, and its gradients of the upsampled maps."""
    model = cs.build_magnet_train(margs, "cuda")
    with torch.no_grad():
        model.g_net.gnet[6].weight.mul_(0.05)
    raw = cs.base.collate([cs.SyntheticMultiView(margs).get(i)
                           for i in range(cs.MAGNET_TRAIN_B)])
    batch = cs.train_magnet.batch_to_device(raw, "cuda")
    return (model, batch) + capture_bf16_step(model, batch, margs)


def capture_bf16_step(model, batch: dict, margs) -> tuple:
    """The bf16 step of ``bf16_step_operands`` on ``model`` and ``batch``."""
    coarse, feat, fine, logits, convs = [], [], [], [], []

    def upsample(maps, mask, k):
        mask.retain_grad()
        logits.append(mask)
        out = cs.upsample_via_mask(maps, mask, k)
        for p in out:
            p.retain_grad()
        fine.extend(out)
        return out
    hooks = [model.g_net.register_forward_hook(
                 lambda m, inputs, out: coarse.append(out.detach())),
             model.d_net.register_forward_hook(
                 lambda m, inputs, out: feat.append(
                     out[1].detach()))]
    hooks += [m.register_forward_hook(
                  lambda m, inputs, out: convs.append(inputs[0].detach()))
              for m in model.mask_head if isinstance(m, torch.nn.ReLU)]
    magnet_module.upsample_via_mask = upsample
    try:
        bf16 = cs.magnet_step_grads(model, batch, margs, torch.bfloat16)
    finally:
        magnet_module.upsample_via_mask = cs.upsample_via_mask
        for h in hooks:
            h.remove()
    return (cs.only(bf16, "mask_head."), coarse, feat[0][:len(coarse[0])],
            logits[0].detach(), logits[0].grad.detach(),
            [p.grad.detach() for p in fine],
            convs + [cs.nchw(logits[0].detach())])


def r16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 in the forward, the identity in the backward."""
    return t + (t.to(torch.bfloat16).to(t.dtype) - t).detach()


def upsample64(maps: list, logits: torch.Tensor, k: int) -> list:
    """Convex upsampling in f64, as ``upsample_mask_ref`` computes it in
    f32."""
    B, H, W = logits.shape[:3]
    w = logits.reshape(B, H, W, 9, k, k).softmax(3)
    outs = []
    for d in maps:
        C = d.shape[-1]
        nb = F.unfold(d.permute(0, 3, 1, 2), 3, padding=1)
        nb = nb.reshape(B, C, 9, H, W).permute(0, 3, 4, 2, 1)
        outs.append(torch.einsum("bhwjkl,bhwjc->bhkwlc", w, nb).reshape(
            B, H * k, W * k, C))
    return outs


def loss64(preds: list, depth: torch.Tensor, args) -> torch.Tensor:
    """``losses.magnet_loss`` on the clamped ground truth, in f64."""
    gt, mask = cs.steps._clamped_gt(depth.double(), args.max_depth,
                                    args.min_depth)
    m, n, loss = mask.double(), len(preds), 0.0
    for i, p in enumerate(preds):
        var = torch.clamp(torch.square(p[..., 1]), min=1e-10)
        nll = torch.square(p[..., 0] - gt) / (2.0 * var) + 0.5 * torch.log(
            var)
        loss = loss + args.loss_gamma ** (n - i - 1) * torch.sum(
            nll * m) / torch.clamp(torch.sum(m), min=1.0)
    return loss


def head64(model, x: torch.Tensor, head16: bool, actual=None,
           outs=None) -> tuple:
    """The mask head in f64 on x (NHWC): its parameters as f64 leaves and
    the logits; with ``head16`` each weight, bias and conv output is
    rounded to bf16 as the bf16 step's convs give them. With ``actual``
    (the bf16 step's conv outputs, NCHW) those are the forward values, the
    gradients flowing through the f64 convs. ``outs`` collects the conv
    outputs."""
    params, y = {}, cs.nchw(x.double())
    actual = None if actual is None else list(actual)
    for i, m in enumerate(model.mask_head):
        if isinstance(m, torch.nn.Conv2d):
            w = m.weight.detach().double().requires_grad_()
            b = m.bias.detach().double().requires_grad_()
            params[f"mask_head.{i}.weight"] = w
            params[f"mask_head.{i}.bias"] = b
            if head16:
                w, b = r16(w), r16(b)
            y = F.conv2d(y, w, b, m.stride, m.padding)
            if head16:
                y = r16(y)
            if actual is not None:
                y = actual.pop(0).double() + (y - y.detach())
            if outs is not None:
                outs.append(y.detach())
        else:
            y = m(y)
    return params, cs.nhwc(y)


def forward_gaps(actual: list, emulated: list) -> list:
    """Each conv output of the bf16 step against the f64 head's with the
    bf16 roundings (NCHW): the largest difference over max|emulated|, the
    share of elements apart by more than a bf16 step (2^-7 of |emulated|),
    and the elements whose sign differs, all and in the coarse map's
    outer ring of pixels."""
    out = []
    for a, e in zip(actual, emulated):
        a = a.double()
        d = (a - e).abs()
        flip = (a > 0) != (e > 0)
        ring = torch.ones_like(flip)
        ring[:, :, 1:-1, 1:-1] = False
        out.append(dict(rel_max=(d.max() / e.abs().max()).item(),
                        over_ulp=(d > 2 ** -7 * e.abs()).double()
                        .mean().item(),
                        sign_flips=int(flip.sum()),
                        ring_flips=int((flip & ring).sum())))
    return out


def f64_ladder(model, mask: tuple, coarse: list, x16: torch.Tensor,
               logits16: torch.Tensor, dlogits16: torch.Tensor,
               upstream: list, convs16: list, batch: dict, args,
               f32_refs: dict) -> dict:
    """The bf16 step's mask-head gradients ``mask`` and the f32 references
    ``f32_refs`` (phase 13's gate's) against f64 steps on the bf16 step's
    coarse maps and decoder feature, each adding roundings of the bf16
    step: of the upsampled maps before the loss (fine16), of the head's
    weights and conv outputs (head16), both; and the f64 backward of the
    head from the bf16 step's own mask-logit gradient, through the head16
    forward and through the bf16 step's own conv outputs ``convs16``. Also
    how those outputs differ from the head16 forward's, where the logits'
    gradient differs, and how few pixels carry the upstream."""
    k = model.downsample_ratio

    def step(fine16: bool, head16: bool, dlogits=None, actual=None,
             outs=None) -> tuple:
        params, z = head64(model, x16, head16, actual, outs)
        if dlogits is not None:
            torch.autograd.backward(z, dlogits.double())
            return None, {n: p.grad for n, p in params.items()}, None
        z.retain_grad()
        preds = upsample64([c.double() for c in coarse], z, k)
        if fine16:
            preds = [r16(p) for p in preds]
        loss = loss64(preds, batch["depth"], args)
        loss.backward()
        grads = {n: p.grad for n, p in params.items()}
        return float(loss.detach()), grads, z.grad

    out, dz = {}, {}
    refs = {}
    for name, fine16, head16 in (("f64", False, False),
                                 ("f64_fine16", True, False),
                                 ("f64_head16", False, True),
                                 ("f64_both", True, True)):
        loss, grads, dz[name] = step(fine16, head16)
        refs[name] = (loss, grads)
    f64 = refs["f64"]
    emulated = []
    refs["f64_from_bf16_dlogits"] = (f64[0], step(
        False, True, dlogits16, outs=emulated)[1])
    refs["f64_from_bf16_dlogits_bf16_forward"] = (f64[0], step(
        False, True, dlogits16, actual=convs16)[1])
    out["forward"] = forward_gaps(convs16, emulated)
    for name, ref in refs.items():
        out[name] = dict(vs_bf16=cs.grad_errors(mask, ref),
                         vs_f64=cs.grad_errors(ref, f64))
    for name, ref in f32_refs.items():
        out[name] = dict(vs_bf16=cs.grad_errors(mask, ref),
                         vs_f64=cs.grad_errors(ref, f64))
    # the mask logits' gradient of the bf16 step against the f64 steps'
    d16 = dlogits16.double()
    out["dlogits"] = {n: dict(
        rel_max=((d16 - g).abs().max() / g.abs().max()).item(),
        rel_l2=((d16 - g).norm() / g.norm()).item()) for n, g in dz.items()}
    # how few pixels carry the upstream: the share of sum |dL/dmap| in the
    # largest 0.01 % and 1 % of the fine pixels' |gradients|
    g = torch.cat([u.float().abs().sum(-1).flatten() for u in upstream])
    s = g.sort(descending=True).values
    out["upstream_top_share"] = {
        f"{q:g}": (s[:max(1, int(q * s.numel()))].sum() / s.sum()).item()
        for q in (1e-4, 1e-2)}
    out["max_abs_logit"] = logits16.float().abs().max().item()
    line = "; ".join(
        f"{n} {r['vs_bf16']['grad']:.2e}/{r['vs_bf16']['grad_median']:.2e} "
        f"(vs f64 {r['vs_f64']['grad']:.2e}/{r['vs_f64']['grad_median']:.2e})"
        for n, r in out.items() if isinstance(r, dict) and "vs_bf16" in r)
    cs.log(f"  mask-head gradients, bf16 step vs each reference, worst/median "
           f"(the reference vs the f64 step): {line}")
    cs.log("  the bf16 step's conv outputs vs the f64 head's with the bf16 "
           "roundings, by conv (rel max, share over a bf16 step, sign flips,"
           " of them in the outer ring): " + "; ".join(
               f"{v['rel_max']:.2e}, {v['over_ulp']:.2e}, {v['sign_flips']}, "
               f"{v['ring_flips']}" for v in out["forward"]))
    cs.log("  mask-logit gradient, bf16 step vs the f64 steps (rel max, rel "
           "L2): " + "; ".join(f"{n} {v['rel_max']:.2e}, {v['rel_l2']:.2e}"
                               for n, v in out["dlogits"].items())
           + f"; upstream share of the top 0.01 % / 1 % fine pixels "
           f"{out['upstream_top_share']['0.0001']:.3f} / "
           f"{out['upstream_top_share']['0.01']:.3f}; max|logit| "
           f"{out['max_abs_logit']:.3f}")
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n", type=int, help="fresh states to read")
    p.add_argument("--out", default="", help="also write the readings here")
    opts = p.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke_phase13: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    cs.log(f"device: {smi}")
    cs.build.build()
    cs.build.library()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs("exp", exist_ok=True)
    readings = []
    for i in range(opts.n):
        exp_dir = tempfile.mkdtemp(prefix="chip_smoke_", dir="exp")
        cs.log(f"[8, 12, 13] state {i + 1} of {opts.n}")
        fnet = cs.run_train_path(exp_dir)
        dnet = cs.run_dnet_train_path(exp_dir)
        margs = cs.magnet_train_args(exp_dir, dnet["ckpt"], fnet["ckpt"])
        r = cs.check_magnet_train_step(margs, gate=False)
        if r["failed"]:
            cs.log(f"  state {i + 1}: out of their limits: {r['failed']}")
        model, batch, mask, coarse, x16, *ops = bf16_step_operands(margs)
        refs = {"f32_gate": tuple(cs.mask_head_reference(
            model, coarse, x16.float(), batch, margs)[:2])}
        r["ladder"] = f64_ladder(model, mask, coarse, x16, *ops, batch,
                                 margs, refs)
        del model, batch, mask, coarse, x16, ops
        readings.append(dict(state=i + 1, **r))
        torch.cuda.empty_cache()
    failed = sum(bool(r["failed"]) for r in readings)
    cs.log(f"phase 13 failed in {failed} of {opts.n} states")
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(dict(device=smi, states=readings), f, indent=1)
    return int(failed > 0)


if __name__ == "__main__":
    raise SystemExit(main())
