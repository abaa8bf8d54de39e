#!/usr/bin/env python3
"""Phase 13 of chip_smoke.py (the stage-3 step against its references) from
several fresh states, on one NVIDIA GPU.

    python3 chip_smoke_phase13.py N [--min M --until K] [--out readings.json]

Builds the kernels, then up to N times: phase 8 (F-Net training), phase 12
(D-Net training) and phase 13's one-step check on a MaGNet built from those
two checkpoints, each time in a new experiment directory (phase 13's own
three training steps, which change no checkpoint the check reads, are left
out). Row 10's atomics and cuDNN's backward make each run's trained state
another, and phase 13's readings depend on that state. With ``--until K``
it stops after state M (default N) once K states have read over
``FORMER_GATE`` on the end-to-end reading. Prints each check's readings as
chip_smoke.py does (the three gates of the bf16 step's mask head and the
end-to-end reading against the f32 mask head), a table of them over the
states, writes them to ``--out``, and exits 1 if any state failed a gate.

Each state also places the bf16 step's mask-head gradients and the f32
mask head's against f64 steps on the bf16 step's coarse maps and decoder
feature (the f64 ladder, a witness, not a gate): the f64 step alone, then
with the bf16 step's roundings added one by one (the upsampled maps before
the loss, the head's weights and conv outputs, both), and the f64 backward
of the head from the bf16 step's own mask-logit gradient through the
exactly rounded forward (gate 3 runs it through the step's own forward). It
also reads how the step's conv outputs differ from that exactly rounded
forward's (each on the forward's own input, where gate 2 reads each on the
step's), the mask-logit gradients' differences, and the share of the
upstream gradient that the largest 0.01 % and 1 % of the fine pixels carry.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import torch

import chip_smoke as cs

# the end-to-end reading's limits before it was split into three gates:
# worst and median tensor of their tensor's max (counted, not gated)
FORMER_GATE = dict(grad=0.3, grad_median=0.05)


def upsample64(maps: list, logits: torch.Tensor, k: int) -> list:
    """Convex upsampling in f64, as ``upsample_mask_ref`` computes it in
    f32."""
    B, H, W = logits.shape[:3]
    w = logits.reshape(B, H, W, 9, k, k).softmax(3)
    outs = []
    for d in maps:
        C = d.shape[-1]
        nb = torch.nn.functional.unfold(d.permute(0, 3, 1, 2), 3, padding=1)
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


def f64_ladder(model, cap: dict, batch: dict, args, f32_refs: dict) -> dict:
    """The bf16 step's mask-head gradients (``capture_bf16_step``'s
    ``cap``) and the f32 references ``f32_refs`` against f64 steps on the
    bf16 step's coarse maps and decoder feature, each adding roundings of
    the bf16 step: of the upsampled maps before the loss (fine16), of the
    head's weights and conv outputs (head16), both; and the f64 backward of
    the head from the bf16 step's own mask-logit gradient through the
    head16 forward. Also how the step's conv outputs differ from that
    forward's, where the logits' gradient differs, and how few pixels carry
    the upstream."""
    head, k, x16 = model.mask_head, model.downsample_ratio, cap["x"]
    mask = cs.only(cap["step"], "mask_head.")

    def step(fine16: bool, head16: bool, dlogits=None, outs=None) -> tuple:
        params, z = cs.head64(head, x16, head16, outs=outs)
        if dlogits is not None:
            torch.autograd.backward(z, dlogits.double())
            return None, {n: p.grad for n, p in params.items()}, None
        z.retain_grad()
        preds = upsample64([c.double() for c in cap["coarse"]], z, k)
        if fine16:
            preds = [cs.r16(p) for p in preds]
        loss = loss64(preds, batch["depth"], args)
        loss.backward()
        grads = {n: p.grad for n, p in params.items()}
        return float(loss.detach()), grads, z.grad

    out, dz, refs = {}, {}, {}
    for name, fine16, head16 in (("f64", False, False),
                                 ("f64_fine16", True, False),
                                 ("f64_head16", False, True),
                                 ("f64_both", True, True)):
        loss, grads, dz[name] = step(fine16, head16)
        refs[name] = (loss, grads)
    f64 = refs["f64"]
    emulated = []
    refs["f64_from_bf16_dlogits"] = (f64[0], step(
        False, True, cap["dlogits"], outs=emulated)[1])
    out["forward_emulated"] = cs.forward_gaps(cap["outs"], emulated)
    for name, ref in list(refs.items()) + list(f32_refs.items()):
        out[name] = dict(vs_bf16=cs.grad_errors(mask, ref),
                         vs_f64=cs.grad_errors(ref, f64))
    # the mask logits' gradient of the bf16 step against the f64 steps'
    d16 = cap["dlogits"].double()
    out["dlogits"] = {n: dict(
        rel_max=((d16 - g).abs().max() / g.abs().max()).item(),
        rel_l2=((d16 - g).norm() / g.norm()).item()) for n, g in dz.items()}
    # how few pixels carry the upstream: the share of sum |dL/dmap| in the
    # largest 0.01 % and 1 % of the fine pixels' |gradients|
    g = torch.cat([u.float().abs().sum(-1).flatten()
                   for u in cap["upstream"]])
    s = g.sort(descending=True).values
    out["upstream_top_share"] = {
        f"{q:g}": (s[:max(1, int(q * s.numel()))].sum() / s.sum()).item()
        for q in (1e-4, 1e-2)}
    out["max_abs_logit"] = cap["outs"][-1].float().abs().max().item()
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
               f"{v['ring_flips']}" for v in out["forward_emulated"]))
    cs.log("  mask-logit gradient, bf16 step vs the f64 steps (rel max, rel "
           "L2): " + "; ".join(f"{n} {v['rel_max']:.2e}, {v['rel_l2']:.2e}"
                               for n, v in out["dlogits"].items())
           + f"; upstream share of the top 0.01 % / 1 % fine pixels "
           f"{out['upstream_top_share']['0.0001']:.3f} / "
           f"{out['upstream_top_share']['0.01']:.3f}; max|logit| "
           f"{out['max_abs_logit']:.3f}")
    return out


def over_former_gate(r: dict) -> bool:
    e = r["mask_head"]["end_to_end"]
    return not all(e[k] <= v for k, v in FORMER_GATE.items())


def summary(r: dict) -> str:
    """A state's three gate readings and its end-to-end reading."""
    m = r["mask_head"]
    u, b, e = m["upstream"], m["backward"], m["end_to_end"]
    l2 = e["rel_l2"].values()
    return (f"state {r['state']}: upstream {u['rel_max']:.2e} (L2 "
            f"{u['rel_l2']:.2e}); forward by conv "
            + ", ".join(f"{f['rel_max']:.2e}" for f in m["forward"])
            + f"; backward {b['grad']:.2e}/{b['grad_median']:.2e}; end to "
            f"end {e['grad']:.2e}/{e['grad_median']:.2e}, rel L2 "
            f"{min(l2):.2e}-{max(l2):.2e}"
            + (" (over the former gate)" if over_former_gate(r) else "")
            + (f"; FAILED {r['failed']}" if r["failed"] else ""))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n", type=int, help="fresh states to read, at most")
    p.add_argument("--min", type=int, default=0,
                   help="states to read at least with --until (default n)")
    p.add_argument("--until", type=int, default=0,
                   help="stop once this many states read over FORMER_GATE")
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
        cs.log(f"[8, 12, 13] state {i + 1} of at most {opts.n}")
        fnet = cs.run_train_path(exp_dir)
        dnet = cs.run_dnet_train_path(exp_dir)
        margs = cs.magnet_train_args(exp_dir, dnet["ckpt"], fnet["ckpt"])
        keep = {}
        r = cs.check_magnet_train_step(margs, gate=False, keep=keep)
        model, cap, batch = keep["model"], keep["cap"], keep["batch"]
        refs = {"f32_head": cs.mask_head_reference(
            model.mask_head, model.downsample_ratio, cap["coarse"],
            cap["x"].float(), batch, margs)[:2]}
        r["ladder"] = f64_ladder(model, cap, batch, margs, refs)
        del keep, model, cap, batch
        readings.append(dict(state=i + 1, **r))
        cs.log("  " + summary(readings[-1]))
        torch.cuda.empty_cache()
        over = sum(map(over_former_gate, readings))
        if opts.until and over >= opts.until and i + 1 >= (opts.min or opts.n):
            break
    failed = sum(bool(r["failed"]) for r in readings)
    over = sum(map(over_former_gate, readings))
    cs.log(f"over {len(readings)} states:")
    for r in readings:
        cs.log("  " + summary(r))
    cs.log(f"a gate failed in {failed} of {len(readings)} states; the former "
           f"gate ({FORMER_GATE}) would have failed in {over}")
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(dict(device=smi, states=readings), f, indent=1)
    return int(failed > 0)


if __name__ == "__main__":
    raise SystemExit(main())
