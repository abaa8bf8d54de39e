"""Where the F-Net conv kernel (``kernels/csrc/psm_conv.cu``, TPU kernel rows
6-8) and the head chain (``kernels/csrc/head_chain.cu``, row 3) spend their
time on the GPU, bf16. Both run the conv of ``kernels/csrc/hopper_conv.cuh``.

    python -m magnet_tpu_torch.profile_psm_conv [--ablate] [--out p.json]

Times each kernel (calls captured in a CUDA graph, the replay timed with
events) and cuDNN over the same convolutions at the sites of ``sites``: one
conv of each kind the F-Net runs on the 5 frames of a MaGNet sample at
480x640 (stem and layer1 at 240x320 with 32 channels, layer2 64, layers 3-4
128, layer4's dilation 2, both transition blocks' convs and projections) and
the three heads (the depth head at N = 5, G-Net's feature term and MaGNet's
mask head at N = 1); each output is held against the plain version
(2e-2 * max|ref|). With ``--ablate`` it also builds copies of the package
under ``build/profile_psm_conv/`` with one part of the kernels switched off
and times them the same way, a process each:
  * ``no_halo``: the halo warps publish halo stages without staging them;
  * ``no_weights``: the weight ring loads its first slabs only, and the
    consumers reuse them (no change where the weights stay resident);
  * ``mma_only``: both;
  * ``no_mma``: the consumers issue no wgmma for the 3x3 (the head's 1x1
    layers still run);
  * ``no_1x1``: the head's 1x1 layers issue no wgmma;
  * ``kb64``: 32-channel inputs in 64-channel K blocks, 32 of them zeros,
    in place of the 64-byte swizzle's 32-channel blocks.
Their outputs are wrong by design (all but ``kb64``); the times split a
kernel's between its MMA, its halo staging and its weight stream. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

from magnet_tpu_torch.kernels import head_chain as hc
from magnet_tpu_torch.kernels import psm_blocks as pb
from magnet_tpu_torch.profile_conv import PEAK_BF16_FLOPS, ROOT, edited_copy
from magnet_tpu_torch.profile_dnet import graph_ms

ABLATE_DIR = ROOT / "build" / "profile_psm_conv"
CONV = "magnet_tpu_torch/kernels/csrc/hopper_conv.cuh"
HEAD = "magnet_tpu_torch/kernels/csrc/head_chain.cu"
_NO_HALO = ((CONV, "for (int r = r0; r < g.rows; r += rstep) {",
             "for (int r = r0; r < 0; r += rstep) {"),)
_NO_WEIGHTS = (
    (CONV, "hp::mbar_wait(&b.wfull[s], (it / g.stages) & 1);",
     "if (it < g.stages) hp::mbar_wait(&b.wfull[s], 0);"),
    (CONV, "if (it >= g.stages) hp::mbar_wait(&b.wempty[s], (it / g.stages - 1) & 1);",
     "if (it >= g.stages) break;"))
# variant -> (file, text in it, its replacement) edits
ABLATIONS = {
    "no_halo": _NO_HALO,
    "no_weights": _NO_WEIGHTS,
    "mma_only": _NO_HALO + _NO_WEIGHTS,
    "no_mma": ((CONV, "hp::wgmma_ss<BN>(acc[m],",
                "if (k < 0) hp::wgmma_ss<BN>(acc[m],"),),
    "no_1x1": ((HEAD, "hp::wgmma_rs<128>(acc, frag", "if (k < 0) hp::wgmma_rs<128>(acc, frag"),),
    "kb64": (("magnet_tpu_torch/kernels/psm_blocks.py",
              "return 32 if ci <= 32 else 64", "return 64"),),
}


def sites(h: int = 480, w: int = 640, frames: int = 5) -> list:
    """(site, kind, spec) at the ScanNet eval shape: "conv" specs are (N, H,
    W, Ci, Co, k, stride, dilation, epilogue) of one F-Net conv, "head"
    specs (N, H, W, C0, widths after the 3x3)."""
    hh, wh, hc_, wc = h // 2, w // 2, h // 4, w // 4
    n = frames
    return [
        ("stem conv (32)", "conv", (n, hh, wh, 32, 32, 3, 1, 1, "relu")),
        ("layer1 conv (32, + res)", "conv", (n, hh, wh, 32, 32, 3, 1, 1, "res")),
        ("layer2_0 conv1 (32->64, stride 2)", "conv",
         (n, hh, wh, 32, 64, 3, 2, 1, "relu")),
        ("layer2_0 projection (1x1, stride 2)", "conv",
         (n, hh, wh, 32, 64, 1, 2, 1, "none")),
        ("layer2 conv (64, + res)", "conv", (n, hc_, wc, 64, 64, 3, 1, 1, "res")),
        ("layer3_0 conv1 (64->128)", "conv", (n, hc_, wc, 64, 128, 3, 1, 1, "relu")),
        ("layer3_0 projection (1x1)", "conv", (n, hc_, wc, 64, 128, 1, 1, 1, "none")),
        ("layer3 conv (128, + res)", "conv", (n, hc_, wc, 128, 128, 3, 1, 1, "res")),
        ("layer4 conv (128, dilation 2, + res)", "conv",
         (n, hc_, wc, 128, 128, 3, 1, 2, "res")),
        ("depth head N=5", "head", (n, hc_, wc, 256, (128, 128, 2))),
        ("gnet feature term N=1", "head", (1, hc_, wc, 256, (128,))),
        ("magnet mask head N=1", "head", (1, hc_, wc, 256, (128, 128, 128, 144))),
    ]


def _r(g, *shape, scale=1.0):
    return (torch.randn(*shape, generator=g) * scale).cuda()


def conv_case(spec, g):
    """(kernel call, plain call, cuDNN call, flops) of one F-Net conv."""
    n, h, w, ci, co, k, stride, dil, epi = spec
    bf = torch.bfloat16
    x = _r(g, n, h, w, ci, scale=0.5).to(bf)
    wt = _r(g, k, k, ci, co, scale=(k * k * ci) ** -0.5).to(bf)
    scale, shift = _r(g, co).abs() + 0.5, _r(g, co, scale=0.1)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    res = _r(g, n, ho, wo, co).to(bf) if epi == "res" else None
    args = (x, wt, scale, shift, stride, dil, epi == "relu", res)
    packed = pb.pack_weights(wt)
    counter = pb.fused_residual_stage
    xin = x.permute(0, 3, 1, 2)
    wl = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    pad = dil if k == 3 else 0
    return (lambda: pb._conv_cuda(*args, counter, packed),
            lambda: pb._conv_ref(*args),
            lambda: F.conv2d(xin, wl, None, stride, pad, dil),
            2.0 * n * ho * wo * co * k * k * ci)


def head_case(spec, g):
    """(kernel call, plain call, cuDNN call over the 3x3, flops) of a head."""
    n, h, w, c0, widths = spec
    bf = torch.bfloat16
    convs, cin = [], c0
    for i, co in enumerate(widths):
        ks = 3 if i == 0 else 1
        convs.append((_r(g, ks, ks, cin, co, scale=(ks * ks * cin) ** -0.5).to(bf),
                      _r(g, co, scale=0.1), i < len(widths) - 1))
        cin = co
    x = _r(g, n, h, w, c0, scale=0.5).to(bf)
    ops = hc.head_operands(convs)
    xin = x.permute(0, 3, 1, 2)
    w0 = convs[0][0].permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    flops = 2.0 * n * h * w * (9 * c0 * widths[0] + sum(
        a * b for a, b in zip(widths[:-1], widths[1:])))
    return (lambda: hc.head_chain(x, convs, ops),
            lambda: hc.head_chain_ref(x, convs),
            lambda: F.conv2d(xin, w0, None, 1, 1),
            flops)


def time_sites(library: bool, tolerate: bool = False) -> list:
    """The kernels (and cuDNN) at every site; with ``tolerate`` a site whose
    launch raises (an ablated kernel's shared memory too large) is recorded
    with ``ms`` None."""
    g = torch.Generator().manual_seed(0)
    rows = []
    for site, kind, spec in sites():
        call, plain, lib, flops = (conv_case if kind == "conv" else head_case)(spec, g)
        try:
            out = call().float()
        except RuntimeError as e:
            if not tolerate:
                raise
            rows.append(dict(site=site, kind=kind, ms=None, error=str(e)))
            continue
        ref = plain().float()
        torch.cuda.synchronize()
        ms = graph_ms(call)
        rows.append(dict(
            site=site, kind=kind, ms=ms, gflop=flops / 1e9,
            max_abs_err=(out - ref).abs().max().item(),
            limit=2e-2 * ref.abs().max().item(),
            peak_share=flops / PEAK_BF16_FLOPS / (ms * 1e-3),
            library_ms=graph_ms(lib) if library else None))
    return rows


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ablate", action="store_true",
                   help="also time the ablated copies of the kernels")
    p.add_argument("--sites-only", action="store_true",
                   help=argparse.SUPPRESS)   # one ablated copy's process
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_psm_conv needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    if a.sites_only:
        print(json.dumps(time_sites(library=False, tolerate=True)))
        return {}
    res = dict(device=torch.cuda.get_device_name(0),
               kernel=time_sites(library=True), ablations={})
    for name in ABLATIONS if a.ablate else ():
        root = edited_copy(ABLATE_DIR / name, ABLATIONS[name])
        env = dict(os.environ, PYTHONPATH=str(root))
        done = subprocess.run(
            [sys.executable, "-m", "magnet_tpu_torch.profile_psm_conv",
             "--sites-only"], cwd=root, env=env, capture_output=True,
            text=True, check=True)
        res["ablations"][name] = json.loads(done.stdout.splitlines()[-1])
    for i, r in enumerate(res["kernel"]):
        ablated = "".join(f", {name} {rows[i]['ms'] or float('nan'):.4f}"
                          for name, rows in res["ablations"].items())
        print(f"{r['site']:38s} kernel {r['ms']:.4f} ms "
              f"({100 * r['peak_share']:.1f} % of bf16 peak), cuDNN "
              f"{r['library_ms']:.4f} ms, err {r['max_abs_err']:.3e} "
              f"(limit {r['limit']:.3e}){ablated}")
    bad = [r["site"] for r in res["kernel"]
           if not r["max_abs_err"] <= r["limit"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions at "
                           f"{bad}")
    if a.out:
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
