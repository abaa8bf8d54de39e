"""Where the decoder conv kernel (``kernels/csrc/conv3x3_bnact.cu``, bf16)
spends its time on the GPU.

    python -m magnet_tpu_torch.profile_conv [--ablate] [--out p.json]

Times the kernel (calls captured in a CUDA graph, the replay timed with
events) and one cuDNN convolution over the same contraction at the sites of
``conv_sites``: decoder stages up2 and up3 at 480x640 (one frame, the D-Net
path, and five, the MaGNet path) and at the KITTI configuration (352x1216,
three frames); each output is held against the plain version
(2e-2 * max|ref|). With ``--ablate`` it also builds copies of the package
under ``build/profile_conv/`` in which one part of the kernel is switched
off, and times them the same way in a process each:
  * ``no_halo``: the halo warps publish halo stages without staging them;
  * ``no_weights``: the producer loads the first weight slabs only and the
    consumers reuse them;
  * ``mma_only``: both;
  * ``no_mma``: the consumers issue no wgmma;
  * ``patch8x8`` / ``patch16x16``: one patch at every site.
Their outputs are wrong by design (all but the patch variants); the times
split the kernel's between its MMA, its halo staging and its weight stream.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from magnet_tpu_torch.kernels import conv3x3_bnact as cb
from magnet_tpu_torch.profile_dnet import graph_ms

PEAK_BF16_FLOPS = 989e12   # H100 SXM data sheet, dense
ROOT = Path(__file__).resolve().parents[1]
ABLATE_DIR = ROOT / "build" / "profile_conv"
SOURCE = "magnet_tpu_torch/kernels/csrc/conv3x3_bnact.cu"
_PATCH = "const int p = choose_patch(a, sms);"
_NO_HALO = (("tile = a.ups && srows * scols <= C::SRC_MAX;", "tile = false;"),
            ("hb.from_global(stage(kb), kb, bt);", "stage(kb);"),
            ("hb.copy(chunks, stage(kb), kb, bt);", "stage(kb);"))
_NO_WEIGHTS = (
    ("hp::mbar_wait(&full[s], (it / C::STAGES) & 1);",
     "if (it < C::STAGES) hp::mbar_wait(&full[s], 0);"),
    ("if (it >= C::STAGES) hp::mbar_wait(&empty[s], (it / C::STAGES - 1) & 1);",
     "if (it >= C::STAGES) break;"))
# variant -> (text in SOURCE, its replacement) pairs
ABLATIONS = {
    "no_halo": _NO_HALO,
    "no_weights": _NO_WEIGHTS,
    "mma_only": _NO_HALO + _NO_WEIGHTS,
    "no_mma": (("          hp::wgmma_m64n128k16(acc[m],",
                "          if (k < 0) hp::wgmma_m64n128k16(acc[m],"),),
    "patch8x8": ((_PATCH, "const int p = 1;"),),
    "patch16x16": ((_PATCH, "const int p = 2;"),),
}


def conv_sites(scannet=(480, 640), frames=5, kitti=(352, 1216),
               kitti_frames=3):
    """(site, path, x shape, skip channels, Cout, upsample) of the conv
    kernel: decoder stages up2 and up3 at the ScanNet eval shape, one frame
    on the D-Net path and ``frames`` on the MaGNet path, and at the KITTI
    eval shape (path B), ``kitti_frames`` frames."""
    def stages(h, w):
        return (("up2", "conv_a", (h // 16, w // 16, 1024), 64, 512, True),
                ("up2", "conv_b", (h // 8, w // 8, 512), 0, 512, False),
                ("up3", "conv_a", (h // 8, w // 8, 512), 40, 256, True),
                ("up3", "conv_b", (h // 4, w // 4, 256), 0, 256, False))
    return [(f"{stage}.{conv} N={n}", path, (n,) + hw, cs, cout, ups)
            for n, path in ((1, "dnet"), (frames, "magnet"))
            for stage, conv, hw, cs, cout, ups in stages(*scannet)] + [
        (f"{stage}.{conv} KITTI N={kitti_frames}", "kitti",
         (kitti_frames,) + hw, cs, cout, ups)
        for stage, conv, hw, cs, cout, ups in stages(*kitti)]


def site_args(xs, cs, cout, ups, g, device, dtype):
    """Seeded operands of one site (weights at 1/sqrt(fan-in))."""
    n, hs, ws, cx = xs
    h, w = (2 * hs, 2 * ws) if ups else (hs, ws)
    k = (9 * (cx + cs)) ** -0.5

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(device)
    return dict(x=r(*xs).to(dtype), w=r(3, 3, cx, cout, scale=k).to(dtype),
                scale=r(cout).abs() + 0.5, shift=r(cout),
                skip=r(n, h, w, cs).to(dtype) if cs else None,
                w_skip=r(3, 3, cs, cout, scale=k).to(dtype) if cs else None,
                upsample=ups)


def library_conv(a):
    """One cuDNN convolution over the same contraction, [up(x) | skip]."""
    xin = a["x"].permute(0, 3, 1, 2)
    h, w = (a["skip"].shape[1:3] if a["upsample"] else xin.shape[2:])
    if a["upsample"]:
        xin = F.interpolate(xin, size=(h, w), mode="bilinear",
                            align_corners=True)
    wl = a["w"]
    if a["skip"] is not None:
        xin = torch.cat([xin, a["skip"].permute(0, 3, 1, 2)], 1)
        wl = torch.cat([a["w"], a["w_skip"]], 2)
    xin = xin.contiguous(memory_format=torch.channels_last)
    wl = wl.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return lambda: F.conv2d(xin, wl, padding=1)


def time_sites(library: bool) -> list:
    """The kernel (and cuDNN) at every site, bf16."""
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    rows = []
    for site, path, xs, cs, cout, ups in conv_sites():
        a = site_args(xs, cs, cout, ups, g, dev, torch.bfloat16)
        packed = cb.pack_weights(a["w"], a["w_skip"])
        out = cb.conv3x3_bnact(**a, packed=packed)
        ref = cb.conv3x3_bnact_ref(**a).float()
        torch.cuda.synchronize()
        n, hs, ws, cx = xs
        pixels = n * hs * ws * (4 if ups else 1)
        flops = 2.0 * pixels * cout * 9 * (cx + cs)
        ms = graph_ms(lambda: cb.conv3x3_bnact(**a, packed=packed))
        rows.append(dict(
            site=site, path=path, ms=ms,
            max_abs_err=(out.float() - ref).abs().max().item(),
            limit=2e-2 * ref.abs().max().item(),
            peak_share=flops / PEAK_BF16_FLOPS / (ms * 1e-3),
            library_ms=graph_ms(library_conv(a)) if library else None))
    return rows


def edited_copy(root: Path, edits) -> Path:
    """A copy of the package under ``root`` with ``edits``, (file in the
    repository, text that is in it once, its replacement), applied."""
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(ROOT / "magnet_tpu_torch", root / "magnet_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for source, old, new in edits:
        src = root / source
        text = src.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{root.name}: {old!r} is not in {source} once")
        src.write_text(text.replace(old, new))
    return root


def ablated_copy(name: str) -> Path:
    """A copy of the package with ABLATIONS[name] applied to SOURCE."""
    return edited_copy(ABLATE_DIR / name,
                       [(SOURCE, old, new) for old, new in ABLATIONS[name]])


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ablate", action="store_true",
                   help="also time the ablated copies of the kernel")
    p.add_argument("--sites-only", action="store_true",
                   help=argparse.SUPPRESS)   # one ablated copy's process
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_conv needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    if a.sites_only:
        print(json.dumps(time_sites(library=False)))
        return {}
    res = dict(device=torch.cuda.get_device_name(0),
               kernel=time_sites(library=True), ablations={})
    for name in ABLATIONS if a.ablate else ():
        root = ablated_copy(name)
        env = dict(os.environ, PYTHONPATH=str(root))
        done = subprocess.run(
            [sys.executable, "-m", "magnet_tpu_torch.profile_conv",
             "--sites-only"], cwd=root, env=env, capture_output=True,
            text=True, check=True)
        res["ablations"][name] = json.loads(done.stdout.splitlines()[-1])
    for i, r in enumerate(res["kernel"]):
        ablated = "".join(f", {name} {rows[i]['ms']:.4f}"
                          for name, rows in res["ablations"].items())
        print(f"{r['site']:22s} kernel {r['ms']:.4f} ms "
              f"({100 * r['peak_share']:.1f} % of bf16 peak), cuDNN "
              f"{r['library_ms']:.4f} ms, err {r['max_abs_err']:.3e} "
              f"(limit {r['limit']:.3e}){ablated}")
    bad = [r["site"] for r in res["kernel"]
           if not r["max_abs_err"] <= r["limit"]]
    if bad:
        raise RuntimeError(f"conv kernel disagrees with its plain version "
                           f"at {bad}")
    if a.out:
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
