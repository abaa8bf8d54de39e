"""Where the MaGNet forward spends its time on the GPU.

    python -m magnet_tpu_torch.profile_magnet [--config scannet|kitti]
        [--dtype bfloat16] [--out p.json] [test_magnet flags, e.g.
        --stream_blocks --mbconv_chain all --dw_kernel]

Two readings of one model at the eval shape of ``--config``
(test_scripts/magnet/<config>.txt: ScanNet 480x640, cost volume 120x160, 4
source views; KITTI 352x1216, cost volume 88x304, 2 source views; 5
candidates, 3 iterations, batch 1; seeded random weights pinned to a trained
network's depth regime; one synthetic sample; further flags go to the
entry point's parser):
  * per stage, with CUDA events around each stage run alone on the inputs
    the whole forward gives it: D-Net on the 1 + V frames, F-Net on them,
    then per iteration candidate sampling, cost volume and G-Net
    update, then G-Net's feature term, the mask head, the upsampling of
    every iteration's map (one launch), and the whole forward;
  * per kernel, with ``torch.profiler`` over five forwards: kernel launches
    per frame, device busy time per frame and the device's idle share, the
    ported kernels' share, and, from a second profile of the F-Net alone,
    the F-Net's share of the busy time.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from magnet_tpu_torch import test_magnet
from magnet_tpu_torch.core import config
from magnet_tpu_torch.data.synthetic import SyntheticMultiView
from magnet_tpu_torch.kernels import cost_volume_cw as cvk
from magnet_tpu_torch.models import build
from magnet_tpu_torch.nn.densedepth import run_head
from magnet_tpu_torch.ops.upsample import upsample_via_mask
from magnet_tpu_torch.profile_dnet import cuda_ms, kernel_profile

FRAMES = 5
FLAG_FILES = Path(__file__).resolve().parents[1] / "test_scripts" / "magnet"
CONFIGS = {"scannet": None, "kitti": "kitti_eigen.txt"}


def eval_args(dtype: str, device: str = "cuda", config_name: str = "scannet",
              extra=()):
    """The flags of test_scripts/magnet/<config>.txt (ScanNet: the parser's
    defaults), on the synthetic dataset and without checkpoints, then
    ``extra``."""
    flag_file = CONFIGS[config_name]
    head = ["@" + str(FLAG_FILES / flag_file)] if flag_file else []
    return config.parse_args(config.build_test_magnet_parser(), head + [
        "--exp_name", "profile_magnet", "--exp_dir", "exp",
        "--DNET_ckpt", "", "--FNET_ckpt", "", "--MAGNET_ckpt", "",
        "--dataset_name", "synthetic",
        "--dataset_path", "none", "--compute_dtype", dtype, "--device",
        device, "--synthetic_length", "1", *extra])


def _randn(g, *shape, scale=1.0):
    return torch.randn(*shape, generator=g) * scale


def cv_case(g: torch.Generator, roll: float = 0.0, invalid: bool = False,
            hc: int = 120, wc: int = 160, views: int = 4) -> list:
    """Inputs of ``kernels.cost_volume_cw`` (without kappa) at a main-path
    shape (ScanNet's 120x160 cost volume and 4 views unless ``hc``, ``wc``,
    ``views`` say otherwise; 5 candidates, 64 channels), on the CPU in f32:
    depths around 2 m, small camera motion (as the synthetic dataset makes
    it), plus ``roll`` radians about the optical axis for every view, the
    second view invalid with ``invalid``."""
    hw = hc * wc
    fx = 0.9 * wc
    K = torch.tensor([[fx, 0, wc / 2], [0, fx, hc / 2], [0, 0, 1.0]])
    ys, xs = torch.meshgrid(torch.arange(hc) + 0.5, torch.arange(wc) + 0.5,
                            indexing="ij")
    rays = torch.stack([(xs - K[0, 2]) / fx, (ys - K[1, 2]) / fx,
                        torch.ones_like(xs)]).reshape(1, 3, hw)
    R = torch.empty(1, views, 3, 3)
    for v in range(views):
        ang = roll + 0.02 * float(_randn(g, 1))
        c, s = np.cos(ang), np.sin(ang)
        R[0, v] = torch.tensor([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    valid = torch.ones(1, views)
    if invalid:
        valid[0, 1] = 0.0
    mu = 2.0 + 0.3 * _randn(g, 1, hc, wc, 1)
    return [mu + 0.22 * torch.linspace(-1.5, 1.5, 5),      # d_volume
            _randn(g, 1, hc, wc, 64), _randn(g, 1, views, hc, wc, 64),
            2.0 + 0.3 * _randn(g, 1, views, hc, wc),            # src mu
            0.1 + 0.3 * torch.rand(1, views, hc, wc, generator=g),
            R, _randn(g, 1, views, 3, scale=0.05), valid, K[None], rays]


def stage_times(model, inputs) -> dict:
    ref_img, src_imgs, R, t, valid, K, rays = inputs
    B, V, H, W = src_imgs.shape[:4]
    imgs = torch.cat([ref_img, src_imgs.reshape(B * V, H, W, 3)], 0)
    gauss, feat_d, feat_m = model.encode(imgs)
    ref_gauss, x_d3 = gauss[:B], feat_d[:B].contiguous()
    ref_feat = feat_m[:B]
    src_gauss = gauss[B:].reshape(B, V, *gauss.shape[1:])
    src_feat = feat_m[B:].reshape(B, V, *feat_m.shape[1:])
    src_mu, src_sigma = src_gauss[..., 0].float(), src_gauss[..., 1].float()
    ops = cvk.cv_operands(src_mu, src_sigma, src_feat.dtype)
    k = model.downsample_ratio

    def sample(prev):
        prev = prev.float()
        return prev[..., 0:1] + prev[..., 1:2] * model.k_list

    def cv_of(d_volume):
        return cvk.cost_volume_cw(d_volume, ref_feat, src_feat, src_mu,
                                  src_sigma, R, t, valid, K, rays,
                                  model.kappa, ops)

    feat_contrib = model.g_net.precompute_feature(x_d3)
    mask = run_head(model.mask_head, x_d3)
    stages = {
        f"D-Net, {B * (V + 1)} frames": lambda: model.d_net(imgs),
        f"F-Net, {B * (V + 1)} frames (PSM kernels)": lambda: model.f_net(imgs),
        "G-Net feature term (head kernel)":
            lambda: model.g_net.precompute_feature(x_d3),
    }
    prev, preds = ref_gauss, []
    for it in range(model.n_iters):
        d_volume = sample(prev)
        cv = cv_of(d_volume)
        stages[f"iter {it}: candidate sampling"] = \
            lambda p=prev: sample(p)
        stages[f"iter {it}: cost volume (kernel)"] = \
            lambda d=d_volume: cv_of(d)
        stages[f"iter {it}: G-Net update (kernel)"] = \
            lambda c=cv, p=prev: model.g_net(c, feat_contrib, p)
        prev = model.g_net(cv, feat_contrib, prev)
        preds.append(prev)
    stages.update({
        "mask head (head kernel)":
            lambda: run_head(model.mask_head, x_d3),
        f"upsampling of {len(preds)} maps (kernel, one launch)":
            lambda: upsample_via_mask(preds, mask, k),
        "whole forward": lambda: model(*inputs),
    })
    return {name: cuda_ms(fn, iters=10, warmup=2)
            for name, fn in stages.items()}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"))
    p.add_argument("--config", default="scannet", choices=tuple(CONFIGS))
    p.add_argument("--out", default="")
    a, extra = p.parse_known_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_magnet needs a CUDA device")
    args = eval_args(a.dtype, "cuda", a.config, extra)
    dtype = config.compute_dtype(a.dtype)
    model = build.realistic_depth_init_(build.build_magnet(args))
    build.cast_for_inference(model, dtype)
    batch = {k: v[None] for k, v in SyntheticMultiView(args).get(0).items()
             if hasattr(v, "shape")}
    inputs = test_magnet.batch_to_device(batch, dtype, torch.device("cuda"))
    B, V, H, W = inputs[1].shape[:4]
    imgs = torch.cat([inputs[0], inputs[1].reshape(B * V, H, W, 3)], 0)
    with torch.inference_mode():
        res = dict(device=torch.cuda.get_device_name(0), dtype=a.dtype,
                   config=a.config, flags=extra,
                   shape=[H, W], views=V, stages_ms=stage_times(model, inputs),
                   profile=kernel_profile(lambda: model(*inputs), FRAMES),
                   fnet_profile=kernel_profile(lambda: model.f_net(imgs),
                                               FRAMES))
    for name, ms in res["stages_ms"].items():
        print(f"{name:38s} {ms:9.4f} ms")
    prof, fprof = res["profile"], res["fnet_profile"]
    for k in ("wall_ms_per_frame", "device_busy_ms_per_frame",
              "device_idle_share", "kernel_launches_per_frame",
              "ported_kernels_ms_per_frame"):
        print(f"{k:38s} {prof[k]:9.4f}")
    for o in prof["ported_kernels"]:
        print(f"  {o['ms_per_frame']:8.4f} ms  x{o['launches_per_frame']:5.1f}"
              f"  {o['name']}")
    share = (fprof["device_busy_ms_per_frame"]
             / prof["device_busy_ms_per_frame"])
    print(f"{'F-Net alone: busy ms, launches':38s} "
          f"{fprof['device_busy_ms_per_frame']:9.4f} "
          f"{fprof['kernel_launches_per_frame']:9.1f}  (share of the frame's "
          f"busy time {share:.3f})")
    for t in prof["top_kernels"]:
        print(f"  {t['ms_per_frame']:8.4f} ms  x{t['launches_per_frame']:5.1f}"
              f"  {t['name']}")
    if a.out:
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
