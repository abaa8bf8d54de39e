"""Training visualisation: image dumps written with PIL and numpy.

The port of ``magnet_tpu/utils/visualize.py``, the reference's periodic
dumps (utils/utils.py:205-332): input image, ground-truth depth, predicted
depth, error map and standard-deviation map (per iteration for MaGNet).
Depth and error colour ranges depend on the dataset (indoor 5.0 / 0.5,
outdoor 60 / 3). Inputs NHWC, numpy arrays or tensors.

The JAX package writes them with matplotlib's ``imsave``; the card's machine
has no matplotlib, so this module does what ``imsave`` does for a JPEG
(matplotlib 3.10): the values normalised to [0, 1] over (vmin, vmax) and
looked up in a 256-entry table (below 0 the first entry, from 1 the last, NaN
transparent), the RGBA bytes composited onto the white figure background
and saved by PIL as a JPEG at 100 dpi. ``JET`` and ``REDS`` are copies of
matplotlib's ``jet`` and ``Reds`` tables as bytes. The files equal the JAX
package's byte for byte.
"""

from __future__ import annotations

import numpy as np
from PIL import Image

from magnet_tpu_torch.data.base import IMAGENET_MEAN, IMAGENET_STD

DPI = 100
BACKGROUND = (255, 255, 255)

_JET_HEX = (
    "00007f00008400008800008d00009100009600009a00009f0000a30000a80000"
    "ac0000b10000b60000ba0000bf0000c30000c80000cc0000d10000d50000da00"
    "00de0000e30000e80000ec0000f10000f50000fa0000fe0000ff0000ff0000ff"
    "0000ff0004ff0008ff000cff0010ff0014ff0018ff001cff0020ff0024ff0028"
    "ff002cff0030ff0034ff0038ff003cff0040ff0044ff0048ff004cff0050ff00"
    "54ff0058ff005cff0060ff0064ff0068ff006cff0070ff0074ff0078ff007cff"
    "0080ff0084ff0088ff008cff0090ff0094ff0098ff009cff00a0ff00a4ff00a8"
    "ff00acff00b0ff00b4ff00b8ff00bcff00c0ff00c4ff00c8ff00ccff00d0ff00"
    "d4ff00d8ff00dcfe00e0fa00e4f702e8f405ecf108f0ed0cf4ea0ff8e712fce4"
    "15ffe118ffdd1cffda1fffd722ffd425ffd029ffcd2cffca2fffc732ffc336ff"
    "c039ffbd3cffba3fffb742ffb346ffb049ffad4cffaa4fffa653ffa356ffa059"
    "ff9d5cff9a5fff9663ff9366ff9069ff8d6cff8970ff8673ff8376ff8079ff7d"
    "7cff7980ff7683ff7386ff7089ff6c8dff6990ff6693ff6396ff5f9aff5c9dff"
    "59a0ff56a3ff53a6ff4faaff4cadff49b0ff46b3ff42b7ff3fbaff3cbdff39c0"
    "ff36c3ff32c7ff2fcaff2ccdff29d0ff25d4ff22d7ff1fdaff1cddff18e0ff15"
    "e4ff12e7ff0feaff0cedff08f1fc05f4f802f7f400faf000feed00ffe900ffe5"
    "00ffe200ffde00ffda00ffd700ffd300ffcf00ffcb00ffc800ffc400ffc000ff"
    "bd00ffb900ffb500ffb100ffae00ffaa00ffa600ffa300ff9f00ff9b00ff9800"
    "ff9400ff9000ff8c00ff8900ff8500ff8100ff7e00ff7a00ff7600ff7300ff6f"
    "00ff6b00ff6700ff6400ff6000ff5c00ff5900ff5500ff5100ff4d00ff4a00ff"
    "4600ff4200ff3f00ff3b00ff3700ff3400ff3000ff2c00ff2800ff2500ff2100"
    "ff1d00ff1a00ff1600fe1200fa0f00f50b00f10700ec0300e80000e30000de00"
    "00da0000d50000d10000cc0000c80000c30000bf0000ba0000b60000b10000ac"
    "0000a80000a300009f00009a00009600009100008d00008800008400007f0000")

_REDS_HEX = (
    "fff5f0fef4effef3eefef3edfef2ecfef1ebfef1eafef0e9feefe8feefe7feee"
    "e6feede5feede4feece3feebe2feebe1feeae0fee9e0fee9dffee8defee7ddfe"
    "e7dcfee6dbfee5dafee5d9fee4d8fee3d7fee3d6fee2d5fee1d4fee1d3fee0d2"
    "fddfd1fdded0fdddcefddccdfddbcbfddacafdd8c8fdd7c7fdd6c5fdd5c3fdd4"
    "c2fdd3c0fdd1bffdd0bdfdcfbcfdcebafccdb9fcccb7fccab6fcc9b4fcc8b3fc"
    "c7b1fcc6affcc5aefcc3acfcc2abfcc1a9fcc0a8fcbfa6fcbea5fcbda3fcbba2"
    "fcbaa0fcb99ffcb89dfcb69cfcb59afcb499fcb297fcb196fcb094fcaf93fcad"
    "91fcac90fcab8efca98dfca88bfca78afca689fca487fca386fca284fca083fc"
    "9f81fc9e80fc9d7efc9b7dfc9a7bfc997afc9778fc9677fc9575fc9474fc9272"
    "fb9171fb9070fb8f6ffb8d6dfb8c6cfb8b6bfb8a6afb8868fb8767fb8666fb84"
    "64fb8363fb8262fb8161fb7f5ffb7e5efb7d5dfb7c5cfb7a5afb7959fb7858fb"
    "7757fb7555fb7454fb7353fb7252fb7050fb6f4ffb6e4efb6d4dfb6b4bfb6a4a"
    "fa6949fa6748fa6647f96446f96345f86144f86043f85e42f75d42f75b41f75a"
    "40f6593ff6573ef5563df5543cf5533bf4513af45039f44e38f34d37f34b36f2"
    "4a35f24834f24733f14532f14432f14231f04130f03f2fef3e2eef3d2def3b2c"
    "ee3a2bed392bec382aea372ae93529e83429e73328e63228e53127e43027e32f"
    "27e12e26e02d26df2c25de2a25dd2924dc2824db2723d92623d82522d72422d6"
    "2321d52221d42120d31f20d21e1fd01d1fcf1c1fce1b1ecd1a1ecc191dcb181d"
    "ca171cc8171cc7171cc6161cc5161bc4161bc2161bc1151bc0151abf151abe14"
    "1abc141abb1419ba1419b91319b81319b71318b51218b41218b31218b21217b1"
    "1117af1117ae1117ad1116ac1016ab1016a91016a80f15a70f15a60f15a50f15"
    "a30e14a10e149f0d149d0d149b0c13990c13970b13950b13930a12910a128f09"
    "128d09128b08118a08118808118607118407108206108006107e05107c050f7a"
    "040f78040f76030f74030e72020e70020e6e010e6c010d6a000d68000d67000c")

JET = np.frombuffer(bytes.fromhex("".join(_JET_HEX)), np.uint8).reshape(256, 3)
REDS = np.frombuffer(bytes.fromhex("".join(_REDS_HEX)), np.uint8).reshape(
    256, 3)


def _ranges(dataset_name: str):
    if dataset_name in ("nyu", "scannet", "7scenes", "synthetic"):
        return 5.0, 0.5
    return 60.0, 3.0


def _host(x) -> np.ndarray:
    """A numpy array of ``x`` (a tensor goes to the host, bf16 as f32)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        if x.dtype.is_floating_point and x.element_size() < 4:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def unnormalize(img: np.ndarray) -> np.ndarray:
    out = img * IMAGENET_STD + IMAGENET_MEAN
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)


def colorize(values: np.ndarray, vmax: float,
             table: np.ndarray) -> np.ndarray:
    """(H, W) values -> (H, W, 4) RGBA bytes, as matplotlib's
    ``Colorizer.to_rgba(values, bytes=True)`` with ``Normalize(0, vmax)``
    and a 256-entry table: in the values' float type (integers promoted
    with f32), over vmax (in f64, rounded to that type), times 256 and
    truncated; under 0 the first entry, from 256 the last (1.0 itself the
    last), NaN transparent black."""
    x = np.array(values, copy=True)
    if x.dtype.kind != "f":
        x = x.astype(np.promote_types(x.dtype, np.float32))
    x /= np.float64(vmax)
    n = table.shape[0]
    x *= n
    x[x == n] = n - 1
    under, over, bad = x < 0, x >= n, np.isnan(x)
    with np.errstate(invalid="ignore"):
        idx = x.astype(int)
    idx[under], idx[over] = 0, n - 1
    rgba = np.empty(x.shape + (4,), np.uint8)
    rgba[..., :3] = table.take(idx, axis=0, mode="clip")
    rgba[..., 3] = 255
    rgba[bad] = 0
    return rgba


def save_jpeg(path: str, rgba: np.ndarray) -> None:
    """(H, W, 4) or (H, W, 3) bytes -> a JPEG at ``DPI``, RGBA composited
    onto ``BACKGROUND`` first (matplotlib's ``imsave`` path for JPEG)."""
    if rgba.shape[-1] == 3:
        rgba = np.concatenate(
            [rgba, np.full(rgba.shape[:2] + (1,), 255, np.uint8)], -1)
    rgba = np.require(rgba, np.uint8, "C")
    size = (rgba.shape[1], rgba.shape[0])
    image = Image.frombuffer("RGBA", size, rgba, "raw", "RGBA", 0, 1)
    out = Image.new("RGB", size, BACKGROUND)
    out.paste(image, image)
    out.save(path, format="jpeg", dpi=(DPI, DPI))


def _save_depth(path, dmap, d_max):
    save_jpeg(path, colorize(dmap, d_max, JET))


def _save_error(path, emap, e_max):
    save_jpeg(path, colorize(emap, e_max, REDS))


def _error_map(pred, gt, min_depth, max_depth):
    e = np.abs(pred - gt)
    e[gt < min_depth] = 0.0
    e[gt > max_depth] = 0.0
    return e


def visualize_dnet(args, img, gt_dmap, pred, total_iter):
    """img (B,H,W,3); gt (B,H,W); pred (B,H,W,2)=(mu,var)."""
    d_max, e_max = _ranges(args.dataset_name)
    img0 = _host(img)[0]
    gt0 = _host(gt_dmap)[0]
    mu = _host(pred)[0, :, :, 0]
    stdev = np.sqrt(_host(pred)[0, :, :, 1])
    pre = f"{args.exp_vis_dir}/{total_iter:08d}"
    save_jpeg(f"{pre}_img.jpg", unnormalize(img0))
    _save_depth(f"{pre}_gt_dmap.jpg", gt0, d_max)
    _save_depth(f"{pre}_pred_dmap.jpg", mu, d_max)
    _save_error(f"{pre}_pred_emap.jpg",
                _error_map(mu, gt0, args.min_depth, args.max_depth), e_max)
    _save_error(f"{pre}_pred_stdev.jpg", stdev, e_max)


def visualize_fnet(args, img, gt_dmap, pred_dmap, total_iter):
    """pred_dmap at dpv resolution (B,h,w); nearest-upsampled for dump
    (utils/utils.py:266)."""
    d_max, e_max = _ranges(args.dataset_name)
    img0 = _host(img)[0]
    gt0 = _host(gt_dmap)[0]
    p = _host(pred_dmap)[0]
    H, W = img0.shape[:2]
    ry, rx = H // p.shape[0], W // p.shape[1]
    p_up = np.repeat(np.repeat(p, ry, 0), rx, 1)
    pre = f"{args.exp_vis_dir}/{total_iter:08d}"
    save_jpeg(f"{pre}_img.jpg", unnormalize(img0))
    _save_depth(f"{pre}_gt_dmap.jpg", gt0, d_max)
    _save_depth(f"{pre}_pred_dmap.jpg", p_up, d_max)
    _save_error(f"{pre}_pred_emap.jpg",
                _error_map(p_up, gt0, args.min_depth, args.max_depth),
                e_max)


def visualize_magnet(args, img, gt_dmap, pred_list, total_iter):
    """pred_list: list of (B,H,W,2)=(mu,sigma) per iteration."""
    d_max, e_max = _ranges(args.dataset_name)
    img0 = _host(img)[0]
    gt0 = _host(gt_dmap)[0]
    pre = f"{args.exp_vis_dir}/{total_iter:08d}"
    save_jpeg(f"{pre}_img.jpg", unnormalize(img0))
    _save_depth(f"{pre}_gt_dmap.jpg", gt0, d_max)
    for i, pred in enumerate(pred_list):
        mu = _host(pred)[0, :, :, 0]
        stdev = _host(pred)[0, :, :, 1]
        _save_depth(f"{pre}_pred_dmap_iter{i:02d}.jpg", mu, d_max)
        _save_error(f"{pre}_pred_emap_iter{i:02d}.jpg",
                    _error_map(mu, gt0, args.min_depth, args.max_depth),
                    e_max)
        _save_error(f"{pre}_pred_stdev_iter{i:02d}.jpg", stdev, e_max)
