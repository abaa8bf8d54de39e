"""DenseDepth: EfficientNet-B5 U-Net for single-view Gaussian depth (D-Net).

Counterpart of ``magnet_tpu/nn/densedepth.py``. Each decoder stage
bilinearly upsamples (align_corners=True), merges the encoder skip, and
applies conv3x3 -> norm -> LeakyReLU twice: BatchNorm (``UpSampleBN``,
DenseDepth_BN) or GroupNorm over weight-standardised convs
(``UpSampleGN``, DenseDepth_GN; ``use_bn=False``); two heads predict
(mu, sigma-param) and the convex-upsampling mask.

Where the JAX package runs a TPU kernel, the port runs a Hopper kernel:
* up2 (512 features) and up3 (256): ``kernels.conv3x3_bnact``, two launches
  per stage, conv_a in upsample mode over [x | skip], then conv_b, on
  operands prepared once and kept on the stage (``UpSampleBN.operands``);
* the depth and mask heads: ``kernels.head_chain``, on operands kept on
  the head (``run_head``).
up1 (1024 features) and the 1x1 ``conv2`` run as plain PyTorch convs, as the
JAX package runs them in XLA. The GroupNorm stages run plain PyTorch (WSConv in
x's dtype, GroupNorm in f32) at every width, as the JAX package runs
``UpSampleGN`` in XLA: the conv kernel of up2 and up3 folds an eval BatchNorm
into its epilogue, and a GroupNorm needs its statistics over the whole map; the
heads and the upsampling run their kernels with either decoder. In train mode
(D-Net training) every stage runs conv -> train-mode BatchNorm -> LeakyReLU and
the heads run plain convs, as the JAX package gates its kernels ``not train``:
a module chooses its path by ``self.training`` alone.

Parameter names give the reference state-dict layout:
``encoder.original_model.*``, ``decoder.conv2``,
``decoder.up{i}._net.{0,1,3,4}`` (conv_a over the concat, bn_a or gn_a,
conv_b, bn_b or gn_b) and ``decoder.{depth,mask}_head.{0,2,4}``. Tensors
are NHWC at the module boundary. With ``remat`` the decoder stages, like
the trunk's blocks, are recomputed in the backward in train mode, as the
JAX package's ``nn.remat`` recomputes them.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import torch
import torch.nn as nn

from magnet_tpu_torch.kernels.conv3x3_bnact import conv3x3_bnact, pack_weights
from magnet_tpu_torch.kernels.head_chain import head_chain, head_operands
from magnet_tpu_torch.nn.efficientnet import EfficientNetB5Features
from magnet_tpu_torch.nn.layers import (GN_GROUPS, WSConv2d, cached_fold,
                                        conv2d, fold_bn, group_norm, hwio,
                                        leaky_relu, nchw, nhwc, norm, remat,
                                        ws_conv2d)
from magnet_tpu_torch.ops.resample import resize_bilinear_align_corners
from magnet_tpu_torch.ops.upsample import upsample_bilinear, upsample_via_mask
from magnet_tpu_torch.utils.profiling import stage

# Decoder widths that run through the conv kernel (up2, up3).
KERNEL_STAGE_FEATURES = (512, 256)


class UpSampleBN(nn.Module):
    """[upsample x -> concat skip] -> (conv3x3-BN-LeakyReLU) x 2."""

    def __init__(self, skip_input: int, features: int):
        super().__init__()
        self.features = features
        self._net = nn.Sequential(
            nn.Conv2d(skip_input, features, 3, padding=1),
            nn.BatchNorm2d(features), nn.LeakyReLU(),
            nn.Conv2d(features, features, 3, padding=1),
            nn.BatchNorm2d(features), nn.LeakyReLU())

    def operands(self, dtype: torch.dtype, cx: int) -> tuple:
        """The keyword operands of ``conv3x3_bnact`` for conv_a (its HWIO
        weight split at x's cx channels into w and w_skip) and for conv_b, in
        ``dtype``, each with its BatchNorm folded into (scale, shift) and, in
        bf16, ``packed``: kept on the stage until a parameter or buffer
        changes (``cached_fold``)."""
        def fold():
            conv_a, bn_a, _, conv_b, bn_b, _ = self._net
            wa = hwio(conv_a, dtype)
            sa, ta = fold_bn(bn_a, conv_a.bias)
            sb, tb = fold_bn(bn_b, conv_b.bias)
            op_a = dict(w=wa[:, :, :cx].contiguous(),
                        w_skip=wa[:, :, cx:].contiguous(), scale=sa, shift=ta)
            op_b = dict(w=hwio(conv_b, dtype), scale=sb, shift=tb)
            if dtype == torch.bfloat16:
                op_a["packed"] = pack_weights(op_a["w"], op_a["w_skip"])
                op_b["packed"] = pack_weights(op_b["w"])
            return op_a, op_b
        return cached_fold(self, f"operands{cx}", dtype,
                           [*self._net.parameters(), *self._net.buffers()],
                           fold)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        """x: (N, h, w, Cx), skip: (N, H, W, Cs), NHWC."""
        t = self.training
        if self.features in KERNEL_STAGE_FEATURES and not t:
            op_a, op_b = self.operands(x.dtype, x.shape[-1])
            mid = conv3x3_bnact(x, skip=skip.to(x.dtype), upsample=True,
                                **op_a)
            return conv3x3_bnact(mid, **op_b)
        conv_a, bn_a, _, conv_b, bn_b, _ = self._net
        up = resize_bilinear_align_corners(x, skip.shape[1], skip.shape[2])
        y = conv2d(torch.cat([nchw(up), nchw(skip).to(x.dtype)], 1), conv_a)
        y = leaky_relu(norm(y, bn_a, t))
        y = leaky_relu(norm(conv2d(y, conv_b), bn_b, t))
        return nhwc(y)


class UpSampleGN(nn.Module):
    """[upsample x -> concat skip] -> (WSConv3x3-GroupNorm(8)-LeakyReLU) x 2,
    plain PyTorch in train and eval mode alike (GroupNorm has no running
    statistics); the GroupNorm's scale and bias rounded to x's dtype in
    train mode (``layers.group_norm``)."""

    def __init__(self, skip_input: int, features: int):
        super().__init__()
        self.features = features
        self._net = nn.Sequential(
            WSConv2d(skip_input, features, 3, padding=1),
            nn.GroupNorm(GN_GROUPS, features), nn.LeakyReLU(),
            WSConv2d(features, features, 3, padding=1),
            nn.GroupNorm(GN_GROUPS, features), nn.LeakyReLU())

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        """x: (N, h, w, Cx), skip: (N, H, W, Cs), NHWC."""
        t = self.training
        conv_a, gn_a, _, conv_b, gn_b, _ = self._net
        up = resize_bilinear_align_corners(x, skip.shape[1], skip.shape[2])
        y = torch.cat([nchw(up), nchw(skip).to(x.dtype)], 1)
        y = leaky_relu(group_norm(ws_conv2d(y, conv_a), gn_a, t))
        y = leaky_relu(group_norm(ws_conv2d(y, conv_b), gn_b, t))
        return nhwc(y)


def _head(in_ch: int, out_ch: int, hidden: int = 128) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(in_ch, hidden, 3, padding=1), nn.ReLU(),
                         nn.Conv2d(hidden, hidden, 1), nn.ReLU(),
                         nn.Conv2d(hidden, out_ch, 1))


def run_head(head: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """conv3x3 -> ReLU -> conv1x1 -> ... -> conv1x1 through the head-chain
    kernel. x: (N, H, W, C) NHWC. The chain's HWIO weights and, on a CUDA
    device, the kernel's operands are kept on ``head`` until a parameter
    changes (``cached_fold``). A head in train mode runs its plain convs in
    x's dtype, with autograd."""
    if head.training:
        y = nchw(x)
        for m in head:
            y = conv2d(y, m) if isinstance(m, nn.Conv2d) else m(y)
        return nhwc(y)
    mods = [m for m in head if isinstance(m, nn.Conv2d)]

    def fold():
        convs = [(hwio(c, x.dtype), c.bias, i < len(mods) - 1)
                 for i, c in enumerate(mods)]
        return convs, (head_operands(convs) if x.is_cuda else None)
    convs, operands = cached_fold(head, "head_chain", x.dtype,
                                  list(head.parameters()), fold)
    return head_chain(x, convs, operands)


class Encoder(nn.Module):
    def __init__(self, mbconv_chain: Union[None, str, Sequence[int]] = None,
                 dw_kernel: bool = False, remat: bool = False):
        super().__init__()
        self.original_model = EfficientNetB5Features(mbconv_chain, dw_kernel,
                                                     remat)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator = None) -> List[torch.Tensor]:
        return self.original_model(x, generator)


class Decoder(nn.Module):
    def __init__(self, num_classes: int = 2, downsample_ratio: int = 4,
                 learned_upsampling: bool = True, use_bn: bool = True):
        super().__init__()
        self.n_ups = {8: 2, 4: 3, 2: 4}[downsample_ratio]
        self.conv2 = nn.Conv2d(2048, 2048, 1)
        skips = (176, 64, 40, 24)
        up = UpSampleBN if use_bn else UpSampleGN
        for i in range(self.n_ups):
            feats = 2048 >> i
            setattr(self, f"up{i + 1}", up(feats + skips[i], feats >> 1))
        i_dim = 2048 >> self.n_ups
        self.depth_head = _head(i_dim, num_classes)
        if learned_upsampling:
            self.mask_head = _head(i_dim, 9 * downsample_ratio ** 2)


class DenseDepth(nn.Module):
    """Full D-Net body. forward(x (B, H, W, 3) NHWC) returns
      as_dnet=True:  (B, H, W, num_classes) learned-upsampled output
      as_dnet=False: ((B, h, w, num_classes), (B, h, w, i_dim) feature)
    where (h, w) = (H, W) / downsample_ratio. ``use_bn`` chooses the
    BatchNorm or the GroupNorm decoder. ``mbconv_chain`` and ``dw_kernel``
    switch the trunk's kernels, ``remat`` recomputes the trunk's blocks
    (``nn.efficientnet``) and the decoder's stages in the backward; in
    train mode ``generator`` draws the trunk's drop-path masks."""

    def __init__(self, num_classes: int = 2, downsample_ratio: int = 4,
                 learned_upsampling: bool = True, as_dnet: bool = True,
                 mbconv_chain: Union[None, str, Sequence[int]] = None,
                 dw_kernel: bool = False, remat: bool = False,
                 use_bn: bool = True):
        super().__init__()
        self.downsample_ratio = downsample_ratio
        self.learned_upsampling = learned_upsampling
        self.as_dnet = as_dnet
        self.remat = remat
        self.encoder = Encoder(mbconv_chain, dw_kernel, remat)
        # The mask head exists whenever upsampling is learned, as in the
        # reference checkpoints, even where as_dnet=False leaves it unused.
        self.decoder = Decoder(num_classes, downsample_ratio,
                               learned_upsampling, use_bn)

    def forward(self, x: torch.Tensor, generator: torch.Generator = None):
        with stage("D-Net trunk"):
            f4, f5, f6, f8, f11 = self.encoder(nchw(x), generator)
        with stage("D-Net decoder"):
            dec = self.decoder
            skips = [f8, f6, f5, f4][:dec.n_ups]
            y = nhwc(conv2d(f11, dec.conv2))
            for i, skip in enumerate(skips):
                up = getattr(dec, f"up{i + 1}")
                y = (remat(up, y, nhwc(skip)) if self.remat and up.training
                     else up(y, nhwc(skip)))
            depth = run_head(dec.depth_head, y)
            if not self.as_dnet:
                return depth, y
            k = self.downsample_ratio
            if self.learned_upsampling:
                return upsample_via_mask(depth, run_head(dec.mask_head, y),
                                         k)
            return upsample_bilinear(depth, None, k)
