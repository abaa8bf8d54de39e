"""PSM-Net 2-D feature extractor (F-Net body), PyTorch.

Counterpart of ``magnet_tpu/nn/psmnet.py``. In eval mode (inference) the
residual stages, the two transition blocks and the tail each run through
the port of the TPU kernel the JAX package runs there,

* the stem's second and third conv, layer1, the rest of layer2 and layer3
  and all of layer4 (dilation 2): ``kernels.psm_blocks.fused_residual_stage``;
* layer2's first block (stride 2, 32 -> 64): ``downsample_block``;
* layer3's first block (64 -> 128): ``expand_block``;
* the 3x3 conv over the 320-channel concat, BN, ReLU and the 1x1
  projection: ``kernels.spp_tail.spp_tail``,

with eval BatchNorm folded to an f32 scale and shift. The folded operands
(HWIO weights, scale and shift, and in bf16 on a CUDA device the packed
weights of ``psm_blocks.pack_weights`` and ``spp_tail.tail_operands``) are
kept on the modules until a weight or BatchNorm buffer changes
(``nn.layers.cached_fold``), so a forward prepares nothing but its
activations. With ``stream_blocks``
(the JAX package's ``MAGNET_TPU_PALLAS_RST``, for maps too large for its
whole-map chains, as at the KITTI shape) each stride-1 BasicBlock of
layer1-layer4 is one ``kernels.res_block.res_block`` launch instead of its
two convs in the chain; the stem and the transition blocks stay as they are,
and the JAX package's gates (``resstream_pallas.supported``,
``PSMNet._chain_ok``) have no counterpart. The stem's first conv
(3 input channels, stride 2) and the four pooled SPP branches (1x1 convs on
maps of a few pixels) run as plain PyTorch, as the JAX package leaves them
to XLA.

In train mode every conv is ``F.conv2d`` with autograd and every BatchNorm
normalises with the batch's statistics and updates its running buffers
(``nn.layers.batch_norm_train``), as the JAX package trains it with XLA
convs and flax BatchNorm, never its kernels. The weights are cast to the
activation dtype in the forward, so that gradients reach the f32 masters.
With ``remat`` each residual block is recomputed in the backward.

Stride-2 stem of three conv-BN-ReLU layers, four residual stages (32x3,
64x16 stride 2, 128x3, 128x3 dilation 2), a 4-branch spatial pyramid
pooling (average pool 64/32/16/8, 1x1 conv-BN-ReLU, bilinear resize back
with align_corners=True), a concat to 320 channels, a 3x3 conv-BN-ReLU and a
1x1 projection to ``feature_dim``. Output stride 4.

Attribute names give the reference state-dict layout: ``firstconv.{0,2,4}.
{0,1}``, ``layer{n}.{i}.conv1.0.{0,1}``, ``layer{n}.{i}.conv2.{0,1}``,
``layer{n}.0.downsample.{0,1}``, ``branch{n}.1.{0,1}``, ``lastconv.0.{0,1}``
and ``lastconv.2``. Tensors are NHWC at the module boundary.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from magnet_tpu_torch.kernels.psm_blocks import (downsample_block,
                                                 expand_block,
                                                 fused_residual_stage,
                                                 pack_chain)
from magnet_tpu_torch.kernels.res_block import res_block
from magnet_tpu_torch.kernels.spp_tail import spp_tail, tail_operands
from magnet_tpu_torch.nn.layers import (batch_norm, batch_norm_train,
                                        cached_fold, fold_bn, hwio, nchw,
                                        nhwc, remat)
from magnet_tpu_torch.ops.resample import (avg_pool,
                                           resize_bilinear_align_corners)

# (planes, blocks, stride, dilation) of layer1..layer4
STAGES = ((32, 3, 1, 1), (64, 16, 2, 1), (128, 3, 1, 1), (128, 3, 1, 2))
SPP_WINDOWS = (64, 32, 16, 8)


def convbn(cin: int, cout: int, k: int, stride: int, pad: int,
           dilation: int) -> nn.Sequential:
    """conv (no bias) + BN; a dilation above 1 sets padding = dilation."""
    return nn.Sequential(
        nn.Conv2d(cin, cout, k, stride, dilation if dilation > 1 else pad,
                  dilation, bias=False),
        nn.BatchNorm2d(cout))


def run_convbn(x: torch.Tensor, cb: nn.Sequential) -> torch.Tensor:
    """conv in x's dtype, then eval BatchNorm with f32 statistics. NCHW."""
    conv, bn = cb
    y = F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride, conv.padding,
                 conv.dilation)
    return batch_norm(y, bn)


def train_convbn(x: torch.Tensor, cb: nn.Sequential) -> torch.Tensor:
    """conv in x's dtype, then train-mode BatchNorm. NCHW."""
    conv, bn = cb
    y = F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride, conv.padding,
                 conv.dilation)
    return batch_norm_train(y, bn)


def fold_chain(cbs: Sequence[nn.Sequential], dtype: torch.dtype
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Equal-shaped conv-BN pairs as the stacked operands of a kernel chain:
    HWIO weights (n, k, k, ci, co) in ``dtype`` and the folded BN
    (scale, shift), each (n, co) f32."""
    f32 = torch.float32
    w = torch.stack([cb[0].weight for cb in cbs]).to(dtype)
    gamma, beta, mean, var = (
        torch.stack([getattr(cb[1], name) for cb in cbs]).to(f32)
        for name in ("weight", "bias", "running_mean", "running_var"))
    scale = gamma * torch.rsqrt(var + cbs[0][1].eps)
    return (w.permute(0, 3, 4, 2, 1).contiguous(), scale.contiguous(),
            (beta - mean * scale).contiguous())


def packs(x: torch.Tensor) -> bool:
    """Whether the kernels read packed weights for x: bf16 on a CUDA
    device."""
    return x.is_cuda and x.dtype == torch.bfloat16


def kept_operands(owner: nn.Module, name: str, cbs: Sequence[nn.Sequential],
                  x: torch.Tensor, stacked: bool = True) -> tuple:
    """The conv-BN pairs ``cbs`` folded for x's dtype: ``fold_chain``'s
    stacked (weights, scales, shifts), or with ``stacked=False`` lists of
    ``hwio`` and ``fold_bn`` per conv (pairs of other shapes); and, where
    the kernels read packed weights (``packs``), those of each conv (else
    None). Kept on ``owner`` under ``name`` until a weight or
    BatchNorm buffer of ``cbs`` changes."""
    def fold():
        if stacked:
            w, scale, shift = fold_chain(cbs, x.dtype)
        else:
            w = [hwio(cb[0], x.dtype) for cb in cbs]
            scale, shift = zip(*[fold_bn(cb[1]) for cb in cbs])
        packed = pack_chain(w) if packs(x) else None
        return w, scale, shift, packed
    sources = [t for cb in cbs for t in (*cb.parameters(), *cb.buffers())]
    return cached_fold(owner, name, x.dtype, sources, fold)


class BasicBlock(nn.Module):
    """Residual block with no activation after the sum. It only holds the
    parameters: ``PSMNet.forward`` runs the blocks through the kernels,
    ``PSMNet.train_forward`` through library convs."""

    def __init__(self, inplanes: int, planes: int, stride: int,
                 downsample, dilation: int):
        super().__init__()
        self.stride, self.dilation = stride, dilation
        self.conv1 = nn.Sequential(
            convbn(inplanes, planes, 3, stride, 1, dilation), nn.ReLU())
        self.conv2 = convbn(planes, planes, 3, 1, 1, dilation)
        self.downsample = downsample


def run_layer(x: torch.Tensor, layer: nn.Sequential,
              stream_blocks: bool = False) -> torch.Tensor:
    """One residual stage on an NHWC map: a first block with a projection
    shortcut goes through its transition kernel, the stride-1 blocks after
    it through one chain, or with ``stream_blocks`` one ``res_block`` launch
    each; their operands kept on the modules (``kept_operands``)."""
    blocks = list(layer)
    if blocks[0].downsample is not None:
        b = blocks.pop(0)
        if b.dilation != 1:
            raise ValueError("a projection block with a dilation")
        w, scale, shift, packed = kept_operands(
            b, "transition", [b.conv1[0], b.conv2, b.downsample], x,
            stacked=False)
        operands = [t for i in range(3) for t in (w[i], scale[i], shift[i])]
        block = downsample_block if b.stride == 2 else expand_block
        x = block(x, *operands, packed=packed)
    if any(b.stride != 1 or b.downsample is not None for b in blocks):
        raise ValueError("only a stage's first block may change the shape")
    if stream_blocks:
        for b in blocks:
            w, scale, shift, packed = kept_operands(
                b, "res_block", [b.conv1[0], b.conv2], x, stacked=False)
            x = res_block(x, w[0], scale[0], shift[0], w[1], scale[1],
                          shift[1], b.dilation, packed)
        return x
    cbs = [cb for b in blocks for cb in (b.conv1[0], b.conv2)]
    w, scale, shift, packed = kept_operands(layer, "chain", cbs, x)
    return fused_residual_stage(x, w, scale, shift, blocks[0].dilation,
                                packed=packed)


def _train_block(b: BasicBlock, y: torch.Tensor) -> torch.Tensor:
    """A residual block of the training forward. NCHW."""
    out = train_convbn(F.relu(train_convbn(y, b.conv1[0])), b.conv2)
    return out + (y if b.downsample is None
                  else train_convbn(y, b.downsample))


class PSMNet(nn.Module):
    def __init__(self, feature_dim: int = 64, stream_blocks: bool = False,
                 remat: bool = False):
        super().__init__()
        self.stream_blocks = stream_blocks
        self.remat = remat
        self.firstconv = nn.Sequential(
            convbn(3, 32, 3, 2, 1, 1), nn.ReLU(),
            convbn(32, 32, 3, 1, 1, 1), nn.ReLU(),
            convbn(32, 32, 3, 1, 1, 1), nn.ReLU())
        inplanes = 32
        for li, (planes, blocks, stride, dil) in enumerate(STAGES, 1):
            down = None
            if stride != 1 or inplanes != planes:
                down = nn.Sequential(
                    nn.Conv2d(inplanes, planes, 1, stride, bias=False),
                    nn.BatchNorm2d(planes))
            layers = [BasicBlock(inplanes, planes, stride, down, dil)]
            layers += [BasicBlock(planes, planes, 1, None, dil)
                       for _ in range(blocks - 1)]
            setattr(self, f"layer{li}", nn.Sequential(*layers))
            inplanes = planes
        # The pooling module holds index 0 of the reference layout; the
        # forward pools with the window clamped to the map instead.
        for bi, win in enumerate(SPP_WINDOWS, 1):
            setattr(self, f"branch{bi}", nn.Sequential(
                nn.AvgPool2d((win, win), stride=(win, win)),
                convbn(128, 32, 1, 1, 0, 1), nn.ReLU()))
        self.lastconv = nn.Sequential(
            convbn(320, 128, 3, 1, 1, 1), nn.ReLU(),
            nn.Conv2d(128, feature_dim, 1, bias=False))

    def spp_branches(self, skip: torch.Tensor, convbn) -> torch.Tensor:
        """The four pooled branches of the NHWC map ``skip``, each resized
        back to its size, concatenated in the order branch4 .. branch1;
        ``convbn`` runs their conv-BN pairs."""
        H, W = skip.shape[1:3]
        # The SPP window is clamped to the map so that small inputs stay
        # valid; at the reference resolutions this changes nothing.
        branches = []
        for bi, win in enumerate(SPP_WINDOWS, 1):
            win = min(win, H, W)
            b = nchw(avg_pool(skip, win, win))
            b = F.relu(convbn(b, getattr(self, f"branch{bi}")[1]))
            branches.append(resize_bilinear_align_corners(nhwc(b), H, W))
        return torch.cat(branches[::-1], -1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, H, W, 3) -> (N, H/4, W/4, feature_dim), NHWC. Train mode
        runs ``train_forward``."""
        if self.training:
            return self.train_forward(x)
        y = nhwc(F.relu(run_convbn(nchw(x), self.firstconv[0])))
        w, scale, shift, packed = kept_operands(
            self.firstconv, "chain", [self.firstconv[2], self.firstconv[4]], y)
        y = fused_residual_stage(y, w, scale, shift, 1, residual=False,
                                 packed=packed)
        sb = self.stream_blocks
        raw = run_layer(run_layer(y, self.layer1, sb), self.layer2, sb)
        skip = run_layer(run_layer(raw, self.layer3, sb), self.layer4, sb)
        # concat order: raw, skip, branch4, branch3, branch2, branch1
        br = self.spp_branches(skip, run_convbn)
        conv0, bn0 = self.lastconv[0]
        proj = self.lastconv[2].weight
        widths = (raw.shape[-1], skip.shape[-1], br.shape[-1])

        def fold_tail():
            w0 = hwio(conv0, y.dtype)
            w1 = proj.to(y.dtype)[:, :, 0, 0].t().contiguous()
            packed = tail_operands(w0, w1, widths) if packs(y) else None
            return w0, *fold_bn(bn0), w1, packed
        tail = cached_fold(
            self.lastconv, "tail", y.dtype,
            [*self.lastconv.parameters(), *self.lastconv.buffers()],
            fold_tail)
        return spp_tail(raw, skip, br, *tail)

    def train_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The training forward: library convs with autograd, train-mode
        BatchNorm; with ``remat`` each residual block is recomputed in the
        backward (``layers.remat``). x: (N, H, W, 3) NHWC ->
        (N, H/4, W/4, feature_dim)."""
        y = nchw(x)
        for i in (0, 2, 4):
            y = F.relu(train_convbn(y, self.firstconv[i]))
        stages = []
        for li in range(1, len(STAGES) + 1):
            for b in getattr(self, f"layer{li}"):
                block = functools.partial(_train_block, b)
                y = remat(block, y) if self.remat else block(y)
            stages.append(y)
        raw, skip = nhwc(stages[1]), nhwc(stages[3])
        cat = torch.cat([raw, skip, self.spp_branches(skip, train_convbn)],
                        -1)
        y = F.relu(train_convbn(nchw(cat), self.lastconv[0]))
        proj = self.lastconv[2].weight
        return nhwc(F.conv2d(y, proj.to(y.dtype)))
