"""EfficientNet-B5 encoder (``tf_efficientnet_b5_ap``), PyTorch.

Counterpart of ``magnet_tpu/nn/efficientnet.py``: the D-Net trunk consumed
as a feature pyramid of the block-stage 0/1/2/4 outputs and the raw
(pre-BN) ``conv_head`` output:

    tap    stage       stride   channels
    f4     blocks[0]   /2       24
    f5     blocks[1]   /4       40
    f6     blocks[2]   /8       64
    f8     blocks[4]   /16      176
    f11    conv_head   /32      2048

``tf_`` semantics: TF-SAME conv padding, BatchNorm eps 1e-3, swish, and a
squeeze-excitation width of 0.25 of each block's input channels. Module
names give the reference state-dict keys (conv_stem, bn1,
blocks.{stage}.{idx}.{conv_pw,bn1,conv_dw,bn2,se,conv_pwl,bn3}, conv_head,
bn2). The trunk runs as plain PyTorch convolutions, as the JAX package runs
it in XLA. Train mode (D-Net training) has train-mode BatchNorm (eps 1e-3)
and stochastic depth on the residual branches at the JAX package's rates
(``drop_connect_rate`` 0.2 * block index / 39, the masks drawn from the
caller's generator; under W ranks each draws the global batch's mask and
takes its rows); with ``remat`` each block runs under
``layers.remat``. In eval mode one of the two switches of the JAX
package's opt-in TPU kernels may be on (both act in eval mode only, as
there):

* ``mbconv_chain`` (``MAGNET_TPU_PALLAS_MB``): ``"all"`` or a tuple of stage
  indices; blocks 1..n-1 of each selected inverted-residual stage run as one
  ``kernels.mbconv_chain`` call after block 0, on operands folded by
  ``fold_mbconv_chain`` (kept until a parameter changes, as are the
  depthwise taps of ``dw_kernel``: ``layers.cached_fold``);
* ``dw_kernel`` (``MAGNET_TPU_PALLAS_DW``): every stride-1 ``conv_dw`` that
  still runs as a module goes to ``kernels.dw_conv``.

The JAX package's VMEM gate (``mbchain_pallas.supported``) has no
counterpart: with the chain on, every stage's tail runs it, stages 2 and 6
at 480x640 included.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from magnet_tpu_torch.core.distributed import rank_world
from magnet_tpu_torch.core.mesh import rank_rows
from magnet_tpu_torch.kernels.mbconv_chain import mbconv_chain
from magnet_tpu_torch.nn.layers import (batch_norm_train, cached_fold, conv2d,
                                        conv2d_same, drop_path,
                                        drop_path_mask, fold_bn, nchw, nhwc,
                                        norm, remat)

BN_EPS_TF = 1e-3
DROP_CONNECT_RATE = 0.2


def round_channels(ch: float, multiplier: float, divisor: int = 8) -> int:
    """EfficientNet channel rounding (make_divisible)."""
    ch *= multiplier
    new_ch = max(divisor, int(ch + divisor / 2) // divisor * divisor)
    if new_ch < 0.9 * ch:
        new_ch += divisor
    return int(new_ch)


def round_repeats(repeats: int, multiplier: float) -> int:
    return int(math.ceil(multiplier * repeats))


# Base (B0) stages: (block_type, kernel, stride, expand, out_ch, repeats).
_B0_STAGES = (
    ("ds", 3, 1, 1, 16, 1),
    ("ir", 3, 2, 6, 24, 2),
    ("ir", 5, 2, 6, 40, 2),
    ("ir", 3, 2, 6, 80, 3),
    ("ir", 5, 1, 6, 112, 3),
    ("ir", 5, 2, 6, 192, 4),
    ("ir", 3, 1, 6, 320, 1),
)


def b5_stage_config():
    """Per-block config list-of-stages for B5 (width 1.6, depth 2.2)."""
    width, depth = 1.6, 2.2
    stages = []
    in_ch = round_channels(32, width)          # stem: 48
    for (btype, k, s, e, c, n) in _B0_STAGES:
        out_ch = round_channels(c, width)
        blocks = []
        for i in range(round_repeats(n, depth)):
            blocks.append(dict(
                btype=btype, kernel=k, stride=s if i == 0 else 1,
                expand=e, in_ch=in_ch, out_ch=out_ch))
            in_ch = out_ch
        stages.append(blocks)
    return stages


def _bn(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=BN_EPS_TF)


class SqueezeExcite(nn.Module):
    """SE gate: pool -> reduce 1x1 -> swish -> expand 1x1 -> sigmoid, with
    the pooled path in f32 as in the JAX package."""

    def __init__(self, ch: int, reduced: int):
        super().__init__()
        self.conv_reduce = nn.Conv2d(ch, reduced, 1, bias=True)
        self.conv_expand = nn.Conv2d(reduced, ch, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        se = x.float().mean((2, 3), keepdim=True)
        se = F.silu(conv2d(se, self.conv_reduce))
        se = conv2d(se, self.conv_expand)
        return x * torch.sigmoid(se).to(x.dtype)


class DepthwiseSeparable(nn.Module):
    """Stage-0 block: dw conv -> BN -> swish -> SE -> pw conv -> BN. A
    block's ``drop_rate`` is its stochastic depth rate; ``forward`` takes the
    keep mask of its samples (``layers.drop_path_mask``) in train mode."""

    def __init__(self, cfg: dict, dw_kernel: bool = False):
        super().__init__()
        c = cfg
        self.dw_kernel = dw_kernel
        self.drop_rate = 0.0
        self.conv_dw = nn.Conv2d(c["in_ch"], c["in_ch"], c["kernel"],
                                 c["stride"], groups=c["in_ch"], bias=False)
        self.bn1 = _bn(c["in_ch"])
        self.se = SqueezeExcite(c["in_ch"], max(1, int(c["in_ch"] * 0.25)))
        self.conv_pw = nn.Conv2d(c["in_ch"], c["out_ch"], 1, bias=False)
        self.bn2 = _bn(c["out_ch"])
        self.residual = c["in_ch"] == c["out_ch"] and c["stride"] == 1

    def forward(self, x: torch.Tensor, drop_mask=None) -> torch.Tensor:
        t = self.training
        y = conv2d_same(x, self.conv_dw, self.dw_kernel and not t)
        y = F.silu(norm(y, self.bn1, t))
        y = self.se(y)
        y = norm(conv2d(y, self.conv_pw), self.bn2, t)
        return _residual(y, x, self, drop_mask)


def _residual(y: torch.Tensor, x: torch.Tensor, block: nn.Module,
              drop_mask) -> torch.Tensor:
    """A block's output: with the shortcut where it has one, its branch
    dropped per sample by ``drop_mask`` where that is given."""
    if not block.residual:
        return y
    if drop_mask is not None:
        y = drop_path(y, drop_mask, block.drop_rate)
    return y + x


class InvertedResidual(nn.Module):
    """MBConv: pw expand -> dw -> SE -> pw linear, residual when possible."""

    def __init__(self, cfg: dict, dw_kernel: bool = False):
        super().__init__()
        c = cfg
        self.dw_kernel = dw_kernel
        self.drop_rate = 0.0
        mid = c["in_ch"] * c["expand"]
        self.conv_pw = nn.Conv2d(c["in_ch"], mid, 1, bias=False)
        self.bn1 = _bn(mid)
        self.conv_dw = nn.Conv2d(mid, mid, c["kernel"], c["stride"],
                                 groups=mid, bias=False)
        self.bn2 = _bn(mid)
        self.se = SqueezeExcite(mid, max(1, int(c["in_ch"] * 0.25)))
        self.conv_pwl = nn.Conv2d(mid, c["out_ch"], 1, bias=False)
        self.bn3 = _bn(c["out_ch"])
        self.residual = c["in_ch"] == c["out_ch"] and c["stride"] == 1

    def forward(self, x: torch.Tensor, drop_mask=None) -> torch.Tensor:
        t = self.training
        y = F.silu(norm(conv2d(x, self.conv_pw), self.bn1, t))
        y = conv2d_same(y, self.conv_dw, self.dw_kernel and not t)
        y = F.silu(norm(y, self.bn2, t))
        y = self.se(y)
        y = norm(conv2d(y, self.conv_pwl), self.bn3, t)
        return _residual(y, x, self, drop_mask)


CHAIN_OPERANDS = ("wpw", "s1", "wdw", "s2", "wse1", "bse1", "wse2", "bse2",
                  "wpwl", "s3")


def fold_mbconv_chain(blocks: Sequence[InvertedResidual],
                      dtype: torch.dtype) -> List[torch.Tensor]:
    """Equal-shaped stride-1 InvertedResidual blocks as the stacked operands
    of ``kernels.mbconv_chain`` (in ``CHAIN_OPERANDS`` order), as the JAX
    package's ``_fused_chain`` packs them: eval BatchNorm folded (eps 1e-3)
    in f32, bn1's scale into the expand columns, bn2's into the depthwise
    taps, bn3's into the projection columns; those three in ``dtype``, the
    shifts and the SE layers f32."""
    f32 = torch.float32
    packs = {k: [] for k in CHAIN_OPERANDS}
    with torch.no_grad():
        for b in blocks:
            (sc1, t1), (sc2, t2), (sc3, t3) = (fold_bn(b.bn1), fold_bn(b.bn2),
                                               fold_bn(b.bn3))
            M, _, K, _ = b.conv_dw.weight.shape
            se = b.se
            packs["wpw"].append(b.conv_pw.weight[:, :, 0, 0].to(f32).t() * sc1)
            packs["s1"].append(t1)
            packs["wdw"].append(
                b.conv_dw.weight.to(f32).reshape(M, K * K).t() * sc2)
            packs["s2"].append(t2)
            packs["wse1"].append(se.conv_reduce.weight[:, :, 0, 0].to(f32).t())
            packs["bse1"].append(se.conv_reduce.bias.to(f32))
            packs["wse2"].append(se.conv_expand.weight[:, :, 0, 0].to(f32).t())
            packs["bse2"].append(se.conv_expand.bias.to(f32))
            packs["wpwl"].append(b.conv_pwl.weight[:, :, 0, 0].to(f32).t() * sc3)
            packs["s3"].append(t3)
        return [torch.stack(packs[k]).to(dtype if k in ("wpw", "wdw", "wpwl")
                                         else f32).contiguous()
                for k in CHAIN_OPERANDS]


def chain_stages(selection: Union[None, str, Sequence[int]]) -> frozenset:
    """The stage indices whose stride-1 tail runs as one chain: ``None`` none,
    ``"all"`` every inverted-residual stage with a tail, or those of a
    sequence of indices (a depthwise-separable stage has no chain)."""
    stages = b5_stage_config()
    if selection is None:
        return frozenset()
    chosen = range(len(stages)) if selection == "all" else selection
    out = set()
    for si in chosen:
        if not 0 <= int(si) < len(stages):
            raise ValueError(f"mbconv_chain: no stage {si}")
        stage = stages[int(si)]
        if len(stage) > 1 and stage[1]["btype"] == "ir":
            out.add(int(si))
    return frozenset(out)


class EfficientNetB5Features(nn.Module):
    """Returns the 5 decoder taps (f4, f5, f6, f8, f11), NCHW; see the
    module doc for ``mbconv_chain``, ``dw_kernel`` and ``remat``. The
    decoder reads the head conv before ``bn2``, which only tracks its
    statistics in train mode, as in the JAX package."""

    def __init__(self, mbconv_chain: Union[None, str, Sequence[int]] = None,
                 dw_kernel: bool = False, remat: bool = False):
        super().__init__()
        self.chain_stages = chain_stages(mbconv_chain)
        self.dw_kernel = dw_kernel
        self.remat = remat
        self.conv_stem = nn.Conv2d(3, 48, 3, 2, bias=False)
        self.bn1 = _bn(48)
        self.blocks = nn.Sequential(*[
            nn.Sequential(*[DepthwiseSeparable(c, dw_kernel)
                            if c["btype"] == "ds"
                            else InvertedResidual(c, dw_kernel)
                            for c in stage])
            for stage in b5_stage_config()])
        self.conv_head = nn.Conv2d(512, 2048, 1, bias=False)
        self.bn2 = _bn(2048)
        blocks = [b for stage in self.blocks for b in stage]
        for i, b in enumerate(blocks):
            b.drop_rate = DROP_CONNECT_RATE * i / len(blocks)

    def chain_operands(self, si: int, dtype: torch.dtype
                       ) -> List[torch.Tensor]:
        """Stage si's tail folded for ``mbconv_chain``, refolded when a
        parameter or buffer of it has changed (``cached_fold``)."""
        tail = list(self.blocks[si])[1:]
        return cached_fold(
            self, f"chain{si}", dtype,
            [t for b in tail for t in (*b.parameters(), *b.buffers())],
            lambda: fold_mbconv_chain(tail, dtype))

    def forward(self, x: torch.Tensor,
                generator: torch.Generator = None) -> List[torch.Tensor]:
        """x: (N, 3, H, W). In train mode the drop masks come from
        ``generator`` (required there), on the device of the maps."""
        t = self.training
        y = F.silu(norm(conv2d_same(x, self.conv_stem), self.bn1, t))
        if (self.chain_stages or self.dw_kernel) and not t:
            # The kernels take the maps' NHWC views, which are free only in
            # channels-last memory; an input whose strides are ambiguous
            # (a size-1 batch with stride 0) gives an NCHW stem output.
            y = y.contiguous(memory_format=torch.channels_last)
        taps = []
        world = rank_world()[1]
        for si, stage in enumerate(self.blocks):
            if si in self.chain_stages and not t:
                y = stage[0](y)
                y = nchw(mbconv_chain(nhwc(y), *self.chain_operands(
                    si, y.dtype), stage[1].conv_dw.kernel_size[0]))
                taps.append(y)
                continue
            for b in stage:
                mask = None
                if t and b.residual and b.drop_rate > 0:
                    if generator is None:
                        raise ValueError("train mode draws the drop-path "
                                         "masks from a generator")
                    # the global batch's mask, this rank's rows: W ranks
                    # drop what one process drops
                    mask = rank_rows(drop_path_mask(
                        y.shape[0] * world, b.drop_rate, generator))
                y = remat(b, y, mask) if self.remat and t else b(y, mask)
            taps.append(y)
        head = conv2d(y, self.conv_head)
        if t:
            with torch.no_grad():       # statistics only; the output is unused
                batch_norm_train(head.detach(), self.bn2)
        return [taps[0], taps[1], taps[2], taps[4], head]
