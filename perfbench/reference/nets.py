"""The networks of MaGNet in plain PyTorch, NCHW, float32.

Written from the published architectures (gen-efficientnet's
tf_efficientnet_b5_ap trunk, the DenseDepth BatchNorm decoder, PSM-Net's
feature extractor, MaGNet's G-Net and mask head) with the parameter names of
the reference checkpoints, so one state dict loads into these modules and
into the program alike. Every convolution is a ``QConv2d``, whose operands
pass through a ``precision.Precision`` first (float32 by default; the
control sets fp8 with ``set_precision``).

Departure: PSM-Net's pooling windows are clamped to the map, as MaGNet's
port does, so that tiny test inputs stay valid; at the published shapes
(maps of 120x160 and 88x304) no window is clamped.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from perfbench.reference.precision import Precision

BN_EPS_TF = 1e-3
# B0's stages (block type, kernel, stride, expand, channels, repeats),
# scaled for B5 by width 1.6 and depth 2.2
B0_STAGES = (("ds", 3, 1, 1, 16, 1), ("ir", 3, 2, 6, 24, 2),
             ("ir", 5, 2, 6, 40, 2), ("ir", 3, 2, 6, 80, 3),
             ("ir", 5, 1, 6, 112, 3), ("ir", 5, 2, 6, 192, 4),
             ("ir", 3, 1, 6, 320, 1))
B5_WIDTH, B5_DEPTH = 1.6, 2.2
PSM_STAGES = ((32, 3, 1, 1), (64, 16, 2, 1), (128, 3, 1, 1), (128, 3, 1, 2))
SPP_WINDOWS = (64, 32, 16, 8)


def round_channels(ch: float, divisor: int = 8) -> int:
    ch *= B5_WIDTH
    out = max(divisor, int(ch + divisor / 2) // divisor * divisor)
    return int(out + divisor if out < 0.9 * ch else out)


def b5_stages() -> list:
    """[[(btype, kernel, stride, expand, in_ch, out_ch), ...], ...]."""
    stages, in_ch = [], round_channels(32)
    for btype, k, s, e, c, n in B0_STAGES:
        out_ch, blocks = round_channels(c), []
        for i in range(int(math.ceil(B5_DEPTH * n))):
            blocks.append((btype, k, s if i == 0 else 1, e, in_ch, out_ch))
            in_ch = out_ch
        stages.append(blocks)
    return stages


def swish(x):
    return x * torch.sigmoid(x)


class QConv2d(nn.Conv2d):
    """A convolution whose input and weight are rounded by ``prec``."""

    prec = Precision()

    def forward(self, x):
        return self._conv_forward(self.prec(x), self.prec(self.weight),
                                  self.bias)


class Conv2dSame(QConv2d):
    """TF-SAME padding: the odd pad goes right and bottom."""

    def forward(self, x):
        ih, iw = x.shape[-2:]
        kh, kw = self.weight.shape[-2:]
        sh, sw = self.stride
        ph = max((math.ceil(ih / sh) - 1) * sh + kh - ih, 0)
        pw = max((math.ceil(iw / sw) - 1) * sw + kw - iw, 0)
        x = F.pad(x, [pw // 2, pw - pw // 2, ph // 2, ph - ph // 2])
        return F.conv2d(self.prec(x), self.prec(self.weight), self.bias,
                        self.stride, 0, 1, self.groups)


def set_precision(model: nn.Module, prec: Precision) -> nn.Module:
    for m in model.modules():
        if isinstance(m, QConv2d):
            m.prec = prec
    return model


def precision_of(model: nn.Module) -> Precision:
    """The precision ``set_precision`` gave ``model``'s convolutions."""
    return next(m for m in model.modules() if isinstance(m, QConv2d)).prec


class SqueezeExcite(nn.Module):
    def __init__(self, ch, reduced):
        super().__init__()
        self.conv_reduce = QConv2d(ch, reduced, 1)
        self.conv_expand = QConv2d(reduced, ch, 1)

    def forward(self, x):
        se = swish(self.conv_reduce(x.mean((2, 3), keepdim=True)))
        return x * torch.sigmoid(self.conv_expand(se))


class DSBlock(nn.Module):
    def __init__(self, in_ch, out_ch, kernel, stride):
        super().__init__()
        self.conv_dw = Conv2dSame(in_ch, in_ch, kernel, stride, groups=in_ch,
                                  bias=False)
        self.bn1 = nn.BatchNorm2d(in_ch, eps=BN_EPS_TF)
        self.se = SqueezeExcite(in_ch, max(1, int(in_ch * 0.25)))
        self.conv_pw = QConv2d(in_ch, out_ch, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(out_ch, eps=BN_EPS_TF)
        self.residual = in_ch == out_ch and stride == 1

    def forward(self, x):
        y = self.se(swish(self.bn1(self.conv_dw(x))))
        y = self.bn2(self.conv_pw(y))
        return y + x if self.residual else y


class IRBlock(nn.Module):
    def __init__(self, in_ch, out_ch, kernel, stride, expand):
        super().__init__()
        mid = in_ch * expand
        self.conv_pw = QConv2d(in_ch, mid, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(mid, eps=BN_EPS_TF)
        self.conv_dw = Conv2dSame(mid, mid, kernel, stride, groups=mid,
                                  bias=False)
        self.bn2 = nn.BatchNorm2d(mid, eps=BN_EPS_TF)
        self.se = SqueezeExcite(mid, max(1, int(in_ch * 0.25)))
        self.conv_pwl = QConv2d(mid, out_ch, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out_ch, eps=BN_EPS_TF)
        self.residual = in_ch == out_ch and stride == 1

    def forward(self, x):
        y = swish(self.bn1(self.conv_pw(x)))
        y = self.se(swish(self.bn2(self.conv_dw(y))))
        y = self.bn3(self.conv_pwl(y))
        return y + x if self.residual else y


class EffNetB5(nn.Module):
    """The B5 trunk; returns the taps of stages 0, 1, 2, 4 and the head conv
    (before its BatchNorm), strides 2, 4, 8, 16, 32."""

    def __init__(self):
        super().__init__()
        self.conv_stem = Conv2dSame(3, 48, 3, 2, bias=False)
        self.bn1 = nn.BatchNorm2d(48, eps=BN_EPS_TF)
        self.blocks = nn.Sequential(*[nn.Sequential(*[
            DSBlock(i, o, k, s) if bt == "ds" else IRBlock(i, o, k, s, e)
            for bt, k, s, e, i, o in stage]) for stage in b5_stages()])
        self.conv_head = QConv2d(512, 2048, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(2048, eps=BN_EPS_TF)

    def forward(self, x):
        y = swish(self.bn1(self.conv_stem(x)))
        taps = []
        for stage in self.blocks:
            y = stage(y)
            taps.append(y)
        return [taps[0], taps[1], taps[2], taps[4], self.conv_head(y)]


class UpSampleBN(nn.Module):
    def __init__(self, skip_input, out_f):
        super().__init__()
        self._net = nn.Sequential(
            QConv2d(skip_input, out_f, 3, padding=1), nn.BatchNorm2d(out_f),
            nn.LeakyReLU(), QConv2d(out_f, out_f, 3, padding=1),
            nn.BatchNorm2d(out_f), nn.LeakyReLU())

    def forward(self, x, skip):
        up = F.interpolate(x, size=skip.shape[-2:], mode="bilinear",
                           align_corners=True)
        return self._net(torch.cat([up, skip], 1))


def head(in_ch, out_ch, n_1x1=2, hidden=128):
    """conv3x3 -> ReLU, then ``n_1x1`` 1x1 convs with ReLU between them."""
    layers = [QConv2d(in_ch, hidden, 3, padding=1), nn.ReLU()]
    for i in range(n_1x1):
        last = i == n_1x1 - 1
        layers.append(QConv2d(hidden, out_ch if last else hidden, 1))
        if not last:
            layers.append(nn.ReLU())
    return nn.Sequential(*layers)


class Decoder(nn.Module):
    """The BatchNorm decoder at downsample ratio 4: (depth, feature)."""

    def __init__(self, num_classes=2, k=4):
        super().__init__()
        self.conv2 = QConv2d(2048, 2048, 1)
        self.up1 = UpSampleBN(2048 + 176, 1024)
        self.up2 = UpSampleBN(1024 + 64, 512)
        self.up3 = UpSampleBN(512 + 40, 256)
        self.depth_head = head(256, num_classes)
        self.mask_head = head(256, 9 * k * k)   # in the layout, unused here

    def forward(self, feats):
        f4, f5, f6, f8, f11 = feats
        y = self.up3(self.up2(self.up1(self.conv2(f11), f8), f6), f5)
        return self.depth_head(y), y


class DNet(nn.Module):
    """images -> coarse (mu, sigma) and the decoder feature, NCHW."""

    def __init__(self):
        super().__init__()
        self.d_net = nn.Module()
        self.d_net.encoder = nn.Module()
        self.d_net.encoder.original_model = EffNetB5()
        self.d_net.decoder = Decoder()

    def forward(self, x):
        depth, feat = self.d_net.decoder(self.d_net.encoder.original_model(x))
        mu, v = depth[:, 0:1], depth[:, 1:2]
        return torch.cat([mu, torch.sqrt(F.elu(v) + 1.0 + 1e-10)], 1), feat


def convbn(inp, outp, k, s, pad, dil):
    return nn.Sequential(
        QConv2d(inp, outp, k, s, dil if dil > 1 else pad, dil, bias=False),
        nn.BatchNorm2d(outp))


class BasicBlock(nn.Module):
    def __init__(self, inplanes, planes, stride, downsample, dil):
        super().__init__()
        self.conv1 = nn.Sequential(convbn(inplanes, planes, 3, stride, 1,
                                          dil), nn.ReLU())
        self.conv2 = convbn(planes, planes, 3, 1, 1, dil)
        self.downsample = downsample

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        return out + (x if self.downsample is None else self.downsample(x))


class PSMNet(nn.Module):
    def __init__(self, feature_dim=64):
        super().__init__()
        self.firstconv = nn.Sequential(
            convbn(3, 32, 3, 2, 1, 1), nn.ReLU(),
            convbn(32, 32, 3, 1, 1, 1), nn.ReLU(),
            convbn(32, 32, 3, 1, 1, 1), nn.ReLU())
        inplanes = 32
        for li, (planes, blocks, stride, dil) in enumerate(PSM_STAGES, 1):
            down = None
            if stride != 1 or inplanes != planes:
                down = nn.Sequential(
                    QConv2d(inplanes, planes, 1, stride, bias=False),
                    nn.BatchNorm2d(planes))
            layers = [BasicBlock(inplanes, planes, stride, down, dil)]
            layers += [BasicBlock(planes, planes, 1, None, dil)
                       for _ in range(blocks - 1)]
            setattr(self, f"layer{li}", nn.Sequential(*layers))
            inplanes = planes
        for bi in range(1, 5):
            setattr(self, f"branch{bi}", nn.Sequential(
                nn.Identity(), convbn(128, 32, 1, 1, 0, 1), nn.ReLU()))
        self.lastconv = nn.Sequential(
            convbn(320, 128, 3, 1, 1, 1), nn.ReLU(),
            QConv2d(128, feature_dim, 1, bias=False))

    def forward(self, x):
        y = self.firstconv(x)
        raw = self.layer2(self.layer1(y))
        skip = self.layer4(self.layer3(raw))
        size = skip.shape[-2:]
        branches = []
        for bi, win in enumerate(SPP_WINDOWS, 1):
            win = min(win, *size)
            b = getattr(self, f"branch{bi}")(F.avg_pool2d(skip, win, win))
            branches.append(F.interpolate(b, size=size, mode="bilinear",
                                          align_corners=True))
        return self.lastconv(torch.cat([raw, skip] + branches[::-1], 1))


class FNet(nn.Module):
    def __init__(self, feature_dim=64):
        super().__init__()
        self.f_net = PSMNet(feature_dim)

    def forward(self, x):
        return self.f_net(x)


class GNet(nn.Module):
    """concat(cost volume, decoder feature) -> the updated (mu, sigma)."""

    def __init__(self, n_samples=5, feature_dim=256):
        super().__init__()
        self.gnet = head(n_samples + feature_dim, 2, n_1x1=3)

    def forward(self, cv, feat, prev):
        out = self.gnet(torch.cat([cv, feat], 1))
        mu0, s0 = prev[:, 0:1], prev[:, 1:2]
        mu = mu0 + out[:, 0:1] * s0
        return torch.cat([mu, (F.elu(out[:, 1:2]) + 1.0 + 1e-10) * s0], 1)


class Magnet(nn.Module):
    """The parameters of the whole pipeline, in the checkpoint layout."""

    def __init__(self, n_samples=5, fnet_feature_dim=64, k=4):
        super().__init__()
        self.d_net = DNet()
        self.f_net = FNet(fnet_feature_dim)
        self.g_net = GNet(n_samples)
        self.mask_head = head(256, 9 * k * k, n_1x1=3)


class MagnetF(nn.Module):
    """The parameters of F-Net training (stage 2)."""

    def __init__(self, fnet_feature_dim=64):
        super().__init__()
        self.f_net = FNet(fnet_feature_dim)
