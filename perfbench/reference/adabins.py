"""AdaBins in plain PyTorch, NCHW, float32.

Written from the published code of Bhat, Alhashim and Wonka (CVPR 2021,
arXiv:2011.14141; github.com/shariqfarooq123/AdaBins,
``models/unet_adaptive_bins.py``, ``models/miniViT.py``,
``models/layers.py``) layer by layer, with its parameter names, so one
state dict loads into these modules and into the program alike: the B5
trunk and ``UpSampleBN`` of ``reference/nets.py`` (the published
``Encoder`` and ``UpSampleBN``), ``DecoderBN(num_classes=128)`` with its
1x1 ``conv2`` at padding 1, ``mViT(128, n_query_channels=128,
patch_size=16, dim_out=n_bins, embedding_dim=128, norm='linear')`` over
``nn.TransformerEncoder``'s four post-norm layers (sequence first, as
published), ``PixelWiseDotProduct`` and ``conv_out`` with its softmax, and
``UnetAdaptiveBins.forward``'s bin edges and weighted centres.

Every matrix product (the convolutions, the Linear layers, attention's
projections and products, the pixel-wise dot product) takes operands
rounded by a ``precision.Precision`` (float32 by default; ``set_precision``
sets fp8 for the control or bfloat16 for the witness). The softmax over
the bins, the cumulative sum of the widths and the weighted sum of the
centres stay float32 in every precision, as the configurations' compute
policy keeps them.

Departure from the published code: no dropout (the encoder layers' 0.1),
which is off in eval, where the model runs.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from perfbench.reference.nets import EffNetB5, QConv2d, UpSampleBN
from perfbench.reference.precision import Precision


class QLinear(nn.Linear):
    """A Linear layer whose input and weight are rounded by ``prec``."""

    prec = Precision()

    def forward(self, x):
        return F.linear(self.prec(x), self.prec(self.weight), self.bias)


class QAttention(nn.MultiheadAttention):
    """``nn.MultiheadAttention``'s packed parameters; its forward written
    out (self-attention, no mask), every product's operands rounded."""

    prec = Precision()

    def forward(self, x):
        """x: (S, N, E)."""
        q = self.prec
        S, N, E = x.shape
        h = self.num_heads
        d = E // h
        qkv = q(x) @ q(self.in_proj_weight).T + self.in_proj_bias
        qh, kh, vh = (t.reshape(S, N * h, d).transpose(0, 1)
                      for t in qkv.chunk(3, -1))
        att = torch.softmax(q(qh) @ q(kh).transpose(1, 2) * d ** -0.5, -1)
        o = (q(att) @ q(vh)).transpose(0, 1).reshape(S, N, E)
        return q(o) @ q(self.out_proj.weight).T + self.out_proj.bias


class TransformerEncoderLayer(nn.Module):
    """``nn.TransformerEncoderLayer(d_model, nhead, dim_feedforward)`` in
    eval: post-norm, ReLU."""

    def __init__(self, d_model, nhead, dim_feedforward):
        super().__init__()
        self.self_attn = QAttention(d_model, nhead)
        self.linear1 = QLinear(d_model, dim_feedforward)
        self.linear2 = QLinear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)

    def forward(self, x):
        x = self.norm1(x + self.self_attn(x))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


class PatchTransformerEncoder(nn.Module):
    def __init__(self, in_channels, patch_size=16, embedding_dim=128,
                 num_heads=4):
        super().__init__()
        self.transformer_encoder = nn.Module()
        self.transformer_encoder.layers = nn.ModuleList(
            TransformerEncoderLayer(embedding_dim, num_heads, 1024)
            for _ in range(4))
        self.embedding_convPxP = QConv2d(in_channels, embedding_dim,
                                         patch_size, patch_size, 0)
        self.positional_encodings = nn.Parameter(torch.rand(500,
                                                            embedding_dim))

    def forward(self, x):
        embeddings = self.embedding_convPxP(x).flatten(2)
        embeddings = embeddings + self.positional_encodings[
            :embeddings.shape[2], :].T.unsqueeze(0)
        x = embeddings.permute(2, 0, 1)
        for layer in self.transformer_encoder.layers:
            x = layer(x)
        return x


class MiniViT(nn.Module):
    prec = Precision()

    def __init__(self, in_channels, n_query_channels=128, patch_size=16,
                 dim_out=256, embedding_dim=128, num_heads=4):
        super().__init__()
        self.n_query_channels = n_query_channels
        self.patch_transformer = PatchTransformerEncoder(
            in_channels, patch_size, embedding_dim, num_heads)
        self.conv3x3 = QConv2d(in_channels, embedding_dim, 3, 1, 1)
        self.regressor = nn.Sequential(
            QLinear(embedding_dim, 256), nn.LeakyReLU(), QLinear(256, 256),
            nn.LeakyReLU(), QLinear(256, dim_out))

    def dot_product(self, x, K):
        """``PixelWiseDotProduct``: x (n, c, h, w), K (n, cout, c) ->
        (n, cout, h, w)."""
        n, c, h, w = x.shape
        y = torch.matmul(self.prec(x).view(n, c, h * w).permute(0, 2, 1),
                         self.prec(K).permute(0, 2, 1))
        return y.permute(0, 2, 1).reshape(n, -1, h, w)

    def forward(self, x):
        tgt = self.patch_transformer(x.clone())
        x = self.conv3x3(x)
        regression_head = tgt[0, ...]
        queries = tgt[1:self.n_query_channels + 1, ...].permute(1, 0, 2)
        range_attention_maps = self.dot_product(x, queries)
        y = torch.relu(self.regressor(regression_head)) + 0.1
        return y / y.sum(dim=1, keepdim=True), range_attention_maps


class DecoderBN(nn.Module):
    def __init__(self, num_features=2048, num_classes=128,
                 bottleneck_features=2048):
        super().__init__()
        f = num_features
        self.conv2 = QConv2d(bottleneck_features, f, 1, 1, 1)
        self.up1 = UpSampleBN(f + 176, f // 2)
        self.up2 = UpSampleBN(f // 2 + 64, f // 4)
        self.up3 = UpSampleBN(f // 4 + 40, f // 8)
        self.up4 = UpSampleBN(f // 8 + 24, f // 16)
        self.conv3 = QConv2d(f // 16, num_classes, 3, 1, 1)

    def forward(self, features):
        f4, f5, f6, f8, f11 = features
        x = self.up2(self.up1(self.conv2(f11), f8), f6)
        return self.conv3(self.up4(self.up3(x, f5), f4))


class AdaBins(nn.Module):
    """``UnetAdaptiveBins`` on the B5 trunk: ``forward(x)`` (x NCHW) gives
    (bin edges (n, n_bins + 1), depth (n, 1, H/2, W/2)). ``features(x)`` is
    the decoder's feature u, ``from_features(u)`` the rest from it."""

    def __init__(self, n_bins=256, min_val=1e-3, max_val=80.0):
        super().__init__()
        self.min_val, self.max_val = min_val, max_val
        self.encoder = nn.Module()
        self.encoder.original_model = EffNetB5()
        self.adaptive_bins_layer = MiniViT(128, n_query_channels=128,
                                           patch_size=16, dim_out=n_bins,
                                           embedding_dim=128)
        self.decoder = DecoderBN(num_classes=128)
        self.conv_out = nn.Sequential(QConv2d(128, n_bins, 1, 1, 0),
                                      nn.Softmax(dim=1))

    def features(self, x):
        return self.decoder(self.encoder.original_model(x))

    def from_features(self, u, edges=None):
        """(bin edges, depth) from u; ``edges`` (n, n_bins + 1), where
        given, are the edges whose centres the probabilities weigh in
        place of its own, which holds the bins head apart from the
        widths."""
        bin_widths_normed, range_attention_maps = self.adaptive_bins_layer(u)
        out = self.conv_out(range_attention_maps)
        bin_widths = (self.max_val - self.min_val) * bin_widths_normed
        bin_widths = F.pad(bin_widths, (1, 0), mode="constant",
                           value=self.min_val)
        bin_edges = torch.cumsum(bin_widths, dim=1)
        e = bin_edges if edges is None else edges.float()
        centers = 0.5 * (e[:, :-1] + e[:, 1:])
        n, dout = centers.size()
        pred = torch.sum(out * centers.view(n, dout, 1, 1), dim=1,
                         keepdim=True)
        return bin_edges, pred

    def forward(self, x):
        return self.from_features(self.features(x))


def set_precision(model: nn.Module, prec: Precision) -> nn.Module:
    """``prec`` for every product of ``model``."""
    for m in model.modules():
        if isinstance(m, (QConv2d, QLinear, QAttention, MiniViT)):
            m.prec = prec
    return model
