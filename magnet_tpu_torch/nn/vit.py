"""AdaBins' mini-ViT (``mViT`` in the published ``models/miniViT.py``, its
``PatchTransformerEncoder`` in ``models/layers.py``), PyTorch.

A conv of ``patch_size`` squares with the same stride embeds the decoder
feature into tokens, learned positions are added (at most
``MAX_POSITIONS`` of them: a map with more patches raises, from its shape
alone), and ``nn.TransformerEncoder`` runs ``num_layers``
``nn.TransformerEncoderLayer(E, heads, dim_feedforward)`` over them, as
published: post-norm, ReLU, LayerNorm eps 1e-5; in eval there is no
dropout and PyTorch's fused path runs the layer. Token 0 goes to the
``regressor`` (Linear, LeakyReLU, Linear, LeakyReLU, Linear), whose
``relu(y) + 0.1`` normalised to sum 1 gives the bin widths; tokens 1 to
``n_query_channels`` are the queries of the range-attention maps.
``conv3x3`` is the mini-ViT's 3x3 conv of the feature, which
``models/adabins.py`` runs in its bins head.

Tokens are (B, S, E), batch first (the published code is sequence first;
the values are the same), in the dtype of the feature. Products run in
that dtype (``models/build.py::cast_for_inference`` puts the Linear,
attention and LayerNorm parameters in the compute dtype, as the fused
layer needs one dtype; LayerNorm's statistics are float32 in its
kernel); the positions are float32, rounded to the tokens' dtype where
they are added, and the widths are normalised in float32. Names give the
published state-dict keys: ``patch_transformer.{embedding_convPxP,
positional_encodings, transformer_encoder.layers.{i}.{self_attn.in_proj_*,
self_attn.out_proj, linear1, linear2, norm1, norm2}}``, ``conv3x3``,
``regressor.{0,2,4}``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from magnet_tpu_torch.nn.layers import conv2d, nchw, nhwc

MAX_POSITIONS = 500
WIDTH_EPS = 0.1


class PatchTransformerEncoder(nn.Module):
    def __init__(self, in_channels: int, patch_size: int = 16,
                 embedding_dim: int = 128, num_heads: int = 4,
                 dim_feedforward: int = 1024, num_layers: int = 4):
        super().__init__()
        self.patch_size = patch_size
        self.transformer_encoder = nn.TransformerEncoder(
            nn.TransformerEncoderLayer(embedding_dim, num_heads,
                                       dim_feedforward, batch_first=True),
            num_layers, enable_nested_tensor=False)
        self.embedding_convPxP = nn.Conv2d(in_channels, embedding_dim,
                                           patch_size, stride=patch_size)
        self.positional_encodings = nn.Parameter(
            torch.rand(MAX_POSITIONS, embedding_dim))

    def n_tokens(self, h: int, w: int) -> int:
        """The tokens of an (h, w) map; more than the positions raise."""
        n = (h // self.patch_size) * (w // self.patch_size)
        if n > self.positional_encodings.shape[0]:
            raise ValueError(
                f"a {h}x{w} map makes {n} patches of {self.patch_size}x"
                f"{self.patch_size}; the model has "
                f"{self.positional_encodings.shape[0]} positions")
        return n

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        """u: (B, h, w, C) NHWC -> tokens (B, S, E)."""
        B, h, w, _ = u.shape
        S = self.n_tokens(h, w)
        t = nhwc(conv2d(nchw(u), self.embedding_convPxP)).view(B, S, -1)
        t = t + self.positional_encodings[:S].to(t.dtype)
        return self.transformer_encoder(t)


class MiniViT(nn.Module):
    """The bin widths and the queries of a decoder feature."""

    def __init__(self, in_channels: int, n_query_channels: int = 128,
                 patch_size: int = 16, dim_out: int = 256,
                 embedding_dim: int = 128, num_heads: int = 4):
        super().__init__()
        self.n_query_channels = n_query_channels
        self.patch_transformer = PatchTransformerEncoder(
            in_channels, patch_size, embedding_dim, num_heads)
        self.conv3x3 = nn.Conv2d(in_channels, embedding_dim, 3, padding=1)
        self.regressor = nn.Sequential(
            nn.Linear(embedding_dim, 256), nn.LeakyReLU(), nn.Linear(256, 256),
            nn.LeakyReLU(), nn.Linear(256, dim_out))

    def forward(self, u: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """u: (B, h, w, C) NHWC -> (the normalised bin widths (B, dim_out)
        f32, the queries (B, n_query_channels, E) in u's dtype). A map of
        fewer tokens than one more than the queries raises, from its shape
        alone."""
        pt = self.patch_transformer
        n = pt.n_tokens(u.shape[1], u.shape[2])
        if n < self.n_query_channels + 1:
            raise ValueError(
                f"a {u.shape[1]}x{u.shape[2]} map makes {n} tokens; "
                f"{self.n_query_channels} queries and the regressor's token "
                "need one more than the queries")
        tokens = pt(u)
        y = torch.relu(self.regressor(tokens[:, 0]).float()) + WIDTH_EPS
        return (y / y.sum(1, keepdim=True),
                tokens[:, 1:self.n_query_channels + 1])
