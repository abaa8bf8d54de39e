"""Shared layers of the port (PyTorch).

Counterpart of ``magnet_tpu/nn/layers.py``. Parameters live in plain
``nn.Conv2d`` / ``nn.BatchNorm2d`` modules so that ``state_dict()`` keys and
shapes follow the reference torch checkpoints; the forward functions here
add the semantics the JAX package gives them:

* TF-SAME padding (right/bottom heavy) for the ``tf_`` EfficientNet convs;
* eval BatchNorm with f32 statistics whatever the activation dtype
  (eps 1e-3 in the EfficientNet trunk, 1e-5 in the decoder), and train-mode
  BatchNorm with flax's statistics and running-buffer update;
* ``leaky_relu`` with torch's default slope 0.01;
* stochastic depth (``drop_path``), its per-sample masks drawn from an
  explicit generator;
* the weight-standardised conv (``WSConv2d``, its kernel standardised in
  f32 at every call) and GroupNorm (``group_norm``: 8 groups, f32) of the
  GroupNorm decoder;
* ``remat``: a block under ``torch.utils.checkpoint`` (the JAX package's
  ``nn.remat``), whose recomputation updates no BatchNorm buffer.

Activations inside these modules are NCHW (channels-last in memory).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from magnet_tpu_torch.core import mesh
from magnet_tpu_torch.kernels.dw_conv import dw_conv

LEAKY_SLOPE = 0.01


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype``: ``t`` itself where it is of that dtype already,
    which a traced program (``serve/export.py``) then records no cast for."""
    return t if t.dtype == dtype else t.to(dtype)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LEAKY_SLOPE)


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """TF-SAME padding (right/bottom heavy)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def is_stride1_depthwise(conv: nn.Conv2d) -> bool:
    """A stride-1, undilated, bias-free depthwise conv: what
    ``kernels.dw_conv`` computes."""
    return (conv.groups > 1 and conv.groups == conv.in_channels
            == conv.out_channels and conv.stride == (1, 1)
            and conv.dilation == (1, 1) and conv.bias is None)


def cached_fold(owner: nn.Module, name: str, dtype: torch.dtype,
                sources: Sequence[torch.Tensor], fold: Callable):
    """``fold()`` (a module's weights prepared for a kernel), kept on
    ``owner`` under ``name`` and recomputed when ``dtype`` or a tensor of
    ``sources`` has changed (storage or version). While a program is traced
    (``torch.export``, ``torch.compile``) the tensors have no storage to key
    on: ``fold()`` is called as it is, so that the packing is traced from
    the weights the program is given."""
    if torch.compiler.is_compiling() or torch.compiler.is_exporting():
        return fold()
    key = (dtype,) + tuple((t.data_ptr(), t._version) for t in sources)
    cache = owner.__dict__.setdefault("_folded", {})
    hit = cache.get(name)
    if hit is None or hit[0] != key:
        with torch.no_grad():
            hit = cache[name] = (key, fold())
    return hit[1]


def conv2d_same(x: torch.Tensor, conv: nn.Conv2d,
                dw_kernel: bool = False) -> torch.Tensor:
    """``conv`` applied with TF-SAME padding, in x's dtype. Symmetric pads go
    to the convolution; asymmetric ones (a stride-2 conv on an even size)
    are applied with ``F.pad`` first. With ``dw_kernel``, a stride-1
    depthwise conv goes to ``kernels.dw_conv`` (the counterpart of the JAX
    package's ``_DWPallasConv``) on x's NHWC view, which on a CUDA device
    must be contiguous: x channels-last in memory. Its (K, K, C) taps are
    kept on ``conv`` (``cached_fold``)."""
    if dw_kernel and is_stride1_depthwise(conv):
        w = cached_fold(conv, "dw_taps", x.dtype, (conv.weight,), lambda: (
            conv.weight.to(x.dtype)[:, 0].permute(1, 2, 0).contiguous()))
        return nchw(dw_conv(x.permute(0, 2, 3, 1), w))
    kh, kw = conv.kernel_size
    sh, sw = conv.stride
    pt, pb = same_pads(x.shape[-2], kh, sh)
    pl, pr = same_pads(x.shape[-1], kw, sw)
    w = cast(conv.weight, x.dtype)
    b = None if conv.bias is None else cast(conv.bias, x.dtype)
    if pt == pb and pl == pr:
        return F.conv2d(x, w, b, conv.stride, (pt, pl), 1, conv.groups)
    x = F.pad(x, (pl, pr, pt, pb))
    return F.conv2d(x, w, b, conv.stride, 0, 1, conv.groups)


def conv2d(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` with its own (symmetric) padding, in x's dtype."""
    w = cast(conv.weight, x.dtype)
    b = None if conv.bias is None else cast(conv.bias, x.dtype)
    return F.conv2d(x, w, b, conv.stride, conv.padding, 1, conv.groups)


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Eval BatchNorm over NCHW with the running statistics, computed in
    f32 and returned in x's dtype."""
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                        bn.bias, False, 0.0, bn.eps)


# flax's convention: running = BN_MOMENTUM * running + (1 - BN_MOMENTUM) *
# batch (torch's momentum 0.1)
BN_MOMENTUM = 0.9


# set while ``remat`` recomputes a block in the backward: the forward has
# updated the running buffers already
_RECOMPUTING = [False]


@contextlib.contextmanager
def _recomputing():
    _RECOMPUTING[0] = True
    try:
        yield
    finally:
        _RECOMPUTING[0] = False


def remat(fn: Callable, *args):
    """``fn(*args)`` with its activations recomputed in the backward instead
    of kept (``torch.utils.checkpoint``, non-reentrant): the same values and
    gradients, less memory. ``fn`` must draw no random numbers (pass drop
    masks in); its train-mode BatchNorms update their buffers once, in the
    forward."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), _recomputing()))


def batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Train-mode BatchNorm over NCHW as the JAX package computes it (flax
    ``BatchNorm`` on f32): the batch mean and the biased variance
    E[x^2] - E[x]^2 (clipped at 0) in f32, or in x's dtype where that is
    wider; scale and bias rounded to x's dtype first (the compute-dtype cast
    of every parameter) and applied in that type; the running buffers
    updated in place from the biased variance (``nn.BatchNorm2d`` would use
    the unbiased one), except in ``remat``'s recomputation. Under a process
    group of several ranks the mean and E[x^2] are those of the global batch
    (``core/mesh.batch_statistics``: SyncBN, as the JAX package's BatchNorm
    under a sharded batch), equal on every rank. Returns x's dtype."""
    dt = x.dtype
    xf = x.to(torch.promote_types(dt, torch.float32))
    mean, sq = mesh.batch_statistics(xf.mean((0, 2, 3)),
                                     (xf * xf).mean((0, 2, 3)))
    var = torch.clamp(sq - mean * mean, min=0.0)
    if not _RECOMPUTING[0]:
        with torch.no_grad():
            for buf, stat in ((bn.running_mean, mean),
                              (bn.running_var, var)):
                buf.copy_(BN_MOMENTUM * buf + (1 - BN_MOMENTUM) * stat)
    mul = torch.rsqrt(var + bn.eps) * bn.weight.to(dt).to(xf.dtype)
    y = ((xf - mean[:, None, None]) * mul[:, None, None]
         + bn.bias.to(dt).to(xf.dtype)[:, None, None])
    return y.to(dt)


def norm(x: torch.Tensor, bn: nn.BatchNorm2d, train: bool) -> torch.Tensor:
    """Train-mode BatchNorm where ``train``, else eval BatchNorm."""
    return batch_norm_train(x, bn) if train else batch_norm(x, bn)


def drop_path_mask(n: int, rate: float, generator: torch.Generator
                   ) -> torch.Tensor:
    """Stochastic depth's keep mask of n samples, (n, 1, 1, 1) f32 of 0 and
    1, each 1 with probability 1 - rate, drawn from ``generator`` on its
    device."""
    keep = torch.full((n, 1, 1, 1), 1.0 - rate, device=generator.device)
    return torch.bernoulli(keep, generator=generator)


def drop_path(x: torch.Tensor, mask: torch.Tensor,
              rate: float) -> torch.Tensor:
    """The residual branch x with a sample's whole branch dropped where its
    mask is 0 and the rest divided by 1 - rate, in x's dtype, as the JAX
    package's ``nn/layers.py::drop_path`` given the same mask (the divisor
    rounded to x's dtype first, as a Python scalar is there)."""
    keep = torch.full((), 1.0 - rate, dtype=x.dtype, device=x.device)
    return x * mask.to(x.dtype) / keep


class WSConv2d(nn.Conv2d):
    """Weight-standardised conv (reference Conv2d, D_dense_depth.py:63-77;
    the JAX package's ``WSConv``): a plain ``nn.Conv2d`` for its parameters
    and state-dict keys, run through ``ws_conv2d``.
    ``models/build.py::cast_for_inference`` leaves its weight in f32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ws_conv2d(x, self)


def standardized_weight(conv: nn.Conv2d) -> torch.Tensor:
    """The conv's OIHW weight standardised in f32: minus its mean per output
    channel, over the unbiased std of each filter plus 1e-5."""
    w = conv.weight.float()
    k = w - w.mean((1, 2, 3), keepdim=True)
    n = w[0].numel()
    var = (k * k).sum((1, 2, 3), keepdim=True) / max(n - 1, 1)
    return k / (torch.sqrt(var) + 1e-5)


def ws_conv2d(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` with its weight standardised in f32 at every call
    (``standardized_weight``), cast to x's dtype; the bias added after the
    convolution, in x's dtype, as the JAX package adds it. NCHW."""
    dt = x.dtype
    y = F.conv2d(x, standardized_weight(conv).to(dt), None, conv.stride,
                 conv.padding)
    return y + conv.bias.to(dt)[:, None, None]


GN_GROUPS = 8


def group_norm(x: torch.Tensor, gn: nn.GroupNorm,
               train: bool = False) -> torch.Tensor:
    """GroupNorm over NCHW computed in f32 and returned in x's dtype, as the
    JAX package's ``GroupNorm`` (8 groups, eps 1e-5). Where ``train``, the
    scale and bias are rounded to x's dtype first (the compute-dtype cast of
    every parameter in a training step), as ``batch_norm_train`` does."""
    dt = x.dtype
    w, b = gn.weight, gn.bias
    if train:
        w, b = w.to(dt), b.to(dt)
    return F.group_norm(x.float(), gn.num_groups, w.float(), b.float(),
                        gn.eps).to(dt)


def fold_bn(bn: nn.BatchNorm2d,
            bias: torch.Tensor = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BatchNorm as an f32 per-channel (scale, shift); a preceding conv
    bias is folded into the shift: bn(acc + b) = acc * s + (t + s * b)."""
    f32 = torch.float32
    scale = cast(bn.weight, f32) * torch.rsqrt(cast(bn.running_var, f32)
                                               + bn.eps)
    shift = cast(bn.bias, f32) - cast(bn.running_mean, f32) * scale
    if bias is not None:
        shift = shift + scale * cast(bias, f32)
    return scale.contiguous(), shift.contiguous()


def hwio(conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """The conv's OIHW weight as a contiguous HWIO tensor of ``dtype``."""
    return conv.weight.to(dtype).permute(2, 3, 1, 0).contiguous()


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> contiguous NHWC (free for a channels-last tensor)."""
    return x.permute(0, 2, 3, 1).contiguous()


def nchw(x: torch.Tensor) -> torch.Tensor:
    """Contiguous NHWC -> NCHW view in channels-last memory."""
    return x.permute(0, 3, 1, 2)
