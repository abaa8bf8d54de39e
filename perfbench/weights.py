"""Seeded weights, made on the device in two draws.

``make_weights(layout, seed, device, scheme, pins)`` returns a state dict
for the parameter layout of ``layout`` (a module on any device, the meta
one included, whose state-dict keys are the reference checkpoints', such
as ``reference.nets.Magnet`` or ``MagnetF``), float32 on ``device``. One
normal and one uniform draw of a ``torch.Generator`` seeded from ``seed``
fill every entry, each a slice of them, so a seed gives the same weights on
any run of one device type.

Rules, by module in ``named_modules()`` order, then by parameter:

* ``nn.Conv2d``, ``weight`` and ``bias``;
* ``nn.BatchNorm2d``, ``weight``, ``bias``, ``running_mean``,
  ``running_var``;
* ``nn.Linear`` (so also ``nn.MultiheadAttention``'s ``out_proj``),
  ``weight`` and ``bias``: as a 1x1 convolution;
* ``nn.LayerNorm`` and ``nn.GroupNorm``, ``weight`` and ``bias``: as a
  batch norm's;
* ``nn.MultiheadAttention``'s packed ``in_proj_weight`` and
  ``in_proj_bias``: as a Linear of that shape (3E from E);
* last, every parameter registered directly on a module of the model's
  own, not on a layer class of ``torch.nn`` (a bare ``nn.Parameter`` such
  as learned positional encodings or tokens), in ``named_parameters()``
  order: normal with standard deviation 0.02 in either scheme, the
  convention of vision transformers' positional encodings;
* ``num_batches_tracked`` 0.

Any other entry is not made and the layout raises ``KeyError``: a buffer
of the model's own, and a parameter of a ``torch.nn`` layer that no rule
above covers (``Conv1d``, ``ConvTranspose2d``, ``Embedding``, attention's
separate ``q/k/v_proj_weight`` or its ``bias_k``), which needs a rule of
its own scale rather than 0.02.

A layout of ``Conv2d`` and ``BatchNorm2d`` alone (MaGNet's) takes entries
from those two rules only, in module order, so the rules after them leave
its tensors as they are, bit for bit.

Schemes:
* "eval", a network of a trained model's scale: convolution and Linear
  weights normal with standard deviation fan_in ** -0.5 (activations stay
  of order one through the deep trunk), biases normal 0.02; norm scales
  uniform in [0.5, 1.5], shifts normal 0.1, batch norms' running means
  normal 0.5 and variances uniform in [0.5, 2];
* "train", the start of a training run (PSM-Net's initialisation):
  convolution and Linear weights normal with standard deviation
  sqrt(2 / (k k out)) (k k = 1 for a Linear), biases 0, norm scales 1,
  shifts 0, running means 0 and variances 1.

``pins`` then set single modules' weights: ``weight_scale`` multiplies the
weight (one number, or one per output channel), ``bias`` replaces the
bias. A configuration's pins put the heads of a random network in a trained
network's regime (depths of metres around the depth head's bias, an
uncertainty of a tenth of them, matching features whose dot products are
of order one) without zeroing any layer's share of the output.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

SCHEMES = ("eval", "train")
OTHER_STD = 0.02


def _weight_std(fan_in: int, k: int, out: int, scheme: str) -> float:
    if scheme == "eval":
        return fan_in ** -0.5
    return (2.0 / (k * out)) ** 0.5


def _bias(key, shape, scheme):
    return (key, shape, "n" if scheme == "eval" else "c", 0.02, 0.0)


def _norm_affine(pre, m, scheme):
    if m.weight is None:
        return []
    shape = m.weight.shape
    scale = ((pre + "weight", shape, "u", 1.0, 0.5) if scheme == "eval"
             else (pre + "weight", shape, "c", 0.0, 1.0))
    out = [scale]
    if m.bias is not None:
        out.append((pre + "bias", shape, "n" if scheme == "eval" else "c",
                    0.1, 0.0))
    return out


def _entries(layout: nn.Module, scheme: str):
    """(key, shape, kind, a, b) for every state-dict entry: the entry is
    a * normal + b ("n"), a * uniform + b ("u") or the constant b ("c")."""
    out = []
    for name, m in layout.named_modules():
        pre = name + "." if name else ""
        if isinstance(m, nn.Conv2d):
            kh, kw = m.kernel_size
            std = _weight_std(m.weight[0].numel(), kh * kw, m.out_channels,
                              scheme)
            out.append((pre + "weight", m.weight.shape, "n", std, 0.0))
            if m.bias is not None:
                out.append(_bias(pre + "bias", m.bias.shape, scheme))
        elif isinstance(m, nn.BatchNorm2d):
            shape = m.running_mean.shape
            out += _norm_affine(pre, m, scheme)
            out += ([(pre + "running_mean", shape, "n", 0.5, 0.0),
                     (pre + "running_var", shape, "u", 1.5, 0.5)]
                    if scheme == "eval" else
                    [(pre + "running_mean", shape, "c", 0.0, 0.0),
                     (pre + "running_var", shape, "c", 0.0, 1.0)])
        elif isinstance(m, nn.Linear):
            std = _weight_std(m.in_features, 1, m.out_features, scheme)
            out.append((pre + "weight", m.weight.shape, "n", std, 0.0))
            if m.bias is not None:
                out.append(_bias(pre + "bias", m.bias.shape, scheme))
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            out += _norm_affine(pre, m, scheme)
        elif isinstance(m, nn.MultiheadAttention):
            w = m.in_proj_weight
            if w is not None:
                std = _weight_std(w.shape[1], 1, w.shape[0], scheme)
                out.append((pre + "in_proj_weight", w.shape, "n", std, 0.0))
            if m.in_proj_bias is not None:
                out.append(_bias(pre + "in_proj_bias", m.in_proj_bias.shape,
                                 scheme))
    covered = {key for key, *_ in out}
    for name, m in layout.named_modules():
        if type(m).__module__.startswith("torch.nn."):
            continue
        pre = name + "." if name else ""
        out += [(pre + key, p.shape, "n", OTHER_STD, 0.0)
                for key, p in m.named_parameters(recurse=False)
                if pre + key not in covered]
    return out


def make_weights(layout: nn.Module, seed: int, device, scheme: str,
                 pins: Dict[str, Dict] = None) -> Dict[str, torch.Tensor]:
    if scheme not in SCHEMES:
        raise ValueError(f"unknown weight scheme {scheme!r}")
    entries = _entries(layout, scheme)
    n = sum(torch.Size(s).numel() for _, s, _, _, _ in entries)
    g = torch.Generator(device).manual_seed(seed)
    normal = torch.randn(n, generator=g, device=device)
    uniform = torch.rand(n, generator=g, device=device)
    out, at = {}, 0
    for key, shape, kind, a, b in entries:
        k = torch.Size(shape).numel()
        if kind == "c":
            t = torch.full(shape, b, device=device)
        else:
            t = (normal if kind == "n" else uniform)[at:at + k].view(shape) \
                * a + b
        out[key] = t
        at += k
    for key, v in layout.state_dict().items():
        if key.endswith("num_batches_tracked"):
            out[key] = torch.zeros((), dtype=v.dtype, device=device)
    for conv, pin in (pins or {}).items():
        if "weight_scale" in pin:
            w = out[conv + ".weight"]
            scale = torch.tensor(pin["weight_scale"], device=device)
            out[conv + ".weight"] = w * scale.reshape(-1, *[1] * (w.dim() - 1))
        if "bias" in pin:
            out[conv + ".bias"] = torch.tensor(pin["bias"], device=device)
    missing = set(layout.state_dict()) - set(out)
    if missing:
        raise KeyError(f"no weights made for {sorted(missing)[:5]}")
    return out
