"""Seeded weights, made on the device in two draws.

``make_weights(layout, seed, device, scheme, pins)`` returns a state dict
for the parameter layout of ``layout`` (a module whose state-dict keys are
the reference checkpoints': ``reference.nets.Magnet`` or ``MagnetF``),
float32 on ``device``. One normal and one uniform draw of a
``torch.Generator`` seeded from ``seed`` fill every entry, each a slice of
them, so a seed gives the same weights on any run of one device type.

Schemes:
* "eval", a network of a trained model's scale: convolutions normal with
  standard deviation fan_in ** -0.5 (activations stay of order one through
  the deep trunk), biases normal 0.02; BatchNorm scales uniform in
  [0.5, 1.5], shifts normal 0.1, running means normal 0.5 and variances
  uniform in [0.5, 2];
* "train", the start of a training run (PSM-Net's initialisation):
  convolutions normal with standard deviation sqrt(2 / (k k out)), biases
  0, BatchNorm scale 1, shift 0, running mean 0 and variance 1.

``pins`` then set single convolutions: ``weight_scale`` multiplies the
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


def _entries(layout: nn.Module, scheme: str):
    """(key, shape, kind, a, b) for every state-dict entry: the entry is
    a * normal + b ("n"), a * uniform + b ("u") or the constant b ("c")."""
    out = []
    for name, m in layout.named_modules():
        pre = name + "." if name else ""
        if isinstance(m, nn.Conv2d):
            kh, kw = m.kernel_size
            if scheme == "eval":
                std = m.weight[0].numel() ** -0.5
            else:
                std = (2.0 / (kh * kw * m.out_channels)) ** 0.5
            out.append((pre + "weight", m.weight.shape, "n", std, 0.0))
            if m.bias is not None:
                out.append((pre + "bias", m.bias.shape,
                            "n" if scheme == "eval" else "c", 0.02, 0.0))
        elif isinstance(m, nn.BatchNorm2d):
            shape = m.weight.shape
            if scheme == "eval":
                out += [(pre + "weight", shape, "u", 1.0, 0.5),
                        (pre + "bias", shape, "n", 0.1, 0.0),
                        (pre + "running_mean", shape, "n", 0.5, 0.0),
                        (pre + "running_var", shape, "u", 1.5, 0.5)]
            else:
                out += [(pre + "weight", shape, "c", 0.0, 1.0),
                        (pre + "bias", shape, "c", 0.0, 0.0),
                        (pre + "running_mean", shape, "c", 0.0, 0.0),
                        (pre + "running_var", shape, "c", 0.0, 1.0)]
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
