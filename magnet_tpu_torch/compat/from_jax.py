"""Weights into the port: from the JAX package's variables, or from the
reference torch checkpoints.

``dnet_state_dict`` turns the ``{"params", "batch_stats"}`` tree of a JAX
``DNet`` (numpy arrays, as ``jax.device_get`` returns them) into the port's
``state_dict``, whose keys follow the reference checkpoint layout:

    d_net.encoder.original_model.{conv_stem|bn1|conv_head|bn2}.*
    d_net.encoder.original_model.blocks.{stage}.{idx}.{conv_pw|bn1|...}.*
    d_net.encoder.original_model.blocks.{stage}.{idx}.se.conv_{reduce|expand}.*
    d_net.decoder.conv2.*
    d_net.decoder.up{i}._net.{0|1|3|4}.*    conv_a, bn_a|gn_a, conv_b,
                                            bn_b|gn_b
    d_net.decoder.{depth|mask}_head.{0|2|4}.*

Conv kernels go HWIO -> OIHW. The JAX BatchNorm decoder splits each stage's
conv_a along its input channels (``conv_a_up`` over the upsampled map, with
the bias, and ``conv_a_skip`` over the skip); they are joined back into the
reference's single conv over the concat, upsampled channels first. The
GroupNorm decoder's weight-standardised convs hold their ``kernel`` and
``bias`` directly under ``conv_a`` / ``conv_b`` (no ``conv`` scope), its
GroupNorms a scale and a bias under ``gn_a/gn`` / ``gn_b/gn`` (no running
statistics).

``fnet_state_dict`` does the same for a JAX ``FNet`` (keys ``f_net.*`` in
the PSM-Net layout of ``nn/psmnet.py``) and ``magnet_state_dict`` for a JAX
``Magnet``: ``d_net.d_net.*``, ``f_net.f_net.*``, ``mask_head.{0,2,4,6}``
and ``g_net.gnet.{0,2,4,6}``, where G-Net's split first conv (``conv0_cv``
over the cost volume, no bias; ``conv0_feat`` over the decoder feature, with
the bias) is joined along input channels, cost volume first.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}
_CONV_LEAF = {"kernel": "weight", "bias": "bias"}
_HEAD_IDX = {"conv0": "0", "conv1": "2", "conv2": "4"}
_UP_IDX = {"conv_a": "0", "bn_a": "1", "gn_a": "1", "conv_b": "3",
           "bn_b": "4", "gn_b": "4"}
_GN_LEAF = {"scale": "weight", "bias": "bias"}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()
             ) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _module_key(parts: Tuple[str, ...]) -> str:
    """Path of a module inside the JAX DenseDepth scope (without the trailing
    'conv'/'bn' wrapper and leaf) -> the port's module key."""
    head = parts[0]
    if head == "encoder":
        m = re.match(r"blocks_(\d+)_(\d+)$", parts[1])
        if m:
            inner = ".".join(parts[2:])
            return (f"encoder.original_model.blocks.{m.group(1)}."
                    f"{m.group(2)}.{inner}")
        return f"encoder.original_model.{parts[1]}"
    if re.match(r"up\d$", head):
        name = "conv_a" if parts[1].startswith("conv_a") else parts[1]
        return f"decoder.{head}._net.{_UP_IDX[name]}"
    if head == "conv2":
        return "decoder.conv2"
    if head in ("depth_head", "mask_head"):
        return f"decoder.{head}.{_HEAD_IDX[parts[1]]}"
    raise KeyError(f"unmapped DenseDepth path {parts}")


def dnet_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``DNet`` variables -> the port's state_dict
    (``num_batches_tracked`` set to 0 for every BatchNorm). A JAX
    ``DNetCoarse`` tree converts too; it has no mask head, which the port's
    modules (like the reference checkpoints) always hold, so it loads with
    ``strict=False``."""
    flat = _collections(variables)
    out: Dict[str, torch.Tensor] = {}
    split_a: Dict[str, Dict[str, np.ndarray]] = {}
    for path, value in flat.items():
        if path[0] != "d_net":
            raise KeyError(f"not a D-Net path {path}")
        *mod, wrapper, leaf = path[1:]
        if wrapper not in ("conv", "bn", "gn"):       # a WSConv's own leaf
            mod.append(wrapper)
        key = "d_net." + _module_key(tuple(mod))
        if wrapper == "gn":
            out[f"{key}.{_GN_LEAF[leaf]}"] = torch.from_numpy(value.copy())
        elif wrapper == "bn":
            out[f"{key}.{_BN_LEAF[leaf]}"] = torch.from_numpy(value.copy())
            out[f"{key}.num_batches_tracked"] = torch.tensor(0)
        elif mod[-1] in ("conv_a_up", "conv_a_skip"):
            split_a.setdefault(key, {})[f"{mod[-1]}.{leaf}"] = value
        elif leaf == "kernel":
            out[f"{key}.weight"] = _oihw(value)
        else:
            out[f"{key}.{_CONV_LEAF[leaf]}"] = torch.from_numpy(value.copy())
    for key, parts in split_a.items():
        w = np.concatenate([parts["conv_a_up.kernel"],
                            parts["conv_a_skip.kernel"]], axis=2)
        out[f"{key}.weight"] = _oihw(w)
        out[f"{key}.bias"] = torch.from_numpy(parts["conv_a_up.bias"].copy())
    return out


_FIRSTCONV_IDX = {"firstconv0": "0", "firstconv1": "2", "firstconv2": "4"}
_CHAIN4_IDX = {"conv0": "0", "conv1": "2", "conv2": "4", "conv3": "6"}


def _psm_key(parts: Tuple[str, ...]) -> str:
    """Path of a conv or BN inside the JAX PSMNet scope (wrappers and leaf
    dropped) -> the port's module key; ``{cb}`` stands for the position
    inside a conv-BN pair."""
    head = parts[0]
    if head in _FIRSTCONV_IDX:
        return f"firstconv.{_FIRSTCONV_IDX[head]}.{{cb}}"
    m = re.match(r"layer(\d+)_(\d+)$", head)
    if m:
        base = f"layer{m.group(1)}.{m.group(2)}"
        return {"convbn1": f"{base}.conv1.0.{{cb}}",
                "convbn2": f"{base}.conv2.{{cb}}",
                "down_conv": f"{base}.downsample.0",
                "down_bn": f"{base}.downsample.1"}[parts[1]]
    if re.match(r"branch\d$", head):
        return f"{head}.1.{{cb}}"
    if head == "lastconv0":
        return "lastconv.0.{cb}"
    if head == "lastconv1":
        return "lastconv.2"
    raise KeyError(f"unmapped PSMNet path {parts}")


def _oihw(kernel: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))


def _collections(variables: Mapping) -> Dict[Tuple[str, ...], np.ndarray]:
    flat = {}
    for coll in ("params", "batch_stats"):
        flat.update(_flatten(variables.get(coll, {})))
    return flat


def fnet_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``FNet`` variables -> the port's ``FNet`` state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _collections(variables).items():
        if path[0] != "f_net":
            raise KeyError(f"not an F-Net path {path}")
        leaf = path[-1]
        is_bn = path[-2] == "bn"
        mod = tuple(p for p in path[1:-1] if p not in ("conv", "bn"))
        key = "f_net." + _psm_key(mod).format(cb="1" if is_bn else "0")
        if is_bn:
            out[f"{key}.{_BN_LEAF[leaf]}"] = torch.from_numpy(value.copy())
            out[f"{key}.num_batches_tracked"] = torch.tensor(0)
        else:
            out[f"{key}.weight"] = _oihw(value)
    return out


def _chain_state_dict(tree: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """conv0..conv3 of a JAX 4-conv chain -> Sequential indices 0, 2, 4, 6."""
    out = {}
    for name, idx in _CHAIN4_IDX.items():
        if name in tree:
            conv = tree[name]["conv"]
            out[f"{prefix}.{idx}.weight"] = _oihw(np.asarray(conv["kernel"]))
            out[f"{prefix}.{idx}.bias"] = torch.from_numpy(
                np.asarray(conv["bias"]).copy())
    return out


def gnet_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``GNet`` params -> the port's ``GNet`` state_dict: the split first
    conv is joined along input channels, cost volume first; the bias is the
    feature half's."""
    out = _chain_state_dict(params, "gnet")
    w0 = np.concatenate(
        [np.asarray(params["conv0_cv"]["conv"]["kernel"]),
         np.asarray(params["conv0_feat"]["conv"]["kernel"])], 2)
    out["gnet.0.weight"] = _oihw(w0)
    out["gnet.0.bias"] = torch.from_numpy(
        np.asarray(params["conv0_feat"]["conv"]["bias"]).copy())
    return out


def magnet_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``Magnet`` variables -> the port's ``Magnet`` state_dict. The JAX
    tree has no D-Net decoder mask head (MaGNet has its own), which the
    port's D-Net holds as the reference checkpoints do: load with
    ``strict=False``."""
    def sub(key):
        return {c: {key: variables[c][key][key]} for c in variables
                if key in variables[c]}

    out = {"d_net." + k: v for k, v in dnet_state_dict(sub("d_net")).items()}
    out.update({"f_net." + k: v
                for k, v in fnet_state_dict(sub("f_net")).items()})
    params = variables["params"]
    out.update(_chain_state_dict(params["mask_head"], "mask_head"))
    out.update({"g_net." + k: v
                for k, v in gnet_state_dict(params["g_net"]).items()})
    return out


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``.pt`` checkpoint as a state_dict: the 'model' entry is
    unwrapped and DDP 'module.' prefixes are stripped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model" in ckpt:
        ckpt = ckpt["model"]
    out = {}
    for k, v in ckpt.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if isinstance(v, torch.Tensor):
            out[k] = v
    return out
