"""Model construction and checkpoint loading from parsed args.

Counterpart of ``magnet_tpu/models/build.py``. ``build_dnet``,
``build_fnet`` and ``build_magnet`` make a model with seeded random weights
on the requested device; ``load_dnet_checkpoint`` and
``load_magnet_checkpoints`` load reference torch ``.pt`` files natively and
the port's own training checkpoints (``train/checkpoint.py``: a directory of
steps, one step's directory or its ``state.pt``), and an empty path keeps
the seeded weights (smoke runs without a checkpoint).
``build_magnet_f`` makes the F-Net training head with the JAX package's
training initialisation (``init_train_weights_``), ``build_dnet_train`` the
D-Net of stage 1 (``init_flax_weights_``) and ``build_magnet_train`` the
stage-3 pipeline with its stage checkpoints loaded.
``cast_for_inference`` applies the compute-dtype policy;
``realistic_depth_init_`` puts seeded random weights into the depth regime
of a trained network.
"""

from __future__ import annotations

import os

import torch
import torch.nn as nn

from magnet_tpu_torch.compat.from_jax import load_state_dict
from magnet_tpu_torch.core import config
from magnet_tpu_torch.models.dnet import DNet
from magnet_tpu_torch.models.fnet import FNet
from magnet_tpu_torch.models.magnet import Magnet, MagnetF
from magnet_tpu_torch.nn.efficientnet import SqueezeExcite
from magnet_tpu_torch.train import checkpoint


def _check_arch(args) -> None:
    arch = getattr(args, "DNET_architecture", "DenseDepth_BN")
    if arch != "DenseDepth_BN":
        raise ValueError(f"D-Net architecture {arch!r} is not ported; "
                         "the port has DenseDepth_BN")


def init_weights_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights: fan-in scaled normal convs (activations stay
    O(1) through the deep trunk), random positive BatchNorm statistics."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, fan_in ** -0.5, generator=g)
                if m.bias is not None:
                    m.bias.normal_(0.0, 0.02, generator=g)
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
                m.running_mean.normal_(0.0, 0.5, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
    return model


def init_train_weights_(model: nn.Module, seed: int = 0) -> nn.Module:
    """The initialisation a training run starts from, as the JAX package's
    PSM-Net has it (F_psmnet.py:71-85): every conv weight normal with std
    sqrt(2 / (k * k * out_channels)) (Kaiming, fan-out), BatchNorm scale 1,
    bias 0, running mean 0 and variance 1; seeded from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                kh, kw = m.kernel_size
                std = (2.0 / (kh * kw * m.out_channels)) ** 0.5
                m.weight.normal_(0.0, std, generator=g)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model


def init_flax_weights_(model: nn.Module, seed: int = 0) -> nn.Module:
    """flax's default initialisation, the JAX package's D-Net at the start
    of training: every conv weight normal with std fan_in ** -0.5 (LeCun;
    flax truncates it at two standard deviations, here it is not), biases
    0, BatchNorm scale 1, bias 0, running mean 0 and variance 1; seeded from
    ``seed``."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.normal_(0.0, m.weight[0].numel() ** -0.5,
                                 generator=g)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model


def build_magnet_f(args, device: str = None) -> MagnetF:
    """The F-Net training head of the flags, initialised for training from
    ``--seed``, in train mode on ``device`` (default ``--device``), f32."""
    if args.FNET_architecture != "PSM-Net":
        raise ValueError(f"unknown F-Net arch {args.FNET_architecture!r}")
    model = MagnetF(fnet_feature_dim=args.FNET_feature_dim,
                    remat=getattr(args, "remat", False))
    init_train_weights_(model, getattr(args, "seed", 0))
    return model.train().to(device or args.device)


def build_dnet_train(args, device: str = None) -> DNet:
    """The D-Net of stage 1 from the flags (``--remat`` included),
    initialised as flax initialises it from ``--seed``, in train mode on
    ``device`` (default ``--device``), f32."""
    _check_arch(args)
    model = DNet(output_dim=args.output_dim, output_type=args.output_type,
                 downsample_ratio=args.downsample_ratio,
                 remat=getattr(args, "remat", False))
    init_flax_weights_(model, getattr(args, "seed", 0))
    return model.train().to(device or args.device)


def trunk_switches(args) -> dict:
    """The D-Net trunk's kernel switches of the flags (``--mbconv_chain``,
    ``--dw_kernel``), off where the flags lack them."""
    return dict(mbconv_chain=config.parse_mbconv_chain(
        getattr(args, "mbconv_chain", "none")),
        dw_kernel=getattr(args, "dw_kernel", False))


def build_dnet(args, device: str = None) -> DNet:
    """DNet from the parsed flags, seeded from ``--seed``, in eval mode on
    ``device`` (default ``--device``)."""
    _check_arch(args)
    model = DNet(output_dim=args.output_dim, output_type=args.output_type,
                 downsample_ratio=args.downsample_ratio,
                 **trunk_switches(args))
    init_weights_(model, getattr(args, "seed", 0))
    return model.eval().to(device or args.device)


def stage_state_dict(path: str, prefix: str = "") -> dict:
    """The weights of a stage checkpoint: a reference ``.pt`` file
    (``load_state_dict``), or a training checkpoint of the port (the parent
    of its step directories, meaning the latest step, one step's directory,
    or its ``state.pt``), whose ``"model"`` entry is taken with ``prefix``
    stripped from its keys and the keys without it dropped, as the
    reference takes ``params["f_net"]`` of a ``train_FNet.py`` state."""
    if os.path.isdir(path):
        saved = checkpoint.restore(path)
    elif os.path.basename(path) == checkpoint.STATE_FILE:
        saved = checkpoint.restore(os.path.dirname(os.path.abspath(path)))
    else:
        return load_state_dict(path)
    return {k[len(prefix):]: v for k, v in saved["model"].items()
            if k.startswith(prefix)}


def load_dnet_checkpoint(model: DNet, path: str) -> DNet:
    """A D-Net checkpoint (``stage_state_dict``; a training state holds the
    D-Net's own state dict) into ``model``; an empty path keeps it."""
    if not path:
        return model
    model.load_state_dict(stage_state_dict(path))
    return model


def build_fnet(args, device: str = None) -> FNet:
    model = FNet(args.FNET_architecture, args.FNET_feature_dim,
                 getattr(args, "stream_blocks", False))
    init_weights_(model, getattr(args, "seed", 0))
    return model.eval().to(device or args.device)


def build_magnet(args, device: str = None) -> Magnet:
    """Magnet from the parsed flags, seeded from ``--seed``, in eval mode on
    ``device`` (default ``--device``)."""
    _check_arch(args)
    if args.FNET_architecture != "PSM-Net":
        raise ValueError(f"unknown F-Net arch {args.FNET_architecture!r}")
    model = Magnet(output_dim=getattr(args, "output_dim", 2),
                   downsample_ratio=args.downsample_ratio,
                   fnet_feature_dim=args.FNET_feature_dim,
                   sampling_range=args.MAGNET_sampling_range,
                   n_samples=args.MAGNET_num_samples,
                   mvs_weighting=args.MAGNET_mvs_weighting,
                   n_iters=args.MAGNET_num_test_iter,
                   stream_blocks=getattr(args, "stream_blocks", False),
                   **trunk_switches(args))
    init_weights_(model, getattr(args, "seed", 0))
    return model.eval().to(device or args.device)


def build_magnet_train(args, device: str = None) -> Magnet:
    """The stage-3 pipeline of the flags: ``build_magnet``'s model with the
    ``--DNET_ckpt`` and ``--FNET_ckpt`` stage checkpoints loaded, in train
    mode (G-Net and the mask head; ``Magnet.train``), f32."""
    model = build_magnet(args, device)
    return load_magnet_checkpoints(model, args).train()


def load_magnet_checkpoints(model: Magnet, args) -> Magnet:
    """Stage composition, as the reference does it: the D-Net checkpoint
    (keys ``d_net.*``) and the F-Net checkpoint (``f_net.*``) into the
    frozen backbones, then the MAGNET checkpoint over the whole model
    (``g_net``, ``mask_head`` and the same backbones). Empty paths are
    skipped. The D-Net and F-Net checkpoints may also be the port's training
    checkpoints (``stage_state_dict``): a ``train_fnet`` state holds
    ``MagnetF``'s keys, whose ``f_net.`` prefix is stripped. The MAGNET file
    may lack the D-Net decoder's own mask head, which MaGNet does not use;
    nothing else may be missing."""
    if getattr(args, "DNET_ckpt", ""):
        model.d_net.load_state_dict(stage_state_dict(args.DNET_ckpt))
    if getattr(args, "FNET_ckpt", ""):
        model.f_net.load_state_dict(stage_state_dict(args.FNET_ckpt,
                                                     "f_net."))
    if getattr(args, "MAGNET_ckpt", ""):
        res = model.load_state_dict(load_state_dict(args.MAGNET_ckpt),
                                    strict=False)
        missing = [k for k in res.missing_keys
                   if not k.startswith("d_net.d_net.decoder.mask_head.")]
        if missing or res.unexpected_keys:
            raise KeyError(f"MAGNET checkpoint: missing {missing[:5]}, "
                           f"unexpected {res.unexpected_keys[:5]}")
    return model


def realistic_depth_init_(model: Magnet) -> Magnet:
    """Pin the Gaussian heads of a randomly initialised model to the regime
    of a trained one: the last depth-head conv is zeroed with the bias
    (2.0, -3.0), so mu = 2 m and sigma = sqrt(elu(-3) + 1) ~ 0.22 m; G-Net's
    last conv is zeroed, so the refinement residuals stay (0, 0). Random
    weights otherwise give depths that project to degenerate coordinates,
    which no trained network produces. The computation is unchanged; only
    the data it sees."""
    head = model.d_net.d_net.decoder.depth_head[4]
    last = model.g_net.gnet[6]
    if head.bias.shape != (2,) or last.bias.shape != (2,):
        raise ValueError("realistic_depth_init_ needs 2-channel heads")
    with torch.no_grad():
        head.weight.zero_()
        head.bias.copy_(torch.tensor([2.0, -3.0]))
        last.weight.zero_()
        last.bias.zero_()
    return model


def cast_for_inference(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """The compute-dtype policy: conv weights and biases in ``dtype``;
    BatchNorm parameters and statistics stay f32 (the folded scale and shift
    are f32); the squeeze-excitation convs stay f32, as their pooled input
    is f32."""
    skip = {id(c) for m in model.modules() if isinstance(m, SqueezeExcite)
            for c in m.modules()}
    for m in model.modules():
        if isinstance(m, nn.Conv2d) and id(m) not in skip:
            m.to(dtype)
    return model
