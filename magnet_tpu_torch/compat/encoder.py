"""Encoder starts of D-Net training: an EfficientNet-B5 state dict into the
D-Net's encoder.

The port of the effect of ``magnet_tpu/compat/torch_loader.py::
convert_hub_encoder`` and ``convert_adabins_encoder``: a partial load that
fills ``d_net.encoder.original_model.*`` and leaves the decoder as it is.

* ``--encoder_ckpt``: a bare torch.hub ``tf_efficientnet_b5_ap`` ImageNet
  state dict, keys ``conv_stem.*``, ``bn1.*``, ``blocks.{stage}.{idx}.*``,
  ``conv_head.*``, ``bn2.*`` (the reference's ``pretrained=True``
  construction); the encoder stays trainable.
* ``AdaBins_fix``: the AdaBins KITTI encoder, the same keys under
  ``original_model.``; the optimizer freezes the encoder
  (``train/optim.py::make_dnet_optimizer``).

Every parameter and BatchNorm statistic of the encoder must be in the file
with its shape (a missing or misnamed key raises: a half-random encoder
would be worse than failing); other keys, a classifier's, are ignored.
"""

from __future__ import annotations

from typing import Dict

import torch

from magnet_tpu_torch.compat.from_jax import load_state_dict


def load_encoder(model: torch.nn.Module, state_dict: Dict[str, torch.Tensor],
                 prefix: str = "") -> torch.nn.Module:
    """Copy ``state_dict`` (keys of ``EfficientNetB5Features`` after
    ``prefix``) into ``model``'s ``d_net.encoder.original_model``; the
    BatchNorms' batch counters may be absent."""
    enc = model.d_net.encoder.original_model
    want = {k: v for k, v in enc.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    missing = [prefix + k for k in want if prefix + k not in state_dict]
    if missing:
        raise KeyError(f"encoder state dict lacks {len(missing)} keys: "
                       f"{missing[:5]}")
    with torch.no_grad():
        for k, v in want.items():
            src = state_dict[prefix + k]
            if tuple(src.shape) != tuple(v.shape):
                raise ValueError(f"encoder key {prefix + k}: shape "
                                 f"{tuple(src.shape)}, expected "
                                 f"{tuple(v.shape)}")
            v.copy_(src)
    return model


def load_hub_encoder(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """``--encoder_ckpt``: a torch.hub ``tf_efficientnet_b5_ap`` file."""
    return load_encoder(model, load_state_dict(path))


def load_adabins_encoder(model: torch.nn.Module,
                         path: str) -> torch.nn.Module:
    """``AdaBins_fix``: the AdaBins encoder file (keys
    ``original_model.*``)."""
    return load_encoder(model, load_state_dict(path), "original_model.")
