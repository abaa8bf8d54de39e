"""What the benchmark takes from the program under test, ``magnet_tpu_torch``.

The models are built by the program's own builders from the
configuration's flags (``models.build.build_magnet``,
``build_magnet_f``), on the meta device and with the builders' host-side
random initialisation skipped; then they are materialised on the device
and given the benchmark's seeded weights (``weights.make_weights``), and
the inference model is cast by the program's ``cast_for_inference``. The
forward and the training step are the program's: ``Magnet.forward`` and
``train.steps.make_fnet_train_step`` with ``train.optim.make_fnet_optimizer``
as ``train_fnet`` builds them. The kernels' operators are
``kernels.ops.OPS``, where the traced run wraps each one.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch


@contextlib.contextmanager
def _no_host_init(build):
    saved = build.init_weights_, build.init_train_weights_
    build.init_weights_ = build.init_train_weights_ = (
        lambda model, seed=0: model)
    try:
        yield
    finally:
        build.init_weights_, build.init_train_weights_ = saved


def magnet(flags, device, weights: Dict[str, torch.Tensor]):
    """(model, args): the inference model of ``flags``, in eval mode on
    ``device`` with ``weights``, cast to the flags' compute dtype."""
    from magnet_tpu_torch.core import config
    from magnet_tpu_torch.models import build, magnet as mg
    args = config.parse_args(config.build_test_magnet_parser(),
                             list(flags) + ["--device", str(device)])
    with _no_host_init(build), torch.device("meta"):
        model = build.build_magnet(args, "meta")
    model = model.to_empty(device=device)
    # the one buffer outside the state dict
    model.k_list = torch.from_numpy(mg.gaussian_sampling_offsets(
        args.MAGNET_sampling_range, args.MAGNET_num_samples)).to(device)
    model.load_state_dict(weights)
    build.cast_for_inference(model, config.compute_dtype(args.compute_dtype))
    return model.eval(), args


def compute_dtype(args):
    from magnet_tpu_torch.core import config
    return config.compute_dtype(args.compute_dtype)


def fnet_training(flags, device, weights: Dict[str, torch.Tensor], seed,
                  total_steps: int):
    """(state, step, d_center, args): stage 2 as ``train_fnet`` builds it,
    from ``weights``; ``total_steps`` sets the one-cycle schedules, which
    ``train_fnet`` takes from its loader's length."""
    from magnet_tpu_torch.core import config
    from magnet_tpu_torch.models import build
    from magnet_tpu_torch.models.magnet import sid_depth_centers
    from magnet_tpu_torch.train import optim, steps
    args = config.parse_args(config.build_train_fnet_parser(),
                             list(flags) + ["--device", str(device)])
    with _no_host_init(build), torch.device("meta"):
        model = build.build_magnet_f(args, "meta")
    model = model.to_empty(device=device)
    model.load_state_dict(weights)
    model.train()
    opt = optim.make_fnet_optimizer(
        model.parameters(), lr=args.lr, total_steps=total_steps,
        weight_decay=args.weight_decay, grad_clip=args.grad_clip,
        div_factor=args.div_factor, final_div_factor=args.final_div_factor)
    state = steps.TrainState(model, opt, seed=seed)
    d_center = torch.from_numpy(sid_depth_centers(
        args.min_depth, args.max_depth, args.FNET_num_depth_bins)).to(device)
    step = steps.make_fnet_train_step(d_center, args.max_depth,
                                      args.min_depth,
                                      compute_dtype=compute_dtype(args))
    return state, step, d_center, args


def operators():
    """(namespace, names): the kernels' operators as the wrappers find
    them (``OPS.<name>``)."""
    from magnet_tpu_torch.kernels import ops
    return ops.OPS, ops.op_names()


def stage_times():
    """The program's span recorder of the training step
    (``utils.profiling.StageTimes``)."""
    from magnet_tpu_torch.utils.profiling import StageTimes
    return StageTimes()
