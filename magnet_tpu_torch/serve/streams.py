"""Multi-stream serving: S independent video streams, one per device.

The port of ``magnet_tpu/serve/streams.py``. The JAX package runs S
windows as one ``shard_map`` program over a one-axis mesh, each shard at
batch 1, with no collectives. Here each device gets its own replica of the
model and its own CUDA stream, and stream s's window runs the batch-1
forward on its device, enqueued without waiting for the others; nothing
crosses between them. On the card S is the number of GPUs; on the CPU (the
tests) the streams run one after the other.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Callable, Dict, Sequence

import torch

INPUTS = ("ref_img", "src_imgs", "R", "t", "is_valid", "intM", "rays2d")


def make_multistream_forward(model: torch.nn.Module,
                             devices: Sequence, n_iters: int = 3,
                             dtype: torch.dtype = None
                             ) -> Callable[[Dict], torch.Tensor]:
    """Returns forward(batch) -> (S, H, W, 2), the last iteration's (mu,
    sigma) of each stream, on ``devices[0]``. ``batch``: the inputs of
    ``Magnet.forward`` stacked over the S = len(devices) streams (ref_img
    (S, H, W, 3), src_imgs (S, V, H, W, 3), R (S, V, 3, 3), t (S, V, 3),
    is_valid (S, V), intM (S, 3, 3), rays2d (S, 3, N)); stream s runs on
    ``devices[s]``, its images in ``dtype`` (default: the model's compute
    dtype, that of its first conv's weight). The model (eval mode, cast for
    inference) serves its own device; every other device gets a copy."""
    devices = [torch.device(d) for d in devices]
    home = next(model.parameters()).device
    if dtype is None:
        dtype = next(m.weight.dtype for m in model.modules()
                     if isinstance(m, torch.nn.Conv2d))
    replicas = {}
    for d in devices:
        if d not in replicas:
            replicas[d] = (model if d == home else
                           copy.deepcopy(model).to(d)).eval()
    streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
               for d in devices]

    @torch.inference_mode()
    def forward(batch: Dict) -> torch.Tensor:
        if batch["ref_img"].shape[0] != len(devices):
            raise ValueError(f"{batch['ref_img'].shape[0]} windows for "
                             f"{len(devices)} streams")
        outs = []
        for s, (d, st) in enumerate(zip(devices, streams)):
            ctx = (torch.cuda.stream(st) if st is not None
                   else contextlib.nullcontext())
            with ctx:
                args = [batch[k][s:s + 1].to(d, non_blocking=True)
                        for k in INPUTS]
                args[:2] = [a.to(dtype) for a in args[:2]]
                outs.append(replicas[d](*args, n_iters=n_iters)[-1])
        for o, d, st in zip(outs, devices, streams):
            if st is not None:
                main = torch.cuda.current_stream(d)
                main.wait_stream(st)
                o.record_stream(main)
        return torch.cat([o.to(devices[0]) for o in outs])

    return forward
