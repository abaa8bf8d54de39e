"""The data-parallel world of the training entry points.

The port's counterpart of ``magnet_tpu/core/mesh.py``. The JAX package
shards the global batch over a one-axis device mesh under one controller;
XLA inserts the gradient sum and BatchNorm takes its statistics over the
global batch. The port runs one process a device (``core/distributed.py``)
and makes each of those explicit:

* ``world_from_args``: the world the flags ask for. ``--batch_size`` is the
  global batch; each of W ranks takes a contiguous ``batch_size / W`` of it
  (the loaders, ``data/base.Loader``);
* ``replicate``: the parameters and buffers broadcast from rank 0 once;
* ``batch_statistics``: the per-rank BatchNorm moments averaged over the
  ranks with a differentiable all-reduce, so that every rank normalises
  with the global batch's statistics (``nn/layers.batch_norm_train``);
* ``average_gradients``: every parameter's gradient averaged over the ranks
  in one flattened all-reduce, before the clip (``train/steps.py``);
* ``batch_total``: the global batch's count of valid pixels, the
  denominator of the losses' masked means;
* ``mean_over_ranks``: the loss a step reports.

Each is a no-op without a process group. One deviation from the JAX
package: its ``--mesh_shape auto`` takes the most devices that divide the
batch, leaving the others idle; here the processes are launched by the
user, so a batch that does not divide over them raises and names the
largest world that it does divide over.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import torch
import torch.distributed as dist

from magnet_tpu_torch.core.distributed import rank_world


def world_from_args(args) -> Tuple[int, int]:
    """(rank, world) of a training run: ``--no_distributed`` is one process,
    ``--mesh_shape N`` must be the world size (``auto`` takes it) and the
    global ``--batch_size`` must divide over it."""
    rank, world = rank_world()
    if not getattr(args, "distributed", True) and world > 1:
        raise ValueError(f"--no_distributed runs one process, but the world "
                         f"has {world}")
    spec = getattr(args, "mesh_shape", "auto")
    if spec not in ("auto", "", None) and int(spec) != world:
        raise ValueError(f"--mesh_shape {spec} does not match the world "
                         f"size: {world} process(es)")
    batch = int(getattr(args, "batch_size", 1))
    if batch % world:
        fits = max(d for d in range(1, world + 1) if batch % d == 0)
        raise ValueError(f"--batch_size {batch} (the global batch) does not "
                         f"divide over {world} processes; launch {fits} "
                         f"(torchrun --nproc_per_node {fits})")
    return rank, world


def shard_batch(batch: dict, rank: int, world: int) -> dict:
    """Rank ``rank``'s contiguous 1/world of every array of a batch (the
    leading axis)."""
    def part(v):
        n = v.shape[0] // world
        return v[rank * n:(rank + 1) * n]
    return {k: part(v) for k, v in batch.items()}


def rank_rows(t: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous rows of ``t``, a tensor over the global
    batch; all of it without a group."""
    rank, world = rank_world()
    if world == 1:
        return t
    n = t.shape[0] // world
    return t[rank * n:(rank + 1) * n]


def replicate(module: torch.nn.Module, group=None) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank (of ``group``, a group
    that holds rank 0; default the whole world)."""
    if dist.is_available() and dist.is_initialized():
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, 0, group=group)
    return module


def batch_statistics(*stats: torch.Tensor) -> Sequence[torch.Tensor]:
    """Per-rank means over equal shares of the global batch -> the global
    batch's means, on every rank and with gradients through the reduction
    (``torch.distributed.nn.functional.all_reduce``). Unchanged on one
    rank."""
    world = rank_world()[1]
    if world == 1:
        return stats
    from torch.distributed.nn.functional import all_reduce
    flat = all_reduce(torch.stack(stats)) / world
    return flat.unbind(0)


def average_gradients(params: Iterable[torch.Tensor]) -> None:
    """Each gradient replaced by its mean over the ranks, in one flattened
    all-reduce, wherever a process group is active (on one rank too)."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    world = dist.get_world_size()
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= world
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n


def batch_total(t: torch.Tensor) -> torch.Tensor:
    """A detached count's sum over the ranks (itself without a group): the
    global batch's, for the losses' masked means (``train/losses.py``)."""
    if not (dist.is_available() and dist.is_initialized()):
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t


def mean_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """A detached scalar's mean over the ranks (itself without a group)."""
    if not (dist.is_available() and dist.is_initialized()):
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t / dist.get_world_size()
