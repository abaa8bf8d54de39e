"""View-sharded single-stream inference.

The port of ``magnet_tpu/core/sharding_inference.py``. At inference the
batch is 1, so data parallelism has nothing to split; the multi-view stage
is parallel over the source views instead: each view's plane-sweep warp and
matching is independent and the cost volume is a sum over the views. The
JAX package shards the view axis over a ``('view',)`` mesh and XLA adds one
psum for the view sum. Here each of W processes (one a device, in the
process group of ``core/distributed.py``: NCCL on cards, gloo on the CPU)
is given the full inputs, takes its contiguous V / W of the source views,
encodes the reference frame and its own views (1 + V / W frames through
``Magnet.encode``: the frozen-backbone pass shards its frame batch the same
way, and every rank encodes the reference frame itself rather than
receiving it), and runs ``Magnet.fuse`` with the group's reduction: each
iteration's partial cost volume, divided by the global V inside row 4's
kernel (its ``v_total``), is summed over the group by one all-reduce of the
(B, h, w, D) f32 volume before G-Net. G-Net, the mask head and the
upsampling then run alike on every rank, as XLA runs them replicated.

Usage, in every process of the group:

    mesh = view_mesh(n)                      # the first n ranks
    fwd = shard_magnet_inference(model, mesh, n_iters)
    pred = fwd(ref_img, src_imgs, R, t, is_valid, intM, rays2d)

V must be divisible by the mesh size.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from magnet_tpu_torch.core import mesh as mesh_lib


@dataclass(frozen=True)
class ViewMesh:
    """The ranks that split a frame's views: their process group, this
    process's index in it (-1 outside it) and its size."""
    group: Optional[dist.ProcessGroup]
    rank: int
    size: int

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the mesh in place (one all-reduce), returned:
        the reduction ``Magnet.fuse`` applies to each partial cost
        volume."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t


def view_mesh(n_devices: int = None) -> ViewMesh:
    """The first ``n_devices`` ranks (default all) of the active process
    group, as a ``ViewMesh``. Every rank of the group calls it (a subgroup
    is made collectively); raises without a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("view_mesh needs a process group "
                           "(core/distributed.py)")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"view_mesh({n_devices}): the group has {world} "
                         "ranks")
    group = dist.group.WORLD if n == world else dist.new_group(
        list(range(n)))
    return ViewMesh(group, rank if rank < n else -1, n)


def shard_magnet_inference(model, mesh: ViewMesh, n_iters: int):
    """Returns ``run(ref_img, src_imgs, R, t, is_valid, intM, rays2d)`` ->
    the last iteration's (B, H, W, 2) (mu, sigma) map, on every rank of
    ``mesh``. Each rank is given the full inputs (images in the model's
    compute dtype, geometry in f32, on its device) and takes its views.
    ``model`` (eval mode, cast for inference) gets rank 0's weights here."""
    if mesh.rank < 0:
        raise ValueError(f"this process is not in the view mesh of "
                         f"{mesh.size} ranks")
    mesh_lib.replicate(model, mesh.group)
    model.eval()

    @torch.inference_mode()
    def run(ref_img, src_imgs, R, t, is_valid, intM, rays2d):
        V = src_imgs.shape[1]
        if V % mesh.size:
            raise ValueError(f"V = {V} source views do not divide over the "
                             f"mesh's W = {mesh.size} devices")
        n = V // mesh.size
        mine = slice(mesh.rank * n, (mesh.rank + 1) * n)
        preds = model(ref_img, src_imgs[:, mine], R[:, mine], t[:, mine],
                      is_valid[:, mine], intM, rays2d, n_iters=n_iters,
                      view_mesh=mesh)
        return preds[-1]

    return run
