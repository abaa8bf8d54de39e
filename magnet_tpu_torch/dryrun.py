"""Training steps run across several processes, and their checks.

``dryrun_multichip(n)`` is the port's counterpart of
``__graft_entry__.py::dryrun_multichip``: a correctness check of the data
parallelism, not a liveness check. It starts n processes in a process group
(``core/distributed.spawn``: gloo on the CPU by default, NCCL with
``device="cuda"``), and each runs the MaGNet stage-3 training step
(``train/steps.make_magnet_train_step``) on its share of one batch of n
samples at the JAX check's shape (2 source views, 32x32, one iteration,
the depth head in a trained network's regime:
``models/build.realistic_depth_init_``). Every rank asserts that

* the step's loss (the ranks' mean) is within 1e-4 relative of the loss of
  one process on the whole batch;
* the step changed the parameters;
* the parameters after the step are equal on every rank.

A sharding fault (every rank fed the same samples, a gradient summed and
not averaged) moves the loss or the parameters; ``_shard_fn`` takes the
place of ``core/mesh.shard_batch`` to show it (``shard_same_everywhere``,
the check's control, must fail it).

The module's other workers run the port's own steps and entry points under
such a group, for the tests and ``chip_smoke.py``: ``fnet_step_worker``
(one stage-2 step from a saved case, its outputs saved), ``entry_worker``
(a training entry point's ``train``) and ``view_sharded_worker`` (the
view-sharded forward of ``core/sharding_inference.py`` from a saved case).
They are module functions so that ``spawn`` can import them.

    python -m magnet_tpu_torch.dryrun [n] [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from magnet_tpu_torch.core import distributed, mesh
from magnet_tpu_torch.kernels import ops

# the JAX check's shape (``__graft_entry__._dryrun_multichip_impl``)
VIEWS, SIZE, N_ITERS = 2, 32, 1
GAMMA, MAX_DEPTH, MIN_DEPTH = 0.8, 10.0, 1e-3
LOSS_TOL = 1e-4


def dryrun_batch(n: int) -> dict:
    """The check's batch of n samples (``_dryrun_multichip_impl``'s), numpy
    f32."""
    B, V, H, W = n, VIEWS, SIZE, SIZE
    h, w = H // 4, W // 4
    rng = np.random.RandomState(0)
    fx = 0.9 * w
    K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1.0]], np.float32)
    grid = np.ones((h, w, 3), np.float32)
    grid[:, :, 0] = (np.arange(w)[None] + 0.5 - K[0, 2]) / K[0, 0]
    grid[:, :, 1] = (np.arange(h)[:, None] + 0.5 - K[1, 2]) / K[1, 1]
    rays = grid.transpose(2, 0, 1).reshape(3, -1)
    return {
        "ref_img": rng.rand(B, H, W, 3).astype(np.float32),
        "src_imgs": rng.rand(B, V, H, W, 3).astype(np.float32),
        "R": np.tile(np.eye(3, dtype=np.float32), (B, V, 1, 1)),
        "t": rng.randn(B, V, 3).astype(np.float32) * 0.02,
        "is_valid": np.ones((B, V), np.float32),
        "intM": np.tile(K, (B, 1, 1)),
        "rays2d": np.tile(rays, (B, 1, 1)),
        "depth": rng.uniform(1, 5, (B, H, W)).astype(np.float32),
    }


def shard_same_everywhere(batch: dict, rank: int, world: int) -> dict:
    """The check's control: every rank gets rank 0's share (the classic
    data-partition fault)."""
    return mesh.shard_batch(batch, 0, world)


def _process_device(device: str) -> torch.device:
    if torch.device(device).type != "cuda":
        return torch.device(device)
    torch.cuda.set_device(distributed.local_device_index())
    return torch.device("cuda", torch.cuda.current_device())


def _tensors(batch: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def _dryrun_worker(rank: int, world: int, device: str,
                   shard_fn: Optional[Callable], out: str) -> None:
    from magnet_tpu_torch.models.build import (init_weights_,
                                               realistic_depth_init_)
    from magnet_tpu_torch.models.magnet import Magnet
    from magnet_tpu_torch.train import optim, steps
    dev = _process_device(device)
    model = realistic_depth_init_(init_weights_(Magnet(n_iters=N_ITERS)))
    model = mesh.replicate(model.to(dev).train())
    batch = dryrun_batch(world)
    with torch.no_grad():
        loss_1 = float(steps.magnet_batch_loss(
            model, _tensors(batch, dev), GAMMA, MAX_DEPTH, MIN_DEPTH,
            N_ITERS))
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    opt = optim.make_magnet_optimizer(model, lr=1e-3, total_steps=10)
    step = steps.make_magnet_train_step(GAMMA, MAX_DEPTH, MIN_DEPTH, N_ITERS)
    shard = (shard_fn or mesh.shard_batch)(batch, rank, world)
    _, m = step(steps.TrainState(model, opt), _tensors(shard, dev))
    loss_n = float(m["loss"])
    assert np.isfinite(loss_n) and np.isfinite(loss_1), (loss_n, loss_1)
    rel = abs(loss_n - loss_1) / max(1.0, abs(loss_1))
    assert rel <= LOSS_TOL, (
        f"sharded-vs-single loss mismatch: {loss_n} (x{world}) vs {loss_1} "
        f"(x1), rel={rel:.3e}")
    upd = sum(float((p.detach() - before[k]).abs().double().sum())
              for k, p in model.named_parameters())
    assert upd > 0.0, "the optimizer step changed no parameters"
    flat = torch.cat([p.detach().reshape(-1)
                      for p in model.parameters()]).double()
    ref = flat.clone()
    dist.broadcast(ref, 0)
    assert torch.equal(flat, ref), "the parameters differ between ranks"
    if rank == 0:
        torch.save(dict(loss=loss_n, loss_1=loss_1, rel=rel,
                        param_update_l1=upd), out)


def dryrun_multichip(n_devices: int, device: str = "cpu",
                     backend: str = "", init_method: str = "",
                     _shard_fn: Optional[Callable] = None) -> dict:
    """The stage-3 step over ``n_devices`` processes against one process
    (module note). ``backend``: default gloo on the CPU, NCCL on cards;
    ``init_method``: default a free local TCP port. Raises if a rank's check
    fails; returns rank 0's loss, the one-process loss, their relative
    difference and the L1 norm of the update."""
    backend = backend or ("nccl" if torch.device(device).type == "cuda"
                          else "gloo")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.pt")
        distributed.spawn(_dryrun_worker, n_devices,
                          (device, _shard_fn, out), init_method, backend)
        res = torch.load(out)
    print(f"dryrun_multichip({n_devices}): ok, loss={res['loss']:.6f}, "
          f"loss_1dev={res['loss_1']:.6f}, rel_delta={res['rel']:.3e}, "
          f"param_update_l1={res['param_update_l1']:.3e}", flush=True)
    return res


def fnet_step_worker(rank: int, world: int, case_path: str,
                     out_path: str) -> None:
    """One stage-2 step (``train/steps.make_fnet_train_step``) under the
    group, from the case that ``case_path`` holds (``torch.save`` of a dict:
    ``state`` the ``MagnetF`` state dict, ``feat`` its feature width,
    ``batch`` the global batch of numpy arrays, ``d_center``, ``device``,
    ``dtype``, ``lr``): this rank's share of the batch, the clipped AdamW
    update (TF32 off in f32). Saves the loss, every parameter's gradient,
    the parameters and the BatchNorm buffers after the step to
    ``out_path`` with ``{rank}`` filled in."""
    from magnet_tpu_torch.models.magnet import MagnetF
    from magnet_tpu_torch.train import optim, steps
    c = torch.load(case_path, weights_only=False)
    dev = _process_device(c["device"])
    if c["dtype"] == torch.float32:      # an f32 step: f32 convs, no TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    model = MagnetF(c["feat"])
    model.load_state_dict(c["state"])
    model = mesh.replicate(model.to(dev).train())
    opt = optim.make_fnet_optimizer(model.parameters(), c["lr"], 10)
    step = steps.make_fnet_train_step(
        torch.from_numpy(c["d_center"]).to(dev), MAX_DEPTH, MIN_DEPTH,
        c["dtype"])
    _, m = step(steps.TrainState(model, opt), _tensors(
        mesh.shard_batch(c["batch"], rank, world), dev))
    torch.save(dict(
        loss=float(m["loss"]),
        grads={k: p.grad.detach().cpu() for k, p in model.named_parameters()},
        state={k: v.detach().cpu() for k, v in model.state_dict().items()}),
        out_path.format(rank=rank))


def entry_worker(rank: int, world: int, entry: str, argv: list,
                 out_path: str) -> None:
    """A training entry point (``train_dnet``, ``train_fnet`` or
    ``train_magnet``) run by this rank on the flags ``argv``, through its
    ``train`` under the group. Saves the losses, the step times, the
    kernels' launches and the model's state after the run to ``out_path``
    with ``{rank}`` filled in."""
    import importlib
    from magnet_tpu_torch.core import config
    mod = importlib.import_module(f"magnet_tpu_torch.{entry}")
    parser = getattr(config, f"build_{entry}_parser")()
    args = config.setup_exp_dirs(config.parse_args(parser, argv),
                                 kind="train")
    if torch.device(args.device).type == "cuda":
        torch.cuda.set_device(distributed.local_device_index())
    res = mod.train(args)
    torch.save(dict(
        launches=ops.launch_counts(), losses=res["losses"],
        step_ms=res["step_ms"],
        step_event_ms=res["step_event_ms"], ckpt=res["ckpt"],
        metrics=res["metrics"],
        state={k: v.detach().cpu()
               for k, v in res["state"].model.state_dict().items()}),
        out_path.format(rank=rank))


def view_sharded_worker(rank: int, world: int, case_path: str,
                        out_path: str) -> None:
    """The view-sharded forward (``core/sharding_inference.py``) under the
    group, from the case that ``case_path`` holds (``torch.save`` of a
    dict: ``argv`` the ``test_magnet`` flags that build the model,
    ``state`` its state dict, ``dtypes`` the compute dtypes to run in turn,
    ``device``, ``inputs`` the numpy arguments of ``Magnet.forward`` by
    name, ``n_iters``, ``meshes`` the mesh sizes to run, ``frames`` the
    forwards to time on a card, 0 for none). Every rank builds the model;
    only rank 0 loads ``state``, the others start from another seed, so
    that only the replication makes them agree. TF32 is off. Saves, by
    (dtype, mesh size) for each mesh that holds this rank, the (B, H, W, 2)
    map in f32 and on a card the ms a frame by CUDA events and the ms of
    one all-reduce of the cost volume, to ``out_path`` with ``{rank}``
    filled in."""
    from magnet_tpu_torch.core import config
    from magnet_tpu_torch.core.sharding_inference import (
        shard_magnet_inference, view_mesh)
    from magnet_tpu_torch.models.build import (build_magnet,
                                               cast_for_inference,
                                               init_weights_)
    c = torch.load(case_path, weights_only=False)
    dev = _process_device(c["device"])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    args = config.parse_args(config.build_test_magnet_parser(), c["argv"])
    model = build_magnet(args, "cpu")
    if rank == 0:
        model.load_state_dict(c["state"], strict=False)
    else:
        init_weights_(model, 1000 + rank)
    model = model.to(dev)
    x = _tensors(c["inputs"], dev)
    meshes = {n: view_mesh(n) for n in c["meshes"]}
    out = {}
    for dtype in c["dtypes"]:
        model = cast_for_inference(model, dtype)
        inputs = [x[k] for k in ("ref_img", "src_imgs", "R", "t",
                                 "is_valid", "intM", "rays2d")]
        inputs[:2] = [a.to(dtype) for a in inputs[:2]]
        for n, mesh in meshes.items():
            if mesh.rank < 0:
                continue
            run = shard_magnet_inference(model, mesh, c["n_iters"])
            res = dict(pred=run(*inputs).float().cpu())
            if c.get("frames") and dev.type == "cuda":
                res.update(_sharded_ms(run, inputs, mesh, c["frames"],
                                       model.k_list.numel()))
            out[str(dtype).split(".")[-1], n] = res
    torch.save(out, out_path.format(rank=rank))


def _sharded_ms(run, inputs, mesh, frames: int, D: int) -> dict:
    """ms a frame of ``run`` by CUDA events over ``frames`` forwards, and
    ms of one all-reduce of the (B, h, w, D) f32 cost volume by events over
    as many (the ranks meet at a barrier before each)."""
    rays = inputs[-1]
    cv = torch.zeros(rays.shape[0], rays.shape[-1], D, device=rays.device)
    out = {}
    for name, fn in (("frame_ms", lambda: run(*inputs)),
                     ("all_reduce_ms", lambda: mesh.sum(cv))):
        fn()
        dist.barrier(group=mesh.group)
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(frames):
            fn()
        ev[1].record()
        torch.cuda.synchronize()
        out[name] = ev[0].elapsed_time(ev[1]) / frames
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n", type=int, nargs="?", default=2)
    p.add_argument("--device", default="cpu")
    a = p.parse_args(argv)
    dryrun_multichip(a.n, a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
