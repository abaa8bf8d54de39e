"""Process groups for training on several devices, one process each.

The port's counterpart of ``magnet_tpu/core/distributed.py``. The JAX
package initialises ``jax.distributed`` once a host and then sees every
chip; the port runs one process per device (the reference's NCCL DDP,
``train_DNet.py:180-212``) and joins them in a ``torch.distributed``
process group. Off unless the environment asks for it, so a one-process run
is untouched:

  MAGNET_TPU_DIST=1                enable; so do torchrun's RANK and
                                   WORLD_SIZE (its MASTER_ADDR/MASTER_PORT
                                   then give the rendezvous, ``env://``)
  MAGNET_TPU_COORDINATOR=ip:port   the rendezvous, ``tcp://ip:port``; a URL
                                   (``tcp://...``, ``file://...``) as given
  MAGNET_TPU_NUM_PROCESSES=N       the world size
  MAGNET_TPU_PROCESS_ID=K          this process's rank
  LOCAL_RANK=L                     this process's card, ``cuda:L`` (default
                                   the rank modulo the cards visible)

The backend is NCCL for ``--device cuda`` and gloo on the CPU.

``spawn`` starts W local processes on such a group (the CPU tests and the
multi-process checks of ``dryrun.py`` and ``chip_smoke.py``).
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

_initialized = False


def _on(e) -> bool:
    return (e.get("MAGNET_TPU_DIST", "").lower() in ("1", "true", "on")
            or ("RANK" in e and "WORLD_SIZE" in e))


def local_device_index(env=None) -> int:
    """The card of this process: ``LOCAL_RANK``, else its rank modulo the
    cards visible."""
    e = os.environ if env is None else env
    if e.get("LOCAL_RANK"):
        return int(e["LOCAL_RANK"])
    rank = int(e.get("MAGNET_TPU_PROCESS_ID") or e.get("RANK") or 0)
    return rank % max(1, torch.cuda.device_count())


def maybe_initialize_distributed(env=None, _init_fn: Optional[Callable] = None,
                                 device: str = "cuda") -> bool:
    """Join the process group that the environment names (see the module
    note); returns whether a group is active. Idempotent; a no-op when the
    environment names none. ``env`` and ``_init_fn`` exist for the tests."""
    global _initialized
    e = os.environ if env is None else env
    if not _on(e):
        return False
    if _initialized or (_init_fn is None and dist.is_initialized()):
        return True
    on_card = torch.device(device).type == "cuda"
    kwargs = {"backend": "nccl" if on_card else "gloo"}
    addr = e.get("MAGNET_TPU_COORDINATOR")
    if addr:
        kwargs["init_method"] = addr if "://" in addr else f"tcp://{addr}"
    n = e.get("MAGNET_TPU_NUM_PROCESSES") or e.get("WORLD_SIZE")
    if n:
        kwargs["world_size"] = int(n)
    rank = e.get("MAGNET_TPU_PROCESS_ID") or e.get("RANK")
    if rank:
        kwargs["rank"] = int(rank)
    if _init_fn is None:
        if on_card:
            torch.cuda.set_device(local_device_index(e))
        _init_fn = dist.init_process_group
    _init_fn(**kwargs)
    _initialized = True
    return True


def shutdown() -> None:
    """Leave the process group (a later ``maybe_initialize_distributed``
    joins a new one)."""
    global _initialized
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


@contextlib.contextmanager
def session(device: str = "cuda"):
    """The entry points' group: joined at the start where the environment
    names one and left at the end; a group the caller made is left to the
    caller."""
    started = (not (dist.is_available() and dist.is_initialized())
               and maybe_initialize_distributed(device=device))
    try:
        yield
    finally:
        if started:
            shutdown()


def rank_world() -> Tuple[int, int]:
    """(rank, world size) of the active group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def free_port() -> str:
    """A free local TCP port's rendezvous, ``tcp://127.0.0.1:<port>``."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def _spawned(rank: int, fn: Callable, world: int, init_method: str,
             backend: str, threads: int, args: tuple) -> None:
    torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    try:
        fn(rank, world, *args)
    finally:
        shutdown()


def spawn(fn: Callable, world: int, args: tuple = (),
          init_method: str = "", backend: str = "gloo") -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes joined in a
    ``backend`` group at ``init_method`` (a ``file://`` path suits test
    runners that share ports; default ``free_port()``), each with its share
    of this process's CPU threads. ``fn`` must be importable (a
    module-level function of a package). Raises if any process fails."""
    import torch.multiprocessing as mp
    threads = max(1, torch.get_num_threads() // world)
    mp.start_processes(_spawned, args=(fn, world, init_method or free_port(),
                                       backend, threads, tuple(args)),
                       nprocs=world, join=True, start_method="spawn")
