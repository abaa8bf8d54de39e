"""The training loop of the port's three entry points.

``train_dnet``, ``train_fnet`` and ``train_magnet`` differ in their model,
loss and validation; the loop around their step is the JAX package's: a
loss line every ``--log_every`` steps, a validation (metrics appended to
``exp/<name>/log/eval_acc.txt``) and a checkpoint (``train/checkpoint.py``)
every ``--validate_every`` samples and at the end, and image dumps
(``utils/visualize.py``, the entry point's ``visualize``) every
``--visualize_every`` samples. Under a process group
(``core/distributed.py``) every rank steps on its share of the batch and
rank 0 alone logs, dumps, validates and saves, the others waiting at a
barrier.
``--profile_dir`` traces a window of steps (``utils/profiling.py``).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from magnet_tpu_torch.core import distributed
from magnet_tpu_torch.eval import metrics
from magnet_tpu_torch.train import checkpoint
from magnet_tpu_torch.utils.profiling import ProfileWindow, StepTimer

# --profile_dir traces steps [start, start + num), start at most
# PROFILE_START: a short run is traced from its middle
PROFILE_START, PROFILE_STEPS = 10, 3


def device_of(args) -> torch.device:
    """``--device``; a card asked for and missing is an error. Under a
    process group ``cuda`` is this process's card."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available")
    if device == torch.device("cuda") and dist.is_available() and \
            dist.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return device


def run(args, state, step_fn: Callable, loader, to_device: Callable,
        validate: Callable[[], Dict],
        visualize: Optional[Callable[[Dict, Dict, int], None]] = None
        ) -> Dict:
    """Train ``state`` over ``--n_epochs`` of ``loader`` (each raw batch
    through ``to_device``, then ``step_fn``); after a step where
    ``total_iter % --visualize_every`` is below the batch size, rank 0
    calls ``visualize(raw, batch, total_iter)``. Returns the final state, the
    loss and time of every step (host clock with the loss read, and CUDA
    events around the step on a card), the last validation's metrics and
    the last checkpoint's directory (None and "" on ranks other than 0),
    and the ``--profile_dir`` trace's path."""
    on_card = torch.device(args.device).type == "cuda"
    lead = distributed.rank_world()[0] == 0
    out = dict(losses=[], step_ms=[], step_event_ms=[])
    total_iter, t0, timer, mts, ckpt = 0, time.time(), StepTimer(), None, ""
    window = ProfileWindow(getattr(args, "profile_dir", ""),
                           min(PROFILE_START,
                               len(loader) * args.n_epochs // 2),
                           PROFILE_STEPS)

    def validate_and_save():
        m, path = None, ""
        if lead:
            m = validate()
            metrics.log_metrics(args.eval_acc_txt, m,
                                f"total_iter: {total_iter}")
            path = checkpoint.save(args.exp_model_dir, state, total_iter)
        if dist.is_available() and dist.is_initialized():
            dist.barrier()
        return m, path

    for epoch in range(args.n_epochs):
        for raw in loader:
            window.tick()
            batch = to_device(raw)
            t_step = time.perf_counter()
            if on_card:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            state, m = step_fn(state, batch)
            if on_card:
                ev[1].record()
            loss = float(m["loss"])                # waits for the step
            out["step_ms"].append(1e3 * (time.perf_counter() - t_step))
            if on_card:
                out["step_event_ms"].append(ev[0].elapsed_time(ev[1]))
            out["losses"].append(loss)
            sps = timer.tick()
            total_iter += args.batch_size
            if lead and total_iter % (args.log_every * args.batch_size) < \
                    args.batch_size:
                print(f"epoch {epoch + 1}/{args.n_epochs} iter {total_iter} "
                      f"loss {loss:.5f} ({time.time() - t0:.1f}s, "
                      f"{sps:.2f} steps/s)", flush=True)
            if visualize is not None and lead and \
                    total_iter % args.visualize_every < args.batch_size:
                visualize(raw, batch, total_iter)
            if total_iter % args.validate_every < args.batch_size:
                mts, ckpt = validate_and_save()
    window.close()
    mts, ckpt = validate_and_save()
    return dict(out, state=state, metrics=mts, ckpt=ckpt,
                profile_trace=window.path)
