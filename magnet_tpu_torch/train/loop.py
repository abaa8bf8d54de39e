"""The training loop of the port's three entry points.

``train_dnet``, ``train_fnet`` and ``train_magnet`` differ in their model,
loss and validation; the loop around their step is the JAX package's: a
loss line every ``--log_every`` steps, a validation (metrics appended to
``exp/<name>/log/eval_acc.txt``) and a checkpoint (``train/checkpoint.py``)
every ``--validate_every`` samples and at the end.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import torch

from magnet_tpu_torch.eval import metrics
from magnet_tpu_torch.train import checkpoint
from magnet_tpu_torch.utils.profiling import StepTimer


def device_of(args) -> torch.device:
    """``--device``; a card asked for and missing is an error."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available")
    return device


def run(args, state, step_fn: Callable, loader, to_device: Callable,
        validate: Callable[[], Dict]) -> Dict:
    """Train ``state`` over ``--n_epochs`` of ``loader`` (each raw batch
    through ``to_device``, then ``step_fn``). Returns the final state, the
    loss and time of every step (host clock with the loss read, and CUDA
    events around the step on a card), the last validation's metrics and
    the last checkpoint's directory."""
    on_card = torch.device(args.device).type == "cuda"
    out = dict(losses=[], step_ms=[], step_event_ms=[])
    total_iter, t0, timer, mts, ckpt = 0, time.time(), StepTimer(), None, ""

    def validate_and_save():
        m = validate()
        metrics.log_metrics(args.eval_acc_txt, m, f"total_iter: {total_iter}")
        return m, checkpoint.save(args.exp_model_dir, state, total_iter)

    for epoch in range(args.n_epochs):
        for raw in loader:
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
            if total_iter % (args.log_every * args.batch_size) < \
                    args.batch_size:
                print(f"epoch {epoch + 1}/{args.n_epochs} iter {total_iter} "
                      f"loss {loss:.5f} ({time.time() - t0:.1f}s, "
                      f"{sps:.2f} steps/s)", flush=True)
            if total_iter % args.validate_every < args.batch_size:
                mts, ckpt = validate_and_save()
    mts, ckpt = validate_and_save()
    return dict(out, state=state, metrics=mts, ckpt=ckpt)
