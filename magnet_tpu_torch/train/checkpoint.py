"""Checkpoints of the training state, with ``torch.save``.

The port of ``magnet_tpu/train/checkpoint.py`` (orbax there): the whole
``TrainState`` (model parameters and BatchNorm buffers, optimizer moments
and the schedules' position, step, generator) under
``<ckpt_dir>/<step:010d>/state.pt``, so a resumed run continues the schedule
exactly; ``restore`` takes the parent directory (latest step) or one step's
directory.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

STATE_FILE = "state.pt"


def save(ckpt_dir: str, state, step: Optional[int] = None) -> str:
    """Save ``state`` under ckpt_dir/<step> (default: ``state.step``);
    returns that directory."""
    step = state.step if step is None else int(step)
    path = os.path.join(os.path.abspath(ckpt_dir), f"{step:010d}")
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save({"step": state.step, "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "generator": state.generator.get_state()}, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d) for d in os.listdir(ckpt_dir) if d.isdigit()]
    return max(steps) if steps else None


def restore(ckpt_dir: str, state=None, step: Optional[int] = None):
    """Load into ``state`` (a ``TrainState`` of the same model) and return
    it, or return the saved dict when ``state`` is None. ``ckpt_dir`` is a
    parent of step directories or one step directory itself."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    if os.path.basename(ckpt_dir.rstrip("/")).isdigit() and step is None:
        path = ckpt_dir
    else:
        if step is None:
            step = latest_step(ckpt_dir)
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
        path = os.path.join(ckpt_dir, f"{step:010d}")
    saved = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                       weights_only=True)
    if state is None:
        return saved
    state.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.generator.set_state(saved["generator"])
    state.step = int(saved["step"])
    return state
