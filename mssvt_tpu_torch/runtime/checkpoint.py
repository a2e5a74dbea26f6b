"""Checkpoints with rotation and resume (torch counterpart of
``mssvt_tpu/runtime/checkpoint.py``, which uses orbax).

A checkpoint is one ``torch.save`` file, ``checkpoint_<step>.pt``, holding
``{"model": model.state_dict(), "optimizer": optimizer.state_dict(),
"epoch": ..., "it": ...}``: the parameters and the BatchNorm statistics
(buffers of the model's state dict), the optimizer's moments and count, the
epoch and the iteration. The newest ``max_keep`` are kept.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Optional

import torch

_NAME = re.compile(r"checkpoint_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, ckpt_dir, max_keep: int = 30):
        self.ckpt_dir = Path(ckpt_dir).resolve()
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        self.max_keep = int(max_keep)

    def _path(self, step: int) -> Path:
        return self.ckpt_dir / f"checkpoint_{int(step)}.pt"

    def all_steps(self):
        return sorted(int(m.group(1)) for p in self.ckpt_dir.iterdir()
                      if (m := _NAME.match(p.name)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict):
        """Write ``state`` (see the module note) and drop the oldest files
        beyond ``max_keep``. The file is written whole, then renamed."""
        tmp = self._path(step).with_suffix(".tmp")
        torch.save(state, tmp)
        tmp.replace(self._path(step))
        for old in self.all_steps()[:-self.max_keep]:
            self._path(old).unlink()

    def restore(self, step: Optional[int] = None, map_location="cpu") -> dict:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.ckpt_dir}")
        return torch.load(self._path(step), map_location=map_location,
                          weights_only=False)


def training_state(model, optimizer, epoch: int, it: int) -> dict:
    return {"model": {k: v.detach().cpu() for k, v in
                      model.state_dict().items()},
            "optimizer": optimizer.state_dict(), "epoch": int(epoch),
            "it": int(it)}


def load_training_state(model, optimizer, state: dict):
    """Resume: parameters, BatchNorm statistics and optimizer state in
    place; returns (epoch, it)."""
    model.load_state_dict(state["model"])
    if optimizer is not None:
        optimizer.load_state_dict(state["optimizer"])
    return int(state["epoch"]), int(state["it"])
