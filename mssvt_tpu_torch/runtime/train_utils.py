"""Training step and loop on one card (torch counterpart of
``mssvt_tpu/runtime/train_utils.py``; data parallelism is a later slice).

``train_step`` is the unit the loop repeats: forward in train mode, loss,
backward (K5 for the assembled attention), then the optimizer chain. Its
gradients repeat bit for bit for the same weights, batch and DropPath
generator state: the port's gathers and K5 sum without float atomics, and
``forward_backward`` asks cuDNN for its deterministic algorithms.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from .checkpoint import CheckpointManager, training_state


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = self.avg = self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def forward_backward(model, batch, generator=None):
    """Train-mode forward and backward: leaves the gradients in the
    parameters' ``.grad`` (accumulated onto what is there) and returns
    ``(loss, tb_dict)``, detached."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    model.train()
    out = model(batch, generator=generator)
    out["loss"].backward()
    return out["loss"].detach(), {k: v.detach() for k, v in
                                  out["tb_dict"].items()}


def train_step(model, optimizer, batch, generator=None):
    """One optimisation step; returns ``(loss, tb_dict)``."""
    optimizer.zero_grad()
    loss, tb = forward_backward(model, batch, generator)
    optimizer.step()
    return loss, tb


def train_model(model, optimizer, train_loader, total_epochs: int,
                ckpt_manager: Optional[CheckpointManager] = None,
                ckpt_save_interval: int = 1, start_epoch: int = 0,
                start_iter: int = 0, generator=None, lr_fn=None, logger=None,
                tb_log=None, log_interval: int = 50):
    """Run ``train_step`` over ``train_loader`` (any iterable of batches on
    the model's device; ``set_epoch(epoch)`` is called when it has one) for
    ``total_epochs`` epochs, logging every ``log_interval`` iterations and
    saving a checkpoint every ``ckpt_save_interval`` epochs. Returns the
    accumulated iteration count."""
    accumulated_iter = start_iter
    for epoch in range(start_epoch, total_epochs):
        if hasattr(train_loader, "set_epoch"):
            train_loader.set_epoch(epoch)
        data_meter, batch_meter = AverageMeter(), AverageMeter()
        end = time.time()
        for batch in train_loader:
            data_meter.update(time.time() - end)
            loss, tb = train_step(model, optimizer, batch, generator)
            accumulated_iter += 1
            if accumulated_iter % log_interval == 0:
                loss_v = float(loss)
                lr_v = float(lr_fn(accumulated_iter)) if lr_fn else float("nan")
                batch_meter.update(time.time() - end)
                if logger:
                    logger.info(
                        f"epoch {epoch} it {accumulated_iter} "
                        f"loss {loss_v:.4f} lr {lr_v:.6f} "
                        f"data {data_meter.avg:.3f}s batch {batch_meter.avg:.3f}s")
                if tb_log:
                    tb_log.add_scalar("train/loss", loss_v, accumulated_iter)
                    tb_log.add_scalar("meta_data/learning_rate", lr_v,
                                      accumulated_iter)
                    for k, v in tb.items():
                        tb_log.add_scalar(f"train/{k}", float(v),
                                          accumulated_iter)
            end = time.time()
        if ckpt_manager and (epoch + 1) % ckpt_save_interval == 0:
            ckpt_manager.save(epoch + 1, training_state(
                model, optimizer, epoch + 1, accumulated_iter))
            if logger:
                logger.info(f"saved checkpoint @ epoch {epoch + 1}")
    return accumulated_iter
