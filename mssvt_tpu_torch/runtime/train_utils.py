"""Training step and loop on one card (torch counterpart of
``mssvt_tpu/runtime/train_utils.py``; data parallelism is a later slice).

``train_step`` is the unit the loop repeats: forward in train mode, loss,
backward (K5 for the assembled attention), then the optimizer chain. Its
gradients repeat bit for bit for the same weights, batch and DropPath
generator state once :func:`set_deterministic` has been called: the port's
gathers and K5 sum without float atomics. ``train_model`` feeds it from the
data loader through :func:`batch_to_device`.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .checkpoint import CheckpointManager, training_state

def set_deterministic():
    """Ask cuDNN for its deterministic algorithms and no autotuning.

    Process-wide (``torch.backends.cudnn``), so it is set once by the
    caller that needs bit-identical repeats, not per step: the training
    entry point (``tools/train_torch.py``), ``chip_smoke.py`` and the card
    tests. It also slows the process's other cuDNN work (the
    BEV backbone's and the head's convolutions may lose a faster
    nondeterministic algorithm)."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def batch_to_device(batch, device):
    """The collated batch on ``device`` (the one-card counterpart of
    ``shard_batch_for_mesh``): numpy arrays go through pinned memory with
    ``non_blocking=True`` on a card; tensors are moved; python values and
    lists (``frame_id``, ``n_real``, ``batch_size``) stay on the host."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == "cuda":
                v = v.pin_memory()
        if isinstance(v, torch.Tensor):
            v = v.to(device, non_blocking=True)
        out[k] = v
    return out


def model_device(model) -> torch.device:
    return next(model.parameters()).device


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


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
                tb_log=None, log_interval: int = 50, history=None):
    """Run ``train_step`` over ``train_loader`` (a ``Loader`` of collated
    numpy batches, or any iterable of batches; ``set_epoch(epoch)`` is
    called when it has one) for ``total_epochs`` epochs, each batch moved
    to the model's device by :func:`batch_to_device`, logging every
    ``log_interval`` iterations and saving a checkpoint every
    ``ckpt_save_interval`` epochs (checkpoints fall on epoch boundaries, so
    a resumed run starts at ``start_epoch``'s first batch). With a
    ``history`` list, one record per step is appended:
    epoch, iteration, loss, the host seconds spent waiting for the batch
    and handing it to the device (``data_s``) and the step's seconds up to
    a device synchronisation (``step_s``). Returns the accumulated
    iteration count."""
    device = model_device(model)
    accumulated_iter = start_iter
    for epoch in range(start_epoch, total_epochs):
        if hasattr(train_loader, "set_epoch"):
            train_loader.set_epoch(epoch)
        data_meter, batch_meter = AverageMeter(), AverageMeter()
        end = time.time()
        for batch in train_loader:
            batch = batch_to_device(batch, device)
            data_s = time.time() - end
            data_meter.update(data_s)
            loss, tb = train_step(model, optimizer, batch, generator)
            accumulated_iter += 1
            if history is not None:
                synchronize(device)
                history.append({"epoch": epoch, "it": accumulated_iter,
                                "loss": float(loss), "data_s": data_s,
                                "step_s": time.time() - end - data_s})
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
