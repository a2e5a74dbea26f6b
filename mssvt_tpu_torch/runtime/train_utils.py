"""Training step and loop (torch counterpart of
``mssvt_tpu/runtime/train_utils.py`` and of the sharded step of
``mssvt_tpu/parallel/mesh.py``).

``train_step`` is the unit the loop repeats: forward in train mode, loss,
backward (K5 for the assembled attention), then the optimizer chain. Its
gradients repeat bit for bit for the same weights, batch and DropPath
generator state once :func:`set_deterministic` has been called: the port's
gathers and K5 sum without float atomics. ``train_model`` feeds it from the
data loader through :func:`batch_to_device`.

Data parallel (a model wrapped by ``parallel.dist.wrap_ddp``): each rank
runs the step on its own shard of the batch with SyncBN on
(``syncbn.sync_bn``), DDP averages the gradients before the optimizer's
``GRAD_NORM_CLIP`` and update, and the returned loss and ``tb_dict`` are
their means over the ranks (the JAX step's ``pmean``s). Each rank draws
DropPath and dropout masks from its own generator (the JAX step folds its
key by the device index); checkpoints and logs are written by rank 0.
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.model_utils import syncbn
from ..parallel.dist import rank_and_world, unwrap
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


def _collective_device():
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def average_across_hosts(*values):
    """Mean over the ranks of scalars in one all-reduce: python numbers
    (host timings, as the reference averages its data/forward/batch times
    every iteration; ref: commu_utils.py:143-145, train_utils.py:67-69)
    come back as floats (summed in f64), 0-d tensors (the loss,
    ``tb_dict``) as tensors of their dtype on their device (summed in f32).
    One process: identity."""
    _, world = rank_and_world()
    if world == 1:
        return values if len(values) > 1 else values[0]
    tensors = isinstance(values[0], torch.Tensor)
    dev = values[0].device if tensors else _collective_device()
    dtype = torch.float32 if tensors else torch.float64
    packed = torch.stack([torch.as_tensor(v, device=dev).to(dtype)
                          for v in values])
    dist.all_reduce(packed)
    packed = packed / world
    means = tuple(packed[i].to(v.dtype) if tensors else float(packed[i])
                  for i, v in enumerate(values))
    return means if len(values) > 1 else means[0]


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
    parameters' ``.grad`` (accumulated onto what is there; averaged over
    the ranks when ``model`` is DDP-wrapped, whose BatchNorm layers then
    sync their statistics) and returns ``(loss, tb_dict)``, detached and
    averaged over the ranks."""
    model.train()
    ddp = model is not unwrap(model)
    with (syncbn.sync_bn(model.process_group) if ddp else nullcontext()):
        out = model(batch, generator=generator)
    out["loss"].backward()
    keys = sorted(out["tb_dict"])
    means = average_across_hosts(
        out["loss"].detach(), *(out["tb_dict"][k].detach() for k in keys))
    if not keys:
        return means, {}
    return means[0], dict(zip(keys, means[1:]))


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
    a resumed run starts at ``start_epoch``'s first batch; under DDP rank 0
    logs and saves, and the timings are the ranks' means). With a
    ``history`` list, one record per step is appended:
    epoch, iteration, loss, the host seconds spent waiting for the batch
    and handing it to the device (``data_s``), the step's seconds up to
    a device synchronisation (``step_s``) and the host clock then (``t``).
    Returns the accumulated iteration count."""
    device = model_device(model)
    rank, _ = rank_and_world()
    if rank != 0:  # checkpoints and logs come from rank 0
        ckpt_manager, logger, tb_log = None, None, None
    accumulated_iter = start_iter
    for epoch in range(start_epoch, total_epochs):
        if hasattr(train_loader, "set_epoch"):
            train_loader.set_epoch(epoch)
        data_meter, batch_meter = AverageMeter(), AverageMeter()
        end = time.time()
        for batch in train_loader:
            batch = batch_to_device(batch, device)
            data_s = time.time() - end
            data_meter.update(average_across_hosts(data_s))
            loss, tb = train_step(model, optimizer, batch, generator)
            accumulated_iter += 1
            if history is not None:
                synchronize(device)
                now = time.time()
                history.append({"epoch": epoch, "it": accumulated_iter,
                                "loss": float(loss), "data_s": data_s,
                                "step_s": now - end - data_s, "t": now})
            if accumulated_iter % log_interval == 0:
                loss_v = float(loss)
                lr_v = float(lr_fn(accumulated_iter)) if lr_fn else float("nan")
                batch_meter.update(average_across_hosts(time.time() - end))
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
                unwrap(model), optimizer, epoch + 1, accumulated_iter))
            if logger:
                logger.info(f"saved checkpoint @ epoch {epoch + 1}")
    return accumulated_iter
