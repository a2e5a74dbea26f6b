"""Rank bodies of the port's data-parallel tests (``test_torch_ddp.py``).

``parallel.dist.launch_local`` runs them in fresh spawned processes, which
import this module and the port, never JAX. Each joins the file rendezvous
that ``launch_local`` set up, over gloo on the CPU.
"""

from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch

from mssvt_tpu_torch.bridge import to_flax_tree
from mssvt_tpu_torch.config import cfg_from_yaml_file
from mssvt_tpu_torch.models import build_network
from mssvt_tpu_torch.models.model_utils import syncbn
from mssvt_tpu_torch.models.model_utils.layers import MaskedBatchNorm
from mssvt_tpu_torch.parallel import dist
from mssvt_tpu_torch.runtime.train_utils import (
    average_across_hosts,
    train_step,
)
from mssvt_tpu_torch.utils.edict import EasyDict


def set_window_caps(cfg, max_num_wins):
    """Each backbone block's window cap a frame set to ``max_num_wins``
    (unchanged when None)."""
    for p in cfg.MODEL.BACKBONE_3D.PARAMS:
        if max_num_wins is not None:
            p["max_num_wins"] = max_num_wins
    return cfg


def tiny_model(cfg_path, batch_size, max_voxels, state=None,
               max_num_wins=None):
    """``cfg_path``'s model on the CPU for ``batch_size`` frames of
    ``max_voxels`` voxel slots each, with ``state`` (a state dict) loaded."""
    cfg = set_window_caps(cfg_from_yaml_file(str(cfg_path), EasyDict()),
                          max_num_wins)
    dc = cfg.DATA_CONFIG
    pcr = tuple(dc.POINT_CLOUD_RANGE)
    vs = tuple(dc.DATA_PROCESSOR[-1].VOXEL_SIZE)
    grid = tuple(int(round((pcr[i + 3] - pcr[i]) / vs[i])) for i in range(3))
    model = build_network(
        cfg.MODEL, num_class=len(cfg.CLASS_NAMES),
        class_names=list(cfg.CLASS_NAMES), grid_size=grid, voxel_size=vs,
        point_cloud_range=pcr, batch_size=batch_size, max_voxels=max_voxels,
        max_points_per_voxel=5,
        num_point_features=len(dc.POINT_FEATURE_ENCODING.used_feature_list),
        device="cpu")
    if state is not None:
        model.load_state_dict(state)
    return model


def sgd_step(model, batch, lr, rank=0):
    """One ``train_step`` with plain SGD; returns (loss, tb_dict, the
    parameters and BatchNorm statistics after the step as flax-path trees,
    the names of parameters left without a gradient)."""
    opt = torch.optim.SGD(model.parameters(), lr=lr)
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(rank)
    loss, tb = train_step(model, opt, batch, gen)
    inner = dist.unwrap(model)
    no_grad = [n for n, p in inner.named_parameters() if p.grad is None]
    return (float(loss), {k: float(v) for k, v in tb.items()},
            to_flax_tree(inner, "params"), to_flax_tree(inner, "batch_stats"),
            no_grad)


def ddp_rank(cfg_path, max_voxels, max_num_wins, state, shards, lr):
    """One DDP ``train_step`` of this rank on ``shards[rank]`` (one frame),
    plus the rank's view of ``average_across_hosts`` on host numbers and on
    tensors."""
    rank, world = dist.init_distributed("pytorch", "cpu")
    try:
        torch.use_deterministic_algorithms(True)
        model = dist.wrap_ddp(tiny_model(cfg_path, 1, max_voxels, state,
                                         max_num_wins))
        step = sgd_step(model, shards[rank], lr, rank)
        hosts = (average_across_hosts(float(rank)),
                 average_across_hosts(float(rank), 10.0 * rank))
        loss, x = average_across_hosts(torch.tensor(float(rank)),
                                       torch.tensor(2.0 * rank))
        return dict(step=step, world=world, hosts=hosts,
                    ranks_mean=(float(loss), float(x)))
    finally:
        dist.shutdown()


def masked_bn(state, x, valid, g):
    """One train-mode ``MaskedBatchNorm`` forward and backward (inside
    ``syncbn.sync_bn`` when a process group is up): output, input and
    parameter cotangents, the updated running statistics."""
    bn = MaskedBatchNorm(x.shape[1])
    bn.load_state_dict(state)
    bn.train()
    xt = torch.as_tensor(x).requires_grad_(True)
    with syncbn.sync_bn() if dist.initialized() else nullcontext():
        y = bn(xt, torch.as_tensor(valid))
    y.backward(torch.as_tensor(g))
    return dict(y=y.detach().numpy(), dx=xt.grad.numpy(),
                dscale=bn.scale.grad.numpy(), dbias=bn.bias.grad.numpy(),
                mean=bn.mean.numpy(), var=bn.var.numpy())


def masked_bn_rank(state, xs, valids, gs):
    """This rank's rows of :func:`masked_bn` under SyncBN over gloo."""
    rank, _ = dist.init_distributed("pytorch", "cpu")
    try:
        return masked_bn(state, xs[rank], valids[rank], gs[rank])
    finally:
        dist.shutdown()


def shard(batch, rank, world):
    """Rank ``rank``'s share of a batch in per-frame voxel slots, its batch
    column localised (the JAX package's ``shard_batch_for_mesh``)."""
    frames = len(batch["gt_boxes"]) // world
    out = {}
    for k, v in batch.items():
        per = len(v) // world
        v = np.array(v[rank * per:(rank + 1) * per])
        if k == "voxel_coords":
            v[:, 0] = np.where(v[:, 0] >= 0, v[:, 0] - rank * frames, -1)
        out[k] = v
    return out
