"""SyncBN: cross-process BatchNorm statistics under data parallelism (torch
counterpart of ``mssvt_tpu/models/model_utils/syncbn.py``).

The reference converts every BatchNorm to SyncBN when it trains distributed
(ref: tools/train.py:118-119). The JAX package binds flax's BatchNorm to the
data axis inside its sharded train step (``sync_bn("data")``), and flax
then takes ``pmean`` of the batch mean and of ``E[x^2]``. The port does the
same: ``runtime.train_utils.train_step`` enters :func:`sync_bn` with the
process group when the model is wrapped in ``DistributedDataParallel``, and
``layers.BatchNorm`` in training then averages its two statistics over the
ranks with :func:`all_mean`; ``layers.MaskedBatchNorm`` (the sparse
convolutions') sums its valid count and sums with :func:`all_sum`, as the
JAX module's ``psum`` does. Eval and one-process runs never enter it and
stay local.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.distributed as dist

_GROUP = None
_ACTIVE = False


def active():
    """(on, process group): whether BatchNorm statistics are synced now."""
    return _ACTIVE, _GROUP


@contextmanager
def sync_bn(group=None):
    """BatchNorm layers called inside sync their batch statistics over
    ``group`` (None: the default group)."""
    global _GROUP, _ACTIVE
    prev = _GROUP, _ACTIVE
    _GROUP, _ACTIVE = group, True
    try:
        yield
    finally:
        _GROUP, _ACTIVE = prev


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks forward, sum of the cotangents backward: each
    rank's input feeds every rank's loss, and DDP then averages the
    parameter gradients (torch's SyncBatchNorm and flax's pmean under the
    JAX package's sharded step differentiate the same way)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_sum(x, group=None):
    """The sum of ``x`` over the ranks of ``group``, differentiable (its
    cotangent is summed over the ranks too)."""
    return _AllReduceSum.apply(x, group)


def all_mean(x, group=None):
    """The mean of ``x`` over the ranks of ``group``, differentiable."""
    return _AllReduceSum.apply(x, group) / dist.get_world_size(group)
