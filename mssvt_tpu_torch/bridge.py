"""Carry a JAX model's variables into the port, and the port's back.

``load_flax_variables(model, tree)`` takes the flax variables as a nested
dict of numpy arrays (``{"params": ..., "batch_stats": ...}``) and fills
the port's modules, whose submodules carry the flax path names, so the walk
is mechanical. Layout rules:

- Dense kernel (in, out) -> ``Linear.weight`` (out, in);
- Conv kernel HWIO -> OIHW, and a 3D one (``Conv3d``, the PartA2 head's)
  DHWIO -> OIDHW;
- ConvTranspose kernel (kh, kw, in, out) -> (in, out, kh, kw), flipped
  spatially (flax's transposed convolution does not flip its kernel,
  PyTorch's does);
- LayerNorm / BatchNorm ``scale``/``bias`` -> ``weight``/``bias`` or
  ``scale``/``bias``; BatchNorm ``mean``/``var`` from ``batch_stats``
  (``MaskedBatchNorm`` and the VFEs' channels-last BatchNorm alike);
- sparse-conv kernel (K, Cin, Cout) -> ``weight`` as it is (a node of the
  sparse-conv layers holds its ``kernel`` beside its ``bn`` subtree);
- a bare parameter of a flax module (UNetV2's ``up{lvl}_inv_kernel``,
  (K, Cin, Cout); the CT3D transformer's ``q_w`` ... ``out_w`` (in, out),
  ``proj_*_w`` (out, in), ``down_w`` and ``query_embed``) -> the port
  module's parameter of the same name, as it is.

The RoI heads' submodules carry their flax names too
(``{stage}_sa_{i}/mlp/mlp_j``, ``shared_fc_i``, ``conv3d_i``, ...), and so
do the point-based family's: the PFE's ``raw_mlp_{i}``, ``{src}_mlp_{i}``,
``{src}_vp_fc_{i}`` / ``{src}_vp_bn_{i}``, ``vsa_point_fc`` and ``vsa_bn``;
the PV-RCNN head's ``pool_mlp_{i}``, ``shared_fc_{i}`` / ``shared_bn_{i}``,
``cls_out`` and ``reg_out``; the point heads' ``cls_fc_{i}`` /
``cls_bn_{i}`` and ``reg_fc_{i}`` / ``reg_bn_{i}``; PointNet2MSG's
``sa_{i}/mlp_g{j}`` and ``fp_{i}/mlp``; PointRCNN's RoI head ``up_{i}``.

MixedScaleAttention's per-group ``to_q_i``/``to_kv_i``/``proj_i`` are
stored as they are (the block-diagonal folding happens at call time), and
``input_proj`` is carried like any Dense.

``to_flax_tree(model, collection, grads)`` is the other direction: the
port's parameters (or their ``.grad``) or BatchNorm statistics as a nested
flax-path tree of numpy arrays, with the inverse layout rules, so that a
test can compare gradients and updated statistics leaf by leaf.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from .models.backbones_3d.spconv_backbone import SparseConvKernel
from .models.model_utils.layers import (
    BatchNorm,
    Conv2d,
    Conv3d,
    ConvTranspose2d,
    Dense,
    LayerNorm,
)

_LEAF_MODULES = (Dense, Conv2d, Conv3d, ConvTranspose2d, SparseConvKernel,
                 LayerNorm, BatchNorm)


def _tensor(a, like: torch.Tensor, name: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, np.float32, order="C"))
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"{name}: flax shape {tuple(t.shape)} does not fit "
                         f"{tuple(like.shape)}")
    return t.to(device=like.device, dtype=like.dtype)


def from_flax_layout(mod: nn.Module, key: str, val) -> np.ndarray:
    """A flax leaf ``key`` of ``mod`` in the port's layout (the rules of
    the module note)."""
    val = np.asarray(val)
    if key != "kernel":
        return val
    if isinstance(mod, ConvTranspose2d):
        return val[::-1, ::-1].transpose(2, 3, 0, 1)
    if isinstance(mod, Conv3d):
        return val.transpose(4, 3, 0, 1, 2)
    if val.ndim == 4:
        return val.transpose(3, 2, 0, 1)
    if val.ndim == 2:
        return val.T
    return val


def _load_leaf(mod: nn.Module, leaf: Dict, path: str) -> int:
    n = 0
    with torch.no_grad():
        for key, val in leaf.items():
            val = from_flax_layout(mod, key, val)
            if key == "kernel":
                tgt = mod.weight
            elif key == "scale":
                tgt = mod.scale if isinstance(mod, BatchNorm) else mod.weight
            elif key in ("bias", "mean", "var"):
                tgt = getattr(mod, key)
            elif not isinstance(mod, _LEAF_MODULES) and isinstance(
                    getattr(mod, key, None), nn.Parameter):
                tgt = getattr(mod, key)
            else:
                raise KeyError(f"{path}/{key}: unknown flax leaf")
            if tgt is None:
                raise KeyError(f"{path}/{key}: module has no such parameter")
            tgt.copy_(_tensor(val, tgt, f"{path}/{key}"))
            n += 1
    return n


def _walk(mod: nn.Module, tree: Dict, path: str) -> int:
    """Load the leaves of ``tree`` onto ``mod`` (a node may hold leaves
    beside subtrees: a sparse-conv layer's ``kernel`` beside its ``bn``)
    and walk its subtrees into the submodules of the same names."""
    leaves = {k: v for k, v in tree.items() if not isinstance(v, dict)}
    n = _load_leaf(mod, leaves, path) if leaves else 0
    for key, val in tree.items():
        if not isinstance(val, dict):
            continue
        child = getattr(mod, key, None)
        if not isinstance(child, nn.Module):
            raise KeyError(f"{path}/{key}: no such submodule in the port")
        n += _walk(child, val, f"{path}/{key}")
    return n


def load_flax_variables(model: nn.Module, tree: Dict) -> int:
    """Fill ``model`` from flax variables; returns the number of arrays
    loaded. Raises on a path or shape the port does not have, and when a
    parameter or statistic of the port is left unset."""
    n = 0
    for collection in ("params", "batch_stats"):
        if collection in tree:
            n += _walk(model, tree[collection], collection)
    expected = (sum(1 for _ in model.parameters())
                + sum(1 for m in model.modules() if isinstance(m, BatchNorm)) * 2)
    if n != expected:
        raise ValueError(f"loaded {n} arrays, the port holds {expected}")
    return n


def to_flax_layout(mod: nn.Module, key: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().float().cpu().numpy()
    if key != "kernel":
        return a
    if isinstance(mod, ConvTranspose2d):
        return a.transpose(2, 3, 0, 1)[::-1, ::-1].copy()
    if isinstance(mod, Conv3d):
        return a.transpose(2, 3, 4, 1, 0).copy()
    if a.ndim == 4:
        return a.transpose(2, 3, 1, 0).copy()
    if a.ndim == 3:  # sparse-conv (K, Cin, Cout): the flax layout
        return a
    return a.T.copy()


def to_flax_tree(model: nn.Module, collection: str = "params",
                 grads: bool = False) -> Dict:
    """The port's ``params`` (their ``.grad`` with ``grads``; a parameter
    without one gives zeros) or ``batch_stats`` as a nested flax-path dict of
    numpy arrays."""
    tree: Dict = {}
    for name, mod in model.named_modules():
        if collection == "batch_stats":
            if not isinstance(mod, BatchNorm):
                continue
            leaves = {"mean": mod.mean, "var": mod.var}
        elif isinstance(mod, (Dense, Conv2d, Conv3d, ConvTranspose2d)):
            leaves = {"kernel": mod.weight, "bias": mod.bias}
        elif isinstance(mod, SparseConvKernel):
            leaves = {"kernel": mod.weight}
        elif isinstance(mod, (LayerNorm, BatchNorm)):
            leaves = {"scale": mod.weight if isinstance(mod, LayerNorm)
                      else mod.scale, "bias": mod.bias}
        else:  # a module's bare parameters (UNetV2's inverse kernels)
            leaves = dict(mod.named_parameters(recurse=False))
            if not leaves:
                continue
        node = tree
        for part in name.split(".") if name else ():
            node = node.setdefault(part, {})
        for key, t in leaves.items():
            if t is None:
                continue
            if grads:
                t = t.grad if t.grad is not None else torch.zeros_like(t)
            node[key] = to_flax_layout(mod, key, t)
    return tree
