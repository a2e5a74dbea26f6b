"""Carry a JAX model's variables into the port.

``load_flax_variables(model, tree)`` takes the flax variables as a nested
dict of numpy arrays (``{"params": ..., "batch_stats": ...}``) and fills
the port's modules, whose submodules carry the flax path names, so the walk
is mechanical. Layout rules:

- Dense kernel (in, out) -> ``Linear.weight`` (out, in);
- Conv kernel HWIO -> OIHW;
- ConvTranspose kernel (kh, kw, in, out) -> (in, out, kh, kw), flipped
  spatially (flax's transposed convolution does not flip its kernel,
  PyTorch's does);
- LayerNorm / BatchNorm ``scale``/``bias`` -> ``weight``/``bias`` or
  ``scale``/``bias``; BatchNorm ``mean``/``var`` from ``batch_stats``.

MixedScaleAttention's per-group ``to_q_i``/``to_kv_i``/``proj_i`` are
stored as they are (the block-diagonal folding happens at call time), and
``input_proj`` is carried like any Dense.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from .models.model_utils.layers import BatchNorm, ConvTranspose2d


def _tensor(a, like: torch.Tensor, name: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, np.float32, order="C"))
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"{name}: flax shape {tuple(t.shape)} does not fit "
                         f"{tuple(like.shape)}")
    return t.to(device=like.device, dtype=like.dtype)


def _load_leaf(mod: nn.Module, leaf: Dict, path: str) -> int:
    n = 0
    with torch.no_grad():
        for key, val in leaf.items():
            val = np.asarray(val)
            if key == "kernel":
                if isinstance(mod, ConvTranspose2d):
                    val = val[::-1, ::-1].transpose(2, 3, 0, 1)
                elif val.ndim == 4:
                    val = val.transpose(3, 2, 0, 1)
                elif val.ndim == 2:
                    val = val.T
                tgt = mod.weight
            elif key == "scale":
                tgt = mod.scale if isinstance(mod, BatchNorm) else mod.weight
            elif key in ("bias", "mean", "var"):
                tgt = getattr(mod, key)
            else:
                raise KeyError(f"{path}/{key}: unknown flax leaf")
            if tgt is None:
                raise KeyError(f"{path}/{key}: module has no such parameter")
            tgt.copy_(_tensor(val, tgt, f"{path}/{key}"))
            n += 1
    return n


def _walk(mod: nn.Module, tree: Dict, path: str) -> int:
    n = 0
    for key, val in tree.items():
        child = getattr(mod, key, None)
        if not isinstance(child, nn.Module):
            raise KeyError(f"{path}/{key}: no such submodule in the port")
        if all(not isinstance(v, dict) for v in val.values()):
            n += _load_leaf(child, val, f"{path}/{key}")
        else:
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
