"""Reference (pcdet) checkpoint importer: a pcdet ``model_state`` becomes the
port's state dict (torch counterpart of ``mssvt_tpu/runtime/torch_import.py``,
whose key names and layout rules this module keeps its own copy of).

The reference saves ``{epoch, it, model_state, version}`` (ref:
tools/train_utils/train_utils.py:146-180) with the module names of
``Detector3DTemplate`` (``backbone_3d.backbone.<i>``, ``map_to_bev_module``,
``backbone_2d.blocks``/``deblocks``, ``dense_head.heads_list``, ...). The
port's modules carry the flax path names, so each port tensor is found by
its flax path: :func:`flax_to_torch_key` names the pcdet key and the pcdet
-> flax layout transform, and ``bridge.from_flax_layout`` takes the flax
layout to the port's. The two steps give what the JAX importer followed by
``bridge.load_flax_variables`` gives.

Shape-tolerant like the reference loader (ref: detector3d_template.py:
330-359): unmatched or shape-mismatched tensors keep their current value
and are reported. One layout divergence is handled here: the port's BEV is
z-major like the JAX package's ((B, H, W, D*C), ``core/sparse.py``) where
the reference's is channel-major, so the first convolution reading the BEV
gets its input channels permuted (:func:`bev_channel_perm`).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..bridge import from_flax_layout
from ..models.backbones_3d.spconv_backbone import out_spatial_shape_8x
from ..models.model_utils.layers import (
    BatchNorm,
    Conv2d,
    ConvTranspose2d,
    Dense,
    LayerNorm,
)


def _t_linear(w):
    return np.ascontiguousarray(w.T)


def _t_conv2d(w):
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


def _t_conv1d_k1(w):
    return np.ascontiguousarray(w[:, :, 0].T)


def _t_deconv2d(w):
    return np.ascontiguousarray(w.transpose(2, 3, 0, 1)[::-1, ::-1])


def bev_channel_perm(num_bev: int, depth: int) -> np.ndarray:
    """perm[j] = pcdet input channel feeding the port's channel j (port
    channel j = z * C + c, z-major; pcdet channel c * D + z)."""
    c_dim = num_bev // depth
    j = np.arange(num_bev)
    return (j % c_dim) * depth + j // c_dim


def _bn_leaf(leaf: str, collection: str) -> str:
    if collection == "batch_stats":
        return {"mean": "running_mean", "var": "running_var"}[leaf]
    return {"scale": "weight", "bias": "bias"}[leaf]


def _map_backbone_3d(parts: List[str]) -> Tuple[str, Any]:
    m = re.match(r"blocks_(\d+)$", parts[0])
    if not m:
        return None, None  # input_proj has no pcdet counterpart
    base = f"backbone_3d.backbone.{m.group(1)}"
    rest, leaf = parts[1:], parts[-1]
    wb = "weight" if leaf == "kernel" else "bias"
    if rest[0] == "ms_attn":
        g = re.match(r"(to_q|to_kv|proj)_(\d+)$", rest[1])
        name = {"to_q": "to_qs", "to_kv": "to_kvs", "proj": "projs"}[g.group(1)]
        return (f"{base}.ms_attn.{name}.{g.group(2)}.{wb}",
                _t_linear if leaf == "kernel" else None)
    if rest[0] in ("norm1", "norm2"):
        return f"{base}.{rest[0]}." + ("weight" if leaf == "scale" else "bias"), None
    if rest[0] in ("linear1", "linear2", "out_linear"):
        return f"{base}.{rest[0]}.{wb}", _t_linear if leaf == "kernel" else None
    if rest[0] == "pos_proj":
        idx = {"proj0": 0, "proj1": 2}[rest[1]]  # Sequential: Conv1d, ReLU, ...
        return (f"{base}.pos_proj.{idx}.{wb}",
                _t_conv1d_k1 if leaf == "kernel" else None)
    return None, None


def _map_backbone_2d(parts: List[str], collection: str) -> Tuple[str, Any]:
    leaf = parts[-1]
    m = re.match(r"block(\d+)_(conv|bn)(\d+)$", parts[0])
    if m:
        i, k = int(m.group(1)), int(m.group(3))
        # Sequential: [ZeroPad, Conv, BN, ReLU] + [Conv, BN, ReLU] * n
        idx = 1 if k == 0 else 1 + 3 * k
        if m.group(2) == "conv":
            return f"backbone_2d.blocks.{i}.{idx}.weight", _t_conv2d
        return (f"backbone_2d.blocks.{i}.{idx + 1}."
                + _bn_leaf(leaf, collection), None)
    m = re.match(r"deblock(?:(\d+)|_extra)_(conv|bn)$", parts[0])
    if m:
        # the extra deblock is the last entry of pcdet's ModuleList
        i = m.group(1) if m.group(1) is not None else "LAST"
        if m.group(2) == "conv":
            return f"backbone_2d.deblocks.{i}.0.weight", _t_deconv2d
        return f"backbone_2d.deblocks.{i}.1." + _bn_leaf(leaf, collection), None
    return None, None


def _map_map_to_bev(parts: List[str], collection: str) -> Tuple[str, Any]:
    m = re.match(r"compress_(conv|bn)_(\d+)$", parts[0])
    if not m:
        return None, None
    i = 3 * int(m.group(2))  # ModuleList flat: [Conv, BN, ReLU] * n
    if m.group(1) == "conv":
        return f"map_to_bev_module.compress_layers.{i}.weight", _t_conv2d
    return (f"map_to_bev_module.compress_layers.{i + 1}."
            + _bn_leaf(parts[-1], collection), None)


def _map_dense_head(parts: List[str], collection: str) -> Tuple[str, Any]:
    leaf = parts[-1]
    if parts[0] == "shared_conv":
        return "dense_head.shared_conv.0.weight", _t_conv2d
    if parts[0] == "shared_bn":
        return "dense_head.shared_conv.1." + _bn_leaf(leaf, collection), None
    m = re.match(r"head_(\d+)$", parts[0])
    if m and len(parts) >= 3:
        h, sub = m.group(1), parts[1]
        g = re.match(r"(.+)_(conv|bn)(\d+)$", sub)
        if g:
            name, kind, k = g.group(1), g.group(2), int(g.group(3))
            if kind == "conv":
                return (f"dense_head.heads_list.{h}.{name}.{k}.0.weight",
                        _t_conv2d)
            return (f"dense_head.heads_list.{h}.{name}.{k}.1."
                    + _bn_leaf(leaf, collection), None)
        g = re.match(r"(.+)_out$", sub)
        if g:
            return (f"dense_head.heads_list.{h}.{g.group(1)}.LAST."
                    + ("weight" if leaf == "kernel" else "bias"),
                    _t_conv2d if leaf == "kernel" else None)
    return None, None


def flax_to_torch_key(path: Tuple[str, ...]) -> Tuple[str, Any]:
    """(collection, module, ..., leaf) flax path -> (pcdet key, pcdet ->
    flax layout transform or None); (None, None) when pcdet has no such
    tensor. A key may hold the placeholder ``LAST`` for a trailing
    Sequential/ModuleList index, resolved against the state dict."""
    collection, top, parts = path[0], path[1], list(path[2:])
    if top == "backbone_3d":
        return _map_backbone_3d(parts)
    if top == "backbone_2d":
        return _map_backbone_2d(parts, collection)
    if top == "map_to_bev":
        return _map_map_to_bev(parts, collection)
    if top == "dense_head":
        return _map_dense_head(parts, collection)
    return None, None


def _resolve_last(key: str, state) -> str:
    if "LAST" not in key:
        return key
    prefix, suffix = key.split(".LAST.", 1)
    pat = re.compile(re.escape(prefix) + r"\.(\d+)\.")
    found = [int(m.group(1)) for k in state if (m := pat.match(k))]
    return f"{prefix}.{max(found)}.{suffix}" if found else key


def port_leaves(model):
    """(port state-dict key, module, flax path) of every parameter and
    BatchNorm statistic of ``model``."""
    for name, mod in model.named_modules():
        parts = tuple(name.split("."))
        if isinstance(mod, (Dense, Conv2d, ConvTranspose2d)):
            leaves = [("weight", "params", "kernel"), ("bias", "params", "bias")]
            if mod.bias is None:
                leaves = leaves[:1]
        elif isinstance(mod, LayerNorm):
            leaves = [("weight", "params", "scale"), ("bias", "params", "bias")]
        elif isinstance(mod, BatchNorm):
            leaves = [("scale", "params", "scale"), ("bias", "params", "bias"),
                      ("mean", "batch_stats", "mean"),
                      ("var", "batch_stats", "var")]
        else:
            continue
        for attr, collection, leaf in leaves:
            yield f"{name}.{attr}", mod, (collection, *parts, leaf)


def convert_state_dict(state: Dict[str, Any], model, bev_depth: int = 0):
    """Map a pcdet ``model_state`` (key -> tensor or array) onto ``model``.

    Returns ``(new_state, report)``: ``new_state`` is a copy of
    ``model.state_dict()`` with every matched tensor replaced, and
    ``report`` lists port keys ``loaded``, ``missing`` (no pcdet source)
    and ``shape_mismatch``, and pcdet keys ``unused``. With ``bev_depth >
    0`` the first BEV convolution's input channels are permuted from
    pcdet's channel-major to the port's z-major order."""
    state = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
             else np.asarray(v) for k, v in state.items()}
    current = model.state_dict()
    first_bev = (("map_to_bev", "compress_conv_0")
                 if "map_to_bev.compress_conv_0.weight" in current
                 else ("backbone_2d", "block0_conv0"))
    report = {"loaded": [], "missing": [], "shape_mismatch": [], "unused": []}
    out, used = dict(current), set()
    for key, mod, path in port_leaves(model):
        src, tf = flax_to_torch_key(path)
        if src is None or _resolve_last(src, state) not in state:
            report["missing"].append(key)
            continue
        src = _resolve_last(src, state)
        val = state[src]
        if tf is not None:
            val = tf(val)
        if bev_depth > 0 and path[-1] == "kernel" and path[1:3] == first_bev:
            val = val[:, :, bev_channel_perm(val.shape[2], bev_depth), :]
        val = from_flax_layout(mod, path[-1], val)
        if tuple(val.shape) != tuple(current[key].shape):
            report["shape_mismatch"].append(
                f"{key}: port {tuple(current[key].shape)} pcdet "
                f"{tuple(val.shape)} ({src})")
            continue
        # a fresh copy: a flipped 1x1 kernel is a view with negative strides
        out[key] = torch.from_numpy(np.array(val, order="C")).to(
            current[key].dtype)
        report["loaded"].append(key)
        used.add(src)
    report["unused"] = sorted(k for k in state if k not in used
                              and "num_batches_tracked" not in k)
    return out, report


def bev_depth_of(model_cfg, grid_z: int) -> int:
    """z-depth of the backbone's last sparse tensor: for MsSVT each
    compress block divides the grid's z by its window's; for the sparse-conv
    backbones (no ``PARAMS``) it is their output grid's z (at KITTI's 40
    cells 1, or 2 with ``PCDET_SPARSE_SHAPE``)."""
    b3d = model_cfg["BACKBONE_3D"]
    if "PARAMS" not in b3d:
        return out_spatial_shape_8x(
            (1, 1, grid_z), bool(b3d.get("PCDET_SPARSE_SHAPE", False)))[2]
    depth = int(grid_z)
    for p in b3d["PARAMS"]:
        if p["name"].endswith("CompressBlock"):
            depth //= int(p["window_size"][0][2])
    return depth
