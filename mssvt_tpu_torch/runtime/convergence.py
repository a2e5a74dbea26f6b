"""The convergence gate on the golden scene: the port's twin of the JAX
suite's ``tests/test_train_convergence.py``.

A fixed-seed tiny MsSVT CenterPoint is trained for 120 ``adam_onecycle``
steps on one synthetic scene; the loss must fall (the mean of the last 5
losses below half the mean of the first 5), every loss must be finite, and
the trained model must detect the scene's boxes (recall >= 0.5 of the GT
boxes by centre distance < 2 m at score > 0.1). Memorising one scene is the
point: it is the first check that would catch a silent decode or
target-assignment regression.

The config and the scene are copies of the repo's ``__graft_entry__.py``
``_model_cfg`` / ``_make_batch`` and its constants (the port imports
nothing of the JAX side), trimmed as the JAX test trims them: the first two
blocks (an MsSVT block and a compress block) and 128 BEV features.
:func:`train_golden` is the one loop: the CPU test runs it on the plain
versions, ``chip_smoke.py`` on the card's kernels (K1, K2, K3, K5).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.edict import EasyDict

GRID = (48, 48, 8)
VOXEL_SIZE = (0.4, 0.4, 0.5)
PC_RANGE = (0.0, -9.6, -2.0, 19.2, 9.6, 2.0)
MAX_PTS = 5
MAX_GT = 16
C = 64
CLASSES = ["Vehicle", "Pedestrian", "Cyclist"]
STEPS = 120
MAX_VOXELS = 256
SCENE_SEED = 3
OPTIMIZATION = {
    "OPTIMIZER": "adam_onecycle", "LR": 0.003, "WEIGHT_DECAY": 0.01,
    "MOMS": [0.95, 0.85], "PCT_START": 0.4, "DIV_FACTOR": 10,
    "GRAD_NORM_CLIP": 10.0,
}


def model_cfg():
    """The tiny-but-representative MsSVT CenterPoint config (every
    mechanism active): ``__graft_entry__._model_cfg``."""
    return EasyDict({
        "NAME": "CenterPoint",
        "VFE": {"NAME": "MeanVFE"},
        "BACKBONE_3D": {
            "NAME": "MixedScaleSparseTransformer",
            "NUM_OUTPUT_FEATURES": C,
            "PARAMS": [
                {
                    "name": "MixedScaleSparseTransformerBlock",
                    "channels": [C, C * 2, C],
                    "num_heads": [2, 2],
                    "window_size": [[3, 3, 4], [9, 9, 4]],
                    "max_num_win1": 24, "max_num_win2": 48,
                    "max_num_wins": 256, "cbs_mode": "odd_even",
                    "cbs_pattern": 1, "key_num_sample": 16,
                    "use_feature_interpolation": True,
                },
                {
                    "name": "MixedScaleSparseTransformerCompressBlock",
                    "channels": [C, C * 2, C],
                    "num_heads": [2],
                    "window_size": [[2, 2, 4]],
                    "max_num_win1": 16, "max_num_wins": 128,
                },
                {
                    "name": "MixedScaleSparseTransformerBlock",
                    "channels": [C, C * 2, C],
                    "num_heads": [2, 2],
                    "window_size": [[3, 3, 2], [9, 9, 2]],
                    "max_num_win1": 18, "max_num_win2": 48,
                    "max_num_wins": 128, "cbs_mode": "odd_even",
                    "cbs_pattern": 0, "key_num_sample": 16,
                    "use_feature_interpolation": True,
                },
            ],
        },
        "MAP_TO_BEV": {
            "NAME": "HeightCompression",
            "NUM_BEV_FEATURES": C * 2,  # C * (8/4 z planes after one compress)
            "COMPRESS_LAYER_NUMS": 2,
            "LAYER_STRIDES": [1, 1],
            "LAYER_DIALATIONS": [1, 2],
            "LAYER_PADDINGS": [1, 2],
        },
        "BACKBONE_2D": {
            "NAME": "BaseBEVBackbone",
            "LAYER_NUMS": [2, 2],
            "LAYER_STRIDES": [1, 2],
            "NUM_FILTERS": [C, C * 2],
            "UPSAMPLE_STRIDES": [1, 2],
            "NUM_UPSAMPLE_FILTERS": [C, C],
        },
        "DENSE_HEAD": {
            "NAME": "CenterHead",
            "CLASS_NAMES_EACH_HEAD": [["Vehicle", "Pedestrian", "Cyclist"]],
            "SHARED_CONV_CHANNEL": 64,
            "USE_BIAS_BEFORE_NORM": False,
            "NUM_HM_CONV": 2,
            "SEPARATE_HEAD_CFG": {
                "HEAD_ORDER": ["center", "center_z", "dim", "rot"],
                "HEAD_DICT": {
                    "center": {"out_channels": 2, "num_conv": 2},
                    "center_z": {"out_channels": 1, "num_conv": 2},
                    "dim": {"out_channels": 3, "num_conv": 2},
                    "rot": {"out_channels": 2, "num_conv": 2},
                },
            },
            "TARGET_ASSIGNER_CONFIG": {
                "FEATURE_MAP_STRIDE": 2,
                "NUM_MAX_OBJS": MAX_GT,
                "GAUSSIAN_OVERLAP": 0.1,
                "MIN_RADIUS": 2,
                "MAX_RADIUS": 8,
            },
            "LOSS_CONFIG": {
                "LOSS_WEIGHTS": {
                    "cls_weight": 1.0, "loc_weight": 2.0,
                    "code_weights": [1.0] * 8,
                },
            },
            "POST_PROCESSING": {
                "SCORE_THRESH": 0.1,
                "POST_CENTER_LIMIT_RANGE": [-20, -20, -10, 40, 20, 10],
                "MAX_OBJ_PER_SAMPLE": 64,
                "NMS_CONFIG": {
                    "NMS_TYPE": "nms_gpu",
                    "NMS_THRESH": 0.7,
                    "NMS_PRE_MAXSIZE": 64,
                    "NMS_POST_MAXSIZE": 32,
                },
            },
        },
    })


def make_batch(batch_size, max_voxels, seed=0):
    """A seeded synthetic batch of ``max_voxels`` rows a frame (half of
    them random distinct cells) with 6 GT boxes a frame:
    ``__graft_entry__._make_batch``."""
    rng = np.random.default_rng(seed)
    n_per = max_voxels // 2
    coords_list = []
    for b in range(batch_size):
        c = np.unique(np.stack([
            np.full(n_per, b),
            rng.integers(0, GRID[2], n_per),
            rng.integers(0, GRID[1], n_per),
            rng.integers(0, GRID[0], n_per),
        ], 1), axis=0)
        coords_list.append(c)
    cap = batch_size * max_voxels
    pad = np.full((cap, 4), -1, np.int32)
    valid = np.zeros((cap,), bool)
    for b, c in enumerate(coords_list):
        n = min(len(c), max_voxels)
        pad[b * max_voxels: b * max_voxels + n] = c[:n]
        valid[b * max_voxels: b * max_voxels + n] = True
    voxels = (rng.normal(size=(cap, MAX_PTS, 5)).astype(np.float32)
              * valid[:, None, None])
    num_points = np.full((cap,), 3.0, np.float32) * valid

    gt = np.zeros((batch_size, MAX_GT, 8), np.float32)
    for b in range(batch_size):
        for k in range(6):
            gt[b, k] = [
                rng.uniform(2, 17), rng.uniform(-8, 8), rng.uniform(-1, 1),
                rng.uniform(1.5, 4), rng.uniform(1, 2), rng.uniform(1, 2),
                rng.uniform(-np.pi, np.pi), rng.integers(1, 4),
            ]
    return {
        "voxels": voxels,
        "voxel_num_points": num_points,
        "voxel_coords": pad,
        "voxel_valid": valid,
        "gt_boxes": gt,
    }


def golden_recall(out, gt_boxes):
    """(recall, detections): GT boxes (class > 0) of frame 0 with a
    detection of score > 0.1 whose centre lies within 2 m."""
    boxes = out["final_boxes"][0].detach().cpu().numpy()
    scores = out["final_scores"][0].detach().cpu().numpy()
    mask = out["final_mask"][0].detach().cpu().numpy()
    det = boxes[mask & (scores > 0.1)]
    gt = np.asarray(gt_boxes)[0]
    gt = gt[gt[:, 7] > 0]
    if len(gt) < 4:
        raise AssertionError(f"golden scene has {len(gt)} GT boxes, not >= 4")
    hits = sum(1 for g in gt if len(det) and np.min(
        np.linalg.norm(det[:, :2] - g[None, :2], axis=1)) < 2.0)
    return hits / len(gt), len(det), len(gt)


def train_golden(device, steps=STEPS, seed=0, on_step=None):
    """Trains the golden model on ``device`` for ``steps`` steps and
    evaluates it on its own scene. Returns ``{"losses", "recall",
    "detections", "gt"}``; raises at the first non-finite loss.
    ``on_step(i, loss)`` is called after each step."""
    from ..models import build_network
    from .optimization import build_optimizer
    from .train_utils import train_step

    cfg = model_cfg()
    cfg["BACKBONE_3D"]["PARAMS"] = cfg["BACKBONE_3D"]["PARAMS"][:2]
    cfg["MAP_TO_BEV"]["NUM_BEV_FEATURES"] = C * 2
    model = build_network(cfg, len(CLASSES), CLASSES, GRID, VOXEL_SIZE,
                          PC_RANGE, 1, MAX_VOXELS, MAX_PTS,
                          num_point_features=5, device=device, seed=seed)
    host = make_batch(1, MAX_VOXELS, seed=SCENE_SEED)
    batch = {k: torch.as_tensor(v).to(device) for k, v in host.items()}
    optimizer, _ = build_optimizer(EasyDict(OPTIMIZATION),
                                   model.named_parameters(),
                                   total_steps=steps, steps_per_epoch=steps)
    gen = torch.Generator(device=device).manual_seed(seed)
    losses = []
    for i in range(steps):
        loss = float(train_step(model, optimizer, batch, gen)[0])
        if not math.isfinite(loss):
            raise AssertionError(f"non-finite loss at step {i}: {loss}")
        losses.append(loss)
        if on_step is not None:
            on_step(i, loss)
    model.eval()
    with torch.no_grad():
        out = model(batch)
    recall, n_det, n_gt = golden_recall(out, host["gt_boxes"])
    return {"losses": losses, "recall": recall, "detections": n_det,
            "gt": n_gt}


def gate(result):
    """The JAX test's assertions: the tail of the loss curve well below its
    head, and recall >= 0.5 on the golden scene."""
    losses = result["losses"]
    head = float(np.mean(losses[:5]))
    tail = float(np.mean(losses[-5:]))
    if not tail < 0.5 * head:
        raise AssertionError(f"loss tail {tail} not below half its head "
                             f"{head} (every 20th: {losses[::20]})")
    if not result["recall"] >= 0.5:
        raise AssertionError(
            f"golden-scene recall {result['recall']:.2f} below floor "
            f"(dets={result['detections']}, gt={result['gt']}, losses "
            f"{losses[0]:.2f}->{losses[-1]:.2f})")
    return head, tail
