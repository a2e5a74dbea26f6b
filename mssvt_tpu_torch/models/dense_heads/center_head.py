"""CenterPoint detection head, inference (torch counterpart of
``mssvt_tpu/models/dense_heads/center_head.py``): shared conv, per-task
conv towers, heatmap decode and per-head NMS into fixed-size padded
outputs. NHWC at the public boundary."""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
from torch import nn

from ...ops.nms import circle_nms, nms_bev
from ...utils.device import device_constant
from ..model_utils.centernet import decode_bbox_from_heatmap
from ..model_utils.layers import BatchNorm, Conv2d


class SeparateHead(nn.Module):
    """Per-task conv towers: (num_conv - 1) x [conv3x3, BN, ReLU] + conv."""

    def __init__(self, head_dict, channels, use_bias=False,
                 dtype=torch.float32):
        super().__init__()
        self.head_dict = {k: dict(v) for k, v in dict(head_dict).items()}
        for name, spec in self.head_dict.items():
            for k in range(int(spec["num_conv"]) - 1):
                self.add_module(f"{name}_conv{k}", Conv2d(
                    channels, channels, 3, padding=1, bias=use_bias,
                    dtype=dtype))
                self.add_module(f"{name}_bn{k}", BatchNorm(channels, 1e-5,
                                                           dtype=dtype))
            self.add_module(f"{name}_out", Conv2d(
                channels, int(spec["out_channels"]), 3, padding=1, bias=True,
                dtype=dtype))

    def forward(self, x) -> Dict[str, torch.Tensor]:  # x: NCHW
        out = {}
        for name, spec in self.head_dict.items():
            h = x
            for k in range(int(spec["num_conv"]) - 1):
                h = getattr(self, f"{name}_conv{k}")(h)
                h = torch.relu(getattr(self, f"{name}_bn{k}")(h))
            h = getattr(self, f"{name}_out")(h)
            out[name] = h.permute(0, 2, 3, 1).float()  # NHWC
        return out


class CenterHead(nn.Module):
    def __init__(self, model_cfg: Any, input_channels: int, num_class: int,
                 class_names, grid_size, point_cloud_range, voxel_size,
                 dtype=torch.float32):
        super().__init__()
        cfg = model_cfg
        self.model_cfg = cfg
        self.class_names = tuple(class_names)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.compute_dtype = dtype
        self.class_names_each_head = [
            [x for x in names if x in self.class_names]
            for names in cfg["CLASS_NAMES_EACH_HEAD"]]
        self.class_id_mapping_each_head = [
            np.array([self.class_names.index(x) for x in names], np.int64)
            for names in self.class_names_each_head]
        self.feature_map_stride = int(
            cfg["TARGET_ASSIGNER_CONFIG"].get("FEATURE_MAP_STRIDE", 1))
        shared = int(cfg["SHARED_CONV_CHANNEL"])
        use_bias = bool(cfg.get("USE_BIAS_BEFORE_NORM", False))
        self.shared_conv = Conv2d(input_channels, shared, 3, padding=1,
                                  bias=use_bias, dtype=dtype)
        self.shared_bn = BatchNorm(shared, 1e-5, dtype=dtype)
        self.num_heads = len(self.class_names_each_head)
        for i, names in enumerate(self.class_names_each_head):
            head_dict = {k: dict(v) for k, v in
                         dict(cfg["SEPARATE_HEAD_CFG"]["HEAD_DICT"]).items()}
            head_dict["hm"] = dict(out_channels=len(names),
                                   num_conv=int(cfg["NUM_HM_CONV"]))
            self.add_module(f"head_{i}", SeparateHead(
                head_dict, shared, use_bias=use_bias, dtype=dtype))

    def forward(self, spatial_features_2d) -> List[Dict[str, torch.Tensor]]:
        x = spatial_features_2d.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = torch.relu(self.shared_bn(self.shared_conv(x)))
        return [getattr(self, f"head_{i}")(x) for i in range(self.num_heads)]

    def generate_predicted_boxes(self, pred_dicts):
        """Decode + per-head NMS -> (boxes (B, N, 7+), scores (B, N),
        labels (B, N) 1-based, mask (B, N)), N = heads x NMS_POST_MAXSIZE
        (per class when NMS_THRESH is a list)."""
        pp = self.model_cfg["POST_PROCESSING"]
        nms_cfg = pp["NMS_CONFIG"]
        head_order = list(self.model_cfg["SEPARATE_HEAD_CFG"]["HEAD_ORDER"])
        pre_max = int(nms_cfg["NMS_PRE_MAXSIZE"])
        post_max = int(nms_cfg["NMS_POST_MAXSIZE"])
        thresh_cfg = nms_cfg["NMS_THRESH"]
        nms_fn = (circle_nms if str(nms_cfg.get("NMS_TYPE", "nms_gpu"))
                  == "circle_nms" else nms_bev)
        outs = ([], [], [], [])
        for head_idx, pred in enumerate(pred_dicts):
            boxes, scores, labels, mask = decode_bbox_from_heatmap(
                heatmap=torch.sigmoid(pred["hm"]),
                rot_cos=pred["rot"][..., 0:1], rot_sin=pred["rot"][..., 1:2],
                center=pred["center"], center_z=pred["center_z"],
                dim=torch.exp(torch.clamp(pred["dim"], -8, 8)),
                vel=pred.get("vel") if "vel" in head_order else None,
                point_cloud_range=self.point_cloud_range,
                voxel_size=self.voxel_size,
                feature_map_stride=self.feature_map_stride,
                k=int(pp["MAX_OBJ_PER_SAMPLE"]),
                score_thresh=float(pp["SCORE_THRESH"]),
                post_center_limit_range=list(pp["POST_CENTER_LIMIT_RANGE"]))
            id_map = device_constant(self.class_id_mapping_each_head[head_idx],
                                     boxes.device)
            if isinstance(thresh_cfg, (list, tuple)) and len(thresh_cfg) > 1:
                for ci, cth in enumerate(thresh_cfg):
                    sel, _ = nms_fn(boxes, scores, mask & (labels == ci),
                                    float(cth), pre_max, post_max)
                    self._append(sel, boxes, scores, labels, id_map, outs)
            else:
                th = float(thresh_cfg[0] if isinstance(thresh_cfg, (list, tuple))
                           else thresh_cfg)
                sel, _ = nms_fn(boxes, scores, mask, th, pre_max, post_max)
                self._append(sel, boxes, scores, labels, id_map, outs)
        return tuple(torch.cat(o, dim=1) for o in outs)

    @staticmethod
    def _append(sel, boxes, scores, labels, id_map, outs):
        ok = sel >= 0
        safe = sel.clamp(min=0).long()
        bsel = torch.gather(boxes, 1, safe[..., None].expand(
            -1, -1, boxes.shape[-1]))
        ssel = torch.gather(scores, 1, safe)
        lsel = torch.gather(labels, 1, safe)
        gsel = (id_map[lsel.clamp(min=0).long()] + 1).to(torch.int32)
        outs[0].append(bsel * ok[..., None])
        outs[1].append(ssel * ok)
        outs[2].append(gsel * ok)
        outs[3].append(ok)
