"""CenterPoint detection head (torch counterpart of
``mssvt_tpu/models/dense_heads/center_head.py``): shared conv, per-task
conv towers; for training the on-device target assignment (gaussian
heatmaps, centre indices, regression targets) and the loss; for inference
the heatmap decode and per-head NMS into fixed-size padded outputs. NHWC at
the public boundary."""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
from torch import nn

from ...ops.nms import circle_nms, nms_bev
from ...utils.device import device_constant
from ..losses import focal_loss_centernet, reg_loss_centernet
from ..model_utils.centernet import (
    decode_bbox_from_heatmap,
    draw_gaussians,
    draw_gaussians_dense,
    gaussian_radius,
)
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
                self.add_module(f"{name}_bn{k}", BatchNorm(
                    channels, 1e-5, momentum=0.9, dtype=dtype))
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
        self.num_class = int(num_class)
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
        self.shared_bn = BatchNorm(shared, 1e-5, momentum=0.9,
                                   dtype=dtype)
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

    def assign_targets(self, gt_boxes, feature_map_size):
        """Targets for (B, M, C+1) padded GT boxes (last column the 1-based
        global class, 0 = padding) on an (H, W) head map. One dict per head:
        ``heatmaps`` (B, ncls, H, W), ``target_boxes`` (B, M, 8+extras),
        ``inds`` (B, M) int32 flat y*W+x, ``masks`` (B, M) bool."""
        tac = self.model_cfg["TARGET_ASSIGNER_CONFIG"]
        h, w = (int(v) for v in feature_map_size)
        b, m, code = gt_boxes.shape
        dev = gt_boxes.device
        overlap = float(tac.get("GAUSSIAN_OVERLAP", 0.1))
        min_radius = int(tac.get("MIN_RADIUS", 2))
        max_radius = int(tac.get("MAX_RADIUS", 24))
        x, y, z = gt_boxes[..., 0], gt_boxes[..., 1], gt_boxes[..., 2]
        heading = gt_boxes[..., 6]
        gcls = gt_boxes[..., -1].to(torch.int32)
        vx, vy = self.voxel_size[0], self.voxel_size[1]
        stride = self.feature_map_stride
        coord_x = torch.clamp((x - self.point_cloud_range[0]) / vx / stride,
                              0, w - 0.5)
        coord_y = torch.clamp((y - self.point_cloud_range[1]) / vy / stride,
                              0, h - 0.5)
        center = torch.stack([coord_x, coord_y], dim=-1)
        center_int = center.to(torch.int32)
        dxf = gt_boxes[..., 3] / vx / stride
        dyf = gt_boxes[..., 4] / vy / stride
        radius = torch.clamp(
            gaussian_radius(dxf, dyf, min_overlap=overlap).to(torch.int32),
            min=min_radius)
        ret = []
        for names in self.class_names_each_head:
            lut = np.full((self.num_class + 1,), -1, np.int32)
            for local, gname in enumerate(names):
                lut[self.class_names.index(gname) + 1] = local
            local_cls = device_constant(lut, dev)[
                torch.clamp(gcls, 0, self.num_class).long()]
            valid = ((local_cls >= 0) & (dxf > 0) & (dyf > 0)
                     & (center_int[..., 0] >= 0) & (center_int[..., 0] < w)
                     & (center_int[..., 1] >= 0) & (center_int[..., 1] < h))
            drawer = (draw_gaussians_dense if b * m * h * w <= 128 * 1024 * 1024
                      else draw_gaussians)
            heatmap = drawer((b, len(names), h, w), center, radius,
                             torch.clamp(local_cls, min=0), valid, max_radius)
            inds = torch.where(valid, center_int[..., 1] * w + center_int[..., 0],
                               0)
            safe_dims = torch.clamp(gt_boxes[..., 3:6], min=1e-6)
            tb = [center - center_int.float(), z[..., None],
                  torch.log(safe_dims), torch.cos(heading)[..., None],
                  torch.sin(heading)[..., None]]
            if code > 8:
                tb.append(gt_boxes[..., 7:-1])
            ret.append({
                "heatmaps": heatmap,
                "target_boxes": torch.cat(tb, dim=-1) * valid[..., None],
                "inds": inds.to(torch.int32),
                "masks": valid,
            })
        return ret

    def get_loss(self, pred_dicts, target_dicts):
        """(total loss, tb_dict) with ``hm_loss_head_i``,
        ``loc_loss_head_i`` and ``rpn_loss``, as the JAX head names them."""
        lw = self.model_cfg["LOSS_CONFIG"]["LOSS_WEIGHTS"]
        head_order = list(self.model_cfg["SEPARATE_HEAD_CFG"]["HEAD_ORDER"])
        loc_weight = float(lw["loc_weight"])
        total = 0.0
        tb = {}
        for i, (pred, tgt) in enumerate(zip(pred_dicts, target_dicts)):
            hm = torch.clamp(torch.sigmoid(pred["hm"]), 1e-4, 1 - 1e-4)
            hm_loss = focal_loss_centernet(hm.permute(0, 3, 1, 2),
                                           tgt["heatmaps"])
            pred_boxes = torch.cat([pred[k] for k in head_order], dim=-1)
            reg = reg_loss_centernet(pred_boxes, tgt["masks"], tgt["inds"],
                                     tgt["target_boxes"])
            code_weights = device_constant(
                np.asarray(lw["code_weights"], np.float32), reg.device)
            loc_loss = (reg * code_weights).sum() * loc_weight
            total = total + hm_loss + loc_loss
            tb[f"hm_loss_head_{i}"] = hm_loss
            tb[f"loc_loss_head_{i}"] = loc_loss
        tb["rpn_loss"] = total
        return total, tb

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
