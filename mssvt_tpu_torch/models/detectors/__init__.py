import inspect

import torch

from .caddn import CaDDN
from .centerpoint import CenterPoint
from .ct3d_3cat import CT3D3CAT
from .part_a2 import PartA2Net
from .point_rcnn import PointRCNN
from .pointpillar import PointPillar
from .pv_rcnn import PVRCNN
from .second_net import SECONDNet
from .second_net_iou import SECONDNetIoU
from .voxel_rcnn import VoxelRCNN

# PVRCNNPlusPlus is PVRCNN with SPC keypoint sampling and the vector-pool
# source, both chosen by its PFE config (as the JAX registry maps it)
__all__ = {"CaDDN": CaDDN, "CenterPoint": CenterPoint,
           "CT3D_3CAT": CT3D3CAT, "PartA2": PartA2Net,
           "PointPillar": PointPillar, "PointRCNN": PointRCNN,
           "PVRCNN": PVRCNN, "PVRCNNPlusPlus": PVRCNN, "SECOND": SECONDNet,
           "SECONDNet": SECONDNet, "SECONDNetIoU": SECONDNetIoU,
           "VoxelRCNN": VoxelRCNN}

_DTYPES = {
    "float32": torch.float32, "fp32": torch.float32,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
}


def build_detector(model_cfg, **kw):
    """Registry lookup of ``MODEL.NAME``; ``MODEL.DTYPE`` sets the compute
    dtype (parameters stay float32); ``MODEL.MAX_POINTS`` is the raw-point
    rows a frame of the point-based detectors."""
    name = model_cfg["NAME"]
    if name not in __all__:
        raise NotImplementedError(
            f"unknown detector '{name}' (known: {', '.join(sorted(__all__))})")
    dtype = _DTYPES[str(model_cfg.get("DTYPE", "float32")).lower()]
    cls = __all__[name]
    if "max_points" in inspect.signature(cls).parameters and \
            "MAX_POINTS" in model_cfg:
        kw["max_points"] = int(model_cfg["MAX_POINTS"])
    return cls(model_cfg=model_cfg, dtype=dtype, **kw)
