import torch

from .centerpoint import CenterPoint
from .part_a2 import PartA2Net
from .pointpillar import PointPillar
from .second_net import SECONDNet
from .second_net_iou import SECONDNetIoU
from .voxel_rcnn import VoxelRCNN

__all__ = {"CenterPoint": CenterPoint, "PartA2": PartA2Net,
           "PointPillar": PointPillar, "SECOND": SECONDNet,
           "SECONDNet": SECONDNet, "SECONDNetIoU": SECONDNetIoU,
           "VoxelRCNN": VoxelRCNN}

_DTYPES = {
    "float32": torch.float32, "fp32": torch.float32,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
}


def build_detector(model_cfg, **kw):
    """Registry lookup of ``MODEL.NAME``; ``MODEL.DTYPE`` sets the compute
    dtype (parameters stay float32)."""
    name = model_cfg["NAME"]
    if name not in __all__:
        raise NotImplementedError(
            f"detector '{name}' is not ported to mssvt_tpu_torch yet "
            "(see ROADMAP.md)")
    dtype = _DTYPES[str(model_cfg.get("DTYPE", "float32")).lower()]
    return __all__[name](model_cfg=model_cfg, dtype=dtype, **kw)
