"""SECOND (torch counterpart of ``mssvt_tpu/models/detectors/second_net.py``;
ref: pcdet/models/detectors/second_net.py:4-55): MeanVFE ->
VoxelBackBone8x (the sparse-conv engine) -> the z-major BEV map of its
output -> BaseBEVBackbone -> AnchorHeadSingle.

As in the JAX module, ``MAP_TO_BEV`` is not built: the BEV map is the
backbone output's ``SparseVoxels.bev()`` and the 2D backbone takes the
width that map has (output depth x OUT_CHANNELS), not the config's
``NUM_BEV_FEATURES``. The JAX backbone's grid is ``grid_size`` as given,
where the reference's is one cell deeper in z, so at KITTI's grid the
map has 128 channels where ``second.yaml`` says 256; ``BACKBONE_3D``'s
``PCDET_SPARSE_SHAPE: True`` builds the sites on the reference's grid
(2 x 128 = 256 channels, z-major).

Inputs as ``CenterPoint``'s (padded to static capacities, on the model's
device); in eval mode it returns detections, in train mode the loss of
the batch's ``gt_boxes``.
"""

from __future__ import annotations

from .detector3d_template import Detector3DTemplate


class SECONDNet(Detector3DTemplate):
    def forward(self, batch, return_intermediates: bool = False,
                generator=None):
        """Eval: ``final_*`` detections; train: ``loss`` and ``tb_dict``.
        With ``return_intermediates`` also the backbone voxels and the BEV
        maps."""
        return self.one_stage(batch, self.first_stage(batch, generator),
                              return_intermediates)
