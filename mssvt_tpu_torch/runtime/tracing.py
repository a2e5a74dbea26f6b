"""Stage spans on the profiler's clock.

``span(name)`` marks one stage of a request as the ``torch.profiler``
range ``mssvt.<name>``, so the stage lands in the same trace as the
kernels, copies and runtime calls it caused, on the same clock. Without
an active profiler it is a null context: one flag read, no
``record_function``. Stage spans open at stage boundaries only, never
inside a loop, a block or a kernel wrapper; the finer spans,
``mssvt.spconv_rules``, ``mssvt.nms``, ``mssvt.backbone_graph`` and
``mssvt.spconv_graph``, open once for each sparse-conv rulebook, once for
each NMS call and once for each replay of a backbone's CUDA graphs, never
inside a kernel wrapper; the two-stage families' ``mssvt.keypoints``, ``mssvt.pfe``
and ``mssvt.roi_head`` split ``mssvt.post`` once a request.

The spans of an eval request: ``mssvt.request`` around the forward, and
inside it, in order and without overlap, the six stages, opened by the
detectors' shell (``models/detectors/detector3d_template.py``) for every
voxel detector; the sparse-conv backbones add ``mssvt.spconv_rules``
inside ``mssvt.backbone_3d``, the NMS ``mssvt.nms`` inside ``mssvt.post``:

- ``mssvt.request``: ``eval_utils.eval_step``, the eval forward;
- ``mssvt.vfe``: ``generic_post.apply_vfe``, the voxel features;
- ``mssvt.backbone_3d``: ``Detector3DTemplate.first_stage``, the 3-D
  backbone;
- ``mssvt.spconv_rules``: ``backbones_3d/spconv_backbone.py``'s
  ``rules``, the sparse-conv engine's whole rulebook: every sorted-key
  index, output-site set and neighbour table of the forward (one a
  request, inside ``mssvt.backbone_3d``; on the card the replay of the
  rules' CUDA graph, inside ``mssvt.spconv_graph``);
- ``mssvt.backbone_graph``: ``runtime/graphs.py``'s ``ForwardGraph.run``
  for the MsSVT backbone, the input copies, replay and output clones of
  its CUDA graph (inside ``mssvt.backbone_3d``; its capture, once a key,
  is ``mssvt.backbone_graph_capture``, and a forward whose key failed to
  capture runs eagerly in ``mssvt.backbone_graph_eager``);
- ``mssvt.spconv_graph``: the same for the sparse-conv backbone
  (``VoxelBackBone8x``): the input copies, the rules' replay inside
  ``mssvt.spconv_rules``, the layers' replay and the output clones
  (``mssvt.spconv_graph_capture`` and ``mssvt.spconv_graph_eager`` as
  above);
- ``mssvt.map_to_bev``: ``Detector3DTemplate.bev_stages``, the BEV map;
- ``mssvt.backbone_2d``: the same, the 2-D backbone;
- ``mssvt.head``: ``generic_post.run_dense_head`` (one stage) or
  ``Detector3DTemplate.two_stage``, the dense head's maps;
- ``mssvt.post``: the same, decode, score threshold and NMS, or the
  proposals, the RoI head and the refinement;
- ``mssvt.nms``: ``ops/nms.py``'s ``nms_bev`` and ``circle_nms``, each
  greedy NMS call (candidates, suppression mask, scan; one a request for
  one head or the proposals, inside ``mssvt.post``);
- ``mssvt.keypoints``: ``detectors/pv_rcnn.py``'s ``roi_inputs``, the raw
  points by frame and the keypoint picks (PV-RCNN's FPS, or PV-RCNN++'s
  RoI mask and sector FPS), inside ``mssvt.post`` after the proposals;
- ``mssvt.pfe``: the same, the keypoints' features (the BEV map's bilinear
  sample, the raw points' ball-query pooling, the sparse source's pooling
  or vector pool), their fusion and the point head, after
  ``mssvt.keypoints``;
- ``mssvt.roi_head``: ``Detector3DTemplate.two_stage`` /
  ``roi_detections``, every two-stage family's RoI head (for PV-RCNN the
  RoI-grid pooling and the FCs) and, in eval, the refinement, last inside
  ``mssvt.post``.

PointPillar and CaDDN open ``mssvt.vfe``, ``mssvt.map_to_bev``,
``mssvt.backbone_2d``, ``mssvt.head`` and ``mssvt.post`` through the same
code.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

PREFIX = "mssvt."
_NULL = contextlib.nullcontext()


def span(name: str):
    """A context that records the range ``mssvt.<name>`` while a profiler
    (``torch.profiler.profile``, the autograd profiler, ``emit_nvtx``) is
    recording, and does nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return torch.profiler.record_function(PREFIX + name)
