"""Inference demo of the PyTorch port (``mssvt_tpu_torch``) on a folder of
point clouds, beside ``tools/demo.py`` (ref: tools/demo.py:23-110).

Each ``.bin`` (float32 x, y, z, intensity) or ``.npy`` ((N, C) array) frame
of ``--data_path`` (a folder, or one file) is prepared by the config's
processors and voxelizer, runs through the model one frame a request, and
its detections are printed:

    python tools/demo_torch.py --cfg_file tools/cfgs/waymo_models/mssvt.yaml \\
        --data_path frames/ --ext .npy [--ckpt checkpoint_30.pt] \\
        [--out_file dets.pkl] [--vis_dir bev/] [--device cuda|cpu]

``--ckpt`` is a port checkpoint (``tools/train_torch.py`` or
``tools/import_ckpt_torch.py``); without one the weights are the seeded
random initialisation, as ``tools/demo.py`` without ``--ckpt_dir``.
``--out_file`` pickles the per-frame detections; ``--vis_dir`` writes a BEV
PNG a frame (matplotlib; the option raises when it is not installed).
``--device cuda`` (the default) raises without a card. ``main(argv)``
returns (detections, ms a frame): each frame's detections carry the ms of
its forward between two synchronisations (``ms``), and the second value is
their mean.
"""

from __future__ import annotations

import argparse
import glob
import pickle
import sys
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mssvt_tpu_torch.datasets.dataset import DatasetTemplate  # noqa: E402
from mssvt_tpu_torch.runtime.cli import build_model, load_run_config  # noqa: E402
from mssvt_tpu_torch.runtime.eval_utils import eval_step  # noqa: E402
from mssvt_tpu_torch.runtime.train_utils import (  # noqa: E402
    batch_to_device,
    synchronize,
)
from mssvt_tpu_torch.utils import visualize  # noqa: E402
from mssvt_tpu_torch.utils.common import create_logger  # noqa: E402
from mssvt_tpu_torch.utils.device import resolve_device  # noqa: E402


class DemoDataset(DatasetTemplate):
    """A folder of raw point files (ref: demo.py DemoDataset)."""

    def __init__(self, dataset_cfg, class_names, root_path, ext=".bin",
                 logger=None):
        super().__init__(dataset_cfg, class_names, training=False,
                         root_path=root_path, logger=logger)
        self.ext = ext
        p = Path(root_path)
        self.sample_file_list = (sorted(glob.glob(str(p / f"*{ext}")))
                                 if p.is_dir() else [str(p)])

    def __len__(self):
        return len(self.sample_file_list)

    def points(self, index):
        """The frame's points with the encoder's feature count (missing
        features zero)."""
        f = self.sample_file_list[index]
        if self.ext == ".bin":
            pts = np.fromfile(f, np.float32).reshape(-1, 4)
        elif self.ext == ".npy":
            pts = np.load(f)
        else:
            raise NotImplementedError(self.ext)
        n_feat = self.point_feature_encoder.num_point_features
        if pts.shape[1] < n_feat:
            pts = np.concatenate([pts, np.zeros((len(pts), n_feat - pts.shape[1]),
                                                np.float32)], axis=1)
        return pts[:, :n_feat]

    def __getitem__(self, index):
        return self.prepare_data({"points": self.points(index),
                                  "frame_id": index})


def main(argv=None):
    parser = argparse.ArgumentParser(description="mssvt_tpu_torch demo")
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--data_path", type=str, required=True)
    parser.add_argument("--ext", type=str, default=".bin")
    parser.add_argument("--ckpt", type=str, default=None,
                        help="port checkpoint file (checkpoint_<step>.pt)")
    parser.add_argument("--out_file", type=str, default=None)
    parser.add_argument("--vis_dir", type=str, default=None,
                        help="write a BEV PNG a frame (needs matplotlib)")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)
    if args.vis_dir:
        visualize.require_matplotlib()  # fail before any work
    cfg = load_run_config(args.cfg_file)
    device = resolve_device(args.device)
    logger = create_logger()

    dataset = DemoDataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, args.data_path,
                          ext=args.ext, logger=logger)
    logger.info(f"total frames: {len(dataset)}")
    model = build_model(cfg, dataset, 1, device)
    if args.ckpt:
        state = torch.load(args.ckpt, map_location=device, weights_only=False)
        model.load_state_dict(state["model"])
        logger.info(f"weights from {args.ckpt}")

    results = []
    for i in range(len(dataset)):
        batch = batch_to_device(dataset.collate_batch([dataset[i]]), device)
        synchronize(device)
        t0 = time.perf_counter()
        outs = eval_step(model, batch)
        synchronize(device)
        ms = (time.perf_counter() - t0) * 1e3
        boxes, scores, labels, mask = (o[0].cpu().numpy() for o in outs)
        det = {"frame_id": i, "boxes": boxes[mask], "scores": scores[mask],
               "labels": labels[mask], "ms": ms}
        results.append(det)
        logger.info(f"frame {i}: {int(mask.sum())} detections (top score "
                    f"{det['scores'].max() if len(det['scores']) else 0:.3f}"
                    f"), {ms:.2f} ms")
        if args.vis_dir:
            Path(args.vis_dir).mkdir(parents=True, exist_ok=True)
            visualize.draw_bev_scene(
                dataset.points(i), det_boxes=det["boxes"],
                det_scores=det["scores"], det_labels=det["labels"],
                class_names=cfg.CLASS_NAMES,
                point_range=dataset.point_cloud_range,
                out_file=str(Path(args.vis_dir) / f"frame_{i:04d}.png"),
                title=f"frame {i}")
    ms = sum(d["ms"] for d in results) / max(len(results), 1)
    logger.info(f"{ms:.2f} ms a frame on {device}")
    if args.out_file:
        with open(args.out_file, "wb") as f:
            pickle.dump(results, f)
        logger.info(f"wrote {args.out_file}")
    return results, ms


if __name__ == "__main__":
    main()
