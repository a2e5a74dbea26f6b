"""Waymo Open Dataset pipeline (ref: pcdet/datasets/waymo/waymo_dataset.py:21-474;
the port's copy of ``mssvt_tpu/datasets/waymo.py``).

Reads the same artifacts as the reference (per-sequence info pkls + per-frame
.npy point files produced by the TFRecord extraction step), applies the same
point post-processing (NLZ filter, tanh intensity, ref:159-167), and exposes
the same evaluation backends: the fast KITTI-style AP proxy (here our numpy
evaluator, utils/eval_ap.py) and the official waymo-open-dataset metrics when
that package is available (ref:268-319).

The TFRecord → npy extraction CLI (`create_waymo_infos`,
ref:403-474 + waymo_utils.py) requires the waymo-open-dataset + TF packages;
it is provided behind a lazy import. ``seed`` seeds the dataset's
``numpy.random.RandomState`` (augmentation, point shuffling), as for every
dataset of the port.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from .dataset import DatasetTemplate


class WaymoDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None, seed=None):
        super().__init__(dataset_cfg, class_names, training, root_path, logger,
                         seed)
        self.data_path = self.root_path / dataset_cfg.get(
            "PROCESSED_DATA_TAG", "waymo_processed_data"
        )
        self.split = dataset_cfg["DATA_SPLIT"][self.mode]
        split_file = self.root_path / "ImageSets" / (self.split + ".txt")
        self.sample_sequence_list = (
            [x.strip() for x in open(split_file).readlines()]
            if split_file.exists() else []
        )
        self.infos = []
        self.include_waymo_data(self.mode)
        # Two-tier point-cloud cache ≙ the reference's /dev/shm SharedArray
        # staging (ref: waymo_dataset.py:77-119): a per-process dict, backed
        # by /dev/shm .npy files SHARED across dataloader workers and ranks
        # (mmap'd loads ride the page cache — the same memory serves every
        # process, like the reference's sa.attach("shm://...")).
        self.use_shared_memory = bool(
            dataset_cfg.get("USE_SHARED_MEMORY", False))
        self.shared_memory_file_limit = int(
            dataset_cfg.get("SHARED_MEMORY_FILE_LIMIT", 0x7FFFFFFF))
        self._lidar_cache = {}
        shm_root = Path(dataset_cfg.get("SHARED_MEMORY_ROOT", "/dev/shm"))
        self._shm_dir = (shm_root / "mssvt_waymo_cache" / self.split
                         if self.use_shared_memory else None)
        if self._shm_dir is not None:
            try:
                self._shm_dir.mkdir(parents=True, exist_ok=True)
            except OSError:
                self._shm_dir = None  # no /dev/shm → per-process dict only

    def clean_shared_memory(self):
        """Remove this split's /dev/shm staging (ref: waymo_dataset.py
        117-119 cleans its SharedArrays after training)."""
        import shutil

        if self._shm_dir is not None and self._shm_dir.exists():
            shutil.rmtree(self._shm_dir, ignore_errors=True)

    def set_split(self, split):
        """Re-point the sequence list at another split (ref:
        waymo_dataset.py set_split)."""
        self.split = split
        split_file = self.root_path / "ImageSets" / (self.split + ".txt")
        self.sample_sequence_list = (
            [x.strip() for x in open(split_file).readlines()]
            if split_file.exists() else []
        )
        self.infos = []

    def include_waymo_data(self, mode):
        """Ref: waymo_dataset.py:50-75 (info pkl loading + interval subsample)."""
        if self.logger:
            self.logger.info("Loading Waymo dataset")
        waymo_infos = []
        num_skipped = 0
        for seq_name in self.sample_sequence_list:
            seq_name = Path(seq_name).stem
            info_path = self.data_path / seq_name / (seq_name + ".pkl")
            if not info_path.exists():
                num_skipped += 1
                continue
            with open(info_path, "rb") as f:
                waymo_infos.extend(pickle.load(f))

        interval = self.dataset_cfg.get("SAMPLED_INTERVAL", {}).get(self.mode, 1)
        self.infos = waymo_infos[::interval]
        if self.logger:
            self.logger.info(
                f"Total samples for Waymo ({self.split}): {len(self.infos)} "
                f"(skipped {num_skipped} sequences, interval {interval})"
            )

    def __len__(self):
        return len(self.infos)

    def get_lidar(self, sequence_name, sample_idx):
        """Ref: waymo_dataset.py:159-167 (npy load, NLZ filter, tanh intensity)."""
        key = (sequence_name, sample_idx)
        if self.use_shared_memory and key in self._lidar_cache:
            return self._lidar_cache[key].copy()
        shm_file = (self._shm_dir / f"{sequence_name}_{sample_idx:04d}.npy"
                    if self._shm_dir is not None else None)
        if shm_file is not None and shm_file.exists():
            # another worker/rank already staged the PROCESSED points; the
            # mmap shares pages with every attached process
            return np.array(np.load(shm_file, mmap_mode="r"))
        lidar_file = self.data_path / sequence_name / f"{sample_idx:04d}.npy"
        point_features = np.load(lidar_file)  # (N, 6): x, y, z, int, elong, nlz
        points_all, nlz_flag = point_features[:, 0:5], point_features[:, 5]
        points_all = points_all[nlz_flag == -1]
        points_all[:, 3] = np.tanh(points_all[:, 3])
        if (self.use_shared_memory
                and len(self._lidar_cache) < self.shared_memory_file_limit):
            self._lidar_cache[key] = points_all.copy()
            if shm_file is not None and not shm_file.exists():
                tmp = shm_file.with_suffix(".tmp.npy")
                try:  # atomic publish: writers race benignly
                    np.save(tmp, points_all)
                    tmp.rename(shm_file)
                except OSError:
                    tmp.unlink(missing_ok=True)
        return points_all

    def __getitem__(self, index):
        info = self.infos[index]
        pc_info = info["point_cloud"]
        sequence_name = pc_info["lidar_sequence"]
        sample_idx = pc_info["sample_idx"]
        points = self.get_lidar(sequence_name, sample_idx)

        input_dict = {
            "points": points,
            "frame_id": info["frame_id"],
        }
        if "annos" in info:
            annos = info["annos"]
            # drop unknown-class boxes (ref: drop_info_with_name 'unknown')
            keep = annos["name"] != "unknown"
            gt_boxes = annos["gt_boxes_lidar"][keep]
            gt_names = annos["name"][keep]
            if self.dataset_cfg.get("FILTER_EMPTY_BOXES_FOR_TRAIN", True) and self.training:
                n_pts = annos.get("num_points_in_gt")
                if n_pts is not None:
                    nz = n_pts[keep] > 0
                    gt_boxes, gt_names = gt_boxes[nz], gt_names[nz]
            input_dict.update({
                "gt_boxes": gt_boxes[:, :7].astype(np.float32),
                "gt_names": gt_names,
            })
        return self.prepare_data(input_dict)

    # ------------------------------ eval ------------------------------- #

    @staticmethod
    def generate_prediction_dicts(det_frames, class_names):
        """Per-frame eval outputs → Waymo anno dicts (ref: waymo_dataset.py
        :221-266 ``generate_prediction_dicts``)."""
        annos = []
        names = np.asarray(class_names)
        for d in det_frames:
            labels = np.asarray(d["labels"], np.int64)
            annos.append({
                "name": names[np.clip(labels - 1, 0, len(names) - 1)],
                "score": np.asarray(d["scores"], np.float32),
                "boxes_lidar": np.asarray(d["boxes"], np.float32)[:, :7],
            })
        return annos

    def evaluation(self, det_annos, class_names, **kwargs):
        """Dual backends (ref: waymo_dataset.py:268-319): 'kitti' = the fast
        AP proxy; 'waymo' = official-protocol AP/APH L1/L2 (waymo_eval.py —
        TF ops when waymo-open-dataset is importable, numpy otherwise)."""
        metric = self.dataset_cfg.get("EVAL_METRIC", kwargs.get("eval_metric", "kitti"))
        if metric == "waymo":
            return self._waymo_official_eval(det_annos, class_names)
        from ..utils.eval_ap import kitti_style_eval

        return kitti_style_eval(det_annos, kwargs["gt_annos"], class_names)

    def _waymo_official_eval(self, det_annos, class_names):
        """Official AP/APH L1/L2 protocol (ref: waymo_eval.py:86-146)."""
        from .waymo_eval import (
            OpenPCDetWaymoDetectionMetricsEstimator,
            format_waymo_results,
        )

        eval_gt_annos = [info["annos"] for info in self.infos[:len(det_annos)]]
        estimator = OpenPCDetWaymoDetectionMetricsEstimator()
        results = estimator.waymo_evaluation(
            det_annos, eval_gt_annos, class_name=class_names,
            distance_thresh=1000,
            fake_gt_infos=self.dataset_cfg.get("INFO_WITH_FAKELIDAR", False),
        )
        return format_waymo_results(results), results

    # ------------------------- data preparation ------------------------- #

    def create_groundtruth_database(self, info_path=None, used_classes=None,
                                    split="train", sampled_interval=10,
                                    processed_data_tag=None):
        """GT-object database for gt_sampling augmentation
        (ref: waymo_dataset.py:321-400): per-object point crops saved as .bin
        plus a dbinfos pkl. points_in_boxes runs in numpy on host.
        """
        from ..utils.geometry import points_in_boxes_numpy

        db_save_path = self.root_path / (
            f"pcdet_gt_database_{split}_sampled_{sampled_interval}")
        db_info_save_path = self.root_path / (
            f"pcdet_waymo_dbinfos_{split}_sampled_{sampled_interval}.pkl")
        db_save_path.mkdir(parents=True, exist_ok=True)
        all_db_infos = {}

        if info_path is None:
            infos = self.infos
        else:
            with open(info_path, "rb") as f:
                infos = pickle.load(f)

        for k in range(0, len(infos), sampled_interval):
            info = infos[k]
            pc_info = info["point_cloud"]
            sequence_name = pc_info["lidar_sequence"]
            sample_idx = pc_info["sample_idx"]
            points = self.get_lidar(sequence_name, sample_idx)
            annos = info["annos"]
            names = annos["name"]
            gt_boxes = annos["gt_boxes_lidar"]
            if len(gt_boxes) == 0:
                continue

            box_mask = points_in_boxes_numpy(points[:, :3], gt_boxes[:, :7])
            for i in range(len(gt_boxes)):
                if used_classes is not None and names[i] not in used_classes:
                    continue
                filename = f"{sequence_name}_{sample_idx:04d}_{names[i]}_{i}.bin"
                filepath = db_save_path / filename
                gt_points = points[box_mask[:, i]].copy()
                gt_points[:, :3] -= gt_boxes[i, :3]
                gt_points.astype(np.float32).tofile(filepath)

                db_info = {
                    "name": names[i],
                    "path": str(filepath.relative_to(self.root_path)),
                    "sequence_name": sequence_name,
                    "sample_idx": sample_idx,
                    "gt_idx": i,
                    "box3d_lidar": gt_boxes[i],
                    "num_points_in_gt": int(box_mask[:, i].sum()),
                    "difficulty": annos.get(
                        "difficulty", np.zeros(len(gt_boxes)))[i],
                }
                all_db_infos.setdefault(names[i], []).append(db_info)

        for key, val in all_db_infos.items():
            if self.logger:
                self.logger.info(f"Database {key}: {len(val)}")
        with open(db_info_save_path, "wb") as f:
            pickle.dump(all_db_infos, f)
        return db_info_save_path

    def get_infos(self, raw_data_path, save_path, num_workers=1,
                  sampled_interval=1):
        """TFRecord → per-frame npy + per-sequence info pkl
        (ref: waymo_dataset.py:137-157 + waymo_utils.py:11-13). Requires the
        optional waymo-open-dataset package; sequential (the reference fans
        out with multiprocessing.Pool)."""
        from . import waymo_utils

        infos = []
        for seq_file in self.sample_sequence_list:
            infos.extend(waymo_utils.process_single_sequence(
                sequence_file=str(Path(raw_data_path) / seq_file),
                save_path=Path(save_path),
                sampled_interval=sampled_interval,
            ))
        return infos


def create_waymo_infos(dataset_cfg, class_names, data_path, save_path,
                       raw_data_tag="raw_data",
                       processed_data_tag="waymo_processed_data",
                       logger=None):
    """Full data-prep pipeline (ref: waymo_dataset.py:403-474): TFRecord
    extraction for train+val splits, aggregated info pkls, GT database.

    CLI: python -m mssvt_tpu_torch.datasets.waymo --cfg_file <dataset yaml>
    """
    dataset = WaymoDataset(
        dataset_cfg=dataset_cfg, class_names=class_names, training=False,
        root_path=Path(data_path), logger=logger,
    )
    train_split, val_split = "train", "val"
    train_filename = Path(save_path) / f"waymo_infos_{train_split}.pkl"
    val_filename = Path(save_path) / f"waymo_infos_{val_split}.pkl"

    print("---------------Start to generate data infos---------------")
    dataset.set_split(train_split)
    waymo_infos_train = dataset.get_infos(
        raw_data_path=Path(data_path) / raw_data_tag,
        save_path=Path(save_path) / processed_data_tag,
        sampled_interval=1,
    )
    with open(train_filename, "wb") as f:
        pickle.dump(waymo_infos_train, f)
    print(f"Waymo info train file is saved to {train_filename}")

    dataset.set_split(val_split)
    waymo_infos_val = dataset.get_infos(
        raw_data_path=Path(data_path) / raw_data_tag,
        save_path=Path(save_path) / processed_data_tag,
        sampled_interval=1,
    )
    with open(val_filename, "wb") as f:
        pickle.dump(waymo_infos_val, f)
    print(f"Waymo info val file is saved to {val_filename}")

    print("---------------Start create groundtruth database---------------")
    dataset.set_split(train_split)
    dataset.include_waymo_data("train")
    dataset.create_groundtruth_database(
        info_path=train_filename, split=train_split, sampled_interval=10,
        used_classes=list(class_names),
    )
    print("---------------Data preparation Done---------------")


if __name__ == "__main__":
    import argparse

    import yaml

    from ..utils.edict import EasyDict

    parser = argparse.ArgumentParser(description="Waymo data preparation")
    parser.add_argument("--cfg_file", type=str, required=True,
                        help="dataset config yaml")
    parser.add_argument("--func", type=str, default="create_waymo_infos")
    parser.add_argument("--data_path", type=str, default=None)
    args = parser.parse_args()
    assert args.func == "create_waymo_infos", args.func
    cfg = EasyDict(yaml.safe_load(open(args.cfg_file)))
    data_path = args.data_path or cfg.DATA_PATH
    create_waymo_infos(
        dataset_cfg=cfg,
        class_names=["Vehicle", "Pedestrian", "Cyclist"],
        data_path=data_path,
        save_path=data_path,
        processed_data_tag=cfg.get("PROCESSED_DATA_TAG",
                                   "waymo_processed_data"),
    )
