"""Waymo TFRecord → per-frame .npy + per-sequence info pkl extraction (the
port's copy of ``mssvt_tpu/datasets/waymo_utils.py``).

Rebuild of ref pcdet/datasets/waymo/waymo_utils.py (209 LoC): reads one
``segment-*.tfrecord`` with the waymo-open-dataset package, writes
``<seq>/<frame:04d>.npy`` point files (x, y, z, intensity, elongation,
NLZ flag — the 6 columns WaymoDataset.get_lidar expects) and a
``<seq>/<seq>.pkl`` list of per-frame info dicts:

    {point_cloud: {lidar_sequence, sample_idx}, frame_id, metadata,
     annos: {name, difficulty, gt_boxes_lidar, num_points_in_gt, ...}}

The waymo-open-dataset + TF packages are imported only inside the
functions that read records (importing this module loads neither), and
every such function raises a clear ImportError when they are absent. The
pure logic (anno conversion, point stacking) is separated so it can be unit
tested with synthetic frame protos if they ever become available.

Provenance note: the range-image → point-cloud decoding is dictated by the
public waymo-open-dataset ``frame_utils``/``transform_utils`` API (the same
recipe as the package's own tutorial); any extractor, including the
reference's, necessarily issues the same call sequence. The artifact format
(6-column npy, info-pkl schema) is reproduced exactly because
WaymoDataset.get_lidar consumes it.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

WAYMO_CLASSES = ["unknown", "Vehicle", "Pedestrian", "Sign", "Cyclist"]


def _sdk():
    """(tf, dataset_pb2, frame_utils, transform_utils), imported at the
    first call (ref: waymo_utils.py:11-13 imports them at module import);
    ImportError when waymo-open-dataset or tensorflow is absent."""
    try:
        from waymo_open_dataset import dataset_pb2
        from waymo_open_dataset.utils import frame_utils, transform_utils
        import tensorflow as tf
    except ImportError as e:
        raise ImportError(
            "waymo-open-dataset (+ tensorflow) is required for TFRecord "
            "extraction; install it on a data-prep host — training/eval "
            "only need the extracted npy/pkl artifacts"
        ) from e
    return tf, dataset_pb2, frame_utils, transform_utils


def generate_labels(frame):
    """Frame labels → anno dict (ref: waymo_utils.py generate_labels)."""
    obj_name, difficulty, dimensions, locations, heading_angles = [], [], [], [], []
    tracking_difficulty, speeds, accelerations, obj_ids = [], [], [], []
    num_points_in_gt = []
    laser_labels = frame.laser_labels
    for label in laser_labels:
        box = label.box
        class_ind = label.type
        loc = [box.center_x, box.center_y, box.center_z]
        heading_angles.append(box.heading)
        obj_name.append(WAYMO_CLASSES[class_ind])
        difficulty.append(label.detection_difficulty_level)
        tracking_difficulty.append(label.tracking_difficulty_level)
        dimensions.append([box.length, box.width, box.height])
        locations.append(loc)
        obj_ids.append(label.id)
        num_points_in_gt.append(label.num_lidar_points_in_box)

    annotations = {
        "name": np.array(obj_name),
        "difficulty": np.array(difficulty),
        "dimensions": np.array(dimensions).reshape(-1, 3),
        "location": np.array(locations).reshape(-1, 3),
        "heading_angles": np.array(heading_angles),
        "obj_ids": np.array(obj_ids),
        "tracking_difficulty": np.array(tracking_difficulty),
        "num_points_in_gt": np.array(num_points_in_gt),
    }
    if len(obj_name) > 0:
        gt_boxes_lidar = np.concatenate([
            annotations["location"],
            annotations["dimensions"],
            annotations["heading_angles"][..., None],
        ], axis=1)
    else:
        gt_boxes_lidar = np.zeros((0, 7))
    annotations["gt_boxes_lidar"] = gt_boxes_lidar
    return annotations


def convert_range_image_to_point_cloud(frame, range_images, camera_projections,
                                       range_image_top_pose, ri_index=0):
    """Range images → stacked point features (ref: waymo_utils.py
    ``convert_range_image_to_point_cloud``): returns per-laser lists of
    (N, 3) xyz and (N, 3) [intensity, elongation, NLZ]."""
    tf, dataset_pb2, frame_utils, transform_utils = _sdk()
    calibrations = sorted(frame.context.laser_calibrations,
                          key=lambda c: c.name)
    points, cp_points, points_nlz, points_intensity, points_elongation = (
        [], [], [], [], [])

    frame_pose = tf.convert_to_tensor(
        np.reshape(np.array(frame.pose.transform), [4, 4]))
    range_image_top_pose_tensor = tf.reshape(
        tf.convert_to_tensor(range_image_top_pose.data),
        range_image_top_pose.shape.dims)
    range_image_top_pose_rotation = transform_utils.get_rotation_matrix(
        range_image_top_pose_tensor[..., 0],
        range_image_top_pose_tensor[..., 1],
        range_image_top_pose_tensor[..., 2])
    range_image_top_pose_translation = range_image_top_pose_tensor[..., 3:]
    range_image_top_pose_tensor = transform_utils.get_transform(
        range_image_top_pose_rotation, range_image_top_pose_translation)

    for c in calibrations:
        range_image = range_images[c.name][ri_index]
        if len(c.beam_inclinations) == 0:
            beam_inclinations = frame_utils.compute_inclination(
                tf.constant([c.beam_inclination_min, c.beam_inclination_max]),
                height=range_image.shape.dims[0])
        else:
            beam_inclinations = tf.constant(c.beam_inclinations)
        beam_inclinations = tf.reverse(beam_inclinations, axis=[-1])
        extrinsic = np.reshape(np.array(c.extrinsic.transform), [4, 4])

        range_image_tensor = tf.reshape(
            tf.convert_to_tensor(range_image.data), range_image.shape.dims)
        pixel_pose_local = None
        frame_pose_local = None
        if c.name == dataset_pb2.LaserName.TOP:
            pixel_pose_local = range_image_top_pose_tensor[tf.newaxis, ...]
            frame_pose_local = frame_pose[tf.newaxis, ...]
        range_image_mask = range_image_tensor[..., 0] > 0
        nlz_mask = range_image_tensor[..., 3]  # no-label-zone flag

        range_image_cartesian = (
            frame_utils.extract_point_cloud_from_range_image(
                tf.expand_dims(range_image_tensor[..., 0], axis=0),
                tf.expand_dims(extrinsic, axis=0),
                tf.expand_dims(tf.convert_to_tensor(beam_inclinations), axis=0),
                pixel_pose=pixel_pose_local,
                frame_pose=frame_pose_local))
        range_image_cartesian = tf.squeeze(range_image_cartesian, axis=0)
        points_tensor = tf.gather_nd(
            range_image_cartesian, tf.where(range_image_mask))
        points_nlz_tensor = tf.gather_nd(
            nlz_mask, tf.compat.v1.where(range_image_mask))
        points_intensity_tensor = tf.gather_nd(
            range_image_tensor[..., 1], tf.compat.v1.where(range_image_mask))
        points_elongation_tensor = tf.gather_nd(
            range_image_tensor[..., 2], tf.compat.v1.where(range_image_mask))

        points.append(points_tensor.numpy())
        points_nlz.append(points_nlz_tensor.numpy())
        points_intensity.append(points_intensity_tensor.numpy())
        points_elongation.append(points_elongation_tensor.numpy())
    return points, points_intensity, points_elongation, points_nlz


def save_lidar_points(frame, cur_save_path):
    """One frame → (N, 6) npy [x, y, z, intensity, elongation, NLZ]
    (ref: waymo_utils.py ``save_lidar_points``)."""
    _, _, frame_utils, _ = _sdk()
    (range_images, camera_projections, _,
     range_image_top_pose) = frame_utils.parse_range_image_and_camera_projection(frame)
    points, intensity, elongation, nlz = convert_range_image_to_point_cloud(
        frame, range_images, camera_projections, range_image_top_pose)
    points_all = np.concatenate(points, axis=0)
    feats = np.concatenate([
        points_all,
        np.concatenate(intensity)[..., None],
        np.concatenate(elongation)[..., None],
        np.concatenate(nlz)[..., None],
    ], axis=-1).astype(np.float32)
    np.save(cur_save_path, feats)
    return len(points_all)


def process_single_sequence(sequence_file, save_path, sampled_interval=1,
                            has_label=True):
    """One TFRecord → npy frames + info pkl (ref: waymo_utils.py
    ``process_single_sequence``, driven by waymo_dataset.py:137-157)."""
    tf, dataset_pb2, _, _ = _sdk()
    sequence_name = Path(sequence_file).stem
    cur_save_dir = Path(save_path) / sequence_name
    cur_save_dir.mkdir(parents=True, exist_ok=True)
    pkl_file = cur_save_dir / (sequence_name + ".pkl")
    if pkl_file.exists():
        with open(pkl_file, "rb") as f:
            return pickle.load(f)

    dataset = tf.data.TFRecordDataset(str(sequence_file), compression_type="")
    sequence_infos = []
    for cnt, data in enumerate(dataset):
        if cnt % sampled_interval != 0:
            continue
        frame = dataset_pb2.Frame()
        frame.ParseFromString(bytearray(data.numpy()))

        info = {
            "point_cloud": {
                "num_features": 5,
                "lidar_sequence": sequence_name,
                "sample_idx": cnt,
            },
            "frame_id": sequence_name + f"_{cnt:03d}",
            "metadata": {
                "context_name": frame.context.name,
                "timestamp_micros": frame.timestamp_micros,
            },
            "pose": np.array(frame.pose.transform).reshape(4, 4),
        }
        if has_label:
            info["annos"] = generate_labels(frame)
        info["num_points_of_each_lidar"] = save_lidar_points(
            frame, cur_save_dir / f"{cnt:04d}.npy")
        sequence_infos.append(info)

    with open(pkl_file, "wb") as f:
        pickle.dump(sequence_infos, f)
    return sequence_infos
