"""The system under test: the port's model, built through its entry point
``mssvt_tpu_torch.models.build_network`` from a configuration file, its
eval request (``runtime/eval_utils.eval_step``), and the benchmark's
weights loaded into it. Only this module and the loops import the port."""

from __future__ import annotations

import torch


def easydict(d):
    from mssvt_tpu_torch.utils.edict import EasyDict

    return EasyDict(d)


def build(config, batch, device, weights):
    """The port's detector of ``config`` for ``batch`` frames on ``device``
    with ``weights`` (a state dict of the leaves the benchmark made; the
    program's other buffers, such as anchors, stay its own)."""
    from mssvt_tpu_torch.models import build_network

    data = config["data"]
    model = build_network(
        easydict(config["MODEL"]), len(config["class_names"]),
        config["class_names"], tuple(data["grid_size"]),
        tuple(data["voxel_size"]), tuple(data["point_cloud_range"]), batch,
        int(data["max_voxels_per_frame"]), int(data["max_points_per_voxel"]),
        num_point_features=int(data["num_point_features"]), device=device,
        seed=0)
    missing, unexpected = model.load_state_dict(weights, strict=False)
    own = {k for k, _ in model.named_parameters()}
    if unexpected or own & set(missing):
        raise RuntimeError(f"weights do not fit the program's model: "
                           f"unexpected {unexpected}, missing "
                           f"{sorted(own & set(missing))}")
    return model.eval()


def request(model, batch):
    """One request through the eval loop's own call: (boxes, scores,
    labels, mask) on the device."""
    from mssvt_tpu_torch.runtime.eval_utils import eval_step

    return eval_step(model, batch)


def resolve(model, dotted):
    """(owner, attribute) of ``dotted``, ``a.b.c`` on the model."""
    *path, attr = dotted.split(".")
    owner = model
    for p in path:
        owner = getattr(owner, p)
    return owner, attr


def to_device(batch, device):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
