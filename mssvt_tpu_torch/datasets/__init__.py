"""Datasets of the port (the counterpart of ``mssvt_tpu/datasets``).

``build_dataset`` looks a dataset up by its config name. The port has the
synthetic dataset; the file-backed ones of the JAX package (Waymo, KITTI,
Lyft, PandaSet) are queued in ROADMAP.md and raise here.
"""

from .dataset import DatasetTemplate
from .synthetic import SyntheticDataset

_DATASETS = {
    "SyntheticDataset": SyntheticDataset,
}
_NOT_PORTED = ("WaymoDataset", "KittiDataset", "PandasetDataset",
               "LyftDataset")



def build_dataset(dataset_cfg, class_names, training, root_path=None,
                  logger=None, seed=None):
    """Dataset construction by registry name (ref: datasets/__init__.py:45-74).

    ``seed`` seeds the dataset's ``numpy.random.RandomState`` (augmentation,
    point shuffling); None seeds it from the OS.
    """
    name = dataset_cfg["DATASET"]
    if name not in _DATASETS:
        if name in _NOT_PORTED:
            raise NotImplementedError(
                f"dataset '{name}' is not ported to mssvt_tpu_torch yet (the "
                "file-backed datasets are ROADMAP.md Queue 1 item 12); "
                "SyntheticDataset is")
        raise KeyError(f"unknown dataset '{name}'")
    return _DATASETS[name](
        dataset_cfg=dataset_cfg, class_names=class_names, training=training,
        root_path=root_path, logger=logger, seed=seed,
    )


__all__ = ["DatasetTemplate", "SyntheticDataset", "build_dataset"]
