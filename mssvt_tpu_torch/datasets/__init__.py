"""Datasets of the port (the counterpart of ``mssvt_tpu/datasets``).

``build_dataset`` looks a dataset up by its config name: the synthetic
dataset, and the file-backed ones (Waymo, KITTI, Lyft, PandaSet), which are
imported at their first build to keep import costs down.
"""

from .dataset import DatasetTemplate
from .synthetic import SyntheticDataset

_DATASETS = {
    "SyntheticDataset": SyntheticDataset,
}


def register_dataset(name, cls):
    _DATASETS[name] = cls


def build_dataset(dataset_cfg, class_names, training, root_path=None,
                  logger=None, seed=None):
    """Dataset construction by registry name (ref: datasets/__init__.py:45-74).

    ``seed`` seeds the dataset's ``numpy.random.RandomState`` (augmentation,
    point shuffling); None seeds it from the OS. An unknown name raises
    KeyError.
    """
    name = dataset_cfg["DATASET"]
    if name not in _DATASETS:
        if name == "WaymoDataset":
            from .waymo import WaymoDataset

            register_dataset("WaymoDataset", WaymoDataset)
        elif name == "KittiDataset":
            from .kitti import KittiDataset

            register_dataset("KittiDataset", KittiDataset)
        elif name == "PandasetDataset":
            from .pandaset import PandasetDataset

            register_dataset("PandasetDataset", PandasetDataset)
        elif name == "LyftDataset":
            from .lyft import LyftDataset

            register_dataset("LyftDataset", LyftDataset)
    if name not in _DATASETS:
        raise KeyError(f"unknown dataset '{name}'")
    return _DATASETS[name](
        dataset_cfg=dataset_cfg, class_names=class_names, training=training,
        root_path=root_path, logger=logger, seed=seed,
    )


__all__ = ["DatasetTemplate", "SyntheticDataset", "build_dataset",
           "register_dataset"]
