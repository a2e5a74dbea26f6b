"""YAML config loader with ``_BASE_CONFIG_`` inheritance.

The port's own copy of the loader in ``mssvt_tpu/config.py`` (same
semantics): a recursive merge of the YAML tree into an :class:`EasyDict`,
where a section that names ``_BASE_CONFIG_`` first takes the whole base file
(path relative to the working directory, as the configs are written for the
repo root).
"""

from __future__ import annotations

import yaml

from .utils.edict import EasyDict


def merge_new_config(config, new_config):
    if "_BASE_CONFIG_" in new_config:
        with open(new_config["_BASE_CONFIG_"], "r") as f:
            yaml_config = yaml.safe_load(f)
        config.update(EasyDict(yaml_config))

    for key, val in new_config.items():
        if key == "_BASE_CONFIG_":
            continue
        if not isinstance(val, dict):
            config[key] = val
            continue
        if key not in config:
            config[key] = EasyDict()
        merge_new_config(config[key], val)
    return config


def cfg_from_yaml_file(cfg_file, config):
    with open(cfg_file, "r") as f:
        new_config = yaml.safe_load(f)
        merge_new_config(config=config, new_config=new_config)
    return config
