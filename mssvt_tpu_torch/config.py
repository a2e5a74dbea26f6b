"""YAML config system with ``_BASE_CONFIG_`` inheritance and CLI overrides.

The port's own copy of ``mssvt_tpu/config.py`` (same semantics):

- ``cfg_from_yaml_file``: a recursive merge of the YAML tree into an
  :class:`EasyDict`, where a section that names ``_BASE_CONFIG_`` first
  takes the whole base file (path relative to the working directory, as the
  configs are written for the repo root);
- ``cfg_from_list``: dotted-path overrides (``--set KEY VALUE ...``) with
  ``literal_eval`` and coercion to the overridden value's type;
- ``log_config_to_file``: the recursive pretty-printer;
- the global ``cfg`` with ``ROOT_DIR`` (the repo root) and ``LOCAL_RANK``.
"""

from __future__ import annotations

from ast import literal_eval
from pathlib import Path

import yaml

from .utils.edict import EasyDict


def log_config_to_file(cfg_dict, pre="cfg", logger=None):
    for key, val in cfg_dict.items():
        if isinstance(val, EasyDict):
            logger.info("----------- %s -----------" % key)
            log_config_to_file(val, pre=pre + "." + key, logger=logger)
            continue
        logger.info("%s.%s: %s" % (pre, key, val))


def cfg_from_list(cfg_list, config):
    """Set config keys from a flat [KEY, VALUE, ...] list."""
    if len(cfg_list) % 2:
        raise ValueError(f"--set takes KEY VALUE pairs, got {cfg_list}")
    for k, v in zip(cfg_list[0::2], cfg_list[1::2]):
        key_list = k.split(".")
        d = config
        for subkey in key_list[:-1]:
            if subkey not in d:
                raise KeyError("NotFoundKey: %s" % subkey)
            d = d[subkey]
        subkey = key_list[-1]
        if subkey not in d:
            raise KeyError("NotFoundKey: %s" % subkey)
        try:
            value = literal_eval(v)
        except (ValueError, SyntaxError):
            value = v

        if isinstance(value, dict):
            d[subkey].update(EasyDict(value))
        elif type(value) != type(d[subkey]) and isinstance(d[subkey], EasyDict):
            for src in v.split(","):
                cur_key, cur_val = src.split(":")
                d[subkey][cur_key] = type(d[subkey][cur_key])(cur_val)
        elif type(value) != type(d[subkey]) and isinstance(d[subkey], list):
            d[subkey] = [type(d[subkey][0])(x) for x in v.split(",")]
        else:
            if type(value) != type(d[subkey]):
                raise TypeError("type {} does not match original type {}".format(
                    type(value), type(d[subkey])))
            d[subkey] = value


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


cfg = EasyDict()
cfg.ROOT_DIR = (Path(__file__).resolve().parent / "../").resolve()
cfg.LOCAL_RANK = 0
