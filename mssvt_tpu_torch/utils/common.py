"""Common runtime utilities (the port's copy of
``mssvt_tpu/utils/common.py``)."""

from __future__ import annotations

import logging
import os
import random

import numpy as np
import torch


def create_logger(log_file=None, rank=0, log_level=logging.INFO):
    """A rank-0-gated console and file logger."""
    logger = logging.getLogger(f"mssvt_tpu_torch.rank{rank}")
    logger.setLevel(log_level if rank == 0 else logging.ERROR)
    logger.propagate = False
    formatter = logging.Formatter("%(asctime)s  %(levelname)5s  %(message)s")
    if not logger.handlers:
        console = logging.StreamHandler()
        console.setLevel(log_level if rank == 0 else logging.ERROR)
        console.setFormatter(formatter)
        logger.addHandler(console)
    # one file handler at a time: an entry point called again in the same
    # process logs to its own new file
    for h in [h for h in logger.handlers if isinstance(h, logging.FileHandler)]:
        logger.removeHandler(h)
        h.close()
    if log_file is not None:
        fh = logging.FileHandler(log_file)
        fh.setLevel(log_level if rank == 0 else logging.ERROR)
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    return logger


def set_random_seed(seed):
    """Pin python's, numpy's global and torch's (CPU and every card's)
    random state. The data pipeline draws from the dataset's own
    ``numpy.random.RandomState``, seeded where the dataset is built."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
