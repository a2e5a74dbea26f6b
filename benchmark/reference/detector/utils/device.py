"""Device helpers: host constants on the device, uploaded once, and the
entry points' device choice.

Copying a host array to the card without pinned memory makes the host wait
for the stream, which stalls the main path; the static tables of the model
(query-table deltas, class maps, ranges) are therefore uploaded once per
(content, device) and reused.
"""

from __future__ import annotations

import numpy as np
import torch

_CACHE = {}


def device_constant(values, device, dtype=None) -> torch.Tensor:
    """A device tensor holding ``values`` (array-like), cached by content."""
    arr = np.ascontiguousarray(np.asarray(values))
    key = (arr.dtype.str, arr.shape, arr.tobytes(), str(device), dtype)
    t = _CACHE.get(key)
    if t is None:
        t = torch.as_tensor(arr, dtype=dtype).to(device)
        _CACHE[key] = t
    return t


def resolve_device(name) -> torch.device:
    """The device an entry point asked for: ``cuda`` raises when no card is
    present (it never falls back to the CPU); ``cpu`` must be asked for."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r}: no CUDA card is available; "
                           "pass --device cpu to run on the CPU")
    return device
