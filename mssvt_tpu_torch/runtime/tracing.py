"""Stage spans on the profiler's clock.

``span(name)`` marks one stage of a request as the ``torch.profiler``
range ``mssvt.<name>``, so the stage lands in the same trace as the
kernels, copies and runtime calls it caused, on the same clock. Without
an active profiler it is a null context: one flag read, no
``record_function``. Spans open at stage boundaries only, never inside a
loop, a block or a kernel wrapper.

The spans of an eval request (``runtime/eval_utils.eval_step`` and the
detectors' ``generic_post`` helpers): ``mssvt.request`` around the
forward, and inside it, in order and without overlap, ``mssvt.vfe``,
``mssvt.backbone_3d``, ``mssvt.map_to_bev``, ``mssvt.backbone_2d``,
``mssvt.head`` and ``mssvt.post``.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

PREFIX = "mssvt."
_NULL = contextlib.nullcontext()


def span(name: str):
    """A context that records the range ``mssvt.<name>`` while a profiler
    (``torch.profiler.profile``, the autograd profiler, ``emit_nvtx``) is
    recording, and does nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return torch.profiler.record_function(PREFIX + name)
