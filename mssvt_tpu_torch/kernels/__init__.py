"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Each wrapper module (``fill``, ``fps``, ``attention``, ``attention_bwd``,
``attention_qk``, ``attention_qk_bwd``, ``ffn``, ``ball_query``) takes the
plain version for CPU tensors and launches its CUDA kernel for CUDA tensors
(or raises); it adds one to its kernel's module-level launch counter at
each launch. A replayed CUDA graph launches through no wrapper: it adds the
launches its capture counted (``add_launch_counts``), and the capture adds
none. chip_smoke's main path and the card tests hold that count against the
kernels a profiled replay runs. ``KERNELS`` lists the MsSVT blocks' kernels
and the point-based families' (the FPS forms, PointNet++'s ball query).
``nms`` (the greedy NMS scan of the post-processing) and ``nms_iou`` (its
rotated-IoU mask) do the same, and are counted on their own
(``nms.launches``, ``nms_iou.launches``): they run in every detector's
post-processing and in the two-stage proposals. Importing this package
needs neither ``nvcc`` nor a card: the kernels are built on first use
(``_lib.lib()``).
"""

from . import (attention, attention_bwd, attention_qk, attention_qk_bwd,
               ball_query, ffn, fill, fps, nms, nms_iou)

# kernel name -> (wrapper module, name of its launch counter there)
KERNELS = {"fill": fill, "fps": fps, "fps_picks_warp": fps,
           "fps_picks_block": fps, "fps_picks_masked": fps,
           "attention": attention,
           "attention_bwd": attention_bwd, "attention_qk": attention_qk,
           "attention_qk_bwd": attention_qk_bwd, "ffn": ffn,
           "ball_query": ball_query}
_COUNTERS = {"fps_picks_warp": "launches_warp",
             "fps_picks_block": "launches_block",
             "fps_picks_masked": "launches_masked"}


def launch_counts() -> dict:
    return {name: getattr(mod, _COUNTERS.get(name, "launches"))
            for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for name, mod in KERNELS.items():
        setattr(mod, _COUNTERS.get(name, "launches"), 0)


def add_launch_counts(delta: dict) -> None:
    """Adds ``delta`` (kernel name -> launches, negative to take back) to
    the launch counters."""
    for name, n in delta.items():
        counter = _COUNTERS.get(name, "launches")
        mod = KERNELS[name]
        setattr(mod, counter, getattr(mod, counter) + n)
