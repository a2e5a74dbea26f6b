"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Each wrapper module (``fill``, ``fps``, ``attention``, ``ffn``) takes the
plain version for CPU tensors and launches its CUDA kernel for CUDA tensors
(or raises); it adds one to its module-level ``launches`` at each launch.
Importing this package needs neither ``nvcc`` nor a card: the kernels are
built on first use (``_lib.lib()``).
"""

from . import attention, ffn, fill, fps

KERNELS = {"fill": fill, "fps": fps, "attention": attention, "ffn": ffn}


def launch_counts() -> dict:
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0
