"""PyTorch + CUDA (Hopper) port of mssvt_tpu: MsSVT CenterPoint inference.

Layout mirrors ``mssvt_tpu``; the TPU kernels on the inference path are
hand-written CUDA C++ under ``csrc/`` with wrappers in ``kernels/``, built
on first use. Importing this package needs neither ``nvcc`` nor a card.
"""

__version__ = "0.1.0"
