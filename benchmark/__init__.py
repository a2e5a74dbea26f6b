"""The benchmark of the PyTorch + CUDA port (``benchmark/README.md``)."""
