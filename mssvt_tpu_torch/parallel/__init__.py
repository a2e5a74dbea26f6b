"""Data parallelism of the port (``torch.distributed`` + DDP + SyncBN)."""
