"""The plain references of the benchmark's configurations, one module a
configuration (``<config>.py``), over the frozen copy in ``detector/``."""
