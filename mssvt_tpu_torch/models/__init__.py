from .network import build_network

__all__ = ["build_network"]
