"""Core pieces the port keeps its own copies of."""

from linkerd_tpu_torch.core.path import Path

__all__ = ["Path"]
