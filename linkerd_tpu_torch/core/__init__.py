"""Core pieces the port keeps its own copies of."""

from linkerd_tpu_torch.core.path import Path
from linkerd_tpu_torch.core.var import Var

__all__ = ["Path", "Var"]
