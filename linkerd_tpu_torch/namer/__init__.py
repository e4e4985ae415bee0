"""Naming & interpretation: Namer SPI, dtab interpreter, namers: a copy of
``linkerd_tpu/namer/__init__.py``.

Reference parity: linkerd's namer/core (NamerInitializer,
ConfiguredDtabNamer, Paths) and the namer plugins.
"""

from linkerd_tpu_torch.namer.core import (
    Namer, NameInterpreter, ConfiguredDtabNamer, bind_leaves,
    CONFIGURED_PREFIX, UTILITY_PREFIX,
)

__all__ = [
    "Namer", "NameInterpreter", "ConfiguredDtabNamer", "bind_leaves",
    "CONFIGURED_PREFIX", "UTILITY_PREFIX",
]
