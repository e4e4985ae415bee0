"""``kind:``-polymorphic YAML/JSON plugin configuration: a copy of
``linkerd_tpu/config/__init__.py``.

Reference parity: the ``config`` module's Jackson-based polymorphic parsing +
JVM ServiceLoader plugin discovery (linkerd's config/Parser.scala:38-90,
LoadService registration) rebuilt as an explicit registry: plugins register a
config dataclass under a (category, kind) pair; the parser sniffs YAML vs
JSON, enforces unique kinds, rejects unknown fields and duplicate keys, and
instantiates the registered class for each ``kind:``-discriminated object.
"""

from linkerd_tpu_torch.config.registry import (
    ConfigError, register, lookup, kinds, registered_categories, clear_category,
)
from linkerd_tpu_torch.config.parser import (
    parse_config, parse_file, instantiate, instantiate_list,
)
from linkerd_tpu_torch.config.types import Port, HostAndPort

__all__ = [
    "ConfigError", "register", "lookup", "kinds", "registered_categories",
    "clear_category", "parse_config", "parse_file", "instantiate",
    "instantiate_list", "Port", "HostAndPort",
]
