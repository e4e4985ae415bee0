"""Plugin registry of the port: (category, kind) -> config class.

``register``, ``lookup`` and ``ConfigError`` of
``linkerd_tpu/config/registry.py``, over a registry of the port's own:
the port's config classes register here under the reference's category
and kind names (``telemeter`` / ``io.l5d.jaxAnomaly``), never in the
reference's registry.
"""

from __future__ import annotations

from typing import Callable, Dict


class ConfigError(Exception):
    """Raised for malformed or unknown configuration."""


_REGISTRY: Dict[str, Dict[str, type]] = {}


def register(category: str, kind: str) -> Callable[[type], type]:
    """Class decorator registering a config class for ``kind`` in ``category``.

    Kind ids must be unique within a category (duplicate registration is a
    programming error, matching the reference's startup check).
    """

    def deco(cls: type) -> type:
        cat = _REGISTRY.setdefault(category, {})
        if kind in cat and cat[kind] is not cls:
            raise ConfigError(
                f"duplicate kind {kind!r} in category {category!r}: "
                f"{cat[kind].__name__} vs {cls.__name__}")
        cat[kind] = cls
        cls.kind = kind
        return cls

    return deco


def lookup(category: str, kind: str) -> type:
    try:
        return _REGISTRY[category][kind]
    except KeyError:
        known = sorted(_REGISTRY.get(category, ()))
        raise ConfigError(
            f"unknown {category} kind {kind!r}; known kinds: {known}") from None
