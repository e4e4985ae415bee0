"""Plugin registry: (category, kind) -> config class: a copy of
``linkerd_tpu/config/registry.py``.

Reference parity: LoadService/META-INF SPI discovery + the unique-kind
enforcement in Parser.scala:68-90. ``CATEGORIES`` is the authoritative
inventory of every category actually registered in this tree (protocols
are wired by the linker directly, not through the registry): the SPI
kinds the reference Linker loads (Linker.scala:64-75) with h1/h2 split
identifier/classifier categories, plus namerd's dtab storage and
control-plane iface categories. The l5dlint ``config-registry`` rule
cross-checks every ``@register`` call against this tuple, so a new
category must be declared here before it can register kinds.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple, Type


class ConfigError(Exception):
    """Raised for malformed or unknown configuration."""


_REGISTRY: Dict[str, Dict[str, type]] = {}

CATEGORIES = (
    "namer", "interpreter", "transformer",
    "identifier", "h2identifier",      # h1 / h2 request identification
    "classifier", "h2classifier",      # h1 / h2 response classification
    "telemeter", "announcer", "failureAccrual", "logger",
    "dtabStore", "namerdIface",        # namerd storage + control ifaces
)


def register(category: str, kind: str, *, experimental: bool = False,
             aliases: Iterable[str] = ()) -> Callable[[type], type]:
    """Class decorator registering a config class for ``kind`` in ``category``.

    Kind ids must be unique within a category (duplicate registration is a
    programming error, matching the reference's startup check).
    """

    def deco(cls: type) -> type:
        cat = _REGISTRY.setdefault(category, {})
        for k in (kind, *aliases):
            if k in cat and cat[k] is not cls:
                raise ConfigError(
                    f"duplicate kind {k!r} in category {category!r}: "
                    f"{cat[k].__name__} vs {cls.__name__}")
            cat[k] = cls
        cls.kind = kind
        cls.experimental = experimental
        return cls

    return deco


def lookup(category: str, kind: str) -> type:
    try:
        return _REGISTRY[category][kind]
    except KeyError:
        known = sorted(_REGISTRY.get(category, ()))
        raise ConfigError(
            f"unknown {category} kind {kind!r}; known kinds: {known}") from None


def kinds(category: str) -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY.get(category, ())))


def registered_categories() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def clear_category(category: str) -> None:
    """Test helper: drop all registrations in a category."""
    _REGISTRY.pop(category, None)
