"""YAML/JSON config parsing with strict validation: a copy of
``linkerd_tpu/config/parser.py``.

Reference parity: Parser.scala — JSON-vs-YAML sniffing (:38-52), strict
duplicate-key detection (:84), unknown-field rejection (Jackson
FAIL_ON_UNKNOWN_PROPERTIES equivalent), and ``kind:``-discriminated
polymorphic instantiation against the registry.

Config classes are plain dataclasses. Fields are matched by name; unknown
keys raise ConfigError with the offending path. Nested dataclass fields,
``Optional[...]``, ``List[...]`` of dataclasses, and the typed scalars in
``types.py`` are converted automatically.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from typing import Any, Dict, List, Optional, Type, TypeVar, Union, get_args, get_origin

from linkerd_tpu_torch.config.registry import ConfigError, lookup
from linkerd_tpu_torch.config.types import HostAndPort, Port

T = TypeVar("T")


_STRICT_LOADER: Any = None


def _strict_loader() -> Any:
    """The SafeLoader subclass that rejects duplicate mapping keys, built
    on first use: the port imports ``yaml`` only for non-JSON text, so a
    host without PyYAML still takes JSON configs."""
    global _STRICT_LOADER
    if _STRICT_LOADER is not None:
        return _STRICT_LOADER
    try:
        import yaml
    except ImportError:
        raise ConfigError(
            "config is not JSON and PyYAML is not installed: give the "
            "config as JSON text, or install PyYAML") from None

    class _StrictLoader(yaml.SafeLoader):
        """SafeLoader that rejects duplicate mapping keys."""

    def _strict_mapping(loader: _StrictLoader, node: yaml.MappingNode,
                        deep=False):
        mapping: Dict[Any, Any] = {}
        for key_node, value_node in node.value:
            key = loader.construct_object(key_node, deep=deep)
            if key in mapping:
                raise ConfigError(
                    f"duplicate key {key!r} at {key_node.start_mark}")
            mapping[key] = loader.construct_object(value_node, deep=deep)
        return mapping

    _StrictLoader.add_constructor(
        yaml.resolver.BaseResolver.DEFAULT_MAPPING_TAG, _strict_mapping)
    _STRICT_LOADER = _StrictLoader
    return _StrictLoader


def parse_config(text: str) -> Any:
    """Parse YAML or JSON text (YAML is a JSON superset; sniff for the
    error-message's sake like the reference does)."""
    stripped = text.lstrip()
    if stripped.startswith("{") or stripped.startswith("["):
        try:
            return json.loads(text)
        except json.JSONDecodeError:
            pass  # fall through to YAML (JSON5-ish YAML accepts more)
    loader = _strict_loader()
    import yaml
    try:
        return yaml.load(text, Loader=loader)  # noqa: S506 strict SafeLoader subclass
    except yaml.YAMLError as e:
        raise ConfigError(f"config parse error: {e}") from e


def parse_file(path: str) -> Any:
    with open(path, "r", encoding="utf-8") as f:
        return parse_config(f.read())


def _convert(value: Any, ftype: Any, path: str) -> Any:
    origin = get_origin(ftype)
    if origin is Union:  # Optional[...] and unions
        args = [a for a in get_args(ftype) if a is not type(None)]
        if value is None:
            return None
        for a in args:
            try:
                return _convert(value, a, path)
            except (ConfigError, TypeError, ValueError):
                continue
        raise ConfigError(f"{path}: cannot convert {value!r} to {ftype}")
    if origin in (list, typing.List):
        (elem,) = get_args(ftype) or (Any,)
        if not isinstance(value, list):
            raise ConfigError(f"{path}: expected list, got {type(value).__name__}")
        return [_convert(v, elem, f"{path}[{i}]") for i, v in enumerate(value)]
    if origin in (dict, typing.Dict):
        return dict(value)
    if ftype is Any or ftype is None:
        return value
    if isinstance(ftype, type):
        if ftype is Port:
            return Port(int(value))
        if ftype is HostAndPort:
            return HostAndPort.read(str(value))
        if dataclasses.is_dataclass(ftype):
            if not isinstance(value, dict):
                raise ConfigError(
                    f"{path}: expected mapping for {ftype.__name__}, "
                    f"got {type(value).__name__}")
            return instantiate_as(ftype, value, path)
        if ftype is float and isinstance(value, (int, float)) and not isinstance(value, bool):
            return float(value)
        if ftype is int and isinstance(value, bool):
            raise ConfigError(f"{path}: expected int, got bool")
        if isinstance(value, ftype):
            return value
        if ftype in (int, str) and not isinstance(value, (dict, list)):
            # YAML scalars: allow e.g. quoted numbers for int fields
            try:
                return ftype(value)
            except (TypeError, ValueError):
                pass
        raise ConfigError(
            f"{path}: expected {getattr(ftype, '__name__', ftype)}, "
            f"got {type(value).__name__} ({value!r})")
    return value


def instantiate_as(cls: Type[T], data: Dict[str, Any], path: str = "") -> T:
    """Build dataclass ``cls`` from a mapping, strictly."""
    if not dataclasses.is_dataclass(cls):
        raise ConfigError(f"{path}: {cls!r} is not a config dataclass")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    hints = typing.get_type_hints(cls)
    kwargs: Dict[str, Any] = {}
    data = dict(data)
    if "kind" not in fields:
        # 'kind' is the polymorphic discriminator for registered configs;
        # plain specs that declare a real `kind` field keep it.
        data.pop("kind", None)
    for key, value in data.items():
        if key not in fields:
            raise ConfigError(
                f"{path or cls.__name__}: unknown field {key!r} "
                f"(known: {sorted(fields)})")
        kwargs[key] = _convert(value, hints.get(key, Any), f"{path}.{key}")
    missing = [
        name for name, f in fields.items()
        if name not in kwargs
        and f.default is dataclasses.MISSING
        and f.default_factory is dataclasses.MISSING  # type: ignore[misc]
    ]
    if missing:
        raise ConfigError(f"{path or cls.__name__}: missing required fields {missing}")
    return cls(**kwargs)


def instantiate(category: str, data: Dict[str, Any], path: str = "") -> Any:
    """Build the registered config for a ``kind:``-discriminated mapping."""
    if not isinstance(data, dict):
        raise ConfigError(f"{path}: expected mapping with 'kind'")
    kind = data.get("kind")
    if not kind:
        raise ConfigError(f"{path}: missing 'kind' discriminator")
    cls = lookup(category, kind)
    return instantiate_as(cls, data, path or kind)


def instantiate_list(category: str, data: Any, path: str = "") -> List[Any]:
    if data is None:
        return []
    if not isinstance(data, list):
        raise ConfigError(f"{path}: expected a list of {category} configs")
    return [instantiate(category, d, f"{path}[{i}]") for i, d in enumerate(data)]
