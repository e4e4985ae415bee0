"""Typed config scalars (ref: config/src/main/scala/io/buoyant/config/types/): a copy of
``linkerd_tpu/config/types.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

from linkerd_tpu_torch.config.registry import ConfigError


@dataclass(frozen=True)
class Port:
    value: int

    def __post_init__(self) -> None:
        if not (0 <= self.value <= 65535):
            raise ConfigError(f"port out of range: {self.value}")

    def __int__(self) -> int:
        return self.value


@dataclass(frozen=True)
class HostAndPort:
    host: str
    port: Port

    @staticmethod
    def read(s: str) -> "HostAndPort":
        if ":" not in s:
            raise ConfigError(f"expected host:port, got {s!r}")
        host, port = s.rsplit(":", 1)
        try:
            return HostAndPort(host, Port(int(port)))
        except ValueError:
            raise ConfigError(f"bad port in {s!r}") from None
