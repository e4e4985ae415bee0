"""Interpreter config kinds: the ``default``, ``io.l5d.mesh``,
``io.l5d.namerd.http`` and ``io.l5d.namerd`` kinds of
``linkerd_tpu/interpreter/configs.py``.

Ref: namer/core/.../InterpreterInitializer.scala:9-57 (SPI) and
interpreter/mesh/.../MeshInterpreterInitializer.scala:79 (kind io.l5d.mesh:
dst + root). The default interpreter is the in-process recursive dtab
namer (DefaultInterpreterInitializer.scala). The reference's
``io.l5d.fs`` and ``io.l5d.k8s.configMap`` kinds are refused by name by
the linker (ROADMAP Queue 1 items 13 and 5).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from linkerd_tpu_torch.config import ConfigError, register
from linkerd_tpu_torch.core import Path
from linkerd_tpu_torch.interpreter.mesh import MeshClientInterpreter
from linkerd_tpu_torch.namer.core import ConfiguredDtabNamer, NameInterpreter


@register("interpreter", "default")
@dataclass
class DefaultInterpreterConfig:
    def mk(self, namers) -> NameInterpreter:
        return ConfiguredDtabNamer(namers)


def parse_inet_dst(dst: str) -> tuple:
    """``/$/inet/<host>/<port>`` -> (host, port) (the reference's mesh dst
    syntax, MeshInterpreterInitializer.scala dst param)."""
    p = Path.read(dst)
    if len(p) != 4 or p[0] != "$" or p[1] != "inet":
        raise ConfigError(
            f"mesh dst must look like /$/inet/<host>/<port>, got {dst!r}")
    try:
        return p[2], int(p[3])
    except ValueError:
        raise ConfigError(f"mesh dst port not a number: {dst!r}")


@register("interpreter", "io.l5d.mesh")
@dataclass
class MeshInterpreterConfig:
    dst: str = "/$/inet/127.0.0.1/4321"
    root: str = "/default"

    def mk(self, namers) -> NameInterpreter:
        host, port = parse_inet_dst(self.dst)
        return MeshClientInterpreter(host, port, root=self.root)


@register("interpreter", "io.l5d.namerd.http")
@dataclass
class NamerdHttpInterpreterConfig:
    """Ref: NamerdHttpInterpreterInitializer.scala:94 — namerd's HTTP
    control API with chunked-watch streams."""

    dst: str = "/$/inet/127.0.0.1/4180"
    namespace: str = "default"

    def mk(self, namers) -> NameInterpreter:
        from linkerd_tpu_torch.interpreter.namerd_http import NamerdHttpInterpreter
        host, port = parse_inet_dst(self.dst)
        return NamerdHttpInterpreter(host, port, namespace=self.namespace)


@register("interpreter", "io.l5d.namerd")
@dataclass
class NamerdThriftInterpreterConfig:
    """The thrift long-poll interpreter — the reference's default remote
    interpreter (ref: NamerdInterpreterInitializer.scala:133, client
    ThriftNamerClient.scala:1-347)."""

    dst: str = "/$/inet/127.0.0.1/4100"
    namespace: str = "default"

    def mk(self, namers) -> NameInterpreter:
        from linkerd_tpu_torch.interpreter.namerd_thrift import (
            ThriftNamerInterpreter,
        )
        host, port = parse_inet_dst(self.dst)
        return ThriftNamerInterpreter(host, port, namespace=self.namespace)
