"""Addr — concrete replica-set states, and bound names: a copy of
``linkerd_tpu/core/addr.py``.

Reference parity: ``com.twitter.finagle.Addr`` (Bound/Failed/Pending/Neg)
carried in ``Var[Addr]`` from namers to balancers
(consul's SvcAddr.scala, k8s EndpointsNamer), and
``Name.Bound`` (router/core's Dst.scala:42).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, FrozenSet, Tuple

from linkerd_tpu_torch.core.path import Path
from linkerd_tpu_torch.core.var import Var


@dataclass(frozen=True)
class Address:
    """A weighted endpoint address (host, port, weight, metadata)."""

    host: str
    port: int
    weight: float = 1.0
    meta: Tuple[Tuple[str, Any], ...] = ()

    @staticmethod
    def mk(host: str, port: int, weight: float = 1.0, **meta: Any) -> "Address":
        return Address(host, port, weight, tuple(sorted(meta.items())))

    @property
    def hostport(self) -> str:
        return f"{self.host}:{self.port}"


class Addr:
    """Replica-set state ADT."""

    __slots__ = ()


@dataclass(frozen=True)
class Bound(Addr):
    addresses: FrozenSet[Address]
    meta: Tuple[Tuple[str, Any], ...] = ()

    @staticmethod
    def of(*addresses: Address) -> "Bound":
        return Bound(frozenset(addresses))


@dataclass(frozen=True)
class AddrFailed(Addr):
    why: str


@dataclass(frozen=True)
class AddrPending(Addr):
    pass


@dataclass(frozen=True)
class AddrNeg(Addr):
    pass


ADDR_PENDING: Addr = AddrPending()
ADDR_NEG: Addr = AddrNeg()


@dataclass(frozen=True, eq=False)
class BoundName:
    """A bound name: a stable id, a live Var[Addr], and a residual path.

    Identity (hash/eq) is the ``id_`` path + residual, NOT the address state —
    the binding caches key on this (ref: Dst.Bound,
    router/core/.../DstBindingFactory.scala boundCache keying).
    """

    id_: Path
    addr: Var[Addr]
    residual: Path = Path()

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, BoundName)
            and other.id_ == self.id_
            and other.residual == self.residual
        )

    def __hash__(self) -> int:
        return hash((self.id_, self.residual))

    def __repr__(self) -> str:
        return f"BoundName(id={self.id_.show}, residual={self.residual.show})"
