"""HTTP request identifiers: request -> logical Dst path: a copy of
``linkerd_tpu/protocol/http/identifiers.py``.

Reference parity: router/http identifiers (MethodAndHostIdentifier.scala:51,
PathIdentifier, HeaderIdentifier, StaticIdentifier) and linkerd's default
``io.l5d.header.token`` (Host header token). Each is a config dataclass
registered under the ``identifier`` category; ``mk(prefix)`` builds the
callable used by RoutingService.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from linkerd_tpu_torch.config import register
from linkerd_tpu_torch.core import Dtab, Path
from linkerd_tpu_torch.protocol.http.message import Request
from linkerd_tpu_torch.router.binding import DstPath
from linkerd_tpu_torch.router.routing import (
    IdentificationError, Identifier, parse_local_dtab,
)


def _clean_host(host: Optional[str]) -> str:
    if not host:
        raise IdentificationError("no Host header")
    return host.split(":", 1)[0].lower()


@register("identifier", "io.l5d.header.token")
@dataclass
class HeaderTokenIdentifier:
    """``/<prefix>/<token>`` from a header (default Host), the linkerd
    default HTTP identifier."""

    header: str = "Host"

    def mk(self, prefix: Path, base_dtab: Dtab) -> Identifier:
        def identify(req: Request) -> DstPath:
            if self.header.lower() == "host":
                token = _clean_host(req.host)
            else:
                token = req.headers.get(self.header) or ""
            if not token:
                raise IdentificationError(f"no {self.header} header")
            # a token with slashes is a path; otherwise one segment
            p = Path.read(token) if token.startswith("/") else Path.of(token)
            return DstPath(prefix + p, base_dtab, parse_local_dtab(req))

        return identify


@register("identifier", "io.l5d.methodAndHost")
@dataclass
class MethodAndHostIdentifier:
    """``/<prefix>/1.1/<METHOD>/<host>`` (ref: MethodAndHostIdentifier.scala)."""

    httpUriInDst: bool = False

    def mk(self, prefix: Path, base_dtab: Dtab) -> Identifier:
        def identify(req: Request) -> DstPath:
            host = _clean_host(req.host)
            version = "1.1" if req.version == "HTTP/1.1" else "1.0"
            p = prefix + Path.of(version, req.method, host)
            if self.httpUriInDst:
                p = p + Path.read(req.path)
            return DstPath(p, base_dtab, parse_local_dtab(req))

        return identify


@register("identifier", "io.l5d.path")
@dataclass
class PathIdentifier:
    """``/<prefix>/<first-N-uri-segments>`` (ref: PathIdentifier.scala)."""

    segments: int = 1
    consume: bool = False

    def mk(self, prefix: Path, base_dtab: Dtab) -> Identifier:
        def identify(req: Request) -> DstPath:
            segs = Path.read(req.path)
            if len(segs) < self.segments:
                raise IdentificationError(
                    f"uri {req.path!r} has fewer than {self.segments} segments")
            taken = segs.take(self.segments)
            if self.consume:
                rest = segs.drop(self.segments)
                q = req.uri.find("?")
                query = req.uri[q:] if q >= 0 else ""
                req.uri = rest.show + query
            return DstPath(prefix + taken, base_dtab, parse_local_dtab(req))

        return identify


@register("identifier", "io.l5d.header")
@dataclass
class HeaderIdentifier:
    """Path read verbatim from a header (ref: HeaderIdentifier.scala)."""

    header: str = "l5d-name"

    def mk(self, prefix: Path, base_dtab: Dtab) -> Identifier:
        def identify(req: Request) -> DstPath:
            raw = req.headers.get(self.header)
            if not raw:
                raise IdentificationError(f"no {self.header} header")
            try:
                p = Path.read(raw)
            except ValueError as e:
                raise IdentificationError(str(e)) from None
            return DstPath(prefix + p, base_dtab, parse_local_dtab(req))

        return identify


@register("identifier", "io.l5d.static")
@dataclass
class StaticIdentifier:
    """Every request to one logical path (ref: StaticIdentifier.scala)."""

    path: str = "/svc/default"

    def mk(self, prefix: Path, base_dtab: Dtab) -> Identifier:
        dst_path = Path.read(self.path)

        def identify(req: Request) -> DstPath:
            return DstPath(dst_path, base_dtab, parse_local_dtab(req))

        return identify


def compose_identifiers(ids: List[Identifier]) -> Identifier:
    """Try identifiers in order; first success wins
    (ref: HttpConfig.scala:232-236 identifier list composition)."""

    def identify(req: Request) -> DstPath:
        errs = []
        for ident in ids:
            try:
                return ident(req)
            except IdentificationError as e:
                errs.append(str(e))
        raise IdentificationError("; ".join(errs) or "no identifier matched")

    return identify
