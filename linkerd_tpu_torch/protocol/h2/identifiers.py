"""h2 request identifiers: H2Request -> logical Dst path.

Ref: linkerd/protocol/h2 identifiers — HeaderTokenIdentifier (default
``:authority``, H2Config.scala identifier default) and HeaderPathIdentifier.
Registered under the ``h2identifier`` category; the h2 router's default is
``io.l5d.header.token``.
"""

from __future__ import annotations

from dataclasses import dataclass

from linkerd_tpu_torch.config import register
from linkerd_tpu_torch.core import Dtab, Path
from linkerd_tpu_torch.protocol.h2.messages import H2Request
from linkerd_tpu_torch.router.binding import DstPath
from linkerd_tpu_torch.router.routing import (
    IdentificationError, Identifier, parse_local_dtab,
)

# parse_local_dtab only touches headers.get_all, which h2 Headers
# provides, so the HTTP/1 implementation is shared verbatim
_local_dtab = parse_local_dtab


@register("h2identifier", "io.l5d.header.token")
@dataclass
class H2HeaderTokenIdentifier:
    """``/<prefix>/<token>`` from a header; default ``:authority``
    (ref: HeaderTokenIdentifier.scala — the h2 default)."""

    header: str = ":authority"

    def mk(self, prefix: Path, base_dtab: Dtab) -> Identifier:
        def identify(req: H2Request) -> DstPath:
            if self.header == ":authority":
                token = (req.authority or "").split(":", 1)[0].lower()
            else:
                token = req.headers.get(self.header.lower()) or ""
            if not token:
                raise IdentificationError(f"no {self.header} header")
            p = Path.read(token) if token.startswith("/") else Path.of(token)
            return DstPath(prefix + p, base_dtab, _local_dtab(req))

        return identify


@register("h2identifier", "io.l5d.header.path")
@dataclass
class H2HeaderPathIdentifier:
    """``/<prefix>/<first-N-:path-segments>``
    (ref: HeaderPathIdentifier.scala)."""

    segments: int = 1

    def mk(self, prefix: Path, base_dtab: Dtab) -> Identifier:
        def identify(req: H2Request) -> DstPath:
            path_part = req.path.split("?", 1)[0]
            segs = [s for s in path_part.split("/") if s]
            if len(segs) < self.segments:
                raise IdentificationError(
                    f":path has fewer than {self.segments} segments")
            return DstPath(prefix + Path(segs[:self.segments]),
                           base_dtab, _local_dtab(req))

        return identify
