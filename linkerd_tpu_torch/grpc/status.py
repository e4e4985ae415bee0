"""gRPC status model and its h2 mapping.

Ref: grpc/runtime/src/main/scala/io/buoyant/grpc/runtime/GrpcStatus.scala —
statuses surface either as trailers (``grpc-status``/``grpc-message``) or as
h2 RST codes; both directions are implemented here.
"""

from __future__ import annotations

from typing import List, Optional, Tuple
from urllib.parse import quote, unquote

from linkerd_tpu_torch.protocol.h2.stream import StreamReset, Trailers

# canonical status codes
OK = 0
CANCELED = 1
UNKNOWN = 2
INVALID_ARGUMENT = 3
DEADLINE_EXCEEDED = 4
NOT_FOUND = 5
ALREADY_EXISTS = 6
PERMISSION_DENIED = 7
RESOURCE_EXHAUSTED = 8
FAILED_PRECONDITION = 9
ABORTED = 10
OUT_OF_RANGE = 11
UNIMPLEMENTED = 12
INTERNAL = 13
UNAVAILABLE = 14
DATA_LOSS = 15
UNAUTHENTICATED = 16

_NAMES = {
    0: "OK", 1: "CANCELED", 2: "UNKNOWN", 3: "INVALID_ARGUMENT",
    4: "DEADLINE_EXCEEDED", 5: "NOT_FOUND", 6: "ALREADY_EXISTS",
    7: "PERMISSION_DENIED", 8: "RESOURCE_EXHAUSTED", 9: "FAILED_PRECONDITION",
    10: "ABORTED", 11: "OUT_OF_RANGE", 12: "UNIMPLEMENTED", 13: "INTERNAL",
    14: "UNAVAILABLE", 15: "DATA_LOSS", 16: "UNAUTHENTICATED",
}

# h2 RST code <-> grpc status (GrpcStatus.scala fromReset/toReset)
from linkerd_tpu_torch.protocol.h2.frames import (  # noqa: E402
    CANCEL as _RST_CANCEL,
    ENHANCE_YOUR_CALM as _RST_ENHANCE_YOUR_CALM,
    INTERNAL_ERROR as _RST_INTERNAL_ERROR,
    NO_ERROR as _RST_NO_ERROR,
    PROTOCOL_ERROR as _RST_PROTOCOL_ERROR,
    REFUSED_STREAM as _RST_REFUSED,
)


class GrpcStatus:
    __slots__ = ("code", "message")

    def __init__(self, code: int = OK, message: str = ""):
        self.code = code
        self.message = message

    @property
    def ok(self) -> bool:
        return self.code == OK

    @property
    def name(self) -> str:
        return _NAMES.get(self.code, str(self.code))

    def to_trailers(self) -> Trailers:
        items: List[Tuple[str, str]] = [("grpc-status", str(self.code))]
        if self.message:
            items.append(("grpc-message", quote(self.message)))
        return Trailers(items)

    def to_headers(self) -> List[Tuple[str, str]]:
        items = [("grpc-status", str(self.code))]
        if self.message:
            items.append(("grpc-message", quote(self.message)))
        return items

    @staticmethod
    def from_trailers(trailers: Optional[Trailers]) -> "GrpcStatus":
        if trailers is None:
            return GrpcStatus(UNKNOWN, "missing grpc-status trailers")
        code_s = None
        msg = ""
        for k, v in trailers.headers:
            if k == "grpc-status":
                code_s = v
            elif k == "grpc-message":
                msg = unquote(v)
        if code_s is None:
            return GrpcStatus(UNKNOWN, "missing grpc-status")
        try:
            return GrpcStatus(int(code_s), msg)
        except ValueError:
            return GrpcStatus(UNKNOWN, f"bad grpc-status {code_s!r}")

    @staticmethod
    def from_reset(reset: StreamReset) -> "GrpcStatus":
        code = {
            _RST_NO_ERROR: UNAVAILABLE,
            _RST_PROTOCOL_ERROR: INTERNAL,
            _RST_INTERNAL_ERROR: INTERNAL,
            _RST_REFUSED: UNAVAILABLE,
            _RST_CANCEL: CANCELED,
            _RST_ENHANCE_YOUR_CALM: RESOURCE_EXHAUSTED,
        }.get(reset.error_code, UNKNOWN)
        return GrpcStatus(code, reset.message or f"rst={reset.error_code}")

    def to_reset_code(self) -> int:
        return {
            CANCELED: _RST_CANCEL,
            RESOURCE_EXHAUSTED: _RST_ENHANCE_YOUR_CALM,
            UNAVAILABLE: _RST_REFUSED,
        }.get(self.code, _RST_INTERNAL_ERROR)

    def __repr__(self) -> str:
        return f"GrpcStatus({self.name}, {self.message!r})"


class GrpcError(Exception):
    """Raised client-side for non-OK statuses; carries the status."""

    def __init__(self, status: GrpcStatus):
        super().__init__(f"{status.name}: {status.message}")
        self.status = status

    @staticmethod
    def of(code: int, message: str = "") -> "GrpcError":
        return GrpcError(GrpcStatus(code, message))
