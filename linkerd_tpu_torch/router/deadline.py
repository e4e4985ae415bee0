"""Deadline propagation: hop-to-hop request budgets: a copy of
``linkerd_tpu/router/deadline.py``.

Reference parity: finagle's ``Deadline`` broadcast context as linkerd 1.x
propagates it — ``l5d-ctx-deadline`` request headers re-encoded at every
hop (LinkerdHeaders.scala Ctx.Deadline: read at the server edge, clamped
by the router's own timeout, written by the client stack), plus
``DeadlineFilter``'s reject-expired-work-up-front behavior. A hop chain
thus converges on the TIGHTEST budget any upstream declared, and work
that cannot finish in time is shed before it wastes a downstream
dispatch (Taurus/FENIX argument: the assist must fail cheap, not pile
on).

Wire format for ``l5d-ctx-deadline``: ``<timestamp_ns> <deadline_ns>``
— two decimal UNIX-epoch nanosecond values, the time the deadline was
stamped and the absolute expiry. Wall-clock (not monotonic) because it
crosses process boundaries; skew between meshed hosts is expected to be
far below typical budgets (NTP-disciplined fleets), matching the
reference's own wall-clock Deadline wire format.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Optional

from linkerd_tpu_torch.router.service import Filter, Service

CTX_DEADLINE = "l5d-ctx-deadline"
DEADLINE_CTX_KEY = "deadline"


class DeadlineExceeded(TimeoutError):
    """The request's propagated deadline expired (-> 504 / gRPC
    DEADLINE_EXCEEDED). Subclasses TimeoutError so existing responders
    map it without knowing about deadlines."""


@dataclass(frozen=True)
class Deadline:
    """An absolute request expiry (finagle Deadline parity)."""

    timestamp_ns: int  # when this deadline was stamped
    deadline_ns: int   # absolute expiry, UNIX epoch ns

    def encode(self) -> str:
        return f"{self.timestamp_ns} {self.deadline_ns}"

    @staticmethod
    def decode(s: str) -> Optional["Deadline"]:
        parts = s.strip().split()
        if len(parts) != 2:
            return None
        try:
            ts, dl = int(parts[0]), int(parts[1])
        except ValueError:
            return None
        if ts < 0 or dl < 0:
            return None
        return Deadline(ts, dl)

    @staticmethod
    def after(timeout_s: float) -> "Deadline":
        now = time.time_ns()
        return Deadline(now, now + int(timeout_s * 1e9))

    def remaining_s(self) -> float:
        """Seconds until expiry (negative when already expired)."""
        return (self.deadline_ns - time.time_ns()) / 1e9

    @property
    def expired(self) -> bool:
        return self.remaining_s() <= 0

    def combined(self, other: "Deadline") -> "Deadline":
        """The tighter of two deadlines (ref: Deadline.combined — the
        MOST RECENT timestamp and the EARLIEST expiry)."""
        return Deadline(max(self.timestamp_ns, other.timestamp_ns),
                        min(self.deadline_ns, other.deadline_ns))


def deadline_of(req) -> Optional[Deadline]:
    """The request's effective deadline, or None."""
    ctx = getattr(req, "ctx", None)
    if ctx is None:
        return None
    dl = ctx.get(DEADLINE_CTX_KEY)
    return dl if isinstance(dl, Deadline) else None


class ServerDeadlineFilter(Filter):
    """Server edge: decode ``l5d-ctx-deadline`` into the request ctx and
    reject already-expired requests up front — an expired request must
    be shed HERE, before identification/binding dispatches it downstream
    (ref: LinkerdHeaders Ctx.Deadline server module + DeadlineFilter).

    Protocol-agnostic: http Request and h2 H2Request share the headers/
    ctx surface this touches. Sits INSIDE the error responder so the
    raised DeadlineExceeded maps to 504 (or gRPC DEADLINE_EXCEEDED)."""

    def __init__(self, metrics_node=None):
        self._expired = (metrics_node.counter("expired_at_edge")
                         if metrics_node is not None else None)

    async def apply(self, req, service: Service):
        hdr = req.headers.get(CTX_DEADLINE)
        if hdr is not None:
            dl = Deadline.decode(hdr)
            if dl is not None:
                req.ctx[DEADLINE_CTX_KEY] = dl
                if dl.expired:
                    if self._expired is not None:
                        self._expired.incr()
                    raise DeadlineExceeded(
                        f"deadline expired {-dl.remaining_s() * 1e3:.0f}ms "
                        f"ago; shed at the server edge")
        return await service(req)


class DeadlineFilter(Filter):
    """Path-stack budget enforcement (ref: TotalTimeout + finagle
    DeadlineFilter composed): narrows the request's deadline to
    ``min(incoming, now + total_timeout_s)``, rejects expired work
    before dispatch, and bounds the dispatch (including retries below
    it) to the remaining budget — the propagated deadline CLAMPS the
    configured total timeout instead of racing it."""

    def __init__(self, total_timeout_s: Optional[float] = None):
        self.total_timeout_s = total_timeout_s

    async def apply(self, req, service: Service):
        dl = deadline_of(req)
        if self.total_timeout_s is not None:
            local = Deadline.after(self.total_timeout_s)
            dl = local if dl is None else dl.combined(local)
        if dl is None:
            return await service(req)
        req.ctx[DEADLINE_CTX_KEY] = dl
        remaining = dl.remaining_s()
        if remaining <= 0:
            raise DeadlineExceeded(
                f"deadline expired {-remaining * 1e3:.0f}ms ago "
                f"before dispatch")
        try:
            return await asyncio.wait_for(service(req), remaining)
        except asyncio.TimeoutError:
            raise DeadlineExceeded(
                f"deadline budget of {remaining * 1e3:.0f}ms exhausted"
            ) from None


class ClientDeadlineFilter(Filter):
    """Client stack: re-encode the (clamped) deadline onto the outgoing
    request so the next hop inherits the remaining budget
    (ref: LinkerdHeaders Ctx.Deadline client module)."""

    async def apply(self, req, service: Service):
        dl = deadline_of(req)
        if dl is not None:
            req.headers.set(CTX_DEADLINE, dl.encode())
        return await service(req)
