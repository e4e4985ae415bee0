"""The Service / Filter / ServiceFactory abstraction: a copy of
``linkerd_tpu/router/service.py``.

Reference parity: finagle's ``Service[Req, Rep]`` / ``Filter`` /
``ServiceFactory`` — the composition algebra every router stack module uses
(ref: router/core/.../Router.scala stack composition; finagle upstream).
Here a Service is an async callable; a Filter wraps a Service; a
ServiceFactory asynchronously materializes Services (a connection, a
balanced endpoint session, ...) and is what the binding caches hold.
"""

from __future__ import annotations

import abc
import enum
from typing import Any, Awaitable, Callable, Generic, Optional, TypeVar

Req = TypeVar("Req")
Rep = TypeVar("Rep")


class Status(enum.Enum):
    """Availability as seen by balancers / failure accrual
    (ref: finagle Status Open/Busy/Closed)."""

    OPEN = "open"
    BUSY = "busy"
    CLOSED = "closed"


class Service(Generic[Req, Rep]):
    """An async function Req -> Rep with lifecycle and availability."""

    async def __call__(self, req: Req) -> Rep:
        raise NotImplementedError

    @property
    def status(self) -> Status:
        return Status.OPEN

    async def close(self) -> None:
        return


class FnService(Service[Req, Rep]):
    """Service from a plain async function (ref: Service.mk, the
    no-mocking test pattern in BUILD.md:126-131)."""

    def __init__(self, fn: Callable[[Req], Awaitable[Rep]]):
        self._fn = fn

    async def __call__(self, req: Req) -> Rep:
        return await self._fn(req)


class Filter(Generic[Req, Rep]):
    """Wraps service behavior. Subclasses implement ``apply``."""

    async def apply(self, req: Req, service: Service[Req, Rep]) -> Rep:
        raise NotImplementedError

    def and_then(self, inner: "Service[Req, Rep] | Filter[Req, Rep]"):
        if isinstance(inner, Filter):
            return _ComposedFilter(self, inner)
        return _FilteredService(self, inner)


class _ComposedFilter(Filter[Req, Rep]):
    def __init__(self, outer: Filter, inner: Filter):
        self._outer = outer
        self._inner = inner

    async def apply(self, req: Req, service: Service[Req, Rep]) -> Rep:
        return await self._outer.apply(req, self._inner.and_then(service))


class _FilteredService(Service[Req, Rep]):
    def __init__(self, filt: Filter, service: Service[Req, Rep]):
        self._filter = filt
        self._service = service

    async def __call__(self, req: Req) -> Rep:
        return await self._filter.apply(req, self._service)

    @property
    def status(self) -> Status:
        return self._service.status

    async def close(self) -> None:
        await self._service.close()


def filters_to_service(filters: list, service: Service) -> Service:
    """Compose ``filters`` (outermost first) around ``service``."""
    for f in reversed(filters):
        service = f.and_then(service)
    return service


class ServiceFactory(Generic[Req, Rep]):
    """Asynchronously materializes Services; closable and status-bearing."""

    async def acquire(self) -> Service[Req, Rep]:
        raise NotImplementedError

    @property
    def status(self) -> Status:
        return Status.OPEN

    async def close(self) -> None:
        return


class FnServiceFactory(ServiceFactory[Req, Rep]):
    def __init__(self, mk: Callable[[], Awaitable[Service[Req, Rep]]],
                 on_close: Optional[Callable[[], Awaitable[None]]] = None):
        self._mk = mk
        self._on_close = on_close

    async def acquire(self) -> Service[Req, Rep]:
        return await self._mk()

    async def close(self) -> None:
        if self._on_close is not None:
            await self._on_close()
