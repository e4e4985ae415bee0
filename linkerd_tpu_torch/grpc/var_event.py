"""VarEventStream: reactive state -> gRPC stream for watch APIs.

Ref: grpc/runtime/.../VarEventStream.scala:150 — serves the *latest* state:
if the consumer is slower than the producer, intermediate states are
coalesced (only the most recent unobserved value is delivered), which is
exactly the semantics namerd's mesh interface needs when pumping
``Activity[NameTree]`` / ``Var[Addr]`` churn to many linkerds.
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator, Callable, Generic, Optional, TypeVar

from linkerd_tpu_torch.core.var import Closable, Var

T = TypeVar("T")
U = TypeVar("U")

_TOMBSTONE = object()


class VarEventStream(Generic[T, U]):
    """Async iterator over ``var``'s states, mapped through ``to_msg``.

    Never buffers more than one pending state. ``close()`` ends iteration
    after any pending value is delivered.
    """

    def __init__(self, var: Var[T],
                 to_msg: Optional[Callable[[T], U]] = None):
        self._to_msg = to_msg or (lambda v: v)
        self._latest: object = _TOMBSTONE
        self._wake = asyncio.Event()
        self._closed = False
        self._obs: Closable = var.observe(self._on_state)

    def _on_state(self, value: T) -> None:
        self._latest = value
        self._wake.set()

    def close(self) -> None:
        self._closed = True
        self._obs.close()
        self._wake.set()

    def __aiter__(self) -> AsyncIterator[U]:
        return self

    async def __anext__(self) -> U:
        while True:
            if self._latest is not _TOMBSTONE:
                value = self._latest
                self._latest = _TOMBSTONE
                self._wake.clear()
                return self._to_msg(value)
            if self._closed:
                raise StopAsyncIteration
            await self._wake.wait()
