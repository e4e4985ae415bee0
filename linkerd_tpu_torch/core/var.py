"""Var — a watchable state cell: a copy of ``linkerd_tpu/core/var.py``.

Reference parity: ``com.twitter.util.Var`` — the reactive primitive that
carries live address sets from namers into load balancers
(consul's SvcAddr produces Var[Addr]; router/core NameTreeFactory
observes them). Design here is synchronous
callback observation plus an asyncio ``changes()`` stream for watch-style
consumers (the namerd control-plane streams ride this).

Updates are deduplicated on equality, matching the reference's behavior of
not waking observers for identical states.
"""

from __future__ import annotations

import asyncio
import logging
from typing import AsyncIterator, Callable, Generic, List, Optional, TypeVar

T = TypeVar("T")
U = TypeVar("U")

log = logging.getLogger(__name__)


class Closable:
    """A handle that detaches an observation when closed."""

    def __init__(self, fn: Callable[[], None]):
        self._fn: Optional[Callable[[], None]] = fn

    def close(self) -> None:
        fn, self._fn = self._fn, None
        if fn is not None:
            fn()

    def __enter__(self) -> "Closable":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def closable_all(*closables: "Closable") -> "Closable":
    def close_all() -> None:
        for c in closables:
            c.close()
    return Closable(close_all)


class Var(Generic[T]):
    """A mutable cell whose observers are notified on (deduplicated) change."""

    def __init__(self, initial: T):
        self._value = initial
        self._observers: List[Callable[[T], None]] = []
        self._version = 0  # monotonic; bumps on every accepted update
        # Subscriptions this Var holds on upstream Vars (for derived cells
        # built by map/collect). close() detaches them so derived cells are
        # evictable — the binding caches rely on this (SURVEY.md §7 hard
        # part 3: eviction vs in-flight observation).
        self._upstream: List[Closable] = []

    # -- reads ------------------------------------------------------------
    def sample(self) -> T:
        return self._value

    @property
    def version(self) -> int:
        return self._version

    # -- writes -----------------------------------------------------------
    def update(self, value: T) -> bool:
        """Set a new value; returns False if deduplicated (no change)."""
        try:
            if value == self._value:
                return False
        except Exception:
            pass  # incomparable values: treat as changed
        self._value = value
        self._version += 1
        for obs in list(self._observers):
            try:
                obs(value)
            except Exception:  # noqa: BLE001 — one bad observer must not
                # starve the rest or unwind into the writer (a namer watch
                # loop updating Var[Addr] must keep running).
                log.exception("Var observer raised; continuing")
        return True

    def close(self) -> None:
        """Detach this Var from its upstreams (derived cells only)."""
        ups, self._upstream = self._upstream, []
        for h in ups:
            h.close()

    # -- observation ------------------------------------------------------
    def observe(self, fn: Callable[[T], None], run_now: bool = True) -> Closable:
        """Register ``fn`` for every change; by default also run immediately
        with the current value (matching Var.changes first-event semantics)."""
        self._observers.append(fn)
        if run_now:
            fn(self._value)

        def detach() -> None:
            try:
                self._observers.remove(fn)
            except ValueError:
                pass

        return Closable(detach)

    @property
    def observer_count(self) -> int:
        return len(self._observers)

    async def changes(self) -> AsyncIterator[T]:
        """Async stream of states, starting with the current one.

        Intermediate states may be conflated (only the latest unseen state is
        yielded), matching the reference's Var semantics where observers see
        the current state, not every historical one.
        """
        loop = asyncio.get_running_loop()
        event = asyncio.Event()

        def wake(_: T) -> None:
            if loop.is_running():
                loop.call_soon_threadsafe(event.set)

        handle = self.observe(wake, run_now=False)
        try:
            # Track versions, not values: values may not support bool(==)
            # (e.g. numpy/JAX arrays), and update() already deduplicated.
            last_version = -1
            while True:
                if self._version != last_version:
                    last_version = self._version
                    yield self._value
                    continue
                event.clear()
                if self._version != last_version:
                    continue
                await event.wait()
        finally:
            handle.close()

    # -- combinators ------------------------------------------------------
    def map(self, fn: Callable[[T], U]) -> "Var[U]":
        """A derived Var; detach it from this one via ``derived.close()``."""
        derived: Var[U] = Var(fn(self._value))
        h = self.observe(lambda v: derived.update(fn(v)), run_now=False)
        derived._upstream.append(h)
        return derived

    @staticmethod
    def collect(vars_: List["Var[T]"]) -> "Var[tuple]":
        """A Var of the tuple of current values of ``vars_``;
        ``derived.close()`` detaches it from all inputs."""
        derived: Var[tuple] = Var(tuple(v.sample() for v in vars_))

        def recompute(_: T) -> None:
            derived.update(tuple(v.sample() for v in vars_))

        for v in vars_:
            derived._upstream.append(v.observe(recompute, run_now=False))
        return derived
