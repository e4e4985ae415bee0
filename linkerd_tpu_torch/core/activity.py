"""Activity — a Var of Pending / Ok / Failed states: a copy of
``linkerd_tpu/core/activity.py``.

Reference parity: ``com.twitter.util.Activity`` — the tri-state reactive
wrapper every namer lookup and interpreter bind returns
(namer/core's ConfiguredDtabNamer.scala returns
Activity[NameTree[Name]]; mesh/Client.scala:105-165 pumps gRPC streams into
Activities with backoff-resume). Getting Pending-vs-Failed and dedup right
here is what makes live re-routing work (SURVEY.md §7 hard part 2).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, AsyncIterator, Callable, Generic, List, TypeVar

from linkerd_tpu_torch.core.var import Closable, Var

T = TypeVar("T")
U = TypeVar("U")


class State(Generic[T]):
    __slots__ = ()


@dataclass(frozen=True)
class Pending(State[T]):
    pass


@dataclass(frozen=True)
class Ok(State[T]):
    value: T


@dataclass(frozen=True)
class Failed(State[T]):
    exc: Exception

    def __eq__(self, other: Any) -> bool:
        # Exceptions don't compare structurally; dedup on type + args.
        return (
            isinstance(other, Failed)
            and type(other.exc) is type(self.exc)
            and other.exc.args == self.exc.args
        )

    def __hash__(self) -> int:
        return hash((type(self.exc), self.exc.args))


PENDING: State = Pending()


class Activity(Generic[T]):
    """A reactive computation that is pending, has a value, or has failed."""

    def __init__(self, states: Var[State[T]]):
        self.states = states

    # -- constructors -----------------------------------------------------
    @staticmethod
    def pending() -> "Activity[T]":
        return Activity(Var(PENDING))

    @staticmethod
    def value(v: T) -> "Activity[T]":
        return Activity(Var(Ok(v)))

    @staticmethod
    def exception(e: Exception) -> "Activity[T]":
        return Activity(Var(Failed(e)))

    @staticmethod
    def mutable(initial: State[T] = PENDING) -> "Activity[T]":
        """An Activity whose state is driven externally via ``.update()``."""
        return Activity(Var(initial))

    # -- state access -----------------------------------------------------
    def sample(self) -> T:
        """Return the current value; raise if pending or failed."""
        st = self.states.sample()
        if isinstance(st, Ok):
            return st.value
        if isinstance(st, Failed):
            raise st.exc
        raise RuntimeError("Activity is pending")

    @property
    def current(self) -> State[T]:
        return self.states.sample()

    def update(self, state: State[T]) -> bool:
        return self.states.update(state)

    def set_value(self, v: T) -> bool:
        return self.states.update(Ok(v))

    def set_exception(self, e: Exception) -> bool:
        return self.states.update(Failed(e))

    # -- combinators ------------------------------------------------------
    def map(self, fn: Callable[[T], U]) -> "Activity[U]":
        def lift(st: State[T]) -> State[U]:
            if isinstance(st, Ok):
                try:
                    return Ok(fn(st.value))
                except Exception as e:  # noqa: BLE001 - map failure becomes Failed
                    return Failed(e)
            return st  # Pending / Failed pass through

        return Activity(self.states.map(lift))

    def close(self) -> None:
        """Detach this (derived) Activity from its upstreams."""
        self.states.close()

    def flat_map(self, fn: Callable[[T], "Activity[U]"]) -> "Activity[U]":
        """Chain a dependent Activity; re-subscribes on every upstream change.
        Detach the result via ``.close()``."""
        out: Var[State[U]] = Var(PENDING)
        inner_handle: List[Closable] = []

        def close_inner() -> None:
            for h in inner_handle:
                h.close()
            inner_handle.clear()

        def on_state(st: State[T]) -> None:
            close_inner()
            if isinstance(st, Ok):
                try:
                    inner = fn(st.value)
                except Exception as e:  # noqa: BLE001
                    out.update(Failed(e))
                    return
                inner_handle.append(inner.states.observe(out.update))
            elif isinstance(st, Failed):
                out.update(st)
            else:
                out.update(PENDING)

        outer = self.states.observe(on_state)
        out._upstream.append(outer)
        out._upstream.append(Closable(close_inner))
        return Activity(out)

    @staticmethod
    def collect(acts: List["Activity[T]"]) -> "Activity[tuple]":
        """All-or-nothing combination: Ok iff every input is Ok (ordered),
        Failed if any failed, else Pending."""
        def combine(states: tuple) -> State[tuple]:
            vals = []
            for st in states:
                if isinstance(st, Failed):
                    return st
                if not isinstance(st, Ok):
                    return PENDING
                vals.append(st.value)
            return Ok(tuple(vals))

        joined = Var.collect([a.states for a in acts])
        out = joined.map(combine)
        # joined is owned exclusively by this chain: cascade close so
        # Activity.collect(...).close() fully detaches from every input.
        out._upstream.append(Closable(joined.close))
        return Activity(out)

    # -- watching ---------------------------------------------------------
    async def changes(self) -> AsyncIterator[State[T]]:
        async for st in self.states.changes():
            yield st

    async def to_future(self) -> T:
        """Wait for the first non-pending state; return value or raise."""
        async for st in self.states.changes():
            if isinstance(st, Ok):
                return st.value
            if isinstance(st, Failed):
                raise st.exc
        raise RuntimeError("activity stream ended while pending")
