"""Owned background tasks: spawn-with-reference + failure logging: a copy of
``linkerd_tpu/core/tasks.py``.

``asyncio.create_task`` holds only a weak reference to the task — a
fire-and-forget spawn can be garbage-collected mid-flight, and an
exception inside it surfaces only at GC time through the loop's
exception handler (i.e. never, in practice). On the data plane that
turns a dead h2 window pump or a failed channel close into a silent
wedge. The l5dlint ``task-leak`` rule (tools/analysis) rejects dropped
spawn results; this module is the sanctioned fix:

- ``spawn(coro, what=...)``  — create the task, hold a strong reference
  in a module-level registry until it completes, and log non-cancelled
  exceptions with the ``what`` label.
- ``monitor(task, what=...)`` — attach the same failure logging to a
  task whose reference the caller already holds (long-lived loops whose
  crash should be loud even though close() cancels them).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Coroutine, Optional, Set

log = logging.getLogger(__name__)

# Strong references to in-flight fire-and-forget tasks (the event loop
# only keeps weak ones). Bounded by liveness: tasks remove themselves on
# completion.
_BACKGROUND: Set["asyncio.Task"] = set()


def _on_done(what: str):
    def cb(task: "asyncio.Task") -> None:
        _BACKGROUND.discard(task)
        if task.cancelled():
            return
        exc = task.exception()
        if exc is not None:
            log.warning("background task %s failed: %r", what, exc)
    return cb


def spawn(coro: Coroutine, *, what: str,
          name: Optional[str] = None) -> "asyncio.Task":
    """Fire-and-forget with ownership: the returned task is also held in
    a module registry until done, and failures are logged (never
    silent). Must be called from a running event loop."""
    task = asyncio.get_running_loop().create_task(coro, name=name or what)
    _BACKGROUND.add(task)
    task.add_done_callback(_on_done(what))
    return task


def monitor(task: "asyncio.Task", *, what: str) -> "asyncio.Task":
    """Attach failure logging to an already-owned task and return it."""
    task.add_done_callback(_on_done(what))
    return task


def pending_count() -> int:
    """Registry depth (observability / test hook)."""
    return len(_BACKGROUND)
