"""Line-rate score dispatch: counterpart of ``RingDispatcher`` in
``linkerd_tpu/telemetry/linerate.py``.

``RingDispatcher`` keeps, per batch bucket, two persistent staging
slots in pinned host memory. A dispatch copies the batch into a free
slot and, on one side CUDA stream, issues the non-blocking
host-to-device copy and the score step, copies the scores back into the
slot's pinned output buffer, and records the slot's event. A single
drainer thread waits on each event in turn, slices the live rows off,
and resolves the caller's asyncio future, so the event loop never waits
on the device and batch N's copy overlaps batch N-1's kernel. A slot is
released only after its event, which is also when the pinned staging
memory is safe to refill.

Device memory that a step reads must be allocated on ``stream`` (see
``device_context``): the caching allocator then reuses a freed block
only for later work on the same stream, so tensors dropped while a
batch is in flight (a hot-swapped model) stay valid until it is done.
"""

from __future__ import annotations

import asyncio
import atexit
import contextlib
import queue
import threading
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

# Every live dispatcher's drainer is woken and joined before the
# interpreter finalizes: a daemon thread woken during finalization dies
# inside native frames and can abort the process after a clean run.
_LIVE_DISPATCHERS: "weakref.WeakSet" = weakref.WeakSet()


def _shutdown_drainers() -> None:
    for d in list(_LIVE_DISPATCHERS):
        d._queue.put(None)
        t = d._thread
        if t is not None and t.is_alive():
            t.join(timeout=2.0)


atexit.register(_shutdown_drainers)


class _Slot:
    """One staging slot of a bucket's ring: pinned input rows, pinned
    output scores, and the event that marks the batch done. ``busy``
    from dispatch until the drainer has read the scores back; touched
    under the dispatcher lock."""

    __slots__ = ("staging", "out", "event", "busy", "bucket")

    def __init__(self, bucket: int, in_dim: int, device: torch.device):
        cuda = device.type == "cuda"
        self.staging = torch.empty((bucket, in_dim), dtype=torch.float32,
                                   pin_memory=cuda)
        self.out = torch.empty(bucket, dtype=torch.float32, pin_memory=cuda)
        self.event = torch.cuda.Event() if cuda else None
        self.bucket = bucket
        self.busy = False


Step = Callable[[torch.Tensor], torch.Tensor]

DEPTH = 2  # slots per bucket: batches of one bucket in flight at once


class RingDispatcher:
    """Double-buffered score dispatch onto ``device``.

    ``dispatch(x, step)`` copies ``x`` (float32 [n, D]) into a staging
    slot of the batch's bucket and calls ``step(rows)`` with the slot's
    first ``n`` rows, a host tensor; ``step`` moves them to the device
    and returns the [n] scores there. The awaitable resolves to a
    float32 numpy [n] once the drainer has read them back. ``DEPTH``
    slots per bucket bound the batches in flight; a dispatch that finds
    none free waits for one of its own bucket.

    On a CPU device the same ring runs without stream or events: the
    step's result is ready when it returns.
    """

    def __init__(self, in_dim: int, bucket_fn: Callable[[int], int],
                 device: torch.device):
        self.in_dim = in_dim
        self.device = torch.device(device)
        self._bucket_fn = bucket_fn
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self._slots: Dict[int, List[_Slot]] = {}
        self._waiters: List[Tuple[int, asyncio.AbstractEventLoop,
                                  asyncio.Future]] = []
        self._lock = threading.Lock()
        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        # a collected dispatcher must not leak its drainer
        self._finalizer = weakref.finalize(self, self._queue.put, None)
        _LIVE_DISPATCHERS.add(self)

    def device_context(self):
        """Context in which to allocate tensors that steps read: the
        dispatch stream on CUDA (see the module docstring)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    # -- drainer ----------------------------------------------------------
    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._drain_loop, name="l5d-score-drainer",
                daemon=True)
            self._thread.start()

    def _drain_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            n, loop, fut, slot = item
            out: Optional[np.ndarray] = None
            err: Optional[BaseException] = None
            try:
                # the only wait on the device, on this thread
                if slot.event is not None:
                    slot.event.synchronize()
                out = slot.out[:n].numpy().copy()
            except Exception as e:  # noqa: BLE001 — surfaced via fut
                err = e
            self._release(slot)
            try:
                if err is None:
                    loop.call_soon_threadsafe(self._resolve, fut, out)
                else:
                    loop.call_soon_threadsafe(self._reject, fut, err)
            except RuntimeError:
                pass  # loop already closed; the result is moot

    @staticmethod
    def _resolve(fut: asyncio.Future, out: np.ndarray) -> None:
        if not fut.done():
            fut.set_result(out)

    @staticmethod
    def _reject(fut: asyncio.Future, err: BaseException) -> None:
        if not fut.done():
            fut.set_exception(err)

    # -- slot ring --------------------------------------------------------
    def _acquire_nowait(self, bucket: int) -> Optional[_Slot]:
        slots = self._slots.get(bucket)
        if slots is None:
            slots = [_Slot(bucket, self.in_dim, self.device)
                     for _ in range(DEPTH)]
            self._slots[bucket] = slots
        for s in slots:
            if not s.busy:
                s.busy = True
                return s
        return None

    async def _acquire(self, bucket: int) -> _Slot:
        loop = asyncio.get_running_loop()
        while True:
            waiter: Optional[asyncio.Future] = None
            with self._lock:
                slot = self._acquire_nowait(bucket)
                if slot is None:
                    waiter = loop.create_future()
                    self._waiters.append((bucket, loop, waiter))
            if slot is not None:
                return slot
            await waiter  # backpressure: every slot of the bucket in flight

    def _release(self, slot: _Slot) -> None:
        """Free ``slot`` and wake the oldest waiter for the same bucket
        (a freed bucket-A slot cannot admit a bucket-B dispatch)."""
        wake: List[Tuple[asyncio.AbstractEventLoop, asyncio.Future]] = []
        with self._lock:
            slot.busy = False
            still = []
            for bucket, loop, fut in self._waiters:
                if fut.done():
                    continue
                if bucket == slot.bucket and not wake:
                    wake.append((loop, fut))
                else:
                    still.append((bucket, loop, fut))
            self._waiters = still
        for loop, fut in wake:
            try:
                loop.call_soon_threadsafe(self._resolve_waiter, fut)
            except RuntimeError:
                pass

    @staticmethod
    def _resolve_waiter(fut: asyncio.Future) -> None:
        if not fut.done():
            fut.set_result(None)

    # -- dispatch ---------------------------------------------------------
    def _launch(self, slot: _Slot, n: int, step: Step) -> None:
        with self.device_context():
            result = step(slot.staging[:n])
            slot.out[:n].copy_(result, non_blocking=True)
            if slot.event is not None:
                slot.event.record(self.stream)

    async def dispatch(self, x: np.ndarray, step: Step) -> np.ndarray:
        """Score one batch through the ring; returns float32 [n]."""
        if self._closed:
            raise RuntimeError("dispatcher closed")
        n = len(x)
        loop = asyncio.get_running_loop()
        bucket = int(self._bucket_fn(n))
        slot = await self._acquire(bucket)
        if self._closed:  # close() may have raced the acquire
            self._release(slot)
            raise RuntimeError("dispatcher closed")
        try:
            slot.staging[:n].numpy()[...] = x
            self._launch(slot, n, step)
        except BaseException:
            self._release(slot)
            raise
        fut = loop.create_future()
        self._ensure_thread()
        self._queue.put((n, loop, fut, slot))
        return await fut

    def close(self) -> None:
        self._closed = True
        self._finalizer()  # idempotent: enqueues the drainer sentinel
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)
        # a dispatch that raced close() past the sentinel would wait
        # forever on an item the drainer never saw: reject it instead
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is None:
                continue
            _n, loop, fut, slot = item
            self._release(slot)
            try:
                loop.call_soon_threadsafe(
                    self._reject, fut, RuntimeError("dispatcher closed"))
            except RuntimeError:
                pass
