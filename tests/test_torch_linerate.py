"""The port's dispatch ring (linkerd_tpu_torch/telemetry/linerate.py) on
the CPU: the waiter, backpressure and close semantics of the reference
``RingDispatcher`` (``tests/test_line_rate.py``). The CUDA side (pinned
slots, side stream, events) runs in ``tests/test_torch_kernels.py``.
"""

import asyncio
import sys

import numpy as np
import pytest
import torch

from linkerd_tpu_torch.telemetry.linerate import RingDispatcher

CPU = torch.device("cpu")


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, 60))


def row_sums(rows: torch.Tensor) -> torch.Tensor:
    return rows.sum(dim=1)


class TestRingDispatcher:
    def test_dispatch_returns_scores_and_reuses_staging(self):
        seen = []

        def step(rows):
            seen.append(rows.data_ptr())
            return row_sums(rows)

        async def go():
            d = RingDispatcher(4, lambda n: 8, CPU)
            try:
                for v in (1.0, 2.0, 3.0):
                    out = await d.dispatch(np.full((3, 4), v, np.float32),
                                           step)
                    assert out.dtype == np.float32 and out.shape == (3,)
                    assert (out == 4 * v).all()
                # persistent staging: at most depth distinct buffers
                assert len(set(seen)) <= 2
                assert list(d._slots) == [8]
            finally:
                d.close()

        run(go())

    def test_step_sees_only_live_rows(self):
        shapes = []

        def step(rows):
            shapes.append(tuple(rows.shape))
            return row_sums(rows)

        async def go():
            d = RingDispatcher(4, lambda n: 16, CPU)
            try:
                await d.dispatch(np.ones((16, 4), np.float32), step)
                out = await d.dispatch(np.ones((5, 4), np.float32), step)
                assert shapes == [(16, 4), (5, 4)] and out.shape == (5,)
            finally:
                d.close()

        run(go())

    def test_backpressure_waits_for_same_bucket(self):
        async def go():
            d = RingDispatcher(2, lambda n: 4, CPU)
            try:
                held = [d._acquire_nowait(4), d._acquire_nowait(4)]
                assert d._acquire_nowait(4) is None
                t = asyncio.ensure_future(
                    d.dispatch(np.ones((2, 2), np.float32), row_sums))
                await asyncio.sleep(0.05)
                assert not t.done()  # both slots of its bucket are held
                # a free slot of ANOTHER bucket does not admit it
                other = d._acquire_nowait(8)
                d._release(other)
                await asyncio.sleep(0.05)
                assert not t.done()
                d._release(held[0])
                assert (await t == 2.0).all()
                d._release(held[1])
            finally:
                d.close()

        run(go())

    def test_many_in_flight_all_complete(self):
        async def go():
            d = RingDispatcher(3, lambda n: 4, CPU)
            try:
                xs = [np.full((3, 3), i, np.float32) for i in range(16)]
                outs = await asyncio.gather(
                    *(d.dispatch(x, row_sums) for x in xs))
                for i, o in enumerate(outs):
                    assert (o == 3 * i).all()
                assert len(d._slots[4]) == 2
                assert not any(s.busy for s in d._slots[4])
            finally:
                d.close()

        run(go())

    def test_stress_mixed_buckets_under_fast_thread_switching(self):
        """The event loop and the drainer thread share the slot ring
        under one lock. With thread switches forced every microsecond,
        many concurrent dispatches over four buckets each get their own
        rows' scores back, and every slot ends free."""

        async def go():
            d = RingDispatcher(4, lambda n: 1 << max(0, n - 1).bit_length(),
                               CPU)
            rng = np.random.default_rng(0)
            xs = [rng.standard_normal((int(rng.integers(1, 9)), 4)).astype(
                np.float32) for _ in range(300)]
            try:
                outs = await asyncio.gather(
                    *(d.dispatch(x, row_sums) for x in xs))
                for x, o in zip(xs, outs):
                    np.testing.assert_allclose(o, x.sum(axis=1), rtol=1e-6)
                assert sorted(d._slots) == [1, 2, 4, 8]
                assert not any(s.busy for slots in d._slots.values()
                               for s in slots)
                assert not d._waiters
            finally:
                d.close()

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            run(go())
        finally:
            sys.setswitchinterval(old)

    def test_step_exception_releases_slot(self):
        def boom(rows):
            raise RuntimeError("no")

        async def go():
            d = RingDispatcher(2, lambda n: 4, CPU)
            try:
                for _ in range(5):  # a leaked slot would deadlock
                    with pytest.raises(RuntimeError, match="no"):
                        await d.dispatch(np.ones((2, 2), np.float32), boom)
                with pytest.raises(ValueError):  # wrong width
                    await d.dispatch(np.ones((2, 3), np.float32), row_sums)
                out = await d.dispatch(np.ones((2, 2), np.float32), row_sums)
                assert (out == 2.0).all()
            finally:
                d.close()

        run(go())

    def test_close_rejects_new_dispatch_and_joins_drainer(self):
        async def go():
            d = RingDispatcher(2, lambda n: 4, CPU)
            await d.dispatch(np.ones((1, 2), np.float32), row_sums)
            thread = d._thread
            d.close()
            thread.join(timeout=5)
            assert not thread.is_alive()
            with pytest.raises(RuntimeError, match="closed"):
                await d.dispatch(np.ones((1, 2), np.float32), row_sums)

        run(go())
