"""The port's native engine feed against the JAX package's, on the CPU:
``NativeFeatureRing``, ``NativeFeaturizer`` (with ``RouteTemporal``) and
the ``io.l5d.jaxAnomaly`` telemeter's native ring path
(``native_committed``, ``set_native_route_resolver``, ``_take_batch``'s
split of engine-scored and unscored rows, ``_score_and_publish``).

Inputs are engine rows (``NATIVE_ROW_WIDTH`` floats: route id, latency,
status, bytes, timestamp, in-plane score and scored flag, ...) made from
numpy seeds. Bounds: the ring's state and every consumed view equal;
encoded features bit-equal; through the telemeters, with the same
snapshot and no training, counters equal, the rows each fit would take
bit-equal, and boards and ``dst/*`` gauges within 1e-3 (bf16 scores of
the unscored rows against the JAX scorer's jit, as
``tests/test_torch_telemeter.py`` bounds them).
"""

import asyncio

import numpy as np
import pytest

from linkerd_tpu.telemetry import linerate as ref
from linkerd_tpu_torch.telemetry import linerate as port
from tests.test_torch_telemeter import (
    BOARD_ATOL, board_gap, dst_gauges, start_snapshot, telemeters,
)

ROUTE_IDS = 6          # route ids 0..5; id 5 stays unresolved


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def engine_rows(rng, n, scored_share=0.5):
    """``n`` engine rows over ROUTE_IDS routes: a tenth slow and 5xx,
    ``scored_share`` of them carrying an in-plane score."""
    rows = np.zeros((n, port.NATIVE_ROW_WIDTH), np.float32)
    bad = rng.random(n) < 0.1
    rows[:, 0] = rng.integers(ROUTE_IDS, size=n)
    rows[:, 1] = np.where(bad, rng.gamma(2.0, 150.0, n),
                          rng.gamma(2.0, 4.0, n))
    rows[:, 2] = np.where(bad, rng.choice([500, 503], n),
                          rng.choice([200, 200, 204, 404], n))
    rows[:, 3] = rng.integers(0, 1 << 14, n)
    rows[:, 4] = rng.integers(0, 1 << 18, n)
    rows[:, 5] = np.sort(rng.uniform(0, 10, n))
    rows[:, port.NATIVE_COL_SCORED] = rng.random(n) < scored_share
    rows[:, port.NATIVE_COL_SCORE] = np.where(
        rows[:, port.NATIVE_COL_SCORED] > 0, rng.random(n), 0.0)
    return rows


def resolver(rid):
    return None if rid == ROUTE_IDS - 1 else f"/svc/route-{rid}"


def test_constants_equal():
    for name in ("NATIVE_ROW_WIDTH", "NATIVE_COL_SCORE", "NATIVE_COL_SCORED",
                 "NATIVE_COL_TENANT", "NATIVE_COL_KIND", "NATIVE_COL_STREAM",
                 "NATIVE_COL_SEQ", "NATIVE_KIND_REQUEST",
                 "NATIVE_KIND_STREAM", "NATIVE_KIND_TUNNEL"):
        assert getattr(port, name) == getattr(ref, name), name


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ring_matches_reference(seed):
    """One seeded sequence of produce (filling fewer rows than offered
    now and then), commit, consume and drop on both rings."""
    rng = np.random.default_rng(seed)
    rings = ref.NativeFeatureRing(37), port.NativeFeatureRing(37)
    for _ in range(300):
        op = rng.integers(3)
        if op == 0:
            ask = int(rng.integers(1, 30))
            block = engine_rows(rng, ask)
            partial, frac = rng.random() < 0.2, rng.random()
            for r in rings:
                off = 0
                for view in r.produce_views(ask):
                    k = int(frac * len(view)) if partial else len(view)
                    view[:k] = block[off:off + k]
                    off += k
                    if k < len(view):
                        break
                r.commit(off)
        elif op == 1:
            m = int(rng.integers(1, 40))
            a, b = (r.consume(m) for r in rings)
            assert np.array_equal(a, b)
        else:
            d = int(rng.integers(5))
            for r in rings:
                r.drop(d)
        a, b = rings
        assert (a.head, a.count, a.dropped, a.free, len(a)) == \
            (b.head, b.count, b.dropped, b.free, len(b))
    with pytest.raises(ValueError):
        rings[1].commit(rings[1].free + 1)
    with pytest.raises(ValueError):
        port.NativeFeatureRing(0)


@pytest.mark.parametrize("seed", [0, 1])
def test_featurizer_encodes_bit_equal(seed):
    """Seeded blocks in sequence, so the per-route drift state evolves;
    route 5 unresolved (an uncached placeholder) until the third
    block."""
    rng = np.random.default_rng(seed)
    known = {}

    def res(rid):
        return known.get(rid, resolver(rid))

    fs = ref.NativeFeaturizer(resolver=res), port.NativeFeaturizer(
        resolver=res)
    for i in range(6):
        if i == 2:
            known[ROUTE_IDS - 1] = "/svc/late"
        block = engine_rows(rng, int(rng.integers(1, 300)))
        (xa, ia, da), (xb, ib, db) = (f.encode_block(block) for f in fs)
        assert np.array_equal(xa, xb) and np.array_equal(ia, ib)
        assert da == db
        assert xb.dtype == np.float32 and xb.shape == (len(block), 36)
    assert fs[0].temporal._ewma == fs[1].temporal._ewma
    assert fs[0].temporal._dev == fs[1].temporal._dev
    empty = fs[1].encode_block(np.zeros((0, port.NATIVE_ROW_WIDTH),
                                        np.float32))
    assert empty[0].shape == (0, 36) and empty[2] == []


@pytest.fixture(scope="module")
def snap():
    return start_snapshot()


def commit(tele, block):
    """Write ``block`` into the telemeter's native ring as the
    controller does, then ``native_committed``."""
    off = 0
    for view in tele.native_ring.produce_views(len(block)):
        view[:] = block[off:off + len(view)]
        off += len(view)
    tele.native_ring.commit(off)
    tele.native_committed(off, dropped=len(block) - off)
    if off < len(block):
        tele.native_ring.drop(len(block) - off)


@pytest.mark.parametrize("scored_share", [0.0, 0.5, 1.0])
def test_telemeters_native_feed_match(snap, scored_share):
    """The same seeded blocks, engine-scored and unscored mixed, through
    both telemeters' native rings (one block past the ring's capacity,
    so rows are shed and counted): counters equal, the rows a fit takes
    bit-equal, boards and gauges within BOARD_ATOL."""
    async def go():
        cfg = dict(maxBatch=64, trainEveryBatches=2, ringCapacity=256)
        rt, pt, rm, pm = telemeters(snap, cfg)
        fits = ([], [])
        for tele, log in zip((rt, pt), fits):
            tele.set_native_route_resolver(resolver)

            async def fit(x, labels, mask, log=log):
                log.append((x.copy(), labels.copy(), mask.copy()))
                return 0.5

            tele._scorer.fit = fit
        rng = np.random.default_rng(3)
        try:
            for n in (50, 130, 300, 20):
                block = engine_rows(rng, n, scored_share)
                for tele in (rt, pt):
                    commit(tele, block)
                while any(len(t.native_ring) for t in (rt, pt)):
                    for t in (rt, pt):
                        await t.drain_once()
            rf, pf = rm.flatten(), pm.flatten()
            for k in ("requests_total", "scored_total",
                      "native_scored_total", "batches", "score_failures",
                      "native_ring_dropped", "native_ring_depth",
                      "scored_fraction", "native_scored_fraction"):
                assert pf[f"anomaly/{k}"] == rf[f"anomaly/{k}"], k
            assert pf["anomaly/requests_total"] == 500
            assert pf["anomaly/native_ring_dropped"] == 300 - 256
            assert sorted(pf) == sorted(rf)
            assert len(fits[1]) == len(fits[0]) > 0
            for a, b in zip(*fits):
                for u, v in zip(a, b):
                    assert np.array_equal(u, v)
            gap = board_gap(rt.board, pt.board)
            gauges = dst_gauges(rf)
            ggap = max(abs(pf[k] - v) for k, v in gauges.items())
            print(f"board max|diff| {gap:.3e}, dst gauges {ggap:.3e}")
            assert gap <= BOARD_ATOL and ggap <= BOARD_ATOL
            assert sorted(rt.board.scores.sample()) == sorted(
                pt.board.scores.sample())
            got, want = pt.native_tier_state(), rt.native_tier_state()
            for k in ("native_scored_total", "native_scored_fraction"):
                assert got[k] == want[k], k
        finally:
            rt.close()
            pt.close()

    run(go())
