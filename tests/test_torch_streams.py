"""The port's stream sentinel and connection guard against the JAX
package's, on the CPU.

- ``streams/`` (copies of the reference's package): the frame-delta
  tracker bit-identical to the port's engine accumulator
  (``native.stream_accum``) and to the reference's tracker on seeded
  traces; the tracker, the sentinel's governor and bounded table, and
  the h2 frame observer on a stub connection, as the reference's tests
  hold them.
- The h1 tunnel relay of the port's Python server and client (101
  Upgrade and CONNECT), as the reference's tests hold it.
- The port's engine: the stream config and its snapshot, a 101 tunnel
  through the engine sampled into kind-2 feature rows, and the h1
  connection guard (slowloris and body-stall budgets, the accept
  throttle), counterparts of the reference's h1 guard cases.
- The port's linker: a fastPath router's kind-2 rows reach the Python
  sentinel and the telemeter's batches, as the reference's controller
  sends them, and ``/streams.json`` shows the engine's table and the
  sentinel's.

Every socket wait has its own deadline of at most 30 s.
"""

import asyncio
import contextlib
import itertools
import json

import numpy as np
import pytest

from linkerd_tpu.streams import StreamTracker as RefTracker
from linkerd_tpu.testing.faults import ConnectionChurnAttack, SlowlorisAttack
from linkerd_tpu_torch import native
from linkerd_tpu_torch.streams import (
    ACTION_OBSERVE, ACTION_RST, FRAME_ANOMALY, FRAME_DATA,
    FRAME_WINDOW_UPDATE, H2FrameObserver, StreamSentinel, StreamTracker,
    fold_key, stream_feature_vector,
)
from linkerd_tpu_torch.telemetry.linerate import (
    NATIVE_COL_KIND, NATIVE_COL_SCORE, NATIVE_COL_SCORED, NATIVE_COL_SEQ,
    NATIVE_COL_STREAM, NATIVE_KIND_TUNNEL, NATIVE_ROW_WIDTH,
)

WAIT_S = 10
ENHANCE_YOUR_CALM = 0xB  # the h2 error code the observer sheds with


def bounded(aw, timeout=WAIT_S):
    return asyncio.wait_for(aw, timeout)


def run(coro, timeout=30):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def until(cond, what: str, timeout=WAIT_S):
    t0 = asyncio.get_running_loop().time()
    while not cond():
        if asyncio.get_running_loop().time() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.01)


@pytest.fixture(scope="module")
def engine_lib():
    """The port's engine library, built before any event loop runs."""
    native.ensure_built()


# -- the tracker against the engine's accumulator --------------------------


def trace(seed, n=500):
    rng = np.random.default_rng(seed)
    kinds = rng.integers(0, 3, size=n).astype(np.int32)
    gaps = (rng.random(n, dtype=np.float32) * 250.0).astype(np.float32)
    sizes = (rng.random(n, dtype=np.float32) * 65536.0).astype(np.float32)
    return kinds, gaps, sizes


def tracked(cls, kinds, gaps, sizes) -> np.ndarray:
    t = cls()
    for k, g, s in zip(kinds, gaps, sizes):
        t.frame(int(k), float(g), float(s))
    return t.as_row()


class TestFeaturizationParity:
    """The port's tracker reproduces the engine's float32 EWMA arithmetic
    bit for bit, and the reference's tracker on the same trace."""

    @pytest.mark.parametrize("seed", [7, 1234, 99991])
    def test_bit_identical_accumulators(self, seed, engine_lib):
        kinds, gaps, sizes = trace(seed)
        want = native.stream_accum(kinds, gaps, sizes)
        got = tracked(StreamTracker, kinds, gaps, sizes)
        ref = tracked(RefTracker, kinds, gaps, sizes)
        assert got.dtype == want.dtype == ref.dtype == np.float32
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), \
            f"C={want} port={got}"
        assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))

    def test_data_only_trace_bit_identical(self, engine_lib):
        n = 256
        kinds = np.zeros(n, np.int32)
        gaps = np.linspace(0.5, 900.0, n).astype(np.float32)
        sizes = np.geomspace(1.0, 1e6, n).astype(np.float32)
        want = native.stream_accum(kinds, gaps, sizes)
        got = tracked(StreamTracker, kinds, gaps, sizes)
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))

    def test_bad_kind_and_length_rejected(self, engine_lib):
        with pytest.raises(ValueError):
            native.stream_accum([7], [1.0], [1.0])
        with pytest.raises(ValueError):
            native.stream_accum([0, 0], [1.0], [1.0])


class TestStreamTracker:
    def test_frame_kinds_update_the_right_counters(self):
        t = StreamTracker()
        t.frame(FRAME_DATA, 10.0, 100.0)
        t.frame(FRAME_WINDOW_UPDATE, 5.0)
        t.frame(FRAME_ANOMALY, 1.0)
        assert (t.frames, t.data_frames, t.wu_frames, t.anomalies) == \
            (3, 1, 1, 1)
        assert t.bytes == 100

    def test_first_frame_seeds_the_ewmas(self):
        t = StreamTracker()
        t.frame(FRAME_DATA, 42.0, 1000.0)
        assert float(t.gap_ewma_ms) == 42.0
        assert float(t.bpf_ewma) == 1000.0
        assert float(t.gap_dev_ms) == 0.0

    def test_feature_vector_reflects_anomalies(self):
        t = StreamTracker()
        t.frame(FRAME_DATA, 10.0, 100.0)
        x_ok = stream_feature_vector(t, "/svc/a")
        t.frame(FRAME_ANOMALY, 1.0)
        x_bad = stream_feature_vector(t, "/svc/a")
        # status one-hot: 2xx while clean, 5xx once the stream misbehaves
        assert x_ok[2] == 1.0 and x_bad[5] == 1.0

    def test_fold_key_is_24_bit_and_never_zero(self):
        assert fold_key(0x1FFFFFF) == 0xFFFFFF
        assert fold_key(0x1000000) == 1  # folds to 0 -> reserved 1
        assert fold_key(42) == 42


# -- the sentinel: governor and bounded table -------------------------------


def mk_sentinel(**kw):
    kw.setdefault("enter", 0.7)
    kw.setdefault("exit", 0.3)
    kw.setdefault("quorum", 2)
    kw.setdefault("dwell_s", 0.0)
    return StreamSentinel(**kw)


def stream_rows(key=77, n=12):
    """Two rows the sentinel skips (a request row, a stream row with key
    0), then ``n`` scored stream samples of ``key`` at score 1.0."""
    rows = np.zeros((n + 2, NATIVE_ROW_WIDTH), np.float32)
    rows[1, NATIVE_COL_KIND] = 1.0
    for i in range(2, n + 2):
        rows[i, NATIVE_COL_KIND] = 1.0
        rows[i, NATIVE_COL_STREAM] = float(key)
        rows[i, NATIVE_COL_SEQ] = float(i * 8)
        rows[i, NATIVE_COL_SCORE] = 1.0
        rows[i, NATIVE_COL_SCORED] = 1.0
    return rows


class TestStreamSentinel:
    def test_sick_edge_fires_rst_exactly_once(self):
        shed = []
        s = mk_sentinel(on_rst=shed.append)
        for i in range(12):
            s.observe(5, 1.0, now=100.0 + i)
        assert [e.key for e in shed] == [5]
        assert s.sick_transitions == 1 and s.actions_fired == 1

    def test_quorum_gates_flappy_scores(self):
        shed = []
        s = mk_sentinel(on_rst=shed.append, quorum=3)
        for i in range(30):
            s.observe(9, 1.0 if i % 2 == 0 else 0.0, now=100.0 + i)
        assert shed == []

    def test_observe_action_never_fires_callbacks(self):
        shed = []
        s = mk_sentinel(action=ACTION_OBSERVE, on_rst=shed.append)
        for i in range(12):
            got = s.observe(1, 1.0, now=100.0 + i)
        assert got is None or got == ACTION_OBSERVE
        assert shed == [] and s.sick_transitions == 1
        assert s.actions_fired == 0

    def test_unscored_samples_never_move_the_governor(self):
        shed = []
        s = mk_sentinel(on_rst=shed.append)
        for i in range(20):
            s.observe(3, 1.0, scored=False, now=100.0 + i)
        assert shed == [] and s.sick_transitions == 0
        assert s.entry(3).samples == 20 and s.entry(3).scored == 0

    def test_hostile_churn_stays_bounded(self):
        s = mk_sentinel(table_cap=64)
        for k in range(1, 10_001):
            s.open(k, now=float(k))
            s.observe(k, 0.1, now=float(k))
            s.close(k, now=float(k))
        assert len(s) <= 64
        assert s.evicted == 10_000 - 64
        assert len(s._gov.keys()) <= 64

    def test_live_streams_are_never_evicted(self):
        s = mk_sentinel(table_cap=8)
        for k in range(1, 9):
            s.open(k, now=float(k))
        for k in range(100, 200):
            s.open(k, now=float(k))
            s.close(k, now=float(k))
        assert all(s.entry(k) is not None for k in range(1, 9))

    def test_route_pinned_at_open(self):
        s = mk_sentinel()
        s.open(7, route="/svc/a", now=1.0)
        s.open(7, route="/svc/b", now=2.0)  # re-open: liveness refresh
        assert s.entry(7).route == "/svc/a"

    def test_ingest_rows_skips_request_rows_and_fires_on_streams(self):
        shed = []
        s = mk_sentinel(on_rst=shed.append)
        fired = s.ingest_rows(stream_rows(), now=100.0)
        assert fired == 1 and [e.key for e in shed] == [77]
        assert s.entry(77).frames == 13 * 8
        assert len(s._streams) == 1

    def test_snapshot_shape_matches_native_streams_json(self, engine_lib):
        s = mk_sentinel()
        s.open(3, route="/svc/x", now=1.0)
        s.observe(3, 0.4, now=2.0)
        snap = s.snapshot()
        assert snap["enabled"] is True and snap["count"] == 1
        ent = snap["by_stream"]["3"]
        for field in ("kind", "samples", "scored", "score_ewma",
                      "frames", "bytes", "sick", "live"):
            assert field in ent
        assert ent["route"] == "/svc/x"
        eng = native.FastPathEngine()
        try:
            eng.set_stream_cfg(action="observe")
            doc = eng.streams()
        finally:
            eng.close()
        assert {"enabled", "count", "evicted", "sick_transitions",
                "by_stream"} <= set(doc) & set(snap)

    def test_score_ewma_matches_native_alpha(self):
        s = mk_sentinel()
        want = np.float32(0.0)
        for i, score in enumerate([1.0, 0.5, 0.25, 1.0]):
            s.observe(1, score, now=100.0 + i)
            want = np.float32(want + np.float32(
                np.float32(0.25) * np.float32(np.float32(score) - want)))
        assert s.entry(1).score_ewma.view(np.uint32) == want.view(np.uint32)


# -- the h2 frame observer on a stub connection -----------------------------


class _StubConn:
    def __init__(self):
        self.sheds = []

    def shed_stream(self, sid, code=ENHANCE_YOUR_CALM):
        self.sheds.append((sid, code))
        return True


def mk_observer(scorer=None, action="rst"):
    sent = mk_sentinel(action=ACTION_RST if action == "rst"
                       else ACTION_OBSERVE)
    keys = itertools.count(1)
    obs = H2FrameObserver(sent, next_skey=lambda: next(keys),
                          scorer=scorer, sample_every_frames=2,
                          min_gap_ms=0, action=action)
    conn = _StubConn()
    return obs.bind(conn), conn, sent


class TestH2FrameObserver:
    def test_sampling_cadence_respects_frame_budget(self):
        samples = []
        obs, _, _ = mk_observer(scorer=lambda x: samples.append(1) or 0.0)
        for i in range(10):
            obs.on_frame(1, FRAME_DATA, 10, now=float(i))
        assert len(samples) == 5

    def test_min_gap_bounds_sampling_rate(self):
        samples = []
        obs, _, _ = mk_observer(scorer=lambda x: samples.append(1) or 0.0)
        obs.min_gap_s = 1.0
        for i in range(10):
            obs.on_frame(1, FRAME_DATA, 10, now=100.0 + i * 0.01)
        assert len(samples) == 1

    def test_sick_stream_is_shed_and_closed(self):
        obs, conn, _ = mk_observer(scorer=lambda x: 1.0)
        for i in range(40):
            obs.on_frame(9, FRAME_DATA, 100, now=100.0 + i)
            if conn.sheds:
                break
        assert conn.sheds and conn.sheds[0] == (9, ENHANCE_YOUR_CALM)
        assert obs.sheds == 1
        assert 9 not in obs._slots

    def test_observe_action_detects_but_never_sheds(self):
        obs, conn, sent = mk_observer(scorer=lambda x: 1.0,
                                      action="observe")
        for i in range(40):
            obs.on_frame(9, FRAME_DATA, 100, now=100.0 + i)
        assert sent.sick_transitions == 1
        assert conn.sheds == [] and obs.sheds == 0

    def test_no_scorer_never_sheds(self):
        obs, conn, _ = mk_observer(scorer=None)
        for i in range(40):
            obs.on_frame(9, FRAME_DATA, 100, now=100.0 + i)
        assert conn.sheds == []

    def test_close_marks_all_streams_closed(self):
        obs, _, sent = mk_observer()
        for sid in (1, 3, 5):
            obs.on_frame(sid, FRAME_DATA, 10, now=100.0)
        obs.close()
        assert obs._slots == {}
        assert all(not e.live for e in sent._streams.values())

    def test_chaos_one_sick_stream_neighbors_untouched(self):
        big = np.log1p(10_000.0)
        obs, conn, _ = mk_observer(
            scorer=lambda x: 1.0 if x[8] > big else 0.0)
        healthy = list(range(1, 41, 2))[:20]
        sick = 99
        for i in range(40):
            now = 100.0 + i
            for sid in healthy:
                obs.on_frame(sid, FRAME_DATA, 64, now=now)
            obs.on_frame(sick, FRAME_DATA, 60_000, now=now)
        assert conn.sheds and {s for s, _ in conn.sheds} == {sick}


# -- h1 tunnels through the port's Python server and client -----------------


async def echo_upstream():
    """A raw upstream that speaks 101-upgrade and CONNECT, then echoes
    every byte prefixed with ``echo:``."""

    async def on_conn(reader, writer):
        try:
            data = b""
            while b"\r\n\r\n" not in data:
                chunk = await reader.read(1024)
                if not chunk:
                    return
                data += chunk
            if data.startswith(b"CONNECT"):
                writer.write(b"HTTP/1.1 200 Connection established\r\n\r\n")
            else:
                writer.write(b"HTTP/1.1 101 Switching Protocols\r\n"
                             b"Upgrade: echo\r\nConnection: Upgrade\r\n\r\n")
            await writer.drain()
            while True:
                chunk = await reader.read(65536)
                if not chunk:
                    break
                writer.write(b"echo:" + chunk)
                await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()

    return await asyncio.start_server(on_conn, "127.0.0.1", 0)


async def open_raw(port, head: bytes):
    reader, writer = await bounded(asyncio.open_connection("127.0.0.1",
                                                           port))
    writer.write(head)
    await bounded(writer.drain())
    data = b""
    while b"\r\n\r\n" not in data:
        chunk = await bounded(reader.read(1024))
        assert chunk, f"closed before response head: {data!r}"
        data += chunk
    end = data.index(b"\r\n\r\n") + 4
    return reader, writer, data[:end], data[end:]


async def echo_round(reader, writer, payload: bytes, rest=b"") -> bytes:
    writer.write(payload)
    await bounded(writer.drain())
    got = rest
    while len(got) < len(payload) + 5:
        chunk = await bounded(reader.read(65536))
        assert chunk, f"tunnel closed after {got!r}"
        got += chunk
    return got


UPGRADE = (b"GET /ws HTTP/1.1\r\nHost: ws\r\nConnection: Upgrade\r\n"
           b"Upgrade: echo\r\n\r\n")


class TestH1Tunnels:
    async def front(self):
        from linkerd_tpu_torch.protocol.http.client import HttpClient
        from linkerd_tpu_torch.protocol.http.server import HttpServer

        upstream = await echo_upstream()
        client = HttpClient("127.0.0.1",
                            upstream.sockets[0].getsockname()[1],
                            max_connections=2)
        front = await HttpServer(client).start()
        return upstream, client, front

    async def released(self, client):
        await until(lambda: client._n_open == 0, "the pool slot freed")

    def test_websocket_style_upgrade_tunnels_bytes(self):
        async def go():
            upstream, client, front = await self.front()
            try:
                reader, writer, head, rest = await open_raw(
                    front.bound_port, UPGRADE)
                assert b"101" in head.split(b"\r\n")[0]
                assert await echo_round(reader, writer, b"hello",
                                        rest) == b"echo:hello"
                writer.close()
                await self.released(client)
            finally:
                await front.close()
                await client.close()
                upstream.close()

        run(go())

    def test_connect_tunnels_bytes(self):
        async def go():
            upstream, client, front = await self.front()
            try:
                reader, writer, head, rest = await open_raw(
                    front.bound_port, b"CONNECT example.test:443 HTTP/1.1"
                    b"\r\nHost: example.test:443\r\n\r\n")
                assert b" 200" in head.split(b"\r\n")[0]
                assert await echo_round(reader, writer, b"tls-ish bytes",
                                        rest) == b"echo:tls-ish bytes"
                writer.close()
            finally:
                await front.close()
                await client.close()
                upstream.close()

        run(go())

    def test_unsolicited_101_is_a_gateway_error(self):
        async def go():
            upstream, client, front = await self.front()
            try:
                _, writer, head, _ = await open_raw(
                    front.bound_port,
                    b"GET /no-upgrade HTTP/1.1\r\nHost: x\r\n\r\n")
                assert b"502" in head.split(b"\r\n")[0]
                writer.close()
                await self.released(client)
            finally:
                await front.close()
                await client.close()
                upstream.close()

        run(go())

    def test_plain_requests_still_pool(self):
        from linkerd_tpu_torch.protocol.http.client import HttpClient
        from linkerd_tpu_torch.protocol.http.message import Request

        async def go():
            async def on_conn(reader, writer):
                try:
                    while True:
                        await reader.readuntil(b"\r\n\r\n")
                        writer.write(b"HTTP/1.1 200 OK\r\n"
                                     b"Content-Length: 2\r\n\r\nok")
                        await writer.drain()
                except (ConnectionError, asyncio.IncompleteReadError):
                    pass
                finally:
                    writer.close()

            upstream = await asyncio.start_server(on_conn, "127.0.0.1", 0)
            client = HttpClient("127.0.0.1",
                                upstream.sockets[0].getsockname()[1])
            try:
                for _ in range(3):
                    rsp = await bounded(client(Request(method="GET",
                                                       uri="/")))
                    assert rsp.status == 200 and rsp.body == b"ok"
                assert client._n_open == 1
            finally:
                await client.close()
                upstream.close()

        run(go())


# -- the engine: stream config, tunnels, the connection guard ---------------


class TestNativeStreamConfig:
    def test_stream_cfg_accepted_and_snapshot_enabled(self, engine_lib):
        eng = native.FastPathEngine()
        try:
            eng.set_stream_cfg(enabled=True, sample_every_frames=4,
                               min_gap_ms=5, table_cap=128, enter=0.8,
                               exit=0.4, quorum=2, dwell_ms=100,
                               action="observe")
            snap = eng.streams()
        finally:
            eng.close()
        assert snap.get("enabled") and snap.get("count", 0) == 0

    def test_bad_stream_action_rejected(self, engine_lib):
        eng = native.FastPathEngine()
        try:
            with pytest.raises(ValueError):
                eng.set_stream_cfg(action="nuke")
        finally:
            eng.close()

    def test_tunnel_guard_accepted(self, engine_lib):
        eng = native.FastPathEngine()
        try:
            eng.set_tunnel_guard(idle_ms=1000, max_bytes=1 << 20)
        finally:
            eng.close()

    def test_rst_stream_after_close_raises(self, engine_lib):
        eng = native.FastPathEngine(workers=2)
        eng.close()
        with pytest.raises(RuntimeError):
            eng.rst_stream(5, worker=1)


async def tunnel_frames(port, frames: int, gap_s: float = 0.01) -> int:
    """One 101 tunnel through ``port`` to the echo upstream (Host
    ``ws``), exchanging ``frames`` echoed writes; returns the bytes
    echoed."""
    reader, writer, head, rest = await open_raw(port, UPGRADE)
    assert b"101" in head.split(b"\r\n")[0], head
    got = 0
    try:
        for i in range(frames):
            payload = b"frame-%03d" % i
            echoed = await echo_round(reader, writer, payload, rest)
            rest = b""
            assert echoed == b"echo:" + payload
            got += len(echoed)
            await asyncio.sleep(gap_s)
    finally:
        writer.close()
    return got


class TestNativeTunnels:
    def test_tunnel_samples_become_kind_2_rows(self, engine_lib):
        """A 101 tunnel through the engine with stream scoring on: the
        engine counts the tunnel and retires kind-2 sample rows keyed by
        the tunnel's stream, at the frame cadence."""
        async def go():
            upstream = await echo_upstream()
            eng = native.FastPathEngine()
            try:
                eng.set_stream_cfg(action="observe", sample_every_frames=2,
                                   min_gap_ms=0)
                port = eng.listen("127.0.0.1", 0)
                eng.start()
                eng.set_route("ws", [("127.0.0.1",
                                      upstream.sockets[0].getsockname()[1])])
                await tunnel_frames(port, 16)
                await until(lambda: eng.streams()["tunnels_opened"] == 1,
                            "the tunnel counted")
                rows = eng.drain_features()
                snap = eng.streams()
            finally:
                eng.close()
                upstream.close()
            tun = rows[rows[:, NATIVE_COL_KIND] == NATIVE_KIND_TUNNEL]
            assert len(tun) >= 4, rows[:, NATIVE_COL_KIND]
            assert len(set(tun[:, NATIVE_COL_STREAM].tolist())) == 1
            assert np.all(np.diff(tun[:, NATIVE_COL_SEQ]) > 0)
            assert snap["count"] >= 1

        run(go())

    def test_tunnel_idle_budget_closes(self, engine_lib):
        async def go():
            upstream = await echo_upstream()
            eng = native.FastPathEngine()
            try:
                eng.set_tunnel_guard(idle_ms=300)
                port = eng.listen("127.0.0.1", 0)
                eng.start()
                eng.set_route("ws", [("127.0.0.1",
                                      upstream.sockets[0].getsockname()[1])])
                reader, writer, head, _ = await open_raw(port, UPGRADE)
                assert b"101" in head
                assert await bounded(reader.read(1024)) == b""  # closed
                writer.close()
                await until(lambda: eng.streams().get(
                    "tunnel_idle_closed", 0) >= 1, "the idle close")
            finally:
                eng.close()
                upstream.close()

        run(go())


class TestNativeConnectionGuard:
    """The h1 cases of the reference's native guard tests on the port's
    engine."""

    def test_h1_slowloris_closed_within_budget(self, engine_lib):
        async def go():
            eng = native.FastPathEngine()
            eng.set_guard(header_budget_ms=600)
            port = eng.listen("127.0.0.1", 0)
            eng.start()
            try:
                loris = SlowlorisAttack(port, conns=8, drip_s=10.0).start()
                await until(lambda: eng.stats()["guard"][
                    "slowloris_closed"] >= 8, "8 slow clients closed")
                await loris.stop()
            finally:
                eng.close()

        run(go())

    def test_h1_body_stall_closed(self, engine_lib):
        async def go():
            async def handle(reader, writer):
                with contextlib.suppress(Exception):
                    await reader.readuntil(b"\r\n\r\n")
                await asyncio.sleep(15)
                writer.close()

            srv = await asyncio.start_server(handle, "127.0.0.1", 0)
            eng = native.FastPathEngine()
            eng.set_guard(header_budget_ms=30_000, body_stall_ms=600)
            port = eng.listen("127.0.0.1", 0)
            eng.start()
            eng.set_route("svc", [("127.0.0.1",
                                   srv.sockets[0].getsockname()[1])])
            try:
                r, w = await bounded(asyncio.open_connection("127.0.0.1",
                                                             port))
                w.write(b"POST / HTTP/1.1\r\nHost: svc\r\n"
                        b"Content-Length: 1000\r\n\r\nabc")
                await bounded(w.drain())
                assert await bounded(r.read(4096)) == b""
                assert eng.stats()["guard"]["body_stall_closed"] >= 1
                w.close()
            finally:
                eng.close()
                srv.close()

        run(go())

    def test_accept_throttle_engages_under_churn(self, engine_lib):
        async def go():
            eng = native.FastPathEngine()
            eng.set_guard(accept_burst=20, accept_window_ms=1000)
            port = eng.listen("127.0.0.1", 0)
            eng.start()
            try:
                churn = ConnectionChurnAttack(port, rate_per_s=2000,
                                              workers=8).start()
                await until(lambda: eng.stats()["guard"][
                    "accept_throttled"] > 0, "the throttle")
                await churn.stop()
            finally:
                eng.close()

        run(go())


# -- the linker: kind-2 rows to the sentinel and the telemeter --------------


def fastpath_text(disco, **router) -> str:
    return json.dumps({
        "routers": [dict({
            "protocol": "http", "label": "fp", "fastPath": True,
            "dtab": "/svc => /#/io.l5d.fs ;", "servers": [{"port": 0}],
            "streamScoring": {"action": "observe", "sampleEveryFrames": 2,
                              "minGapMs": 0}}, **router)],
        "namers": [{"kind": "io.l5d.fs", "rootDir": str(disco),
                    "pollIntervalSecs": 0.05}],
        "telemetry": [{"kind": "io.l5d.jaxAnomaly", "nativeTier": "off",
                       "trainEveryBatches": 0}]})


def test_kind_2_rows_reach_the_sentinel_and_the_batches(engine_lib,
                                                        tmp_path):
    """Tunnel samples go into the telemeter's native ring beside request
    rows and are batched and scored like them (the reference's
    ``NativeFeaturizer`` does not filter on the kind column), and the
    same drained block feeds the Python sentinel."""
    from linkerd_tpu_torch.core.tasks import monitor
    from linkerd_tpu_torch.linker import load_linker

    async def go():
        upstream = await echo_upstream()
        (tmp_path / "ws").write_text(
            f"127.0.0.1 {upstream.sockets[0].getsockname()[1]}\n")
        linker = load_linker(fastpath_text(tmp_path), device="cpu")
        ctl = linker.routers[0].controller
        ctl.stats_poll_s = 0.05
        await bounded(linker.start())
        tele = linker.telemeters[0]
        consumed = []
        consume = tele.native_ring.consume

        def consuming(m):
            v = consume(m)
            consumed.append(v.copy())
            return v

        tele.native_ring.consume = consuming
        task = monitor(asyncio.create_task(tele.run()), what="telemeter")
        try:
            await bounded(tunnel_frames(linker.routers[0].server_ports[0],
                                        16), 20)
            await until(lambda: ctl.stream_sentinel.snapshot()["count"]
                        >= 1 and consumed and not len(tele.native_ring)
                        and tele._scored.value == tele._requests.value,
                        "the tunnel's rows drained and scored")
            await bounded(until(lambda: tele._requests.value == sum(
                len(c) for c in consumed), "every row counted"))
            flat = linker.metrics.flatten()
            snap = ctl.streams_snapshot()
        finally:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
            await bounded(linker.close())
            upstream.close()
        rows = np.concatenate(consumed)
        kinds = rows[:, NATIVE_COL_KIND]
        assert (kinds == NATIVE_KIND_TUNNEL).sum() >= 4
        assert flat["anomaly/requests_total"] == len(rows)
        assert flat["anomaly/scored_total"] == len(rows)
        sent = snap["sentinel"]
        assert snap["enabled"] and snap["engine"]["tunnels_opened"] == 1
        (entry,) = sent["by_stream"].values()
        assert entry["kind"] == 2
        assert entry["samples"] == int((kinds == NATIVE_KIND_TUNNEL).sum())
        assert flat["rt/fp/fastpath/streams/tunnels_opened"] == 1

    run(go(), timeout=60)


def test_streams_json_on_a_fastpath_router(engine_lib, tmp_path):
    """The admin server's ``/streams.json`` for a fastPath router with
    ``streamScoring``: the engine's table and the sentinel's, with the
    same keys as the reference's linker serves for the same config."""
    from linkerd_tpu.admin.handlers import (
        linkerd_admin_handlers as ref_handlers,
    )
    from linkerd_tpu.admin.server import AdminServer as RefAdmin
    from linkerd_tpu.linker import load_linker as ref_load_linker
    from linkerd_tpu_torch.admin.handlers import linkerd_admin_handlers
    from linkerd_tpu_torch.admin.server import AdminServer
    from linkerd_tpu_torch.linker import load_linker
    from linkerd_tpu_torch.protocol.http.client import HttpClient
    from linkerd_tpu_torch.protocol.http.message import Request

    text = fastpath_text(tmp_path)

    async def doc(load, admin_cls, handlers):
        linker = load(text)
        await bounded(linker.start())
        admin = admin_cls(linker.metrics, linker.config_dict, port=0)
        admin.add_handlers(handlers(linker))
        await bounded(admin.start())
        client = HttpClient("127.0.0.1", admin.bound_port)
        try:
            rsp = await bounded(client(Request(method="GET",
                                               uri="/streams.json")))
            assert rsp.status == 200
            return json.loads(rsp.body)
        finally:
            await client.close()
            await admin.close()
            await bounded(linker.close())

    async def go():
        got = await doc(lambda t: load_linker(t, device="cpu"),
                        AdminServer, linkerd_admin_handlers)
        want = await doc(ref_load_linker, RefAdmin, ref_handlers)
        return got, want

    got, want = run(go())
    assert got == want
    assert got["fp"]["enabled"] is True
    assert got["fp"]["sentinel"]["action"] == "observe"
    assert got["fp"]["engine"]["enabled"] is True
