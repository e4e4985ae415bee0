"""The port's sharded native engine (``workers`` > 1) against the JAX
package's, on the CPU.

- ``native.FastPathEngine(workers=N)``: N per-core engines share the
  router's ports through SO_REUSEPORT; route ids stay in lockstep; one
  publish or delta into the shared weight slab reaches every worker's
  ``native_scorer`` (version, generation, heads); stats merge at scrape
  time (merged equals the sum of the workers); ``drain_features_into``
  fans in across workers; ``workers=1`` keeps the single engine's stats
  shape; a publish after ``close()`` raises instead of touching the
  freed slab.
- ``_merge_worker_stats`` on seeded synthetic snapshots equals the
  reference's.
- The linker: ``workers: N`` on a fastPath router, its per-worker
  export under ``rt/<label>/fastpath/worker/<i>/*``, and the config
  errors of the sharded engine, the guard, stream scoring and native TLS
  with the reference's text for the same YAML.
- A distilled bank blob and a per-route delta served by the engine's
  specialist head (as the reference's ``TestEngineBankServing``).

The reference's two-worker tests that send traffic wait forever here,
in ``Server.wait_closed()``: their echo backend returns without closing
its writer, and Python 3.12 waits for every connection to be dropped.
The backends below close theirs, and every socket wait has its own
deadline of at most 30 s.
"""

import asyncio
import json
from types import SimpleNamespace

import numpy as np
import pytest

from linkerd_tpu.config import ConfigError as RefConfigError
from linkerd_tpu.linker import load_linker as ref_load_linker
from linkerd_tpu.native import _merge_worker_stats as ref_merge
from linkerd_tpu_torch import native
from linkerd_tpu_torch.config import ConfigError
from linkerd_tpu_torch.lifecycle.export import (
    export_bank_blob, export_delta_blob, export_weight_blob, route_hash,
)
from linkerd_tpu_torch.linker import load_linker
from linkerd_tpu_torch.telemetry.linerate import NATIVE_COL_SCORED

WAIT_S = 10


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


async def echo_backend():
    """A keep-alive backend answering ``ok``; it closes each connection
    when its client goes, so ``wait_closed`` returns."""
    async def handle(r, w):
        try:
            while True:
                await r.readuntil(b"\r\n\r\n")
                w.write(b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n\r\nok")
                await w.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            w.close()

    srv = await asyncio.start_server(handle, "127.0.0.1", 0)
    return srv, srv.sockets[0].getsockname()[1]


async def close_backend(srv) -> None:
    srv.close()
    await bounded(srv.wait_closed())


async def one_shot(port: int, host: str = "svc") -> bytes:
    """One request on a FRESH connection (a fresh 4-tuple, so the
    kernel's REUSEPORT hash keeps spreading across workers)."""
    r, w = await bounded(asyncio.open_connection("127.0.0.1", port))
    try:
        w.write(f"GET / HTTP/1.1\r\nHost: {host}\r\n"
                f"Connection: close\r\n\r\n".encode())
        await bounded(w.drain())
        return await bounded(r.read(65536))
    finally:
        w.close()


async def paced(port: int, n: int, host: bytes = b"svc") -> None:
    """``n`` keep-alive requests on one connection."""
    r, w = await bounded(asyncio.open_connection("127.0.0.1", port))
    rsp = b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n\r\nok"
    try:
        for _ in range(n):
            w.write(b"GET / HTTP/1.1\r\nHost: " + host + b"\r\n\r\n")
            await bounded(w.drain())
            assert await bounded(r.readexactly(len(rsp))) == rsp
    finally:
        w.close()


def fake_snap(seed: int = 0, scale: float = 0.2):
    """A snapshot-shaped object with tiny seeded dense layers in the
    geometry the blob parser takes (36 -> 8 -> 36 recon, 8 -> 1 cls)."""
    rng = np.random.default_rng(seed)
    dim, z = 36, 8

    def layer(rows, cols):
        return {"w": rng.standard_normal((rows, cols)).astype(np.float32)
                * scale,
                "b": rng.standard_normal(cols).astype(np.float32) * 0.1}

    return SimpleNamespace(
        params={"enc": [layer(dim, z)], "dec": [layer(z, dim)],
                "cls": [layer(z, 1)]},
        mu=np.zeros(dim, np.float32), var=np.ones(dim, np.float32),
        norm_initialized=True, step=seed,
        cfg=SimpleNamespace(recon_weight=0.5))


class TestShardedEngine:
    def test_both_workers_serve_and_merged_equals_sum(self, engine_lib):
        async def go():
            srv, bport = await echo_backend()
            eng = native.FastPathEngine(workers=2)
            try:
                port = eng.listen("127.0.0.1", 0)
                eng.start()
                eng.set_route("svc", [("127.0.0.1", bport)])
                n = 80
                got = [await one_shot(port) for _ in range(n)]
                assert all(b"200 OK" in g for g in got)
                st = eng.stats()
            finally:
                eng.close()
                await close_backend(srv)
            reqs = [int(s["routes"]["svc"]["requests"])
                    for s in st["workers"]]
            # 80 fresh 4-tuples: all on one worker is ~2^-80
            assert all(r > 0 for r in reqs), reqs
            assert st["routes"]["svc"]["requests"] == sum(reqs) == n
            assert sum(st["routes"]["svc"]["hist"]) == n
            assert st["accepted"] == sum(
                int(s["accepted"]) for s in st["workers"]) == n

        run(go())

    def test_route_ids_lockstep_across_workers(self, engine_lib):
        eng = native.FastPathEngine(workers=3)
        try:
            for host in ("alpha", "beta", "gamma"):
                eng.set_route(host, [("127.0.0.1", 9)])
            eng.remove_route("beta")
            eng.set_route("beta", [("127.0.0.1", 9)])  # re-add: new id
            st = eng.stats()
        finally:
            eng.close()
        for host in ("alpha", "beta", "gamma"):
            ids = {s["routes"][host]["id"] for s in st["workers"]}
            assert len(ids) == 1, (host, ids)

    def test_single_publish_fans_out_to_all_workers(self, engine_lib):
        """One publish and one delta into the shared slab, no traffic:
        every worker's scorer block reports the same version, bank
        generation and heads."""
        rh = route_hash("/svc/spec")
        eng = native.FastPathEngine(workers=3)
        try:
            eng.publish_weights(export_weight_blob(fake_snap(1), 7))
            st = eng.stats()
            assert [s["native_scorer"]["version"] for s in
                    st["workers"]] == [7, 7, 7]
            assert all(s["native_scorer"]["weights"] for s in st["workers"])
            eng.publish_weights(export_bank_blob(fake_snap(1), 8, 3, {}))
            eng.publish_delta(export_delta_blob(
                3, 4, upserts={rh: (1, fake_snap(2, scale=0.5))}))
            st = eng.stats()
        finally:
            eng.close()
        ns = [s["native_scorer"] for s in st["workers"]]
        assert [(x["generation"], x["heads"], x["delta_swaps"]) for x in
                ns] == [(4, 1, 1)] * 3
        assert (st["native_scorer"]["generation"],
                st["native_scorer"]["heads"]) == (4, 1)

    def test_rows_from_every_worker_arrive_prescored(self, engine_lib):
        """After one publish into the shared slab, rows retired on every
        core come back scored in the engine, and the merged scorer count
        is the workers' sum."""
        async def go():
            srv, bport = await echo_backend()
            eng = native.FastPathEngine(workers=2)
            try:
                port = eng.listen("127.0.0.1", 0)
                eng.start()
                eng.set_route("svc", [("127.0.0.1", bport)])
                assert eng.set_route_feature("svc", 14, 1.0)
                eng.publish_weights(export_weight_blob(fake_snap(3), 7))
                n = 60
                for _ in range(n):
                    assert b"200 OK" in await one_shot(port)
                await until(lambda: eng.stats()["native_scorer"][
                    "scored"] == n, "every row scored")
                rows = eng.drain_features()
                st = eng.stats()
            finally:
                eng.close()
                await close_backend(srv)
            assert len(rows) == n
            assert int((rows[:, NATIVE_COL_SCORED] > 0.5).sum()) == n
            ns = [s["native_scorer"] for s in st["workers"]]
            assert all(x["version"] == 7 and int(x["scored"]) > 0
                       for x in ns), ns
            assert st["native_scorer"]["scored"] == sum(
                int(x["scored"]) for x in ns) == n

        run(go())

    def test_workers1_keeps_single_engine_stats_shape(self, engine_lib):
        eng = native.FastPathEngine()
        try:
            assert eng.workers == 1 and eng._slab is None
            eng.set_route("svc", [("127.0.0.1", 9)])
            st = eng.stats()
        finally:
            eng.close()
        assert "workers" not in st and "svc" in st["routes"]

    def test_drain_features_into_fans_in_across_workers(self, engine_lib):
        async def go():
            srv, bport = await echo_backend()
            eng = native.FastPathEngine(workers=2)
            try:
                port = eng.listen("127.0.0.1", 0)
                eng.start()
                eng.set_route("svc", [("127.0.0.1", bport)])
                n = 40
                for _ in range(n):
                    await one_shot(port)
                await until(lambda: eng.stats()["routes"]["svc"][
                    "requests"] == n, "every request retired")
                per = [int(s["routes"]["svc"]["requests"])
                       for s in eng.stats()["workers"]]
                out = np.zeros((n + 8, eng.FEATURE_DIM), np.float32)
                got = eng.drain_features_into(out)
            finally:
                eng.close()
                await close_backend(srv)
            assert all(p > 0 for p in per), per
            assert got == n
            assert np.all(out[:n, 2] == 200.0)
            assert not out[n:].any()

        run(go())

    def test_invalid_worker_counts_rejected(self, engine_lib):
        for bad in (0, 65):
            with pytest.raises(ValueError):
                native.FastPathEngine(workers=bad)

    def test_publish_after_close_raises(self, engine_lib):
        """The shared slab is freed by ``close()``, after every worker's
        thread has joined; a publish after that raises rather than
        writing freed memory."""
        async def go():
            srv, bport = await echo_backend()
            eng = native.FastPathEngine(workers=2)
            eng.publish_weights(export_weight_blob(fake_snap(3), 1))
            port = eng.listen("127.0.0.1", 0)
            eng.start()
            eng.set_route("svc", [("127.0.0.1", bport)])
            eng.set_route_feature("svc", 14, 1.0)
            try:
                for _ in range(8):
                    assert b"200 OK" in await one_shot(port)
            finally:
                eng.close()  # joins the loops, then frees the slab
                await close_backend(srv)
            assert eng._slab is None
            eng.close()  # a second close is a no-op
            blob = export_weight_blob(fake_snap(3), 2)
            with pytest.raises(RuntimeError):
                eng.publish_weights(blob)
            with pytest.raises(RuntimeError):
                eng.publish_delta(export_delta_blob(1, 2, removes=[1]))

        run(go())


# -- the merge against the reference's --------------------------------------


def synthetic_snaps(seed: int, n_workers: int) -> list:
    """Per-worker stats snapshots as the engine emits them: routes with
    histograms, TLS, guard and scorer blocks, some blocks missing."""
    rng = np.random.default_rng(seed)
    hosts = [f"h{i}" for i in range(int(rng.integers(1, 6)))]
    snaps = []
    for w in range(n_workers):
        routes = {h: {"id": i, **{k: int(rng.integers(0, 500)) for k in (
            "requests", "success", "f4xx", "f5xx", "conn_fail")},
            "hist": rng.integers(0, 50, 8).tolist()}
            for i, h in enumerate(hosts) if rng.random() < 0.8}
        snap = {"accepted": int(rng.integers(0, 1000)),
                "features_dropped": int(rng.integers(0, 3)),
                "routes": routes}
        if rng.random() < 0.8:
            snap["tls"] = {k: int(rng.integers(0, 99)) for k in (
                "handshakes", "failures", "resumed", "alpn_h2",
                "alpn_http1", "upstream_handshakes", "upstream_resumed",
                "upstream_failures")}
            snap["tls"].update(enabled=bool(rng.random() < 0.5),
                               client_enabled=bool(rng.random() < 0.5))
        if rng.random() < 0.8:
            snap["guard"] = {k: int(rng.integers(0, 9)) for k in (
                "slowloris_closed", "body_stall_closed", "accept_throttled",
                "hs_churn_shed")}
        snap["native_scorer"] = {
            "weights": 1, "version": 7, "crc": 12345, "generation": 3,
            "heads": 2, "swaps": 4, "delta_swaps": 1, "retries": 0,
            **{k: int(rng.integers(0, 999)) for k in (
                "scored", "specialist_scored", "unscored")},
            "score_ns_hist": rng.integers(0, 20, 6).tolist()}
        snaps.append(snap)
    return snaps


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_merge_worker_stats_equals_the_reference(seed):
    for n in (2, 3, 4):
        snaps = synthetic_snaps(seed * 10 + n, n)
        got = native._merge_worker_stats(json.loads(json.dumps(snaps)), n)
        assert got == ref_merge(json.loads(json.dumps(snaps)), n)
        assert got["accepted"] == sum(s["accepted"] for s in snaps)
        for host, r in got["routes"].items():
            assert r["requests"] == sum(
                s["routes"][host]["requests"] for s in snaps
                if host in s["routes"])


# -- the linker -------------------------------------------------------------


def fp_text(disco, **router) -> str:
    return json.dumps({"routers": [dict({
        "protocol": "http", "label": "mc", "fastPath": True,
        "dtab": "/svc => /#/io.l5d.fs ;", "servers": [{"port": 0}]},
        **router)], "namers": [{"kind": "io.l5d.fs", "rootDir": str(disco),
                                "pollIntervalSecs": 0.05}]})


class TestShardedLinker:
    def test_workers_zero_is_auto(self, engine_lib, tmp_path):
        linker = load_linker(fp_text(tmp_path, workers=0), device="cpu")
        try:
            assert linker.routers[0].controller.engine.workers == \
                native.auto_workers()
        finally:
            run(linker.close())

    def test_sharded_router_serves_and_exports_per_worker(self, engine_lib,
                                                          tmp_path):
        """``workers: 2``: traffic reaches both workers, the controller
        exports rt/*/fastpath/worker/<i>/*, and the merged route counter
        equals their sum."""
        async def go():
            srv, bport = await echo_backend()
            (tmp_path / "web").write_text(f"127.0.0.1 {bport}\n")
            linker = load_linker(fp_text(tmp_path, workers=2), device="cpu")
            ctl = linker.routers[0].controller
            ctl.stats_poll_s = 0.05
            await bounded(linker.start())
            try:
                port = linker.routers[0].server_ports[0]
                assert ctl.engine.workers == 2
                # the first requests park on a miss while the
                # controller resolves and broadcasts the route
                warm = 0
                while b"200 OK" not in await one_shot(port, "web"):
                    warm += 1
                    assert warm < 100, "the route never installed"
                    await asyncio.sleep(0.05)
                got = [await one_shot(port, "web") for _ in range(60)]
                assert all(b"200 OK" in g for g in got)
                await until(lambda: sum(linker.metrics.flatten().get(
                    f"rt/mc/fastpath/worker/{i}/requests", 0)
                    for i in (0, 1)) == linker.metrics.flatten().get(
                    "rt/mc/fastpath/route/web/requests", -1) >= 61,
                    "the per-worker export")
                flat = linker.metrics.flatten()
            finally:
                await bounded(linker.close())
                await close_backend(srv)
            w = [flat[f"rt/mc/fastpath/worker/{i}/requests"] for i in (0, 1)]
            assert all(x > 0 for x in w), w
            assert flat["rt/mc/fastpath/worker/0/accepted"] + \
                flat["rt/mc/fastpath/worker/1/accepted"] >= 60

        run(go())


# The same YAML through both linkers: the same ConfigError text.
CONFIG_ERRORS = {
    "negative header budget": {"connectionGuard": {"headerBudgetMs": -1}},
    "negative tunnel bytes": {"connectionGuard": {"tunnelMaxBytes": -5}},
    "zero accept window": {"connectionGuard": {"acceptWindowMs": 0}},
    "exit above enter": {"streamScoring": {"enter": 0.5, "exit": 0.6}},
    "exit equals enter": {"streamScoring": {"enter": 0.6, "exit": 0.6}},
    "action nuke": {"streamScoring": {"action": "nuke"}},
    "zero sample cadence": {"streamScoring": {"sampleEveryFrames": 0}},
    "workers 65": {"workers": 65},
    "workers -1": {"workers": -1},
    "workers without fastPath": {"fastPath": False, "workers": 2},
    "connectionGuard without fastPath": {"fastPath": False,
                                         "connectionGuard": {}},
    "two distinct cert pairs": {"servers": [
        {"port": 0, "tls": {"certPath": "a.pem", "keyPath": "a.key"}},
        {"port": 0, "tls": {"certPath": "b.pem", "keyPath": "b.key"}}]},
    "client tls commonName": {"client": {"tls": {"commonName": "x"}}},
    "workers on an h2 router": {"protocol": "h2", "fastPath": False,
                                "workers": 4},
}


# Cases refused by name until the port took them: each is now served,
# and loads to what the reference's linker builds from the same text.
NOW_SERVED = {
    "protocol h2": {"protocol": "h2", "fastPath": False},
}


@pytest.mark.parametrize("case", sorted(NOW_SERVED))
def test_now_served(case, tmp_path):
    text = fp_text(tmp_path, **NOW_SERVED[case])
    got = load_linker(text, device="cpu")
    want = ref_load_linker(text)
    try:
        assert [type(s).__name__ for s in got.routers[0].servers] == \
            [type(s).__name__ for s in want.routers[0].servers] == \
            ["H2Server"]
        assert sorted(got.metrics.flatten()) == \
            sorted(want.metrics.flatten())
    finally:
        run(got.close())
        run(want.close())


@pytest.mark.parametrize("case", sorted(CONFIG_ERRORS))
def test_config_errors_word_for_word(case, engine_lib, tmp_path):
    text = fp_text(tmp_path, **CONFIG_ERRORS[case])
    with pytest.raises(RefConfigError) as want:
        ref_load_linker(text)
    with pytest.raises(ConfigError) as got:
        load_linker(text, device="cpu")
    assert str(got.value) == str(want.value)
    assert "not supported by the port yet" not in str(got.value)


@pytest.mark.parametrize("case", ["tenants", "tenantIdentifier",
                                  "fastPath on h2"])
def test_still_refused_by_name(case, engine_lib, tmp_path):
    """The tenant keys on a sharded engine, refused by name until the
    port took them, load in both packages to the same router, tenant
    views and quota wiring."""
    router = {"tenants": {"tenants": {}},
              "tenantIdentifier": {"tenantIdentifier": {"kind": "header"},
                                   "tenants": {"engineBase": 8}},
              "fastPath on h2": {"protocol": "h2",
                                 "tenantIdentifier": {"kind": "header"},
                                 "tenants": {}}}[case]
    text = fp_text(tmp_path, workers=4, **router)
    out = {}
    for pkg in ("ref", "port"):
        linker = (load_linker(text, device="cpu") if pkg == "port"
                  else ref_load_linker(text))
        try:
            r = linker.routers[0]
            out[pkg] = (type(r).__name__, r.controller.engine.workers,
                        [(label, type(a).__name__ if a else None)
                         for label, _b, a in linker.tenant_views],
                        r.controller.tenant_admission is not None)
        finally:
            run(linker.close())
    assert out["port"] == out["ref"]
    assert out["port"][0] == "_FastPathRouter"


# -- a distilled bank and a per-route delta in the engine -------------------


class TestEngineBankServing:
    def test_engine_serves_specialist_head(self, engine_lib):
        """One worker, real loopback traffic: rows of the hashed route
        score on the specialist head of a published bank, a REMOVE delta
        rolls just that route back to the base model, and the stats
        carry the bank's generation and heads."""
        rh = route_hash("/fp/spec")
        base, head = fake_snap(1), fake_snap(2, scale=0.5)

        async def go():
            srv, bport = await echo_backend()
            eng = native.FastPathEngine()
            port = eng.listen("127.0.0.1", 0)
            try:
                eng.start()
                eng.set_route("svc", [("127.0.0.1", bport)])
                assert eng.set_route_feature("svc", 14, 1.0)
                assert eng.set_route_hash("svc", rh)
                assert not eng.set_route_hash("ghost", rh)
                blob = export_bank_blob(base, 1, 3, {rh: (1, head)})
                eng.publish_weights(blob)
                for _ in range(4):
                    await paced(port, 10)
                await until(lambda: eng.stats()["native_scorer"][
                    "scored"] == 40, "40 rows scored")
                st = eng.stats()["native_scorer"]
                rows = eng.drain_features()
                eng.publish_delta(export_delta_blob(3, 4, removes=[rh]))
                await paced(port, 20)
                await until(lambda: eng.stats()["native_scorer"][
                    "scored"] == 60, "60 rows scored")
                after = eng.stats()["native_scorer"]
            finally:
                eng.close()
                await close_backend(srv)
            assert st["weights"] and st["generation"] == 3
            assert st["heads"] == 1 and st["specialist_scored"] == 40
            assert len(rows) == 40 and (rows[:, NATIVE_COL_SCORED]
                                        == 1.0).all()
            assert after["generation"] == 4 and after["heads"] == 0
            assert after["specialist_scored"] == 40  # the base model now
            assert after["delta_swaps"] == 1

        run(go())

    def test_delta_generation_reaches_every_worker(self, engine_lib):
        """Two workers, no traffic: a bank, then an upsert and a remove
        delta, each seen by both workers at the same generation."""
        rh, other = route_hash("/fp/a"), route_hash("/fp/b")
        eng = native.FastPathEngine(workers=2)
        try:
            eng.publish_weights(export_bank_blob(
                fake_snap(1), 1, 5, {rh: (1, fake_snap(2))}))
            seen = [[(s["native_scorer"]["generation"],
                      s["native_scorer"]["heads"])
                     for s in eng.stats()["workers"]]]
            eng.publish_delta(export_delta_blob(
                5, 6, upserts={other: (2, fake_snap(3))}))
            seen.append([(s["native_scorer"]["generation"],
                          s["native_scorer"]["heads"])
                         for s in eng.stats()["workers"]])
            eng.publish_delta(export_delta_blob(6, 7, removes=[rh]))
            seen.append([(s["native_scorer"]["generation"],
                          s["native_scorer"]["heads"])
                         for s in eng.stats()["workers"]])
            with pytest.raises(ValueError):  # fenced: built against 5
                eng.publish_delta(export_delta_blob(5, 8, removes=[other]))
        finally:
            eng.close()
        assert seen == [[(5, 1)] * 2, [(6, 2)] * 2, [(7, 1)] * 2]
