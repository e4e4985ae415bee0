"""The sidecar's tiers on the port, held against the JAX package's on
the CPU: the ``CircuitBreaker`` and ``ResilientScorer``
(``telemetry/resilience.py``), the ``TieredScorer``
(``telemetry/linerate.py``), the ``ScorerReplicaPool``
(``fleet/scorer_pool.py``), and the telemeter and linker that build
them from ``sidecarAddress`` and ``sidecarTier``.

Each scenario runs once per package on the same script: the breaker on
a scripted clock with the same seeded backoffs, the scorers on scripted
stand-ins, and the two must read alike step by step. The slice's hop
itself runs on the port's own sidecars: a pool over two of them, every
address form under both tiers through a linker, the fleet model push,
and the reference's chaos drill (``tools/validator.py``,
``validate_chaos``) against the port's CLI.
"""

import asyncio
import itertools
import json
import os
import random
import signal
import socket
import subprocess
import sys
import time
import types
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import linkerd_tpu.announcer as ref_announcer
import linkerd_tpu.core as ref_core
import linkerd_tpu.fleet.scorer_pool as ref_pool
import linkerd_tpu.namer.fs as ref_fs
import linkerd_tpu.telemetry.linerate as ref_linerate
import linkerd_tpu.telemetry.resilience as ref_resilience
import linkerd_tpu.telemetry.sidecar as ref_sidecar
import linkerd_tpu.testing.faults as ref_faults
import linkerd_tpu_torch.announcer as port_announcer
import linkerd_tpu_torch.core as port_core
import linkerd_tpu_torch.fleet.scorer_pool as port_pool
import linkerd_tpu_torch.namer.fs as port_fs
import linkerd_tpu_torch.telemetry.linerate as port_linerate
import linkerd_tpu_torch.telemetry.resilience as port_resilience
import linkerd_tpu_torch.telemetry.sidecar as port_sidecar
import linkerd_tpu_torch.testing.faults as port_faults
from linkerd_tpu.telemetry import anomaly as ref_anomaly
from linkerd_tpu.telemetry.metrics import MetricsTree as RefMetricsTree
from linkerd_tpu_torch.config import ConfigError
from linkerd_tpu_torch.linker import load_linker
from linkerd_tpu_torch.models.features import FeatureVector
from linkerd_tpu_torch.protocol.http.client import HttpClient
from linkerd_tpu_torch.protocol.http.message import Request, Response
from linkerd_tpu_torch.protocol.http.server import serve
from linkerd_tpu_torch.router.service import FnService
from linkerd_tpu_torch.telemetry import anomaly as port_anomaly
from linkerd_tpu_torch.telemetry.anomaly import InProcessScorer
from linkerd_tpu_torch.telemetry.metrics import MetricsTree

ROOT = Path(__file__).resolve().parent.parent

PKGS = {
    "ref": types.SimpleNamespace(
        resilience=ref_resilience, TieredScorer=ref_linerate.TieredScorer,
        pool=ref_pool, faults=ref_faults, sidecar=ref_sidecar,
        FsAnnouncer=ref_announcer.FsAnnouncer, FsNamer=ref_fs.FsNamer,
        Path=ref_core.Path),
    "port": types.SimpleNamespace(
        resilience=port_resilience, TieredScorer=port_linerate.TieredScorer,
        pool=port_pool, faults=port_faults, sidecar=port_sidecar,
        FsAnnouncer=port_announcer.FsAnnouncer, FsNamer=port_fs.FsNamer,
        Path=port_core.Path),
}


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def alike(scenario, *args):
    """``scenario(pkg, *args)`` in both packages; their traces equal."""
    traces = {name: scenario(pk, *args) for name, pk in PKGS.items()}
    assert traces["port"] == traces["ref"]
    return traces["port"]


# -- the breaker, on a scripted clock ------------------------------------------


class Clock:
    """Stands for the ``time`` module of a resilience module."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


def scripted(pk, monkeypatch_ctx):
    clock = Clock()
    monkeypatch_ctx.setattr(pk.resilience, "time", clock)
    return clock


def breaker_trace(pk, seed, n_events, failures):
    """A seeded random script of acquires, outcomes and clock steps
    against one breaker with jittered backoffs seeded alike; each step's
    state, probe delay and answer."""
    with pytest.MonkeyPatch.context() as mp:
        clock = scripted(pk, mp)
        random.seed(seed)
        b = pk.resilience.CircuitBreaker(
            failures=failures, min_backoff_s=0.5, max_backoff_s=30.0)
        rng = np.random.default_rng(seed)
        probe, out = False, []
        for _ in range(n_events):
            op = rng.choice(["acquire", "success", "failure", "cancel",
                             "advance"], p=[0.3, 0.15, 0.3, 0.05, 0.2])
            got = None
            if op == "acquire":
                got = b.acquire()
                probe = got[1]
            elif op == "success":
                b.on_success(probe)
            elif op == "failure":
                b.on_failure(probe)
            elif op == "cancel":
                b.on_cancel(probe)
            else:
                clock.now += float(rng.uniform(0.0, 4.0))
            out.append((str(op), got, b.state,
                        round(b.next_probe_in_s(), 12)))
        return out


@pytest.mark.parametrize("seed", range(6))
def test_breaker_scripts_alike(seed):
    trace = alike(breaker_trace, seed, 400, 1 + seed % 3)
    states = {s for _, _, s, _ in trace}
    assert states == {"closed", "open", "half_open"}


def breaker_cases(pk):
    """The reference's breaker cases (tests/test_resilience_chaos.py,
    ``TestCircuitBreaker``) on a scripted clock."""
    out = []
    with pytest.MonkeyPatch.context() as mp:
        clock = scripted(pk, mp)
        CB = pk.resilience.CircuitBreaker
        # open, probe, close
        b = CB(failures=2, backoffs=itertools.repeat(0.02))
        b.on_failure(False)
        out.append(b.state)
        b.on_failure(False)
        out += [b.state, b.acquire()]
        clock.now += 0.03
        out += [b.acquire(), b.acquire()]
        b.on_success(True)
        out.append(b.state)
        # a failed probe re-opens
        b = CB(failures=1, backoffs=itertools.repeat(0.02))
        b.on_failure(False)
        clock.now += 0.03
        out.append(b.acquire())
        b.on_failure(True)
        out += [b.state, b.acquire()]
        # concurrent failures of one outage open once
        b = CB(failures=1, backoffs=iter([0.05, 99.0]))
        b.on_failure(False)
        b.on_failure(False)
        out.append(round(b.next_probe_in_s(), 9))
        # a cancelled probe frees its slot without reviving
        b = CB(failures=1, backoffs=itertools.repeat(0.0))
        b.on_failure(False)
        out.append(b.acquire())
        b.on_cancel(True)
        out += [b.state, b.acquire()]
        with pytest.raises(ValueError):
            CB(failures=0)
    return out


def test_breaker_cases_alike():
    assert alike(breaker_cases) == [
        "closed", "open", (False, False), (True, True), (False, False),
        "closed", (True, True), "open", (False, False), 0.05,
        (True, True), "half_open", (True, True)]


# -- ResilientScorer -----------------------------------------------------------


class Stub:
    """A healthy scorer: zeros."""

    def __init__(self):
        self.scored = 0

    async def score(self, x):
        self.scored += len(x)
        return np.zeros(len(x), np.float32)

    async def fit(self, x, labels, mask):
        return 0.0

    def snapshot(self):
        return "snap"

    def close(self):
        pass


def resilient_trace(pk):
    """The reference's ``TestResilientScorer`` cases: a hang bounded by
    the deadline, then fail fast; an error, then a probe that recovers;
    lifecycle hooks delegated."""
    RS, CB = pk.resilience.ResilientScorer, pk.resilience.CircuitBreaker
    Unavailable = pk.resilience.ScorerUnavailable
    x = np.zeros((4, 8), np.float32)

    async def go():
        out = []
        faulty = pk.faults.FaultScorer(Stub())
        s = RS(faulty, call_timeout_s=0.1, breaker=CB(
            failures=1, backoffs=itertools.repeat(60.0)))
        out.append(len(await s.score(x)))
        faulty.mode = "hang"
        for bound in (1.0, 0.05):
            t0 = time.monotonic()
            with pytest.raises(Unavailable) as e:
                await s.score(x)
            out += [time.monotonic() - t0 < bound, s.breaker.state,
                    "breaker open" in str(e.value)]
        with pytest.raises(Unavailable):
            await s.fit(x, x[:, 0], x[:, 0])
        out += [faulty.calls, s.snapshot()]
        faulty = pk.faults.FaultScorer(Stub())
        s = RS(faulty, call_timeout_s=0.1, breaker=CB(
            failures=1, backoffs=itertools.repeat(0.05)))
        faulty.mode = "error"
        with pytest.raises(Unavailable) as e:
            await s.score(x)
        out += [type(e.value.__cause__).__name__, s.breaker.state]
        faulty.mode = None
        await asyncio.sleep(0.06)
        out += [len(await s.score(x)), s.breaker.state, faulty.calls]
        return out

    return run(go())


def test_resilient_scorer_alike():
    assert alike(resilient_trace) == [
        4, True, "open", False, True, "open", True, 2, "snap",
        "ConnectionError", "open", 4, "closed", 2]


def blackholed_trace(pk):
    """``test_grpc_client_blackholed_sidecar_bounded``: each package's
    own client against its black hole, bounded by the deadline, then
    failing fast on the open breaker."""
    async def go():
        hole = await pk.faults.BlackholeServer().start()
        client = pk.sidecar.GrpcScorerClient(
            f"127.0.0.1:{hole.bound_port}")
        s = pk.resilience.ResilientScorer(
            client, call_timeout_s=0.2,
            breaker=pk.resilience.CircuitBreaker(
                failures=1, backoffs=itertools.repeat(60.0)))
        out = []
        try:
            for bound in (2.0, 0.05):
                t0 = time.monotonic()
                with pytest.raises(pk.resilience.ScorerUnavailable):
                    await s.score(np.zeros((4, 8), np.float32))
                out += [time.monotonic() - t0 < bound, s.breaker.state]
            out.append(hole.connections)
        finally:
            await client.aclose()
            await hole.close()
        return out

    return run(go())


def test_grpc_client_blackholed_sidecar_bounded():
    assert alike(blackholed_trace) == [True, "open", True, "open", 1]


# -- TieredScorer ----------------------------------------------------------------


class Primary:
    def __init__(self):
        self.fail = False
        self.calls = self.fits = 0
        self.restored = None
        self.closed = False

    async def score(self, x):
        self.calls += 1
        if self.fail:
            raise RuntimeError("device sick")
        return np.zeros(len(x), np.float32)

    async def fit(self, x, labels, mask):
        if self.fail:
            raise RuntimeError("device sick")
        self.fits += 1
        return 0.1

    def snapshot(self):
        return "snap"

    def restore(self, snap):
        self.restored = snap

    def close(self):
        self.closed = True


class Fallback:
    def __init__(self):
        self.calls = self.fits = 0
        self.closed = False

    async def score(self, x):
        self.calls += 1
        return np.ones(len(x), np.float32)

    async def fit(self, x, labels, mask):
        self.fits += 1
        return 0.2

    def close(self):
        self.closed = True


def tiered_trace(pk):
    """``TestTieredScorer`` (tests/test_line_rate.py): the primary
    serves; a failure sends that batch to the fallback and opens the
    primary's breaker; a probe re-admits the healed primary; lifecycle
    hooks bind to the primary."""
    CB = pk.resilience.CircuitBreaker

    async def go():
        p, f = Primary(), Fallback()
        t = pk.TieredScorer(p, f, breaker=CB(
            failures=1, backoffs=itertools.repeat(0.05)))
        x = np.zeros((4, 2), np.float32)
        out = [float((await t.score(x)).mean()), t.primary_calls]
        p.fail = True
        out += [float((await t.score(x)).mean()), t.fallback_calls]
        out += [float((await t.score(x)).mean()), p.calls, t.tier_state()]
        p.fail = False
        await asyncio.sleep(0.06)
        out += [float((await t.score(x)).mean()), t.tier_state()]
        out += [t.snapshot(), t.breaker, t._step]
        t.restore("other")
        out.append(p.restored)
        t.close()
        out += [p.closed, f.closed]
        return out

    return run(go())


def test_tiered_scorer_alike():
    trace = alike(tiered_trace)
    assert trace[:6] == [0.0, 1, 1.0, 1, 1.0, 2]
    assert trace[6]["primary_breaker"] == "open"
    assert trace[7:] == [
        0.0, {"primary": "Primary", "primary_breaker": "closed",
              "primary_calls": 2, "fallback_calls": 2},
        "snap", None, None, "other", True, True]


def tiered_fit_trace(pk):
    """``TestTieredFit``: with the primary's breaker open, scoring falls
    back but fit raises ScorerUnavailable: the fallback is never
    trained."""
    async def go():
        p, f = Primary(), Fallback()
        t = pk.TieredScorer(p, f, breaker=pk.resilience.CircuitBreaker(
            failures=1, backoffs=itertools.repeat(30.0)))
        x = np.zeros((2, 2), np.float32)
        z = np.zeros(2, np.float32)
        out = [await t.fit(x, z, z)]
        p.fail = True
        with pytest.raises(RuntimeError):
            await t.fit(x, z, z)
        out.append(float((await t.score(x)).mean()))
        with pytest.raises(pk.resilience.ScorerUnavailable) as e:
            await t.fit(x, z, z)
        out += ["never routes to the fallback" in str(e.value), f.fits,
                p.fits, t.tier_state()["primary_breaker"]]
        return out

    return run(go())


def test_fit_never_routes_to_fallback():
    assert alike(tiered_fit_trace) == [0.1, 1.0, True, 0, 1, "open"]


# -- ScorerReplicaPool -----------------------------------------------------------


class FakeReplica:
    def __init__(self, addr, fail=False):
        self.addr = addr
        self.fail = fail
        self.calls = 0
        self.closed = False
        self.restored = None
        self.last_timing = {"rpc_ms": 1.0, "addr": addr}

    async def score(self, x):
        self.calls += 1
        if self.fail:
            raise RuntimeError(f"replica {self.addr} down")
        return np.zeros(len(x), np.float32)

    async def fit(self, x, labels, mask):
        self.calls += 1
        return 0.0

    async def restore(self, snap):
        self.calls += 1
        if self.fail:
            raise RuntimeError(f"replica {self.addr} down")
        self.restored = snap
        return 0

    def close(self):
        self.closed = True


def pool_trace(pk):
    """``TestScorerReplicaPool`` (tests/test_fleet.py): spread,
    failover, broadcast_restore past a dead replica, every replica down,
    and the membership diff keeping surviving clients."""
    Pool = pk.pool.ScorerReplicaPool

    async def go():
        out = []
        made = {}

        def mk(addr):
            made[addr] = FakeReplica(addr, fail=addr.startswith("bad"))
            return made[addr]

        pool = Pool(["a:1", "b:2", "c:3"], mk_client=mk)
        for n in range(10):
            await pool.score(np.zeros((4, 3), np.float32))
            await pool.fit(np.zeros((n + 1, 3)), None, None)
        out.append({a: r.calls for a, r in made.items()})
        out.append(pool.last_timing)
        made.clear()
        pool = Pool(["bad:1", "ok:2"], mk_client=mk)
        for _ in range(6):
            out.append(len(await pool.score(np.zeros((2, 3), np.float32))))
        out.append(pool.status())
        made.clear()
        pool = Pool(["a:1", "bad:2", "c:3"], mk_client=mk)
        snap = object()
        out.append(await pool.broadcast_restore(snap))
        out.append([made[a].restored is snap for a in ("a:1", "bad:2",
                                                        "c:3")])
        out.append(pool.status())
        pool = Pool(["bad:1", "bad:2"], mk_client=mk)
        with pytest.raises(RuntimeError) as e:
            await pool.score(np.zeros((2, 3), np.float32))
        out.append(str(e.value))
        with pytest.raises(RuntimeError) as e:
            await Pool([], mk_client=mk).score(np.zeros((2, 3)))
        out.append(str(e.value))
        made.clear()
        pool = Pool(["a:1", "b:2"], mk_client=mk)
        keep = made["a:1"]
        pool.set_addresses(["a:1", " c:3 ", ""])
        out += [pool.addresses(), made["b:2"].closed, keep.closed,
                pool._replicas["a:1"].scorer is keep]
        pool.close()
        out += [keep.closed, pool.addresses()]
        return out

    return run(go())


def test_pool_alike():
    trace = alike(pool_trace)
    assert all(c > 0 for c in trace[0].values())
    assert trace[2:8] == [2] * 6
    assert trace[9] == 2 and trace[10] == [True, False, True]
    assert trace[-2:] == [True, []]


def announced_trace(pk, tmp_path):
    """Two replicas fs-announced; the pool resolves
    /#/io.l5d.fs/l5d-scorer through a real fs namer and follows a
    withdrawal."""
    Path_ = pk.Path

    async def go():
        d = tmp_path / f"announce-{id(pk)}"
        ann = pk.FsAnnouncer(str(d), Path_.read("/io.l5d.fs"))
        a1 = ann.announce("127.0.0.1", 7001, Path_.read("/l5d-scorer"))
        a2 = ann.announce("127.0.0.1", 7002, Path_.read("/l5d-scorer"))
        namer = pk.FsNamer(str(d), poll_interval=0.02)
        act = pk.pool.namer_scorer_activity(
            [(Path_.read("/io.l5d.fs"), namer)], "/#/io.l5d.fs/l5d-scorer")
        pool = pk.pool.ScorerReplicaPool(mk_client=FakeReplica)
        pool.attach_activity(act, poll_interval_s=0.02)
        pool.start_watch()
        out = []
        try:
            for want, then in ((["127.0.0.1:7001", "127.0.0.1:7002"],
                                a1.close),
                               (["127.0.0.1:7002"], lambda: None)):
                deadline = time.monotonic() + 5.0
                while pool.addresses() != want \
                        and time.monotonic() < deadline:
                    await asyncio.sleep(0.02)
                out.append(pool.addresses())
                then()
            out.append(pool.status()["watching"])
        finally:
            a2.close()
            pool.close()
            act.close()
            namer.close()
        return out

    return run(go())


def test_announced_replicas_resolve_through_real_namer(tmp_path):
    assert alike(announced_trace, tmp_path) == [
        ["127.0.0.1:7001", "127.0.0.1:7002"], ["127.0.0.1:7002"], True]


def test_unknown_namer_path_fails_loudly(tmp_path):
    for pk in PKGS.values():
        for path in ("/#/io.l5d.nope/l5d-scorer", "/svc/l5d-scorer"):
            with pytest.raises(ValueError):
                pk.pool.namer_scorer_activity([], path)
    text = json.dumps({
        "routers": [{"protocol": "http", "servers": [{"port": 0}],
                     "dtab": "/svc => /#/io.l5d.fs ;"}],
        "namers": [{"kind": "io.l5d.fs", "rootDir": str(tmp_path)}],
        "telemetry": [{"kind": "io.l5d.jaxAnomaly",
                       "sidecarAddress": "/#/io.l5d.nope/l5d-scorer",
                       "sidecarTier": "primary"}]})
    from linkerd_tpu.config import ConfigError as RefConfigError
    from linkerd_tpu.linker import load_linker as ref_load_linker
    with pytest.raises(ConfigError) as port_err:
        load_linker(text, device="cpu")
    with pytest.raises(RefConfigError) as ref_err:
        ref_load_linker(text)
    assert str(port_err.value) == str(ref_err.value)
    assert "no configured namer covers" in str(port_err.value)


def test_telemeter_builds_pool_for_list_and_path_addresses():
    """As the reference's: a list and a path give a pool, one address a
    client; each telemeter wraps it in the breaker, tiered by default."""
    out = {}
    for name, mod, mk in (
            ("ref", ref_anomaly, lambda c: ref_anomaly.JaxAnomalyTelemeter(
                c, RefMetricsTree())),
            ("port", port_anomaly, lambda c: port_anomaly.JaxAnomalyTelemeter(
                c, MetricsTree(), device="cpu"))):
        got = []
        for addr in ("127.0.0.1:1,127.0.0.1:2", "/#/io.l5d.fs/l5d-scorer",
                     "127.0.0.1:1"):
            for tier in ("fallback", "primary"):
                tele = mk(mod.JaxAnomalyConfig(sidecarAddress=addr,
                                               sidecarTier=tier))
                s = tele._ensure_scorer()
                inner = s.fallback if tier == "fallback" else s
                got.append((type(s).__name__, type(inner).__name__,
                            type(inner._inner).__name__,
                            inner.call_timeout_s, inner.breaker.failures,
                            None if tele._scorer_pool is None
                            else tele._scorer_pool.addresses(),
                            sorted(tele.model_state())))
                tele.close()
        out[name] = got
    assert out["port"] == out["ref"]
    assert out["port"][0][:3] == ("TieredScorer", "ResilientScorer",
                                  "ScorerReplicaPool")


# -- the telemeter and the linker on the port's sidecars -------------------------


def test_tiered_config_needs_a_device_and_primary_does_not():
    """No hidden fallback: with no CUDA device and no device named, a
    tiered telemeter refuses to build and names ``sidecarTier:
    primary``; with it, the telemeter builds nothing on a device."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = port_anomaly.JaxAnomalyConfig
    with pytest.raises(RuntimeError, match="sidecarTier: primary"):
        port_anomaly.JaxAnomalyTelemeter(
            cfg(sidecarAddress="127.0.0.1:1"), MetricsTree())
    with pytest.raises(RuntimeError, match="no CUDA device") as e:
        port_anomaly.JaxAnomalyTelemeter(cfg(), MetricsTree())
    assert "sidecarTier" not in str(e.value)
    tele = port_anomaly.JaxAnomalyTelemeter(
        cfg(sidecarAddress="127.0.0.1:1", sidecarTier="primary"),
        MetricsTree())
    assert tele.device is None
    assert type(tele._ensure_scorer()).__name__ == "ResilientScorer"
    tele.close()
    # the reference quietly serves from the sidecar alone instead
    ref = ref_anomaly.JaxAnomalyTelemeter(
        ref_anomaly.JaxAnomalyConfig(sidecarAddress="127.0.0.1:1"),
        RefMetricsTree())
    ref.close()


async def _backend(req):
    return Response(200, body=b"x" * 200)


async def _replicas(n, **kw):
    return [await port_sidecar.ScorerSidecar(
        scorer=InProcessScorer(device="cpu"), warmup_rows=4, **kw).start()
        for _ in range(n)]


def linker_text(disco, addr, tier, **tele):
    return json.dumps({
        "routers": [{"protocol": "http", "label": "rt",
                     "dtab": "/svc => /#/io.l5d.fs ;",
                     "servers": [{"port": 0}],
                     "client": {"failureAccrual": {"kind": "none"}}}],
        "namers": [{"kind": "io.l5d.fs", "rootDir": str(disco)}],
        "telemetry": [{"kind": "io.l5d.jaxAnomaly", "nativeTier": "off",
                       "sidecarAddress": addr, "sidecarTier": tier,
                       **tele}]})


REQUESTS = 64


@pytest.mark.parametrize("tier", ["primary", "fallback"])
@pytest.mark.parametrize("form", ["pinned", "list", "path"])
def test_configs_load_and_score(tmp_path, form, tier):
    """Each address form under each tier loads and scores every request
    of an HTTP router on the port; training crosses the hop with
    ``sidecarTier: primary`` and stays in process with the fallback."""
    async def go():
        reps = await _replicas(2)
        anns = [port_sidecar.announce_replica(str(tmp_path), "l5d-scorer",
                                              "127.0.0.1", r.port)
                for r in reps]
        backend = await serve(FnService(_backend))
        (tmp_path / "web").write_text(f"127.0.0.1 {backend.bound_port}\n")
        addrs = [f"127.0.0.1:{r.port}" for r in reps]
        addr = {"pinned": addrs[0], "list": ",".join(addrs),
                "path": "/#/io.l5d.fs/l5d-scorer"}[form]
        linker = load_linker(linker_text(tmp_path, addr, tier,
                                         trainEveryBatches=1, maxBatch=16),
                             device="cpu")
        await linker.start()
        tele = linker.telemeters[0]
        task = asyncio.create_task(tele.run())
        client = HttpClient("127.0.0.1", linker.routers[0].server_ports[0])
        try:
            for _ in range(REQUESTS):
                req = Request(uri="/")
                req.headers.set("Host", "web")
                assert (await client(req)).status == 200
            deadline = time.monotonic() + 30
            while tele._scored.value < REQUESTS:
                assert time.monotonic() < deadline, tele._scored.value
                await asyncio.sleep(0.01)
            st = tele.model_state()
            assert st["scored_total"] == st["requests_total"] == REQUESTS
            assert not st["degraded"] and st["breaker"]["state"] == "closed"
            rows = sum(r.service.rows_scored for r in reps)
            steps = [r.scorer._step for r in reps]
            if tier == "primary":
                assert rows == REQUESTS and sum(steps) > 0
                assert "tiers" not in st
            else:
                assert rows == 0 and steps == [0, 0]
                assert st["tiers"]["fallback_calls"] == 0
                assert st["tiers"]["primary_calls"] > 0
            if form == "pinned":
                assert "scorer_pool" not in st
            else:
                calls = {a: r["calls"]
                         for a, r in st["scorer_pool"]["replicas"].items()}
                assert sorted(calls) == sorted(addrs)
                if tier == "primary":
                    assert all(calls.values()), calls
            assert np.isfinite(tele.board.score_of("/svc/web"))
        finally:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
            await client.close()
            await linker.close()
            await backend.close()
            for a in anns:
                a.close()
            for r in reps:
                await r.close()

    run(go(), timeout=120)


def test_pool_over_port_sidecars_fails_over_and_degrades():
    """Two of the port's sidecars behind the pool and the breaker, as a
    ``sidecarTier: primary`` telemeter builds them: both serve; one
    closed, every call fails over; both closed, the breaker opens and
    the telemeter degrades; one back on its port, a probe recovers."""
    async def go():
        reps = await _replicas(2)
        ports = [r.port for r in reps]
        tele = port_anomaly.JaxAnomalyTelemeter(
            port_anomaly.JaxAnomalyConfig(
                sidecarAddress=",".join(f"127.0.0.1:{p}" for p in ports),
                sidecarTier="primary", trainEveryBatches=0,
                scoreTimeoutMs=500, breakerFailures=1,
                breakerMinBackoffMs=100, breakerMaxBackoffMs=200),
            MetricsTree())
        flat = tele.metrics.flatten

        async def batch(n=8):
            for i in range(n):
                tele.ring.append((FeatureVector(
                    dst_path="/svc/a", latency_ms=1.0 + i), None))
            return await tele.drain_once()

        try:
            for _ in range(6):
                assert await batch() == 8
            pool = tele._scorer_pool.status()["replicas"]
            assert all(r["calls"] for r in pool.values()), pool
            await reps[0].close()
            for _ in range(4):
                assert await batch() == 8
            assert flat()["anomaly/degraded"] == 0.0
            await reps[1].close()
            assert await batch() == 0
            assert flat()["anomaly/degraded"] == 1.0
            assert tele.board.degraded
            assert tele.model_state()["breaker"]["state"] == "open"
            back = await _replicas(1, port=ports[1])
            reps.append(back[0])
            deadline = time.monotonic() + 10
            while await batch() == 0:
                assert time.monotonic() < deadline, "no recovery"
                await asyncio.sleep(0.05)
            assert flat()["anomaly/degraded"] == 0.0
            assert tele.model_state()["breaker"]["state"] == "closed"
        finally:
            tele.close()
            for r in reps:
                await r.close()

    run(go(), timeout=120)


def test_fleet_model_push_restores_every_replica(tmp_path):
    """A promotion (the lifecycle's first cycle promotes) restores the
    serving checkpoint on every replica of the pool: the replicas then
    hold the router's step and score a probe batch as its in-process
    scorer does."""
    async def go():
        reps = await _replicas(2)
        tele = port_anomaly.JaxAnomalyTelemeter(
            port_anomaly.JaxAnomalyConfig(
                sidecarAddress=",".join(f"127.0.0.1:{r.port}"
                                        for r in reps),
                trainEveryBatches=0,
                lifecycle=port_anomaly.LifecycleConfig(
                    directory=str(tmp_path / "ckpt"), checkpointEveryS=0)),
            MetricsTree(), device="cpu")
        try:
            tiered = tele._ensure_scorer()
            x = np.random.default_rng(3).standard_normal(
                (37, 36)).astype(np.float32)
            await tiered.fit(x, np.zeros(37), np.ones(37))
            outcome = await tele.lifecycle_cycle()
            assert outcome["action"] == "promoted"
            deadline = time.monotonic() + 30
            while tele._fleet_model_pushes.value < 2:
                assert time.monotonic() < deadline, "no fleet push"
                await asyncio.sleep(0.02)
            want = await tiered.primary.score(x)
            for r in reps:
                assert r.scorer._step == tiered.primary._step == 4
                np.testing.assert_array_equal(await r.scorer.score(x), want)
            assert tele.metrics.flatten()["anomaly/fleet_model_pushes"] == 2
        finally:
            tele.close()
            for r in reps:
                await r.close()

    run(go(), timeout=120)


# -- the reference's chaos drill, against the port's CLI --------------------------


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def http_get(port: int, path: str, host: str = None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 headers={"Host": host} if host else {})
    with urllib.request.urlopen(req, timeout=10) as rsp:
        return rsp.status, rsp.read()


def test_chaos_drill_against_the_cli(tmp_path):
    """``validate_chaos`` on the port: the CLI's router with its sidecar
    black-holed answers every request inside its 1 s budget and
    ``anomaly/degraded`` reads 1; a live port sidecar on the same port
    brings it back to 0."""
    async def go():
        backend = await serve(FnService(_backend))
        disco = tmp_path / "disco"
        disco.mkdir()
        (disco / "web").write_text(f"127.0.0.1 {backend.bound_port}\n")
        side_port, router_port, admin_port = (free_port() for _ in range(3))
        hole = await port_faults.BlackholeServer(port=side_port).start()
        cfg = tmp_path / "linkerd.json"
        cfg.write_text(json.dumps({
            "routers": [{"protocol": "http", "label": "chaos",
                         "dtab": "/svc => /#/io.l5d.fs ;",
                         "service": {"totalTimeoutMs": 1000},
                         "admissionControl": {"maxConcurrency": 512,
                                              "maxPending": 64},
                         "servers": [{"port": router_port}]}],
            "namers": [{"kind": "io.l5d.fs", "rootDir": str(disco)}],
            "telemetry": [{"kind": "io.l5d.jaxAnomaly",
                           "sidecarAddress": f"127.0.0.1:{side_port}",
                           "sidecarTier": "primary", "intervalMs": 20,
                           "trainEveryBatches": 0, "scoreTimeoutMs": 200,
                           "breakerFailures": 1,
                           "breakerMinBackoffMs": 200,
                           "breakerMaxBackoffMs": 400,
                           "scoreTtlSecs": 2}],
            "admin": {"port": admin_port},
            "usage": {"enabled": False}}))
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        proc = subprocess.Popen(
            [sys.executable, "-m", "linkerd_tpu_torch", "--device", "cpu",
             str(cfg)], env=env, cwd=tmp_path, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)
        side = None

        def degraded():
            _, body = http_get(admin_port, "/admin/metrics.json?q=anomaly")
            return float(json.loads(body).get("anomaly/degraded", -1.0))

        def route_ok():
            t0 = time.monotonic()
            st, body = http_get(router_port, "/", host="web")
            assert time.monotonic() - t0 < 1.0, "over the 1 s budget"
            return st == 200 and body == b"x" * 200

        async def wait_for(pred, timeout, what):
            t0 = time.monotonic()
            while time.monotonic() - t0 < timeout:
                assert proc.poll() is None, proc.stderr.read()[-3000:]
                try:
                    if await asyncio.to_thread(pred):
                        return time.monotonic() - t0
                except OSError:
                    pass
                await asyncio.sleep(0.05)
            raise AssertionError(f"chaos: no {what} in {timeout} s")

        try:
            await wait_for(route_ok, 60, "route to the backend")
            await wait_for(lambda: route_ok() and degraded() == 1.0, 20,
                           "degraded flip")
            for _ in range(10):
                assert await asyncio.to_thread(route_ok)
            await hole.close()
            side = await port_sidecar.ScorerSidecar(
                scorer=InProcessScorer(device="cpu"),
                port=side_port).start()
            await wait_for(lambda: route_ok() and degraded() == 0.0, 20,
                           "recovery")
            assert side.service.rows_scored > 0
        finally:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=10)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            if side is not None:
                await side.close()
            await hole.close()
            await backend.close()

    run(go(), timeout=150)
