"""The port's ``io.l5d.jaxAnomaly`` telemeter core against the JAX
package's, on the CPU.

Both sides take the same inputs, made from a numpy seed: feature rows
(``FeatureVector``s, some appended to the ring and some recorded through
``recorder().and_then(FnService(...))`` with a scripted clock, so their
latencies, rates and drifts are the same in both packages), and one
snapshot, made in the JAX package's layout and carried to the port
through the checkpoint codec (``decode_snapshot(jax_store.encode_
snapshot(...))``). Each telemeter is handed a scorer restored from it.

Bounds (ROADMAP Queue 3). Features, ``DstTemporal``, ``ScoreBoard``
arithmetic and accrual decisions: exact. Scores through the telemeter,
with no training: board values and ``dst/*`` gauges within 1e-3 (bf16
scores against the JAX scorer's own jit). With training every second
batch, the JAX train step compiled with ``xla_allow_excess_precision``
off: ``train_loss`` within 1e-3 relative, the board within 3e-3 (the
bf16 fit bounds).
"""

import asyncio
import dataclasses
import json
import os
import time
import types

import jax
import numpy as np
import pytest
import torch

from linkerd_tpu.distill import DistillConfig as RefDistillConfig
from linkerd_tpu.lifecycle import LifecycleConfig as RefLifecycleConfig
from linkerd_tpu.lifecycle import export as ref_export
from linkerd_tpu.lifecycle import store as ref_store
from linkerd_tpu.models import anomaly as ref_model
from linkerd_tpu.models import features as ref_features
from linkerd_tpu.protocol.http import message as ref_message
from linkerd_tpu.router import service as ref_service
from linkerd_tpu.router import tracing as ref_tracing
from linkerd_tpu.telemetry import anomaly as ref
from linkerd_tpu.telemetry import metrics as ref_metrics
from linkerd_tpu_torch.config import lookup
from linkerd_tpu_torch.distill import DistillConfig
from linkerd_tpu_torch.lifecycle import LifecycleConfig, export, store
from linkerd_tpu_torch.models import features
from linkerd_tpu_torch.protocol.http import message
from linkerd_tpu_torch.router import service, tracing
from linkerd_tpu_torch.telemetry import anomaly as port
from linkerd_tpu_torch.telemetry import metrics

OFF = {"xla_allow_excess_precision": False}
BOARD_ATOL = 1e-3          # scores through the telemeter, no training
FIT_LOSS_REL = 1e-3        # bf16 fit bounds
FIT_BOARD_ATOL = 3e-3
ROUTES = [f"/svc/route-{i}" for i in range(6)]


def run(coro, timeout=300):
    return asyncio.run(asyncio.wait_for(coro, timeout))


# -- inputs ----------------------------------------------------------------


def fields(rng, n, routes=ROUTES, anomalous=0.1, shift=None):
    """``n`` requests' FeatureVector fields from a seed: a tenth of them
    anomalous (slow and 5xx); ``shift`` maps a route to a factor on the
    fields the anomalies leave alone (bytes, concurrency, rate)."""
    out = []
    for _ in range(n):
        dst = routes[int(rng.integers(len(routes)))]
        bad = bool(rng.random() < anomalous)
        k = 1.0 if shift is None else shift.get(dst, 1.0)
        out.append(dict(
            latency_ms=float(rng.gamma(2.0, 150.0 if bad else 4.0)),
            status=int(rng.choice([500, 503]) if bad
                       else rng.choice([200, 200, 200, 204, 404])),
            retries=int(rng.integers(2)),
            request_bytes=int(rng.integers(50, 2000) * k),
            response_bytes=int(rng.integers(100, 8000) * k),
            concurrency=int(rng.integers(1, 16) * k),
            ewma_ms=float(rng.gamma(2.0, 3.0)),
            queue_ms=float(rng.gamma(1.0, 0.5)),
            exception=False, retryable=bad and bool(rng.random() < 0.5),
            dst_path=dst, dst_rps=float(rng.uniform(5, 50) * k),
            lat_drift_ms=float(rng.normal(0.0, 20.0 if bad else 2.0)),
            label=1.0 if bad else 0.0))
    return out


def fv_pair(f):
    kw = {k: v for k, v in f.items() if k != "label"}
    return ref_features.FeatureVector(**kw), features.FeatureVector(**kw)


class Clock:
    """A scripted ``time`` module: ``monotonic`` reads ``now``, which
    the caller moves; ``time`` is the real clock."""

    def __init__(self, now=1000.0):
        self.now = now

    def monotonic(self):
        return self.now

    @staticmethod
    def time():
        return time.time()


@pytest.fixture
def clocks(monkeypatch):
    """One scripted clock for each package's telemeter module."""
    c = Clock(), Clock()
    monkeypatch.setattr(ref, "time", c[0])
    monkeypatch.setattr(port, "time", c[1])
    return c


def stats_of(rows):
    x = features.featurize_batch([fv_pair(f)[1] for f in rows])
    return x.mean(axis=0).astype(np.float32), \
        (x.var(axis=0) + 1e-6).astype(np.float32)


def start_snapshot(seed=0):
    """A JAX-layout snapshot: the JAX ``init_params`` with biases drawn
    from the seed, zero Adam state, and the stats of a seeded stream of
    feature rows."""
    s = ref.InProcessScorer(devices=jax.devices()[:1])
    snap = s.snapshot()
    s.close()
    p = jax.tree_util.tree_map(np.asarray, ref_model.init_params(
        jax.random.key(seed), ref_model.AnomalyModelConfig()))
    rng = np.random.default_rng(seed)
    for group in p.values():
        for layer in group:
            layer["b"] = (rng.standard_normal(layer["b"].shape)
                          * 0.1).astype(np.float32)
    snap.params = p
    snap.mu, snap.var = stats_of(fields(rng, 512))
    snap.norm_initialized = True
    return snap


def to_port(snap):
    return store.decode_snapshot(ref_store.encode_snapshot(snap))


@pytest.fixture(scope="module")
def snap():
    return start_snapshot()


def scorers(snap, excess_precision=True):
    """(reference, port) scorers restored from ``snap``; with
    ``excess_precision`` off the JAX train step is compiled as the
    port's training is held to."""
    r = ref.InProcessScorer(devices=jax.devices()[:1])
    if not excess_precision:
        r._train_step = jax.jit(r._train_step.__wrapped__,
                                compiler_options=OFF)
    r.restore(snap)
    p = port.InProcessScorer(device="cpu")
    p.restore(to_port(snap))
    return r, p


def telemeters(snap, cfg_kw, excess_precision=True, lifecycle=None,
               distill=None):
    """The two telemeters, each on its own metrics tree and scorer; a
    ``lifecycle`` block's store goes to ``ref/`` and ``port/`` under its
    directory."""
    rs, ps = scorers(snap, excess_precision)

    def lc(cls, pkg):
        if lifecycle is None:
            return None
        return cls(**dict(lifecycle, directory=os.path.join(
            lifecycle["directory"], pkg)))

    rcfg = ref.JaxAnomalyConfig(
        **cfg_kw, lifecycle=lc(RefLifecycleConfig, "ref"),
        distill=distill and RefDistillConfig(**distill))
    pcfg = port.JaxAnomalyConfig(
        **cfg_kw, lifecycle=lc(LifecycleConfig, "port"),
        distill=distill and DistillConfig(**distill))
    rm, pm = ref_metrics.MetricsTree(), metrics.MetricsTree()
    return (ref.JaxAnomalyTelemeter(rcfg, rm, scorer=rs),
            port.JaxAnomalyTelemeter(pcfg, pm, scorer=ps, device="cpu"),
            rm, pm)


class Dst:
    def __init__(self, path):
        self.path = types.SimpleNamespace(show=path)


async def record(tele, clock, rows, pkg):
    """Each row through the telemeter's recorder: the downstream takes
    the row's latency on the scripted clock and answers its status; the
    next request comes 5 ms later."""
    msg, svc_mod = (ref_message, ref_service) if pkg == "ref" \
        else (message, service)

    async def downstream(req):
        clock.now += req.ctx["lat"] / 1e3
        rsp = msg.Response(req.ctx["status"])
        rsp.headers.set("l5d-fault-label", str(req.ctx["label"]))
        return rsp

    svc = tele.recorder().and_then(svc_mod.FnService(downstream))
    for f in rows:
        req = msg.Request()
        req.ctx.update(dst=Dst(f["dst_path"]), lat=f["latency_ms"],
                       status=f["status"], label=f["label"],
                       retries=f["retries"])
        await svc(req)
        clock.now += 5e-3


def append(teles, rows, endpoint=False):
    """Each row onto both rings, as external producers append: a
    2-tuple, or the recorder's 5-tuple with an endpoint."""
    for i, f in enumerate(rows):
        for tele, fv in zip(teles, fv_pair(f)):
            if endpoint:
                tele.ring.append((fv, f["label"], None, None,
                                  f"10.0.0.{i % 3}:80"))
            else:
                tele.ring.append((fv, f["label"]))


async def feed(teles, clocks, seed, n_ring=96, n_rec=64, **kw):
    rng = np.random.default_rng(seed)
    append(teles, fields(rng, n_ring // 2, **kw))
    rows = fields(rng, n_rec, **kw)
    await record(teles[0], clocks[0], rows, "ref")
    await record(teles[1], clocks[1], rows, "port")
    append(teles, fields(rng, n_ring - n_ring // 2, **kw), endpoint=True)


async def drain_all(teles):
    """``drain_once`` on both until both rings are empty; returns the
    rows each drained."""
    done = [0, 0]
    while any(len(t.ring) for t in teles):
        for i, t in enumerate(teles):
            done[i] += await t.drain_once()
    return done


def board_gap(a, b):
    ea, eb = a.effective_scores(), b.effective_scores()
    assert sorted(ea) == sorted(eb)
    return max(abs(ea[k] - eb[k]) for k in ea)


def dst_gauges(flat):
    return {k: v for k, v in flat.items() if k.startswith("anomaly/dst/")}


# -- features --------------------------------------------------------------


class TestFeatures:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_featurize_batch_bit_equal(self, seed):
        rng = np.random.default_rng(seed)
        rows = fields(rng, 300, routes=[f"/svc/{i}" for i in range(40)]
                      + ["/", "/a/b/c/d", "/ünï/çødé"])
        for f in rows[::7]:  # edge rows: negatives, odd statuses
            f.update(latency_ms=-1.0, status=int(rng.choice([0, 99, 600])),
                     request_bytes=-5, exception=True)
        pairs = [fv_pair(f) for f in rows]
        want = ref_features.featurize_batch([a for a, _ in pairs])
        got = features.featurize_batch([b for _, b in pairs])
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want)
        one = np.stack([features.featurize(b) for _, b in pairs])
        assert np.array_equal(one, want)

    def test_path_hash_and_constants(self):
        for path in ROUTES + ["/", "/svc/x", "/ünï"]:
            assert features.path_hash_cols(path) == \
                ref_features.path_hash_cols(path)
        assert features.FEATURE_DIM == ref_features.FEATURE_DIM
        assert features._ABLATE == ref_features._ABLATE
        assert [f.name for f in dataclasses.fields(features.FeatureVector)] \
            == [f.name for f in
                dataclasses.fields(ref_features.FeatureVector)]

    @pytest.mark.parametrize("max_dsts", [4096, 3])
    def test_dst_temporal_observe_equal(self, max_dsts):
        rng = np.random.default_rng(max_dsts)
        a = ref_features.DstTemporal(max_dsts=max_dsts)
        b = features.DstTemporal(max_dsts=max_dsts)
        now = 50.0
        for _ in range(600):
            dst = f"/svc/{int(rng.integers(6))}"
            lat = float(rng.gamma(2.0, 200.0 if rng.random() < 0.1
                                  else 5.0))
            err = bool(rng.random() < 0.1)
            now += float(rng.exponential(0.01)) * (rng.random() < 0.9)
            assert b.observe(dst, lat, err, now) == \
                a.observe(dst, lat, err, now)


# -- copies of the reference's device-free modules --------------------------


def test_metrics_tree_flattens_alike():
    trees = ref_metrics.MetricsTree(), metrics.MetricsTree()
    rng = np.random.default_rng(4)
    vals = rng.gamma(2.0, 3.0, 200)
    for t in trees:
        t.counter("a", "requests").incr(3)
        t.scope("a").gauge("depth", fn=lambda: 7.0)
        t.gauge("b", "level").set(0.25)
        for v in vals:
            t.stat("a", "latency_ms").add(float(v))
        t.counter("c", "gone").incr()
        t.prune("c")
    assert trees[1].flatten() == trees[0].flatten()
    assert trees[1].tree_dict() == trees[0].tree_dict()


def test_var_and_trace_ids_alike():
    from linkerd_tpu.core.var import Var as RefVar
    from linkerd_tpu_torch.core import Var
    seen = ([], [])
    for v, out in zip((RefVar({}), Var({})), seen):
        v.observe(out.append)
        for upd in ({}, {"a": 1}, {"a": 1}, {"a": 2}):
            v.update(upd)
        assert v.map(len).sample() == 1
    assert seen[0] == seen[1] == [{}, {"a": 1}, {"a": 2}]
    t = ref_tracing.TraceId.mk_root()
    got = tracing.TraceId.decode(t.encode())
    assert (got.trace_id, got.span_id, got.parent_id, got.sampled) == \
        (t.trace_id, t.span_id, t.parent_id, t.sampled)
    assert got.encode() == t.encode()
    assert got.child().parent_id == t.span_id


# -- ScoreBoard ----------------------------------------------------------------


class TestScoreBoard:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_update_sequence_matches(self, clocks, seed):
        """The same update_batch sequence, with endpoints, across the
        TTL (decay to neutral), endpoint pruning and degraded mode."""
        rng = np.random.default_rng(seed)
        boards = ref.ScoreBoard(ttl_s=30.0), port.ScoreBoard(ttl_s=30.0)
        eps = [f"10.0.0.{i}:80" for i in range(5)]
        for step in range(40):
            n = int(rng.integers(1, 20))
            dsts = [ROUTES[int(rng.integers(3 if step > 20 else 6))]
                    for _ in range(n)]
            scores = rng.random(n).astype(np.float32)
            ep = [eps[int(rng.integers(2 if step > 25 else 5))]
                  if rng.random() < 0.8 else None for _ in range(n)]
            dt = float(rng.choice([0.5, 5.0, 40.0]))
            for c in clocks:
                c.now += dt
            degraded = bool(rng.random() < 0.15)
            for b in boards:
                b.update_batch(dsts, scores, endpoints=ep)
                b.degraded = degraded
            a, b = boards
            assert b.effective_scores() == a.effective_scores()
            assert b.effective_endpoint_scores() == \
                a.effective_endpoint_scores()
            assert b.anomaly_level() == a.anomaly_level()
            assert sorted(b._ep_scores) == sorted(a._ep_scores)
            for d in ROUTES:
                assert b.score_of(d) == a.score_of(d)
            for e in eps:
                assert b.endpoint_score_of(e) == a.endpoint_score_of(e)
        # late endpoints were pruned, late routes decayed to neutral
        assert len(boards[1]._ep_scores) < len(eps)
        assert min(boards[1].effective_scores().values()) == 0.0


# -- the telemeter -----------------------------------------------------------


class TestTelemeter:
    def test_drain_once_matches_reference(self, snap, clocks):
        """trainEveryBatches 0: ring and recorder rows drained to the
        end by drain_once in both packages."""
        async def go():
            cfg = dict(maxBatch=64, trainEveryBatches=0)
            rt, pt, rm, pm = telemeters(snap, cfg)
            try:
                await feed((rt, pt), clocks, seed=5)
                assert [len(t.ring) for t in (rt, pt)] == [160, 160]
                for a, b in zip(rt.ring, pt.ring):  # recorded alike
                    assert np.array_equal(
                        features.featurize(b[0]),
                        ref_features.featurize(a[0]))
                    a, b = ((it + (None,) * 3)[:5] for it in (a, b))
                    assert (a[1], a[3], a[4]) == (b[1], b[3], b[4])
                assert await drain_all((rt, pt)) == [160, 160]
                gap = board_gap(rt.board, pt.board)
                rf, pf = rm.flatten(), pm.flatten()
                gauges = dst_gauges(rf)
                assert sorted(pf) == sorted(rf)
                assert len(gauges) == len(ROUTES)
                ggap = max(abs(pf[k] - v) for k, v in gauges.items())
                print(f"board max|diff| {gap:.3e}, dst gauges {ggap:.3e}")
                assert gap <= BOARD_ATOL and ggap <= BOARD_ATOL
                for k in ("anomaly/requests_total", "anomaly/scored_total",
                          "anomaly/batches", "anomaly/degraded",
                          "anomaly/score_failures"):
                    assert pf[k] == rf[k], k
                assert (pf["anomaly/requests_total"],
                        pf["anomaly/batches"]) == (64, 3)
                assert pf["anomaly/scored_fraction"] == 1.0
                got, want = pt.model_state(), rt.model_state()
                assert sorted(got) == sorted(want)
                for k in ("lifecycle_enabled", "live_step", "scorer",
                          "degraded", "requests_total", "scored_total",
                          "scored_fraction", "line_rate"):
                    assert got[k] == want[k], k
                assert sorted(got["native_tier"]) == \
                    sorted(want["native_tier"])
                paths = [p for p, _ in pt.admin_handlers()]
                assert paths == [p for p, _ in rt.admin_handlers()]
                for (_, h), (_, rh) in zip(pt.admin_handlers(),
                                           rt.admin_handlers()):
                    rsp = await h(message.Request())
                    assert rsp.status == 200
                    assert rsp.headers.get("Content-Type") == \
                        "application/json"
                    assert sorted(json.loads(rsp.body)) == sorted(
                        json.loads((await rh(ref_message.Request())).body))
            finally:
                rt.close()
                pt.close()

        run(go())

    def test_line_rate_scores_within_linger(self, snap):
        """``run()`` as a task: recorded rows are scored within the
        linger with no manual drain, and the scored fraction reads 1.0
        (as tests/test_line_rate.py's batcher test, on the port's own
        scorer)."""
        async def go():
            mt = metrics.MetricsTree()
            tele = port.JaxAnomalyConfig(
                maxBatch=64, trainEveryBatches=0, maxLingerMs=2.0,
            ).mk(mt, device="cpu")
            rec = tele.recorder()
            drain = asyncio.ensure_future(tele.run())
            try:
                async def ok(req):
                    return message.Response(200)

                svc = rec.and_then(service.FnService(ok))
                for _ in range(10):
                    await svc(message.Request())
                t0 = time.monotonic()
                while mt.flatten().get("anomaly/scored_total", 0) < 10:
                    assert time.monotonic() - t0 < 5.0, \
                        "rows not scored within deadline"
                    await asyncio.sleep(0.005)
                flat = mt.flatten()
                assert flat["anomaly/requests_total"] == 10
                assert flat["anomaly/scored_fraction"] == 1.0
                assert "anomaly/dst/unidentified" in flat
                state = tele.model_state()
                assert state["scored_fraction"] == 1.0
                assert state["line_rate"] is True
                assert state["scorer"] == "InProcessScorer"
            finally:
                drain.cancel()
                await asyncio.gather(drain, return_exceptions=True)
                tele.close()

        run(go())

    def test_interval_loop_drains_bursts(self, snap):
        async def go():
            mt = metrics.MetricsTree()
            tele = port.JaxAnomalyConfig(
                maxBatch=16, trainEveryBatches=0, lineRate=False,
                intervalMs=5, maxBatchesPerWake=2).mk(mt, device="cpu")
            append((tele, tele), fields(np.random.default_rng(2), 40)[::2])
            assert len(tele.ring) == 40
            drain = asyncio.ensure_future(tele.run())
            try:
                t0 = time.monotonic()
                while mt.flatten()["anomaly/scored_total"] < 40:
                    assert time.monotonic() - t0 < 5.0
                    await asyncio.sleep(0.005)
                assert mt.flatten()["anomaly/batches"] == 3
            finally:
                drain.cancel()
                await asyncio.gather(drain, return_exceptions=True)
                tele.close()

        run(go())

    def test_training_matches_reference(self, snap, clocks, tmp_path):
        """trainEveryBatches 2 on labeled rows, with a lifecycle block:
        the same batches go to the hold-out and the same to fits, each
        fit's loss within 1e-3 relative, the board within 3e-3. The
        bounds are those of four Adam steps from one state, so before
        each fit the reference's scorer takes the port's state (as the
        card's fit check resyncs its CPU twin); an optimizer amplifies
        summation-order differences over more steps (ROADMAP Queue 3)."""
        async def go():
            rt, pt, rm, pm = telemeters(
                snap, dict(maxBatch=32, trainEveryBatches=2),
                excess_precision=False,
                lifecycle=dict(directory=str(tmp_path), checkpointEveryS=0,
                               holdoutEveryBatches=3))
            fits = ([], [])
            for tele, log in zip((rt, pt), fits):
                real = tele._scorer.fit

                async def fit(x, labels, mask, real=real, tele=tele,
                              log=log):
                    if tele is rt:  # the port fits this batch next
                        tele._scorer.restore(ref_store.decode_snapshot(
                            store.encode_snapshot(pt._scorer.snapshot())))
                    loss = await real(x, labels, mask)
                    log.append((tele._batch_i, x.copy(), float(loss)))
                    return loss

                tele._scorer.fit = fit
            try:
                await feed((rt, pt), clocks, seed=7, n_ring=224, n_rec=64)
                await drain_all((rt, pt))
                # batches 0, 3, 6 held out; fits after batches 1, 5, 7
                assert [b for b, _, _ in fits[1]] == \
                    [b for b, _, _ in fits[0]] == [2, 6, 8]
                for (_, xa, la), (_, xb, lb) in zip(*fits):
                    assert np.array_equal(xa, xb)
                    print(f"fit loss port {lb} reference {la}")
                    assert abs(lb - la) <= FIT_LOSS_REL * abs(la)
                assert abs(pm.flatten()["anomaly/train_loss"]
                           - rm.flatten()["anomaly/train_loss"]) <= \
                    FIT_LOSS_REL * abs(rm.flatten()["anomaly/train_loss"])
                ra, pa = rt.lifecycle.replay, pt.lifecycle.replay
                assert len(pa) == len(ra) == 3 * 32
                assert np.array_equal(pa.sample()[0], ra.sample()[0])
                gap = board_gap(rt.board, pt.board)
                print(f"board after fits max|diff| {gap:.3e}")
                assert gap <= FIT_BOARD_ATOL
                assert pt._scorer._step == rt._scorer._step == 12
            finally:
                rt.close()
                pt.close()

        run(go())


class TestLifecycle:
    def cfg(self, tmp_path, **kw):
        lc = LifecycleConfig(directory=str(tmp_path / "ckpts"),
                             checkpointEveryS=0, minReplayRows=16, **kw)
        return port.JaxAnomalyConfig(maxBatch=64, trainEveryBatches=1,
                                     lifecycle=lc)

    def feed(self, tele, n, seed, anomalous=False):
        rng = np.random.default_rng(seed)
        for _ in range(n):
            fv = features.FeatureVector(
                latency_ms=float(rng.gamma(2.0, 200.0 if anomalous
                                           else 5.0)),
                status=500 if anomalous else 200, dst_path="/svc/web")
            tele.ring.append((fv, 1.0 if anomalous else 0.0))

    def test_holdout_batches_never_reach_fit(self, tmp_path):
        """As tests/test_lifecycle.py's: a hold-out batch grows the
        replay window and trains nothing."""
        async def go():
            tele = self.cfg(tmp_path).mk(metrics.MetricsTree(),
                                         device="cpu")
            scorer = tele._ensure_scorer()
            hk = tele.cfg.lifecycle.holdoutEveryBatches
            for i in range(3 * hk):
                self.feed(tele, 8, seed=i)
                step_before = scorer._step
                await tele.drain_once()
                if (tele._batch_i - 1) % hk == 0:
                    assert scorer._step == step_before
                else:
                    assert scorer._step > step_before
            assert len(tele.lifecycle.replay) == 3 * 8
            tele.close()

        run(go())

    def test_cycle_model_state_and_restart_restore(self, snap, tmp_path):
        """Both packages promote on a cycle; model_state has the
        reference's keys; close() saves a candidate, and a new telemeter
        whose run() restores on start serves the promoted model."""
        def teles(path):
            return telemeters(snap, dict(maxBatch=64, trainEveryBatches=1),
                              lifecycle=dict(directory=str(path),
                                             checkpointEveryS=0,
                                             minReplayRows=16))

        async def go():
            rt, pt, rm, pm = teles(tmp_path)
            append((rt, pt), fields(np.random.default_rng(1), 48))
            outs = []
            for t in (rt, pt):
                await t.drain_once()
                assert len(t.lifecycle.replay) == 48
                outs.append(await t.lifecycle_cycle())
            assert [o["action"] for o in outs] == ["promoted"] * 2
            want, got = rt.model_state(), pt.model_state()
            assert sorted(got) == sorted(want)
            assert got["serving_version"] == outs[1]["version"]
            assert got["drift"]["batches_observed"] == 1
            rsp = await dict(pt.admin_handlers())["/model.json"](
                message.Request())
            assert rsp.status == 200 and b"serving_version" in rsp.body
            flat = pm.flatten()
            assert flat["anomaly/model/version"] == outs[1]["version"]
            assert sorted(flat) == sorted(rm.flatten())
            x = np.random.default_rng(3).standard_normal(
                (32, 36)).astype(np.float32)
            before = await pt._scorer.score(x)
            step = pt._scorer._step
            rt.close()
            pt.close()  # writes the shutdown candidate
            assert [v.status for v in pt.lifecycle.store.versions()] \
                == [v.status for v in rt.lifecycle.store.versions()] \
                == ["promoted", "candidate"]

            tele2 = port.JaxAnomalyConfig(
                maxBatch=64, trainEveryBatches=1, lifecycle=LifecycleConfig(
                    directory=str(tmp_path / "port"), checkpointEveryS=0),
            ).mk(metrics.MetricsTree(), device="cpu")
            assert tele2.cfg.lifecycle.restoreOnStart
            restored = asyncio.get_running_loop().create_future()
            real = tele2.lifecycle.bootstrap

            async def bootstrap(scorer):
                v = await real(scorer)
                restored.set_result(v)
                return v

            tele2.lifecycle.bootstrap = bootstrap
            task = asyncio.ensure_future(tele2.run())
            try:
                assert await asyncio.wait_for(restored, 10.0) == \
                    outs[1]["version"]
                assert tele2._scorer._step == step
                after = await tele2._scorer.score(x)
            finally:
                task.cancel()
                await asyncio.gather(task, return_exceptions=True)
                tele2.close()
            assert before.tobytes() == after.tobytes()

        run(go())


# -- weight sinks ---------------------------------------------------------------


class TestWeightSinks:
    @pytest.mark.parametrize("quant", ["f32", "int8", "int4"])
    def test_refresh_hands_sinks_equal_bytes(self, snap, quant):
        async def go():
            rt, pt, _, _ = telemeters(snap, dict(nativeQuant=quant))
            got = ([], [])
            try:
                for t, out in zip((rt, pt), got):
                    t.register_weight_sink(out.append)
                    assert await t.refresh_native_weights() is True
                    late = []
                    t.register_weight_sink(late.append)  # replays
                    assert late == out
                assert len(got[1]) == 1 and got[1] == got[0]
                assert export.blob_meta(got[1][0]) == \
                    ref_export.blob_meta(got[0][0])
                assert pt.native_tier_state() == rt.native_tier_state()
            finally:
                rt.close()
                pt.close()

        run(go())

    def test_rejecting_delta_sink_falls_back_to_full(self, snap):
        rt, pt, _, _ = telemeters(snap, {})
        try:
            seen = ([], [])
            for t, out in zip((rt, pt), seen):
                def reject(blob):
                    raise ValueError("generation fence")

                t.register_weight_sink(lambda b, out=out:
                                       out.append(("full", b)), reject)
                t.register_weight_sink(lambda b, out=out:
                                       out.append(("full2", b)),
                                       lambda b, out=out:
                                       out.append(("delta", b)))
                assert t.publish_bank_update(b"FULL", b"DELTA") is True
                assert t.publish_bank_update(None, b"D2") is True
                t.unregister_weight_sink(t._weight_sinks[1])
                assert t.publish_bank_update(b"F3", b"D3") is False
            assert seen[1] == seen[0] == [
                ("full", b"FULL"), ("delta", b"DELTA"), ("delta", b"D2"),
                ("full", b"F3")]
        finally:
            rt.close()
            pt.close()


# -- the distill hook -------------------------------------------------------


def room(decision, tol_loss=0.10, tol_auc=0.02):
    c, s = decision["candidate"], decision["serving"]
    out = [(s["loss"] * (1 + tol_loss) - c["loss"]) / s["loss"]]
    if c["auc"] is not None and s["auc"] is not None:
        out.append(c["auc"] - s["auc"] + tol_auc)
    return out


@pytest.fixture(scope="module")
def teacher(snap):
    """``snap`` after ten fits of the JAX scorer (lr 5e-3) on labeled
    rows of the feature stream: a model that reconstructs normal rows,
    so a route's shifted rows move its scores."""
    async def go():
        s = ref.InProcessScorer(devices=jax.devices()[:1],
                                learning_rate=5e-3)
        s.restore(snap)
        rng = np.random.default_rng(21)
        try:
            for _ in range(10):
                rows = fields(rng, 256)
                x = features.featurize_batch([fv_pair(f)[1] for f in rows])
                await s.fit(x, np.array([f["label"] for f in rows],
                                        np.float32),
                            np.ones(len(x), np.float32))
            return s.snapshot()
        finally:
            s.close()

    return run(go())


def test_distill_hook_promotes_the_same_routes(teacher):
    """``_maybe_distill`` after each drained batch starts ``run_once``
    in both packages, as chip_smoke.py's distill phase builds its routes: every row
    labeled, four of six routes shifted (by 20x to 80x) on the fields
    the anomalies leave alone (bytes, concurrency, rate). Batches go in
    until both banks hold four heads; every retrain is decided alike,
    with each gate's room printed and held well outside the head
    bounds, the same routes hold heads, and each recording sink sees
    the same delta/full sequence by kind and generation."""
    dcfg = dict(maxHeads=4, cooldownS=0.0, retrainSteps=2,
                minRouteRows=32)
    shift = {r: 20.0 * (1 + i) for i, r in enumerate(ROUTES[:4])}

    async def go():
        rt, pt, _, _ = telemeters(teacher, dict(maxBatch=240,
                                                trainEveryBatches=0),
                                  distill=dcfg)
        sinks, outcomes = ([], []), ([], [])
        for t, seen, outs in zip((rt, pt), sinks, outcomes):
            meta = ref_export.blob_meta if t is rt else export.blob_meta
            t.register_weight_sink(
                lambda b, seen=seen, meta=meta: seen.append(
                    ("full", meta(b)["generation"])),
                lambda b, seen=seen, meta=meta: seen.append(
                    ("delta", meta(b)["new_generation"])))
            real = t.distill.run_once

            async def rec(*a, real=real, outs=outs, **kw):
                out = await real(*a, **kw)
                if out is not None:
                    outs.append(out)
                return out

            t.distill.run_once = rec
        rng = np.random.default_rng(9)
        try:
            for b in range(24):
                if len(pt.distill.bank) == len(rt.distill.bank) == 4:
                    break
                append((rt, pt), fields(rng, 240,
                                        shift=shift if b >= 4 else None))
                for t in (rt, pt):
                    await t.drain_once()
                # a retrain this batch started runs to its end before
                # the next batch, in both packages
                while rt.distill.busy or pt.distill.busy:
                    await asyncio.sleep(0.01)
            assert len(outcomes[1]) == len(outcomes[0]) >= 4
            for got, want in zip(*outcomes[::-1]):
                gr, wr = room(got["decision"]), room(want["decision"])
                print(f"{got['route']}: {got['action']} / "
                      f"{want['action']}, gate room port {gr}, "
                      f"reference {wr}")
                assert got["route"] == want["route"]
                assert got["action"] == want["action"] == "promoted"
                # rooms well outside the head bounds (loss 1e-3
                # relative, AUC 0.01): no decision is a coin flip
                assert min(gr[0], wr[0]) > 1e-2
                assert min(gr[1], wr[1]) > 1e-2
            assert sorted(h.dst for h in pt.distill.bank.heads.values()) \
                == sorted(h.dst for h in rt.distill.bank.heads.values()) \
                == sorted(ROUTES[:4])
            assert sinks[1] == sinks[0] == [
                ("delta", g + 1) for g in range(len(outcomes[1]))]
            assert pt.model_state()["distill"]["bank"]["generation"] == \
                len(outcomes[1])
        finally:
            rt.close()
            pt.close()

    run(go())


# -- spans ---------------------------------------------------------------------


def test_sampled_spans_match_reference(snap):
    """With a recording span sink 1 batch in 16 takes ``_score_timed``;
    the span records carry the reference's names and tag keys."""
    class Sink:
        def __init__(self):
            self.spans = []

        def record(self, span):
            self.spans.append(span)

    async def go():
        rt, pt, _, _ = telemeters(snap, dict(maxBatch=8,
                                             trainEveryBatches=0))
        sinks = Sink(), Sink()
        try:
            for t, s in zip((rt, pt), sinks):
                t.set_tracer(s)
                assert t._scorer.timing_enabled
                assert t._scorer.timing_sample_every == 16
            rows = fields(np.random.default_rng(3), 17 * 8)
            for i, f in enumerate(rows):
                for t, fv, tr in zip((rt, pt), fv_pair(f),
                                     (ref_tracing, tracing)):
                    trace = tr.TraceId(1000 + i, 7 + i, 0, i % 2 == 0)
                    t.ring.append((fv, None, trace, 1.0, None))
            await drain_all((rt, pt))
            for t in (rt, pt):
                assert t._scorer.timing_totals["calls"] == 2
                assert sorted(t._scorer.last_timing) == [
                    "bytes", "device_ms", "queue_ms", "transfer_ms"]
            a, b = sinks[0].spans, sinks[1].spans
            assert len(a) == len(b) == 17 * (1 + 4)
            for sa, sb in zip(a, b):
                assert sb["name"] == sa["name"]
                assert sorted(sb) == sorted(sa)
                assert sorted(sb["tags"]) == sorted(sa["tags"])
                assert sb["kind"] == sa["kind"] == "CONSUMER"
            first = [s for s in b if s["name"] == "scorer.batch"][0]
            assert first["tags"]["scorer.batch_size"] == "8"
            assert first["tags"]["scorer.linked"] == "4"
            assert len(first["annotations"]) == 4
            assert {"scorer.device_ms", "scorer.transfer_ms",
                    "scorer.queue_ms", "scorer.bytes"} <= set(first["tags"])
            flat = pt.metrics.flatten()
            assert flat["anomaly/spans_recorded"] == len(b)
        finally:
            rt.close()
            pt.close()

    run(go())


def test_timed_scores_equal_the_ring_scores(snap):
    async def go():
        r, p = scorers(snap)
        r.close()
        try:
            x = features.featurize_batch([fv_pair(f)[1] for f in fields(
                np.random.default_rng(8), 50)])
            ring = await p.score(x)
            p.timing_enabled = True
            timed = await p.score(x)
            assert p.timing_totals["calls"] == 1
            assert p.last_timing["bytes"] == x.nbytes + 4 * len(x)
        finally:
            p.close()
        assert ring.tobytes() == timed.tobytes()

    run(go())


# -- accrual ---------------------------------------------------------------------


@pytest.mark.parametrize("level", [0.1, 0.9])
def test_accrual_decisions_match(level, clocks):
    """Equal boards, explicit backoffs: the same decision sequence,
    calm (under the threshold) and anomalous; then the board's scores
    go stale and the anomalous policy relaxes in both."""
    boards = ref.ScoreBoard(), port.ScoreBoard()
    for b in boards:
        b.update_batch(["/svc/a", "/svc/b"], np.array([0.05, level]))
    rng = np.random.default_rng(int(level * 10))
    ops = rng.choice(["s", "f", "f", "f", "r"], 120)
    decisions = ([], [])
    for board, cfg_cls, out in zip(
            boards, (ref.AnomalyFailureAccrualConfig,
                     port.AnomalyFailureAccrualConfig), decisions):
        cfg = cfg_cls()
        policy = type(cfg.mk(board))(board, cfg.failures,
                                     cfg.anomalousFailures, cfg.threshold,
                                     backoffs=iter(np.arange(1.0, 1e3)))
        for i, op in enumerate(ops):
            if i == 80:
                board.degraded = True
            if op == "s":
                policy.record_success()
            elif op == "r":
                policy.revived()
            else:
                out.append(policy.record_failure())
    assert decisions[1] == decisions[0]
    assert any(d is not None for d in decisions[1])
    assert isinstance(port.AnomalyFailureAccrualConfig().mk(),
                      port.FailureAccrualPolicy)
    assert lookup("failureAccrual", "io.l5d.jaxAnomaly") is \
        port.AnomalyFailureAccrualConfig


# -- config --------------------------------------------------------------------


BAD_CONFIGS = {
    "maxBatchesPerWake": dict(maxBatchesPerWake=0),
    "nativeTier": dict(nativeTier="always"),
    "nativeQuant": dict(nativeQuant="fp16"),
    "distill.quant": dict(distill="int2"),
    "nativeRefreshS": dict(nativeRefreshS=-1.0),
    "maxLingerMs": dict(maxLingerMs=-0.5),
    "scoreConcurrency": dict(scoreConcurrency=0),
    "holdoutEveryBatches": dict(lifecycle=0),
}
REFUSED = {"sidecarAddress": "127.0.0.1:9000", "sidecarTier": "primary",
           "scoreTimeoutMs": 100, "breakerFailures": 2,
           "breakerMinBackoffMs": 10, "breakerMaxBackoffMs": 10}


@pytest.mark.parametrize(
    "case", list(BAD_CONFIGS) + [f"refused:{k}" for k in REFUSED])
def test_config_errors_match_reference(case, tmp_path):
    if case.startswith("refused:"):
        key = case.split(":", 1)[1]
        assert key in {f.name for f in
                       dataclasses.fields(ref.JaxAnomalyConfig)}
        # the port refuses none of them: each key is taken as the
        # reference takes it, and a telemeter builds with it (a sidecar
        # address is only dialled when the scorer is first used)
        assert key not in port.REFUSED_KEYS
        got = port.JaxAnomalyConfig(**{key: REFUSED[key]})
        want = ref.JaxAnomalyConfig(**{key: REFUSED[key]})
        assert getattr(got, key) == getattr(want, key) == REFUSED[key]
        port.JaxAnomalyTelemeter(got, metrics.MetricsTree(),
                                 device="cpu").close()
        return
    kw = dict(BAD_CONFIGS[case])
    mk = {"distill": lambda pkg: (RefDistillConfig if pkg == "ref"
                                  else DistillConfig)(quant=kw["distill"]),
          "lifecycle": lambda pkg: (RefLifecycleConfig if pkg == "ref"
                                    else LifecycleConfig)(
              directory=str(tmp_path / pkg), holdoutEveryBatches=0)}
    for key in ("distill", "lifecycle"):
        if key in kw:
            kw[key] = mk[key]
    errors = []
    for pkg, cfg_cls, build in (
            ("ref", ref.JaxAnomalyConfig,
             lambda c: ref.JaxAnomalyTelemeter(
                 c, ref_metrics.MetricsTree())),
            ("port", port.JaxAnomalyConfig,
             lambda c: port.JaxAnomalyTelemeter(
                 c, metrics.MetricsTree(), device="cpu"))):
        args = {k: (v(pkg) if callable(v) else v) for k, v in kw.items()}
        with pytest.raises(ValueError) as e:
            build(cfg_cls(**args))
        errors.append(str(e.value))
    assert errors[1] == errors[0]


def test_config_keys_and_defaults_match_reference():
    ours = {f.name: f.default for f in dataclasses.fields(port.JaxAnomalyConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(ref.JaxAnomalyConfig)
              if f.name not in port.REFUSED_KEYS}
    assert ours == theirs
    assert lookup("telemeter", "io.l5d.jaxAnomaly") is port.JaxAnomalyConfig
    assert port.JaxAnomalyConfig.kind == "io.l5d.jaxAnomaly"
    # the mixer telemeter, ported with the istio family: the port's own
    # config class, with the reference's fields and defaults
    from linkerd_tpu.istio import telemeter as ref_istio
    from linkerd_tpu_torch.istio import telemeter as port_istio
    assert lookup("telemeter", "io.l5d.istio") is \
        port_istio.IstioTelemeterConfig
    assert {f.name: f.default for f in dataclasses.fields(
        port_istio.IstioTelemeterConfig)} == {
        f.name: f.default for f in dataclasses.fields(
            ref_istio.IstioTelemeterConfig)}


def test_cuda_by_default(snap, tmp_path):
    """With no CUDA device the telemeter, and every entry point it
    builds, raise unless the CPU is named."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    cfg = port.JaxAnomalyConfig(
        lifecycle=LifecycleConfig(directory=str(tmp_path)),
        distill=DistillConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cfg.mk(metrics.MetricsTree())
    tele = cfg.mk(metrics.MetricsTree(), device="cpu")
    try:
        assert tele.lifecycle.device.type == "cpu"
        assert tele.distill.device.type == "cpu"
        assert tele._ensure_scorer().device.type == "cpu"
    finally:
        tele.close()
