"""The port's model lifecycle (checkpoint store, shadow evaluation,
promotion gate, lifecycle manager, drift monitor) and its fs announcer
against the JAX package's, on the CPU.

Stores written by either package load and verify in the other; the
evaluator's loss is held to 1e-3 relative and its AUC to 0.01 of the
JAX evaluator's on the same snapshot and window; the gate, the drift
gauges, the rank-sum AUC and the announcement files are held equal.
"""

import asyncio
import dataclasses
import threading

import jax
import numpy as np
import pytest

from linkerd_tpu import lifecycle as jax_lifecycle
from linkerd_tpu.announcer import FsAnnouncer as JaxFsAnnouncer
from linkerd_tpu.core import Path as JaxPath
from linkerd_tpu.lifecycle import promote as jax_promote
from linkerd_tpu.lifecycle import store as jax_store
from linkerd_tpu.lifecycle.drift import DriftMonitor as JaxDriftMonitor
from linkerd_tpu.telemetry import anomaly as jax_anomaly
from linkerd_tpu.testing.faults import auc as jax_auc
from linkerd_tpu_torch import lifecycle
from linkerd_tpu_torch.announcer import FsAnnouncer
from linkerd_tpu_torch.core import Path
from linkerd_tpu_torch.lifecycle import promote, store
from linkerd_tpu_torch.lifecycle.drift import DriftMonitor
from linkerd_tpu_torch.ops import scoring
from linkerd_tpu_torch.telemetry.anomaly import InProcessScorer

EVAL_LOSS_REL = 1e-3
EVAL_AUC_ATOL = 0.01


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, 300))


def labeled_rows(rng, n):
    """Rows of a stream at raw scale, a quarter anomalous (six features
    shifted by three of the stream's sigmas), about half labeled."""
    labels = (rng.random(n) < 0.25).astype(np.float32)
    x = rng.standard_normal((n, 36)) * 2.0 + 1.0
    x[:, :6] += 6.0 * labels[:, None]
    mask = (rng.random(n) < 0.5).astype(np.float32)
    return x.astype(np.float32), labels, mask


def jax_scorer():
    return jax_anomaly.InProcessScorer(devices=jax.devices()[:1])


async def jax_snapshots(k, seed=0):
    """``k`` snapshots of a JAX scorer, one fit call apart."""
    rng = np.random.default_rng(seed)
    s = jax_scorer()
    out = []
    try:
        for _ in range(k):
            await s.fit(*labeled_rows(rng, 256))
            out.append(s.snapshot())
    finally:
        s.close()
    return out


async def port_snapshots(k, seed=0):
    rng = np.random.default_rng(seed)
    s = InProcessScorer(device="cpu")
    out = []
    try:
        for _ in range(k):
            await s.fit(*labeled_rows(rng, 256))
            out.append(s.snapshot())
    finally:
        s.close()
    return out


PACKAGES = {"jax": (jax_store, jax_snapshots),
            "port": (store, port_snapshots)}


def fill_store(mod, directory, snaps):
    """Saves, marks, retention and lineage records through ``mod``'s
    store; returns the store and the bytes saved per version."""
    st = mod.CheckpointStore(str(directory), retain=3)
    saved = {}

    def save(snap, **kw):
        v = st.save(snap, parent=st.latest_good(), **kw)
        saved[v] = mod.encode_snapshot(snap)

    save(snaps[0], status="promoted")
    save(snaps[1])
    st.mark(2, "rejected")
    save(snaps[2])
    st.mark(3, "promoted")
    st.record_native_blob(3, {"crc": 7, "quant": "int8", "bytes": 99})
    for snap in snaps[3:]:  # retention prunes v1 and v2, never v3
        save(snap)
    st.record_specialist(12345, {"dst": "/svc/web", "head_version": 1})
    st.record_specialist(777, {"dst": "/svc/x"})
    st.record_specialist(777, None)
    return st, saved


class TestCheckpointStore:
    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_store_directory_loads_in_the_other_package(self, tmp_path,
                                                        writer):
        reader = "port" if writer == "jax" else "jax"
        wmod, make = PACKAGES[writer]
        rmod, _ = PACKAGES[reader]
        snaps = run(make(5))
        wst, saved = fill_store(wmod, tmp_path, snaps)
        rst = rmod.CheckpointStore(str(tmp_path), retain=3)
        assert rst.verify() == [] and wst.verify() == []
        assert rst.status() == wst.status()
        assert rst.latest_good() == wst.latest_good() == 3
        kept = [e.version for e in rst.versions()]
        assert kept == [3, 4, 5] and rst.status()["pruned"] == [1, 2]
        for v in kept:
            got_v, snap = rst.load(v)
            assert got_v == v and rmod.encode_snapshot(snap) == saved[v]
        assert rst.specialists() == {"12345": {"dst": "/svc/web",
                                               "head_version": 1}}
        assert rst.versions()[0].native_blob == {"crc": 7, "quant": "int8",
                                                 "bytes": 99}
        # the reader writes on, and the writer reads it back
        v6 = rst.save(rst.load()[1], status="promoted", parent=3)
        again = wmod.CheckpointStore(str(tmp_path), retain=3)
        assert again.verify() == [] and again.latest_good() == v6 == 6
        assert [(e.version, e.status) for e in again.versions()] == \
            [(4, "candidate"), (5, "candidate"), (6, "promoted")]
        assert again.status()["pruned"] == [1, 2, 3]

    @pytest.mark.parametrize("mod", [jax_store, store],
                             ids=["jax", "port"])
    def test_verify_finds_the_same_faults(self, tmp_path, mod):
        snaps = run(port_snapshots(2))
        st = store.CheckpointStore(str(tmp_path))
        for snap in snaps:
            st.save(snap)
        data = bytearray((tmp_path / "v000002.ckpt").read_bytes())
        data[100] ^= 1
        (tmp_path / "v000002.ckpt").write_bytes(bytes(data))
        (tmp_path / "v000009.ckpt").write_bytes(b"x")
        issues = sorted(mod.CheckpointStore(str(tmp_path)).verify())
        assert issues == sorted(
            jax_store.CheckpointStore(str(tmp_path)).verify())
        assert issues[0] == "orphaned checkpoint file: v000009.ckpt"
        assert issues[1].startswith("v2: checkpoint CRC mismatch")
        with pytest.raises(mod.CheckpointCorruptError):
            mod.CheckpointStore(str(tmp_path)).load(2)


class TestEvaluation:
    def test_auc_matches_reference(self):
        rng = np.random.default_rng(0)
        for n in (0, 1, 7, 200):
            labels = (rng.random(n) < 0.3).astype(np.float32).tolist()
            scores = np.round(rng.random(n), 1).tolist()  # with ties
            a, b = promote.auc(labels, scores), jax_auc(labels, scores)
            assert (np.isnan(a) and np.isnan(b)) or a == b

    def test_auc_of_nan_scores_ends(self):
        """A model with NaN weights scores NaN; the reference's tie scan
        never moves past a NaN (it equals nothing), so the port's AUC
        must end, NaN, where the reference's would not."""
        done = []
        worker = threading.Thread(target=lambda: done.append(
            promote.auc([0.0, 1.0, 0.0, 1.0],
                        [0.2, float("nan"), 0.1, 0.7])), daemon=True)
        worker.start()
        worker.join(timeout=10)
        assert not worker.is_alive(), "auc did not end on a NaN score"
        assert np.isnan(done[0])

    @pytest.mark.parametrize("labeled", [True, False])
    def test_evaluate_snapshot_matches_jax(self, labeled):
        snap = run(jax_snapshots(3))[-1]
        x, labels, mask = labeled_rows(np.random.default_rng(5), 1024)
        if not labeled:
            mask = np.zeros_like(mask)
        want = jax_promote.evaluate_snapshot(snap, x, labels, mask)
        port_snap = store.decode_snapshot(jax_store.encode_snapshot(snap))
        before = scoring.fused_anomaly_scores.launches
        got = promote.evaluate_snapshot(port_snap, x, labels, mask,
                                        device="cpu")
        assert scoring.fused_anomaly_scores.launches == before  # plain
        assert abs(got.loss - want.loss) <= EVAL_LOSS_REL * abs(want.loss)
        assert got.n_rows == want.n_rows == 1024
        assert got.n_labeled == want.n_labeled
        if labeled:
            assert abs(got.auc - want.auc) <= EVAL_AUC_ATOL
        else:
            assert np.isnan(got.auc) and np.isnan(want.auc)
        assert abs(got.score_mean - want.score_mean) <= 1e-3
        assert got.as_dict().keys() == want.as_dict().keys()

    def test_gate_decides_as_the_reference(self):
        def reports(mod):
            out = []
            for loss in (1.0, 1.09, 1.2, float("nan"), float("inf")):
                for a in (0.9, 0.885, 0.87, float("nan")):
                    for n in (0, 8, 100):
                        out.append(mod.EvalReport(loss, a, 0.5, 0.1, 500,
                                                  n))
            return out

        serving = [None, (1.0, 0.9, 100), (1.0, 0.9, 4),
                   (1.0, float("nan"), 100)]
        for policy in ({}, {"aucTolerance": 0.0, "lossTolerance": 0.0,
                            "minLabeled": 1}):
            jg = jax_promote.PromotionGate(jax_promote.GatePolicy(**policy))
            tg = promote.PromotionGate(promote.GatePolicy(**policy))
            for srv in serving:
                js = None if srv is None else jax_promote.EvalReport(
                    srv[0], srv[1], 0.5, 0.1, 500, srv[2])
                ts = None if srv is None else promote.EvalReport(
                    srv[0], srv[1], 0.5, 0.1, 500, srv[2])
                for jc, tc in zip(reports(jax_promote), reports(promote)):
                    jd, td = jg.decide(jc, js), tg.decide(tc, ts)
                    assert (td.accepted, td.reason) == (jd.accepted,
                                                        jd.reason)
                    assert str(td.as_dict()) == str(jd.as_dict())

    def test_replay_window_keeps_the_newest_rows(self):
        jw, tw = jax_promote.ReplayWindow(100), promote.ReplayWindow(100)
        rng = np.random.default_rng(1)
        for n in (30, 50, 40, 10, 90):
            b = labeled_rows(rng, n)
            jw.add_batch(*b)
            tw.add_batch(*b)
            assert len(tw) == len(jw) and tw.labeled_rows == jw.labeled_rows
            for u, v in zip(tw.sample(), jw.sample()):
                assert (u == v).all()


class TestManager:
    def test_poisoned_candidate_is_rolled_back_bit_for_bit(self, tmp_path):
        async def go():
            rng = np.random.default_rng(0)
            scorer = InProcessScorer(device="cpu")
            m = lifecycle.LifecycleConfig(
                directory=str(tmp_path), minReplayRows=256).mk_manager(
                    device="cpu")
            try:
                for _ in range(4):
                    m.replay.add_batch(*labeled_rows(rng, 1024))
                first = await m.run_cycle(scorer)
                assert first["action"] == "promoted"
                for _ in range(3):
                    await scorer.fit(*labeled_rows(rng, 1024))
                good = await m.run_cycle(scorer)
                assert good["action"] == "promoted", good
                xs = labeled_rows(rng, 1024)[0]
                promoted = await scorer.score(xs)
                for _ in range(12):
                    x, labels, mask = labeled_rows(rng, 1024)
                    await scorer.fit(x, 1.0 - labels, mask)
                assert not (await scorer.score(xs) == promoted).all()
                bad = await m.run_cycle(scorer)
                assert bad["action"] == "rolled_back", bad
                assert bad["to_version"] == good["version"]
                assert (await scorer.score(xs) == promoted).all()
                st = m.status()
                assert (st["promotions"], st["rollbacks"],
                        st["rejections"]) == (2, 1, 1)
                assert [e["status"] for e in st["store"]["versions"]] == \
                    ["promoted", "promoted", "rejected"]
                # a restarted scorer bootstraps from the store
                again = InProcessScorer(device="cpu")
                m2 = lifecycle.LifecycleConfig(
                    directory=str(tmp_path)).mk_manager(device="cpu")
                assert await m2.bootstrap(again) == good["version"]
                assert (await again.score(xs) == promoted).all()
                again.close()
                # a manual rollback lands on the same version
                await scorer.fit(*labeled_rows(rng, 64))
                assert await m.rollback(scorer) == good["version"]
                assert (await scorer.score(xs) == promoted).all()
            finally:
                scorer.close()

        run(go())

    def test_skips_until_the_window_is_warm_and_checkpoints(self, tmp_path):
        async def go():
            scorer = InProcessScorer(device="cpu")
            m = lifecycle.LifecycleConfig(
                directory=str(tmp_path), minReplayRows=64).mk_manager(
                    device="cpu")
            try:
                assert await m.bootstrap(scorer) is None
                assert (await m.run_cycle(scorer))["action"] == "promoted"
                out = await m.run_cycle(scorer)
                assert out == {"action": "skipped",
                               "reason": "replay window 0 < 64 rows"}
                v = await m.checkpoint(scorer)
                assert m.store.versions()[-1].parent == 1 and v == 2
                assert m.status()["drift"]["reference_version"] == 1
            finally:
                scorer.close()

        run(go())

    def test_config_matches_the_reference(self):
        # every key, as the reference names, orders and defaults them:
        # the manager's and the telemeter's (cadence, hold-out, restore)
        want = [(f.name, f.default) for f in
                dataclasses.fields(jax_lifecycle.LifecycleConfig)]
        got = [(f.name, f.default) for f in
               dataclasses.fields(lifecycle.LifecycleConfig)]
        assert got == want
        with pytest.raises(TypeError):
            lifecycle.LifecycleConfig(directory="d", sidecarTier="primary")


class FakeGauge:
    def __init__(self):
        self.value = None

    def set(self, v):
        self.value = v


class FakeNode:
    def __init__(self):
        self.gauges = {}

    def gauge(self, name):
        return self.gauges.setdefault(name, FakeGauge())


def test_drift_gauges_equal_the_reference():
    jn, tn = FakeNode(), FakeNode()
    jd, td = JaxDriftMonitor(jn), DriftMonitor(tn)
    rng = np.random.default_rng(3)
    mu, var = rng.standard_normal(36), rng.uniform(0.1, 3.0, 36)
    for i in range(12):
        x = (rng.standard_normal((64, 36)) * (1 + i / 4) + i / 3)
        s = rng.random(64) if i % 3 else None
        jd.observe(x, s)
        td.observe(x, s)
        if i == 4:
            jd.set_reference(mu, var, version=3, step=40)
            td.set_reference(mu, var, version=3, step=40)
        assert {k: g.value for k, g in tn.gauges.items()} == \
            {k: g.value for k, g in jn.gauges.items()}
        assert td.snapshot() == jd.snapshot()
    assert tn.gauges["feature_shift"].value > 0


def test_fs_announcer_files_equal_the_reference(tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    ja = JaxFsAnnouncer(str(jdir), JaxPath.read("/io.l5d.fs"))
    ta = FsAnnouncer(str(tdir), Path.read("/io.l5d.fs"))
    name = "/l5d-scorer"
    handles = []
    for port in (7070, 7071, 7070):
        handles.append((ja.announce("127.0.0.1", port, JaxPath.read(name)),
                        ta.announce("127.0.0.1", port, Path.read(name))))
        assert (tdir / "l5d-scorer").read_bytes() == \
            (jdir / "l5d-scorer").read_bytes()
    ja.announce("10.0.0.1", 1, JaxPath.read("/a/b"))
    ta.announce("10.0.0.1", 1, Path.read("/a/b"))
    assert (tdir / "a-b").read_bytes() == (jdir / "a-b").read_bytes()
    for jh, th in handles:
        jh.close()
        th.close()
        th.close()  # closing twice withdraws once
        assert (tdir / "l5d-scorer").exists() == \
            (jdir / "l5d-scorer").exists()
        if (jdir / "l5d-scorer").exists():
            assert (tdir / "l5d-scorer").read_bytes() == \
                (jdir / "l5d-scorer").read_bytes()
    assert not (tdir / "l5d-scorer").exists()
    with pytest.raises(ValueError):
        ta.announce("h", 1, Path())


def test_path_copy_reads_and_shows_alike():
    for s in ("/", "/svc/web", " /a//b/ ", "/io.l5d.fs/l5d-scorer"):
        assert tuple(Path.read(s)) == tuple(JaxPath.read(s))
        assert Path.read(s).show == JaxPath.read(s).show
    with pytest.raises(ValueError):
        Path.read("svc")
