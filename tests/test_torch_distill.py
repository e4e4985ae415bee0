"""The port's distillation slice (weight-blob export, specialist bank,
per-route monitors, ``distill_head``, ``DistillationPipeline``) against
the JAX package's, on the CPU.

Inputs come from numpy seeds; snapshots cross between the packages
through the checkpoint codec. Bounds:

- Blobs (``L5DWTS01``, ``L5DWTS02`` with 0, 1 and 32 heads, ``L5DWTD01``)
  are byte-equal at f32, int8 and int4, error cases raise the same
  error, and ``blob_meta`` agrees. The reference's native evaluator
  reads the port's bank as it reads its own.
- Bank, monitor and replay window: equal states after the same calls.
- ``distill_head``: blended mu/var bit for bit. Four Adam steps against
  the reference's step compiled with XLA's ``xla_allow_excess_precision``
  off (as ``tests/test_torch_train.py`` compiles its reference), on
  rows drawn from the stream with independent labels: float32 params
  within 2e-4 and scores within 1e-5, bf16 params within 5e-3 and
  scores within 3e-3. Eight steps against the reference's own
  ``distill_head`` (its default jit): scores within 2e-2 on every row.
- Pipeline: both packages pick the same routes, reach the same
  generations, bank keys and lineage fields, and take the same action
  wherever the gate's margin exceeds the gap between their candidates'
  reports; the serving side's reports agree within 1e-3 relative
  (loss) and 0.01 (AUC); the rollback's REMOVE-only delta is
  byte-equal; a NaN-poisoned candidate is rejected in both.
"""

import asyncio
import dataclasses

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from linkerd_tpu.distill import DistillConfig as JaxDistillConfig
from linkerd_tpu.distill import pipeline as jax_pipeline
from linkerd_tpu.distill.bank import SpecialistBank as JaxBank
from linkerd_tpu.distill.monitor import RouteDriftMonitor as JaxMonitor
from linkerd_tpu.distill.monitor import RouteReplayWindow as JaxReplay
from linkerd_tpu.lifecycle import CheckpointStore as JaxStore
from linkerd_tpu.lifecycle import export as jax_export
from linkerd_tpu.lifecycle import store as jax_store
from linkerd_tpu.models import anomaly as jax_model
from linkerd_tpu_torch import lifecycle
from linkerd_tpu_torch.distill import DistillConfig
from linkerd_tpu_torch.distill import pipeline
from linkerd_tpu_torch.distill.bank import SpecialistBank
from linkerd_tpu_torch.distill.monitor import (
    RouteDriftMonitor, RouteReplayWindow,
)
from linkerd_tpu_torch.lifecycle import export, store
from linkerd_tpu_torch.lifecycle.store import CheckpointStore
from linkerd_tpu_torch.models import anomaly as torch_model
from linkerd_tpu_torch.models.convert import params_from_numpy
from linkerd_tpu_torch.ops.scoring import fused_anomaly_scores_plain
from linkerd_tpu_torch.telemetry.anomaly import (
    InProcessScorer, zero_adam_leaves,
)

OFF = {"xla_allow_excess_precision": False}
QUANTS = ("f32", "int8", "int4")
SMALL = dict(enc_dims=(64, 32), bottleneck=16, cls_hidden=32)
CONFIGS = {"small": SMALL, "default": {}}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
HEAD_BOUNDS = {"float32": (2e-4, 1e-5), "bfloat16": (5e-3, 3e-3)}
REFERENCE_HEAD_ATOL = 2e-2   # 8 steps against the reference's own jit
EVAL_LOSS_REL = 1e-3
EVAL_AUC_ATOL = 0.01


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, 120))


def port_snap(size="default", seed=0, dtype="bfloat16"):
    """A port snapshot with He-normal weights, biases drawn around zero
    and stats of a seeded stream."""
    cfg = torch_model.AnomalyModelConfig(
        compute_dtype=DTYPES[dtype], recon_weight=0.7, **CONFIGS[size])
    rng = np.random.default_rng(seed)
    params = {g: [{"w": (rng.standard_normal((i, o)) * np.sqrt(2.0 / i)
                         ).astype(np.float32),
                   "b": (rng.standard_normal(o) * 0.1).astype(np.float32)}
                  for i, o in dims]
              for g, dims in torch_model.layer_dims(cfg).items()}
    return store.ModelSnapshot(
        params=params, opt_leaves=zero_adam_leaves(cfg),
        mu=(rng.standard_normal(36) * 0.5).astype(np.float32),
        var=rng.uniform(0.05, 4.0, 36).astype(np.float32),
        norm_initialized=True, step=seed, cfg=cfg)


def to_jax(snap):
    return jax_store.decode_snapshot(store.encode_snapshot(snap))


def to_port(snap):
    return store.decode_snapshot(jax_store.encode_snapshot(snap))


def stream_rows(snap, seed, n, share=0.25, labeled=0.5):
    """Rows of the stream a snapshot's stats describe, ``share`` of them
    anomalous (six features moved by three sigmas), ``labeled`` of them
    labeled."""
    rng = np.random.default_rng(seed)
    labels = (rng.random(n) < share).astype(np.float32)
    sd = np.sqrt(snap.var)
    x = snap.mu + sd * rng.standard_normal((n, 36))
    x[:, :6] += 3.0 * sd[:6] * labels[:, None]
    mask = (rng.random(n) < labeled).astype(np.float32)
    return x.astype(np.float32), labels, mask


@pytest.fixture(scope="module")
def heads():
    """Base and 32 head snapshots at default widths, in both packages."""
    port = [port_snap(seed=s) for s in range(33)]
    return port, [to_jax(s) for s in port]


# -- weight-blob export --------------------------------------------------


class TestExport:
    @pytest.mark.parametrize("path", [
        "", "/svc/web", "/fp/a", "x", "/#/io.l5d.fs/big-svc",
        "/svc/ünïcode", "\udcff/surrogate"])
    def test_route_hash_fixed_paths(self, path):
        assert export.route_hash(path) == jax_export.route_hash(path) != 0

    @settings(max_examples=200, deadline=None)
    @given(st.text())
    def test_route_hash_drawn_strings(self, path):
        assert export.route_hash(path) == jax_export.route_hash(path)

    def test_constants(self):
        for name in ("WEIGHT_MAGIC", "BANK_MAGIC", "DELTA_MAGIC",
                     "MAX_HEADS", "MAX_DELTA_OPS", "DELTA_OP_UPSERT",
                     "DELTA_OP_REMOVE"):
            assert getattr(export, name) == getattr(jax_export, name)
        assert lifecycle.export_bank_blob is export.export_bank_blob

    @pytest.mark.parametrize("quant", QUANTS)
    @pytest.mark.parametrize("size", CONFIGS)
    def test_weight_blob_bytes_equal(self, size, quant):
        snap = port_snap(size, seed=3)
        got = export.export_weight_blob(snap, 7, quant)
        assert got == jax_export.export_weight_blob(to_jax(snap), 7, quant)
        assert export.blob_meta(got) == jax_export.blob_meta(got)

    @pytest.mark.parametrize("quant", QUANTS)
    @pytest.mark.parametrize("n_heads", [0, 1, 32])
    def test_bank_blob_bytes_equal(self, heads, n_heads, quant):
        port, ref = heads
        keys = [export.route_hash(f"/svc/{i}") for i in range(n_heads)]
        got = export.export_bank_blob(
            port[0], 5, 9, {k: (i + 1, port[i + 1])
                            for i, k in enumerate(keys)}, quant)
        want = jax_export.export_bank_blob(
            ref[0], 5, 9, {k: (i + 1, ref[i + 1])
                           for i, k in enumerate(keys)}, quant)
        assert got == want
        meta = export.blob_meta(got)
        assert meta == jax_export.blob_meta(want)
        assert (meta["heads"], meta["generation"]) == (n_heads, 9)

    @pytest.mark.parametrize("quant", QUANTS)
    @pytest.mark.parametrize("kind", ["upserts", "removes", "both"])
    def test_delta_blob_bytes_equal(self, heads, kind, quant):
        port, ref = heads
        ups = {} if kind == "removes" else {1000: (2, 1), 3000: (3, 2)}
        rms = [] if kind == "upserts" else [2000, 77]
        got = export.export_delta_blob(
            4, 5, {k: (v, port[i]) for k, (v, i) in ups.items()}, rms,
            quant)
        want = jax_export.export_delta_blob(
            4, 5, {k: (v, ref[i]) for k, (v, i) in ups.items()}, rms,
            quant)
        assert got == want
        assert export.blob_meta(got) == jax_export.blob_meta(want)

    def test_blob_meta_of_bad_blobs(self):
        blob = export.export_weight_blob(port_snap("small"), 1)
        flipped = bytearray(blob)
        flipped[len(blob) // 2] ^= 0x10
        for bad in (b"", b"L5DWTS02" + bytes(8), bytes(flipped),
                    blob[:40], b"XXXXXXXX" + blob[8:]):
            assert export.blob_meta(bad) == jax_export.blob_meta(bad)

    def test_errors_raise_alike(self, heads):
        def bad_layer(snap):
            snap.params["dec"][0]["b"] = snap.params["dec"][0]["b"][:-1]
            return snap

        def no_cls(snap):
            snap.params["cls"] = []
            return snap

        def short_mu(snap):
            snap.mu = snap.mu[:-1]
            return snap

        port, ref = heads
        many = range(export.MAX_HEADS + 1)
        cases = [
            lambda e, s: e.export_weight_blob(s, 1, "int2"),
            lambda e, s: e.export_weight_blob(bad_layer(s), 1),
            lambda e, s: e.export_weight_blob(no_cls(s), 1),
            lambda e, s: e.export_weight_blob(short_mu(s), 1),
            lambda e, s: e.export_bank_blob(s, 1, 1, {0: (1, s)}),
            lambda e, s: e.export_bank_blob(s, 1, 1, {1 << 32: (1, s)}),
            lambda e, s: e.export_bank_blob(
                s, 1, 1, {1000 + i: (1, s) for i in many}),
            lambda e, s: e.export_delta_blob(1, 2),
            lambda e, s: e.export_delta_blob(3, 3, {1000: (1, s)}),
            lambda e, s: e.export_delta_blob(
                1, 2, removes=range(export.MAX_DELTA_OPS + 1)),
        ]
        for case in cases:
            with pytest.raises(ValueError) as got:
                case(export, dataclasses.replace(
                    port[1], params=_copy(port[1].params)))
            with pytest.raises(ValueError) as want:
                case(jax_export, dataclasses.replace(
                    ref[1], params=_copy(ref[1].params)))
            assert str(got.value) == str(want.value)


def _copy(params):
    return {g: [dict(layer) for layer in layers]
            for g, layers in params.items()}


class TestNativeReadsPortBank:
    @pytest.fixture
    def native(self):
        native = pytest.importorskip("linkerd_tpu.native")
        if not native.available():
            pytest.skip("the reference's native lib does not load here")
        return native

    @pytest.mark.parametrize("quant", QUANTS)
    def test_every_head_serves_from_the_port_bank(self, native, heads,
                                                  quant):
        port, ref = heads
        keys = [export.route_hash(f"/svc/{i}") for i in range(32)]
        got = export.export_bank_blob(
            port[0], 5, 9, {k: (i + 1, port[i + 1])
                            for i, k in enumerate(keys)}, quant)
        want = jax_export.export_bank_blob(
            ref[0], 5, 9, {k: (i + 1, ref[i + 1])
                           for i, k in enumerate(keys)}, quant)
        info = native.score_blob_info(got)
        assert (info["heads"], info["generation"]) == (32, 9)
        x = stream_rows(port[0], 1, 16)[0]
        for k in keys:
            scores, spec = native.score_eval_route(got, k, x)
            ref_scores, ref_spec = native.score_eval_route(want, k, x)
            assert spec and ref_spec
            assert np.array_equal(scores, ref_scores)
        _, spec = native.score_eval_route(got, 12345, x)
        assert not spec


# -- bank and per-route monitors ---------------------------------------------


def monitor_state(mon, routes):
    return (mon.triggered(), mon.snapshot(),
            [mon.score_shift(d) for d in routes],
            [mon.rows_of(d) for d in routes])


class TestBankAndMonitors:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_drift_monitor_matches(self, seed):
        rng = np.random.default_rng(seed)
        kw = dict(threshold=0.8, min_rows=24, momentum=0.2, max_routes=5)
        port, ref = RouteDriftMonitor(**kw), JaxMonitor(**kw)
        routes = [f"/r{i}" for i in range(7)]
        fired = False
        for step in range(60):
            dsts = list(rng.choice(routes, 16))
            loc = 0.2 + 0.6 * (step > 30) * rng.random()
            scores = rng.normal(loc, 0.05, 16).astype(np.float32)
            for mon in (port, ref):
                mon.observe(dsts, scores)
                if step % 17 == 16:
                    mon.re_anchor(routes[step % 7])
                if step == 45:
                    mon.re_anchor_all()
            assert monitor_state(port, routes) == monitor_state(ref, routes)
            fired = fired or bool(port.triggered())
        assert fired

    @pytest.mark.parametrize("seed", [0, 1])
    def test_replay_window_matches(self, seed):
        rng = np.random.default_rng(seed)
        port, ref = RouteReplayWindow(24, 3), JaxReplay(24, 3)
        routes = [f"/r{i}" for i in range(6)]
        for _ in range(30):
            n = int(rng.integers(1, 20))
            dsts = list(rng.choice(routes, n))
            x = rng.standard_normal((n, 36)).astype(np.float32)
            labels = (rng.random(n) < 0.3).astype(np.float32)
            mask = (rng.random(n) < 0.5).astype(np.float32)
            port.add(dsts, x, labels, mask)
            ref.add(dsts, x, labels, mask)
            assert [port.rows(d) for d in routes] == \
                [ref.rows(d) for d in routes]
            for d in routes:
                if ref.rows(d):
                    for a, b in zip(port.sample(d), ref.sample(d)):
                        assert np.array_equal(a, b)
                else:
                    with pytest.raises(ValueError):
                        port.sample(d)

    def test_bank_matches(self, heads):
        port_snaps, ref_snaps = heads
        port, ref = SpecialistBank(3), JaxBank(3)
        ops = [("up", "/a", 1), ("up", "/b", 2), ("up", "/a", 3),
               ("rm", "/b", 0), ("up", "/c", 4), ("up", "/d", 5),
               ("rm", "/x", 0)]
        for op, dst, i in ops:
            if op == "up":
                got = port.upsert(dst, port_snaps[i], port.next_head_version(),
                                  10, i)
                want = ref.upsert(dst, ref_snaps[i], ref.next_head_version(),
                                  10, i)
                assert _meta(got) == _meta(want)
            else:
                assert (port.remove(dst) is None) == (ref.remove(dst) is None)
        assert port.full and ref.full
        with pytest.raises(ValueError) as got:
            port.upsert("/e", port_snaps[1], 9, 10, 9)
        with pytest.raises(ValueError) as want:
            ref.upsert("/e", ref_snaps[1], 9, 10, 9)
        assert str(got.value) == str(want.value)
        state, ref_state = port.state(), ref.state()
        for s in (state, ref_state):
            for h in s["heads"].values():
                h.pop("promoted_at")
        assert state == ref_state
        assert port.export_full(port_snaps[0], 10, 6, "int8") == \
            ref.export_full(ref_snaps[0], 10, 6, "int8")


def _meta(info):
    meta = info.meta()
    meta.pop("promoted_at")
    return meta


# -- distill_head ------------------------------------------------------------


def jax_distill(jsnap, x, labels, mask, steps, lr=1e-3):
    """The reference's fine-tune step compiled with excess precision
    off, ``steps`` times from ``jsnap``, with the reference's blend."""
    mu = (0.5 * jsnap.mu + 0.5 * x.mean(axis=0)).astype(np.float32)
    var = (0.5 * jsnap.var + 0.5 * (x.var(axis=0) + 1e-6)).astype(
        np.float32)
    opt, step = jax_pipeline._fine_tune_step(jsnap.cfg, lr)
    params, state = jsnap.params, opt.init(jsnap.params)
    args = (x, labels, mask, mu, var)
    compiled = jax.jit(step.__wrapped__).lower(params, state,
                                               *args).compile(OFF)
    for _ in range(steps):
        params, state, _ = compiled(params, state, *args)
    return jax.tree_util.tree_map(np.asarray, params), mu, var


def jax_scores(params, x, mu, var, jcfg):
    fn = jax.jit(lambda p, v: jax_model.anomaly_scores(
        p, jax_model.normalize_features(v, mu, var), jcfg))
    return np.asarray(fn.lower(params, x).compile(OFF)(params, x))


def plain_scores(snap, x):
    return fused_anomaly_scores_plain(
        params_from_numpy(snap.params, "cpu"), torch.tensor(x), snap.cfg,
        torch.tensor(snap.mu), torch.tensor(snap.var)).numpy()


def max_param_diff(a, b):
    return max(float(np.abs(la[k] - lb[k]).max())
               for g in a for la, lb in zip(a[g], b[g]) for k in ("w", "b"))


class TestDistillHead:
    def test_blend_is_bit_for_bit(self):
        snap = port_snap("small", seed=2)
        x, labels, mask = stream_rows(snap, 3, 200)
        x = x * 1.7 + 0.3
        got = pipeline.distill_head(snap, x, labels, mask, 1, 1e-3, "cpu")
        want = jax_pipeline.distill_head(to_jax(snap), x, labels, mask, 1,
                                         1e-3)
        assert got.mu.dtype == got.var.dtype == np.float32
        assert np.array_equal(got.mu, want.mu)
        assert np.array_equal(got.var, want.var)
        assert (got.opt_leaves, got.step, got.norm_initialized) == \
            (want.opt_leaves, want.step, want.norm_initialized) == \
            ([], 2, True)
        assert got.cfg == snap.cfg

    @pytest.mark.parametrize("size,dtype,seed", [
        ("small", "float32", 4), ("small", "float32", 5),
        ("small", "bfloat16", 4), ("small", "bfloat16", 5),
        ("default", "float32", 4), ("default", "bfloat16", 4)])
    def test_four_steps_match_jax_optax(self, size, dtype, seed):
        snap = port_snap(size, seed=seed, dtype=dtype)
        jsnap = to_jax(snap)
        x, _, mask = stream_rows(snap, seed + 10, 256, share=0.0)
        labels = (np.random.default_rng(seed).random(256) < 0.25).astype(
            np.float32)  # independent of the rows
        got = pipeline.distill_head(snap, x, labels, mask, 4, 1e-3, "cpu")
        params, mu, var = jax_distill(jsnap, x, labels, mask, 4)
        assert np.array_equal(got.mu, mu) and np.array_equal(got.var, var)
        params_atol, scores_atol = HEAD_BOUNDS[dtype]
        assert max_param_diff(got.params, params) <= params_atol
        xs = stream_rows(snap, seed + 20, 300)[0]
        gap = np.abs(plain_scores(got, xs)
                     - jax_scores(params, xs, mu, var, jsnap.cfg)).max()
        assert gap <= scores_atol

    def test_eight_steps_near_the_reference(self, teacher):
        snap, jsnap = teacher
        x, labels, mask = stream_rows(snap, 7, 384)
        got = pipeline.distill_head(snap, x, labels, mask, 8, 1e-3, "cpu")
        want = jax_pipeline.distill_head(jsnap, x, labels, mask, 8, 1e-3)
        xs = stream_rows(snap, 8, 300)[0]
        gap = float(np.abs(plain_scores(got, xs)
                           - plain_scores(to_port(want), xs)).max())
        print(f"8-step head against the reference's distill_head: "
              f"max|diff| {gap:.3e}")
        assert gap <= REFERENCE_HEAD_ATOL

    def test_refuses_tf32(self):
        snap = port_snap("small")
        x, labels, mask = stream_rows(snap, 1, 32)
        prev = torch.get_float32_matmul_precision()
        try:
            torch.set_float32_matmul_precision("high")
            with pytest.raises(RuntimeError, match="highest"):
                pipeline.distill_head(snap, x, labels, mask, 1, 1e-3, "cpu")
        finally:
            torch.set_float32_matmul_precision(prev)

    def test_cuda_by_default(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present; this checks its absence")
        snap = port_snap("small")
        x, labels, mask = stream_rows(snap, 1, 32)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pipeline.distill_head(snap, x, labels, mask, 1, 1e-3)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DistillConfig().mk(None)


# -- the pipeline ----------------------------------------------------------


@pytest.fixture(scope="module")
def teacher():
    """A port scorer's snapshot after six fits (as the reference's
    ``trained_snapshot``), in both packages."""
    async def go():
        s = InProcessScorer(seed=3, learning_rate=5e-3, device="cpu")
        rng = np.random.default_rng(3)
        try:
            for _ in range(6):
                x = rng.standard_normal((32, 36)).astype(np.float32) * 2 + 1
                labels = (rng.random(32) > 0.8).astype(np.float32)
                await s.fit(x, labels, np.ones(32, np.float32))
            return s.snapshot()
        finally:
            s.close()

    snap = run(go())
    return snap, to_jax(snap)


class SnapScorer:
    def __init__(self, snap):
        self._snap = snap

    def snapshot(self):
        return self._snap


class Counter:
    def __init__(self):
        self.n = 0

    def incr(self):
        self.n += 1


class Node:
    """A metrics scope: counters and gauges by name."""

    def __init__(self):
        self.counters, self.gauges = {}, {}

    def counter(self, name):
        return self.counters.setdefault(name, Counter())

    def gauge(self, name, fn):
        self.gauges[name] = fn

    def read(self):
        return ({k: c.n for k, c in self.counters.items()},
                {k: fn() for k, fn in self.gauges.items()})


def feed(pipes, snap, labeled=0.5, routes=("/a", "/b", "/c")):
    """The same batches into every pipeline: each route's rows from the
    snapshot's stream, scores low for six batches and then shifted, by
    more on each later route."""
    rng = np.random.default_rng(11)
    for shifted in (False, True):
        for _ in range(6):
            for r, dst in enumerate(routes):
                x, labels, mask = stream_rows(snap, int(rng.integers(1e9)),
                                              16, labeled=labeled)
                loc = 0.9 - 0.1 * r if shifted else 0.1
                s = rng.normal(loc, 0.02, 16).astype(np.float32)
                for p in pipes:
                    p.observe_batch([dst] * 16, x, s, labels, mask)


def make_pair(tmp_path, store_too=True, **kw):
    cfg = dict(maxHeads=2, driftThreshold=0.5, minRouteRows=32,
               cooldownS=0.0, **kw)
    nodes = Node(), Node()
    stores = ((CheckpointStore(str(tmp_path / "port")),
               JaxStore(str(tmp_path / "jax"))) if store_too
              else (None, None))
    port = DistillConfig(**cfg).mk(nodes[0], store=stores[0], device="cpu")
    ref = JaxDistillConfig(**cfg).mk(nodes[1], store=stores[1])
    published = ([], [])
    for p, out in zip((port, ref), published):
        p.set_publisher(lambda full, delta, out=out:
                        out.append((full, delta)) or True)
    return port, ref, nodes, stores, published


def room(decision, tol_loss=0.10, tol_auc=0.02):
    c, s = decision["candidate"], decision["serving"]
    out = [(s["loss"] * (1 + tol_loss) - c["loss"]) / s["loss"]]
    if c["auc"] is not None and s["auc"] is not None:
        out.append(c["auc"] - s["auc"] + tol_auc)
    return out


class TestPipeline:
    def test_config_matches_the_reference(self):
        ours = {f.name: f.default
                for f in dataclasses.fields(DistillConfig)}
        theirs = {f.name: f.default
                  for f in dataclasses.fields(JaxDistillConfig)}
        assert ours == theirs
        for bad in (dict(maxHeads=0), dict(driftThreshold=0.0),
                    dict(minRouteRows=7), dict(retrainSteps=0),
                    dict(learningRate=0.0), dict(cooldownS=-1.0)):
            with pytest.raises(ValueError) as got:
                DistillConfig(**bad).mk(None, device="cpu")
            with pytest.raises(ValueError) as want:
                JaxDistillConfig(**bad).mk(None)
            assert str(got.value) == str(want.value)

    def test_both_packages_promote_alike(self, teacher, tmp_path):
        snap, jsnap = teacher
        port, ref, nodes, stores, published = make_pair(tmp_path)
        feed((port, ref), snap)
        outcomes = []
        for _ in range(4):
            assert port.pending_route() == ref.pending_route()
            got = run(port.run_once(SnapScorer(snap), base_version=42))
            want = run(ref.run_once(SnapScorer(jsnap), base_version=42))
            if want is None:
                assert got is None
                break
            assert got["route"] == want["route"]
            gs = got["decision"]["serving"]
            ws = want["decision"]["serving"]
            assert abs(gs["loss"] - ws["loss"]) <= EVAL_LOSS_REL * ws["loss"]
            assert abs(gs["auc"] - ws["auc"]) <= EVAL_AUC_ATOL
            gr, wr = room(got["decision"]), room(want["decision"])
            gaps = [abs(got["decision"]["candidate"]["loss"]
                        - want["decision"]["candidate"]["loss"])
                    / ws["loss"] + EVAL_LOSS_REL, EVAL_AUC_ATOL]
            if all(min(abs(a), abs(b)) > g
                   for a, b, g in zip(gr, wr, gaps)):
                assert got["action"] == want["action"]
            print(f"{got['route']}: {got['action']} / {want['action']}, "
                  f"gate room port {gr}, reference {wr}, gaps {gaps}")
            outcomes.append((got, want))
        assert [g["action"] for g, _ in outcomes] == ["promoted"] * 2
        assert port.bank.generation == ref.bank.generation == 2
        assert sorted(port.bank.heads) == sorted(ref.bank.heads)
        assert port.pending_route() is ref.pending_route() is None
        assert port.monitor.triggered() == ref.monitor.triggered() == ["/c"]
        for got, want in outcomes:
            for k in ("route_hash", "head_version", "generation",
                      "delta_bytes", "full_bytes", "delta_published"):
                assert got[k] == want[k]
        ours, theirs = stores[0].specialists(), stores[1].specialists()
        assert sorted(ours) == sorted(theirs)
        for k, meta in ours.items():
            assert sorted(meta) == sorted(theirs[k])
            for field in set(meta) - {"promoted_at", "delta_crc"}:
                assert meta[field] == theirs[k][field]
        assert nodes[0].read() == nodes[1].read()
        for (full, delta), (rfull, rdelta) in zip(*published):
            assert export.blob_meta(delta) | {"crc": 0} == \
                jax_export.blob_meta(rdelta) | {"crc": 0}
            assert len(full) == len(rfull)

        assert run(port.rollback_route("/a")) is True
        assert run(ref.rollback_route("/a")) is True
        assert published[0][-1][1] == published[1][-1][1]  # REMOVE delta
        assert export.blob_meta(published[0][-1][0])["heads"] == 1
        assert stores[0].specialists().keys() == \
            stores[1].specialists().keys()
        assert run(port.rollback_route("/a")) is False
        state, ref_state = port.state(), ref.state()
        for s in (state, ref_state):
            s.pop("last_outcome")
            s["last_rollback"].pop("at")
            for h in s["bank"]["heads"].values():
                h.pop("promoted_at")
        assert state == ref_state
        assert nodes[0].read() == nodes[1].read()

    def test_poisoned_candidate_rejected_in_both(self, teacher, tmp_path,
                                                 monkeypatch):
        """As the reference's test: the candidate's first encoder
        weights are NaN, the held-out rows unlabeled (the reference's
        AUC scan does not end on NaN scores of labeled rows)."""
        def poisoned(real):
            def fn(*args, **kwargs):
                bad = real(*args, **kwargs)
                bad.params["enc"][0]["w"] = np.full_like(
                    np.asarray(bad.params["enc"][0]["w"]), np.nan)
                return bad
            return fn

        monkeypatch.setattr(pipeline, "distill_head",
                            poisoned(pipeline.distill_head))
        monkeypatch.setattr(jax_pipeline, "distill_head",
                            poisoned(jax_pipeline.distill_head))
        snap, jsnap = teacher
        port, ref, _, stores, published = make_pair(tmp_path,
                                                    retrainSteps=2)
        feed((port, ref), snap, labeled=0.0)
        got = run(port.run_once(SnapScorer(snap)))
        want = run(ref.run_once(SnapScorer(jsnap)))
        assert got["action"] == want["action"] == "rejected"
        assert got["decision"]["reason"] == want["decision"]["reason"] == \
            "candidate loss not finite"
        assert published == ([], [])
        assert port.bank.generation == ref.bank.generation == 0
        assert stores[0].specialists() == stores[1].specialists() == {}

    def test_poisoned_candidate_on_labeled_rows(self, teacher, tmp_path,
                                                monkeypatch):
        """The port's gate ends on NaN scores of labeled rows too."""
        real = pipeline.distill_head

        def poisoned(*args, **kwargs):
            bad = real(*args, **kwargs)
            bad.params["dec"][-1]["b"][:] = np.nan
            return bad

        monkeypatch.setattr(pipeline, "distill_head", poisoned)
        snap, _ = teacher
        port = DistillConfig(maxHeads=2, driftThreshold=0.5, minRouteRows=32,
                             retrainSteps=2, cooldownS=0.0).mk(
            None, device="cpu")
        feed((port,), snap, labeled=1.0)
        out = run(port.run_once(SnapScorer(snap)))
        assert out["action"] == "rejected"
        assert out["decision"]["candidate"]["auc"] is None
        assert port.bank.generation == 0

    def test_export_full_bumps_and_re_anchors(self, teacher):
        snap, jsnap = teacher
        pipes = (DistillConfig(driftThreshold=0.5, minRouteRows=32).mk(
                     None, device="cpu"),
                 JaxDistillConfig(driftThreshold=0.5, minRouteRows=32).mk(
                     None))
        feed(pipes, snap)
        assert pipes[0].monitor.triggered() == pipes[1].monitor.triggered()
        assert pipes[0].monitor.triggered()
        for p, s in zip(pipes, (snap, jsnap)):
            p.bank.upsert("/a", s, p.bank.next_head_version(), 3, 1)
        blobs = [p.export_full(s, 3, "int4")
                 for p, s in zip(pipes, (snap, jsnap))]
        assert blobs[0] == blobs[1]
        assert export.blob_meta(blobs[0])["generation"] == 1
        assert pipes[0].monitor.triggered() == pipes[1].monitor.triggered() \
            == []


if __name__ == "__main__":
    # the measured gaps behind the bounds, for ROADMAP Queue 3:
    #   PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_distill.py
    for size in CONFIGS:
        for dtype in DTYPES:
            for seed in (4, 5, 6):
                snap = port_snap(size, seed=seed, dtype=dtype)
                x, _, mask = stream_rows(snap, seed + 10, 256, share=0.0)
                labels = (np.random.default_rng(seed).random(256)
                          < 0.25).astype(np.float32)
                got = pipeline.distill_head(snap, x, labels, mask, 4, 1e-3,
                                            "cpu")
                params, mu, var = jax_distill(to_jax(snap), x, labels,
                                              mask, 4)
                xs = stream_rows(snap, seed + 20, 300)[0]
                gap = np.abs(plain_scores(got, xs) - jax_scores(
                    params, xs, mu, var, to_jax(snap).cfg)).max()
                print(f"{size} {dtype} seed {seed}: 4 steps, params "
                      f"{max_param_diff(got.params, params):.2e} scores "
                      f"{gap:.2e}")
