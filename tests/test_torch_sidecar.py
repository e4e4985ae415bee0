"""The port's scorer sidecar (linkerd_tpu_torch/telemetry/sidecar.py)
against the JAX package's, on the CPU: the wire codecs byte for byte,
the checkpoint codec in both directions, and a JAX gRPC client (grpcio)
driving the port's sidecar (the port's h2 gRPC runtime) over localhost.

Scores are compared in the scorer's bfloat16 compute. Against the JAX
model's forward on the served checkpoint they agree to 1e-5 on all but
1% of rows and to 1e-3 on every row (another summation order now and
then rounds an activation to the neighbouring bf16 value; see
``tests/test_torch_models.py``). Against the JAX scorer itself only the
1e-3 bound holds: its jitted forward runs under XLA's default excess
precision, which adds each bias to the unrounded layer sum, so once a
fit has made the biases nonzero most rows move by a few 1e-4 (see
``tests/test_torch_ops.py``).
"""

import asyncio
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from linkerd_tpu.lifecycle import store as jax_store
from linkerd_tpu.models import anomaly as jax_model
from linkerd_tpu.telemetry import anomaly as jax_anomaly
from linkerd_tpu.telemetry import sidecar as jax_sidecar
from linkerd_tpu_torch.lifecycle import store
from linkerd_tpu_torch.models.anomaly import AnomalyModelConfig
from linkerd_tpu_torch.telemetry import sidecar
from linkerd_tpu_torch.telemetry.anomaly import (
    InProcessScorer, zero_adam_leaves,
)

SCORE_ATOL = 1e-3
ROW_ATOL = 1e-5
ROW_SHARE = 0.01


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, 120))


def rows(n, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 36)) * scale).astype(np.float32)


def assert_rows_agree(got, ref):
    diff = np.abs(got - ref)
    assert diff.max() <= SCORE_ATOL
    assert (diff > ROW_ATOL).mean() <= ROW_SHARE


def jax_forward(snap, x):
    """The JAX model's scores for raw rows under a snapshot, op by op."""
    p = jax.tree_util.tree_map(jax.numpy.asarray, snap.params)
    xn = jax_model.normalize_features(x, snap.mu, snap.var)
    return np.asarray(jax_model.anomaly_scores(p, xn, snap.cfg))


def jax_scorer():
    # conftest fakes 8 CPU devices; one keeps the single-device path
    return jax_anomaly.InProcessScorer(devices=jax.devices()[:1])


async def trained_jax_scorer():
    """A JAX scorer with non-trivial params, optimizer and norm stats."""
    s = jax_scorer()
    x = rows(64, seed=11, scale=2.0)
    labels = (np.arange(64) % 5 == 0).astype(np.float32)
    await s.fit(x, labels, np.ones(64, np.float32))
    return s


class TestWireCodecs:
    @pytest.mark.parametrize("shape", [(0, 36), (1, 36), (37, 36), (5, 3)])
    def test_matrix_bytes_equal(self, shape):
        x = rows(shape[0])[:, :shape[1]]
        assert sidecar.encode_matrix(x) == jax_sidecar.encode_matrix(x)
        back = sidecar.decode_matrix(jax_sidecar.encode_matrix(x))
        assert back.shape == shape and (back == x).all()

    def test_strided_input_and_fit_bytes_equal(self):
        x = rows(16)[::2]
        labels = np.arange(8, dtype=np.float32)
        mask = np.ones(8, np.float32)
        assert sidecar.encode_matrix(x) == jax_sidecar.encode_matrix(x)
        assert sidecar.encode_fit(x, labels, mask) == \
            jax_sidecar.encode_fit(x, labels, mask)
        x2, l2, m2 = sidecar.decode_fit(jax_sidecar.encode_fit(x, labels,
                                                               mask))
        assert (x2 == x).all() and (l2 == labels).all() and (m2 == mask).all()

    def test_malformed_payloads_raise_alike(self):
        good = sidecar.encode_matrix(rows(4))
        for bad in (good[:-4], good + b"\0\0\0\0", good[:5]):
            with pytest.raises(ValueError):
                jax_sidecar.decode_matrix(bad)
            with pytest.raises(ValueError):
                sidecar.decode_matrix(bad)
        fit = sidecar.encode_fit(rows(4), np.zeros(4), np.zeros(4))
        with pytest.raises(ValueError):
            sidecar.decode_fit(fit[:-1])
        with pytest.raises(ValueError):
            sidecar.encode_fit(rows(4), np.zeros(3), np.zeros(4))

    def test_bucket_rows_agree(self):
        for n in range(0, 2050):
            assert sidecar.bucket_rows(n) == jax_sidecar.bucket_rows(n)


class TestCheckpointCodec:
    def test_jax_bytes_round_trip_through_port(self):
        s = run(trained_jax_scorer())
        blob = jax_store.encode_snapshot(s.snapshot())
        s.close()
        snap = store.decode_snapshot(blob)
        assert snap.cfg.compute_dtype == torch.bfloat16
        assert snap.cfg.recon_weight == 0.7
        assert store.encode_snapshot(snap) == blob

    def test_port_bytes_round_trip_through_jax(self):
        port = InProcessScorer(seed=3, device="cpu")
        snap = port.snapshot()
        snap.mu = rows(1, seed=4)[0]
        snap.step = 12
        port.close()
        blob = store.encode_snapshot(snap)
        back = jax_store.decode_snapshot(blob)
        assert back.step == 12
        assert jax_store.encode_snapshot(back) == blob

    def test_zero_adam_state_is_optax_layout(self):
        cfg = jax_model.AnomalyModelConfig()
        params = jax_model.init_params(jax.random.key(0), cfg)
        ref = jax.tree_util.tree_leaves(optax.adam(1e-3).init(params))
        got = zero_adam_leaves(AnomalyModelConfig())
        assert len(got) == len(ref) == 33
        for g, r in zip(got, ref):
            r = np.asarray(r)
            assert g.shape == r.shape and g.dtype == r.dtype
            assert (g == r).all()

    def test_corrupt_and_bf16_checkpoints_raise(self):
        port = InProcessScorer(device="cpu")
        blob = bytearray(store.encode_snapshot(port.snapshot()))
        port.close()
        blob[40] ^= 1
        with pytest.raises(store.CheckpointCorruptError):
            store.decode_snapshot(bytes(blob))
        ref = jax_scorer()
        snap = jax_store.decode_snapshot(jax_store.encode_snapshot(
            ref.snapshot()))
        ref.close()
        snap.opt_leaves[1] = snap.opt_leaves[1].astype(ml_dtypes.bfloat16)
        with pytest.raises(store.CheckpointError, match="bfloat16"):
            store.decode_snapshot(jax_store.encode_snapshot(snap))


class TestScorer:
    def test_default_device_raises_without_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            InProcessScorer()
        with pytest.raises(RuntimeError):
            sidecar.ScorerSidecar()

    def test_entry_point_refuses_to_start_without_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        proc = subprocess.run(
            [sys.executable, "-m", "linkerd_tpu_torch.telemetry.sidecar",
             "--port", "0"], cwd=Path(__file__).resolve().parent.parent,
            capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert "no CUDA device" in proc.stderr
        assert "SCORER_SIDECAR" not in proc.stdout

    def test_fit_trains_the_served_model(self):
        """Fit trains: a finite loss, the step counter advanced by
        ``fit_steps`` and the served scores moved."""
        s = InProcessScorer(device="cpu")
        try:
            x = rows(16)
            before = run(s.score(x))
            loss = run(s.fit(x, np.zeros(16), np.zeros(16)))
            assert np.isfinite(loss) and loss > 0
            assert s._step == s.fit_steps == 4
            assert not (run(s.score(x)) == before).all()
        finally:
            s.close()

    def test_restore_rejects_other_configs_and_layouts(self):
        s = InProcessScorer(device="cpu")
        snap = s.snapshot()
        bad = dataclasses.replace(snap, cfg=dataclasses.replace(
            snap.cfg, recon_weight=0.5))
        with pytest.raises(ValueError, match="config"):
            s.restore(bad)
        with pytest.raises(ValueError, match="optimizer"):
            s.restore(dataclasses.replace(snap, opt_leaves=snap.opt_leaves[:3]))
        s.close()

    def test_warmup_and_swap_keep_state(self):
        async def go():
            s = InProcessScorer(device="cpu")
            try:
                x = rows(16)
                before = await s.score(x)
                await s.warmup(4)
                assert s._norm_initialized is False and s._step == 0
                assert (await s.score(x) == before).all()
                other = s.snapshot()
                other.mu = rows(1, seed=9)[0]
                old = s.swap(other)
                assert not (await s.score(x) == before).all()
                s.restore(old)
                assert (await s.score(x) == before).all()
            finally:
                s.close()

        run(go())


class TestService:
    def test_handlers_on_wire_bytes(self):
        async def go():
            s = InProcessScorer(device="cpu")
            svc = sidecar.ScorerService(s)
            try:
                snap = s.snapshot()
                snap.step = 5
                echo = await svc.handle_restore(store.encode_snapshot(snap))
                assert np.frombuffer(echo, "<u8")[0] == 5
                for n in (0, 1, 37):
                    out = await svc.handle_score(sidecar.encode_matrix(rows(n)))
                    assert len(out) == 4 * n
                assert svc.rows_scored == 38
                assert await svc.handle_snapshot(b"") == \
                    store.encode_snapshot(snap)
                with pytest.raises(ValueError):
                    await svc.handle_score(b"\0\0")
            finally:
                s.close()

        run(go())


class TestGrpcInterop:
    def test_jax_client_restores_and_scores_on_port_sidecar(self):
        async def go():
            ref = await trained_jax_scorer()
            port = await sidecar.ScorerSidecar(
                scorer=InProcessScorer(device="cpu"), warmup_rows=4).start()
            client = jax_sidecar.GrpcScorerClient(f"127.0.0.1:{port.port}")
            try:
                snap = ref.snapshot()
                assert await client.restore(snap) == snap.step
                assert any(np.abs(layer["b"]).max() > 0
                           for g in snap.params.values() for layer in g)
                served, forward = [], []
                for n in (1, 37, 1024):
                    x = rows(n, seed=n, scale=2.0)
                    got = await client.score(x)
                    want = await ref.score(x)
                    assert got.shape == (n,)
                    np.testing.assert_allclose(got, want, atol=SCORE_ATOL,
                                               rtol=0)
                    served.append(got)
                    forward.append(jax_forward(snap, x))
                assert_rows_agree(np.concatenate(served),
                                  np.concatenate(forward))
                # the port's snapshot restores into the JAX scorer
                back = await client.snapshot()
                assert jax_store.encode_snapshot(back) == \
                    jax_store.encode_snapshot(snap)
                fresh = jax_scorer()
                fresh.restore(back)
                x = rows(300, seed=7, scale=2.0)
                np.testing.assert_allclose(
                    await fresh.score(x), await client.score(x),
                    atol=SCORE_ATOL, rtol=0)
                fresh.close()
                # Fit is served: the port trains on the JAX client's call
                loss = await client.fit(x, np.zeros(300), np.zeros(300))
                assert np.isfinite(loss)
                assert (await client.snapshot()).step == snap.step + 4
            finally:
                await client.aclose()
                await port.close()
                ref.close()

        run(go())

    def test_port_client_against_port_sidecar(self):
        async def go():
            port = await sidecar.ScorerSidecar(
                scorer=InProcessScorer(device="cpu")).start()
            client = sidecar.GrpcScorerClient(f"127.0.0.1:{port.port}")
            try:
                x = rows(37)
                first = await client.score(x)
                snap = await client.snapshot()
                snap.mu = rows(1, seed=2)[0]
                snap.step = 9
                assert await client.restore(snap) == 9
                second = await client.score(x)
                assert first.shape == second.shape == (37,)
                assert not (first == second).all()
                assert port.service.rows_scored == 74
            finally:
                await client.aclose()
                await port.close()

        run(go())

    def test_port_client_fits_and_closes(self):
        """The port's client trains over Fit, keys its first-call
        deadlines by (rpc, bucket), and closes without waiting."""
        async def go():
            port = await sidecar.ScorerSidecar(
                scorer=InProcessScorer(device="cpu")).start()
            client = sidecar.GrpcScorerClient(f"127.0.0.1:{port.port}")
            try:
                x = rows(37)
                before = await client.score(x)
                loss = await client.fit(x, np.zeros(37), np.ones(37))
                assert np.isfinite(loss) and port.scorer._step == 4
                assert client._warm == {("Score", 64), ("Fit", 64)}
                assert not (await client.score(x) == before).all()
                client.close()
                assert client._channel is None
                await client._closing
                await client.aclose()  # nothing left to close
            finally:
                await port.close()

        run(go())


def test_announced_replica_file_equals_the_reference(tmp_path):
    """``main --announce-dir`` registers a replica as the reference's
    sidecar does: the same file, the same bytes, withdrawn on close."""
    from linkerd_tpu.announcer import FsAnnouncer as JaxFsAnnouncer
    from linkerd_tpu.core import Path as JaxPath

    ref = JaxFsAnnouncer(str(tmp_path / "jax"), JaxPath.read("/io.l5d.fs"))
    want = ref.announce("127.0.0.1", 7070, JaxPath.read("/l5d-scorer"))
    got = sidecar.announce_replica(str(tmp_path / "port"), "l5d-scorer",
                                   "127.0.0.1", 7070)
    path = tmp_path / "port" / "l5d-scorer"
    assert path.read_bytes() == (tmp_path / "jax" / "l5d-scorer").read_bytes()
    got.close()
    want.close()
    assert not path.exists()
