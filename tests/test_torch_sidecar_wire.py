"""The sidecar's wire both ways, on the CPU: the port's client against
the reference's grpcio ``ScorerSidecar``, the reference's grpcio client
against the port's sidecar (which serves on the port's own h2 gRPC
runtime), and each client against its own package's sidecar.

Every pair runs the same calls from one seeded checkpoint: Restore,
Score at 1, 37, 1024 and 4096 rows, the full Snapshot, Fit at the same
sizes, and the Snapshot after. What each server receives is byte-equal
whoever sent it, and what each server answers is byte-equal whoever
asked. The port's served scores hold to the bounds in force against
the JAX model's forward on the checkpoint (1e-5 on all but 1% of rows,
1e-3 on every row) and to 1e-3 against the reference's served scores
(see ``tests/test_torch_sidecar.py``); the restored snapshot
comes back byte for byte; each server's Fit losses equal, bit for bit,
its own scorer's called without the hop (the two packages' losses are
printed: the reference's scorer compiles its step under XLA's default
excess precision, and ``tests/test_torch_train.py`` holds training
across the packages with that option off). Errors
answer alike: a scorer fault UNKNOWN, a deadline resets the call and the
server cancels its handler, a refused connection raises, and through
``ResilientScorer`` each is ``ScorerUnavailable``.
"""

import asyncio
import dataclasses
import sys

import grpc
import jax
import numpy as np
import pytest

from linkerd_tpu.lifecycle import store as ref_store
from linkerd_tpu.models import anomaly as jax_model
from linkerd_tpu.telemetry import anomaly as ref_anomaly
from linkerd_tpu.telemetry import resilience as ref_resilience
from linkerd_tpu.telemetry import sidecar as ref_sidecar
from linkerd_tpu_torch.grpc.status import GrpcError
from linkerd_tpu_torch.lifecycle import store as port_store
from linkerd_tpu_torch.telemetry import resilience as port_resilience
from linkerd_tpu_torch.telemetry import sidecar as port_sidecar
from linkerd_tpu_torch.telemetry.anomaly import InProcessScorer

SIZES = (1, 37, 1024, 4096)
SCORE_ATOL = 1e-3
ROW_ATOL = 1e-5
ROW_SHARE = 0.01
SIDES = {"port": (port_sidecar, port_store, port_resilience),
         "ref": (ref_sidecar, ref_store, ref_resilience)}


def run(coro, timeout=300):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def rows(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 36)) * 2.0).astype(np.float32)


def fit_args(n, seed):
    rng = np.random.default_rng(seed + 100)
    return (rows(n, seed), (rng.random(n) < 0.2).astype(np.float32),
            np.ones(n, np.float32))


def jax_forward(snap, x):
    """The JAX model's scores for raw rows under a snapshot, op by op
    (the reference's served scores add each bias to the unrounded sum
    under XLA's excess precision, so only the 1e-3 bound holds there)."""
    p = jax.tree_util.tree_map(jax.numpy.asarray, snap.params)
    xn = jax_model.normalize_features(x, snap.mu, snap.var)
    return np.asarray(jax_model.anomaly_scores(p, xn, snap.cfg))


def jax_scorer():
    # conftest fakes 8 CPU devices; one keeps the single-device path
    return ref_anomaly.InProcessScorer(devices=jax.devices()[:1])


async def seeded_checkpoint() -> bytes:
    """A trained checkpoint (nonzero biases, Adam state, norm stats)."""
    s = jax_scorer()
    try:
        await s.fit(*fit_args(64, 11))
        return ref_store.encode_snapshot(s.snapshot())
    finally:
        s.close()


# the server-side callers of the payload decoders, in both packages (the
# clients decode Snapshot replies in the same process)
HANDLERS = {"score", "fit", "restore", "handle_score", "handle_fit",
            "handle_restore"}


class Recorder:
    """Records the request payloads a sidecar's handlers decode."""

    def __init__(self, mp, module, store):
        self.got = []
        for name, mod in (("decode_matrix", module),
                          ("decode_fit", module),
                          ("decode_snapshot", store)):
            self._wrap(mp, mod, name)
        if module is port_sidecar:  # imported by name at the top
            self._wrap(mp, module, "decode_snapshot")

    def _wrap(self, mp, mod, name):
        real = getattr(mod, name)

        def recording(data):
            if sys._getframe(1).f_code.co_name in HANDLERS:
                self.got.append((name, bytes(data)))
            return real(data)

        mp.setattr(mod, name, recording)


async def start_server(side):
    if side == "port":
        return await port_sidecar.ScorerSidecar(
            scorer=InProcessScorer(device="cpu")).start()
    return await ref_sidecar.ScorerSidecar(scorer=jax_scorer()).start()


async def session(client_side, port, blob):
    """The calls of one client against one server: every answer as the
    bytes the server sent."""
    sidecar, store, _ = SIDES[client_side]
    client = sidecar.GrpcScorerClient(f"127.0.0.1:{port}")
    out = []
    try:
        out.append(("Restore", await client.restore(
            store.decode_snapshot(blob))))
        for n in SIZES:
            out.append((f"Score {n}", (await client.score(
                rows(n, n))).tobytes()))
        out.append(("Snapshot", store.encode_snapshot(
            await client.snapshot())))
        for n in SIZES:
            out.append((f"Fit {n}", np.float32(await client.fit(
                *fit_args(n, n))).tobytes()))
        out.append(("Snapshot after", store.encode_snapshot(
            await client.snapshot())))
    finally:
        await client.aclose()
    return out


def test_four_rpcs_both_ways():
    async def go(mp):
        blob = await seeded_checkpoint()
        answers, received = {}, {}
        for server in ("port", "ref"):
            sidecar, store, _ = SIDES[server]
            rec = Recorder(mp, sidecar, store)
            srv = await start_server(server)
            try:
                for client in ("port", "ref"):
                    rec.got.clear()
                    answers[server, client] = await session(
                        client, srv.port, blob)
                    received[server, client] = list(rec.got)
            finally:
                await srv.close()
        return blob, answers, received

    with pytest.MonkeyPatch.context() as mp:
        blob, answers, received = run(go(mp))

    # what a server receives does not depend on the client or the server
    first = received["port", "port"]
    assert [n for n, _ in first] == (
        ["decode_snapshot"] + ["decode_matrix"] * 4 + ["decode_fit"] * 4)
    for key, got in received.items():
        assert got == first, key
    assert first[0][1] == blob and len(first[4][1]) == 8 + 4096 * 36 * 4
    # what a server answers does not depend on the client
    for server in ("port", "ref"):
        assert answers[server, "port"] == answers[server, "ref"], server
    port, ref = (dict(answers[s, "port"]) for s in ("port", "ref"))
    # across the servers: the restore, the scores, the snapshot
    assert port["Restore"] == ref["Restore"]
    assert port["Snapshot"] == ref["Snapshot"] == blob
    assert len(blob) > 1_000_000  # the whole model and Adam's moments
    got, served = (np.concatenate([
        np.frombuffer(d[f"Score {n}"], np.float32) for n in SIZES])
        for d in (port, ref))
    forward = np.concatenate([jax_forward(ref_store.decode_snapshot(blob),
                                          rows(n, n)) for n in SIZES])
    assert got.shape == (sum(SIZES),)
    diff = np.abs(got - forward)
    assert diff.max() <= SCORE_ATOL
    assert (diff > ROW_ATOL).mean() <= ROW_SHARE
    assert np.abs(got - served).max() <= SCORE_ATOL
    losses = {s: [float(np.frombuffer(d[f"Fit {n}"], np.float32)[0])
                  for n in SIZES] for s, d in (("port", port), ("ref", ref))}
    print("fit losses, port vs ref:", losses)
    assert all(np.isfinite(losses["port"]))
    # each server's fits, bit for bit its scorer's fits without the hop
    assert losses == run(local_fits(blob))
    steps = [port_store.decode_snapshot(port["Snapshot after"]).step,
             ref_store.decode_snapshot(ref["Snapshot after"]).step]
    assert steps[0] == steps[1] == \
        port_store.decode_snapshot(blob).step + 4 * len(SIZES)


async def local_fits(blob):
    """The Fit losses of each package's scorer, called directly, from
    the checkpoint."""
    out = {}
    for side, scorer in (("port", InProcessScorer(device="cpu")),
                         ("ref", jax_scorer())):
        try:
            scorer.restore(SIDES[side][1].decode_snapshot(blob))
            out[side] = [float(np.float32(await scorer.fit(*fit_args(n, n))))
                         for n in SIZES]
        finally:
            scorer.close()
    return out


def code_of(err) -> int:
    """The gRPC status code an error of either client carries."""
    if isinstance(err, GrpcError):
        return err.status.code
    if isinstance(err, grpc.aio.AioRpcError):
        return err.code().value[0]
    raise AssertionError(f"not a gRPC status: {err!r}")


class Hanging:
    """A scorer whose score never ends; counts the calls its server
    cancelled."""

    def __init__(self):
        self.cancelled = 0
        self.started = 0

    async def score(self, x):
        self.started += 1
        try:
            await asyncio.Event().wait()
        except asyncio.CancelledError:
            self.cancelled += 1
            raise

    async def fit(self, x, labels, mask):
        return 0.0

    def close(self):
        pass


def test_errors_alike():
    """A scorer fault, a deadline and a refused connection raise in both
    clients against both servers; the statuses and messages match, and
    ``ResilientScorer`` turns each into ``ScorerUnavailable``."""
    async def go():
        out = {}
        for server in ("port", "ref"):
            sidecar, _, _ = SIDES[server]
            srv = await start_server(server)
            hang = await sidecar.ScorerSidecar(scorer=Hanging()).start()
            try:
                for client in ("port", "ref"):
                    csc, _, res = SIDES[client]
                    c = csc.GrpcScorerClient(f"127.0.0.1:{srv.port}")
                    slow = csc.GrpcScorerClient(
                        f"127.0.0.1:{hang.port}", timeout_s=0.3,
                        first_timeout_s=0.3)
                    try:
                        with pytest.raises(Exception) as fault:
                            await c.score(np.zeros((4, 35), np.float32))
                        snap = await c.snapshot()
                        bad = dataclasses.replace(snap, cfg=dataclasses.replace(
                            snap.cfg, recon_weight=0.5))
                        with pytest.raises(Exception) as refused:
                            await c.restore(bad)
                        with pytest.raises(Exception) as late:
                            await slow.score(np.zeros((4, 36), np.float32))
                        wrapped = res.ResilientScorer(c, call_timeout_s=5.0)
                        with pytest.raises(res.ScorerUnavailable):
                            await wrapped.score(np.zeros((4, 35),
                                                         np.float32))
                        for _ in range(100):  # the server sees the reset
                            if hang.scorer.cancelled == \
                                    hang.scorer.started:
                                break
                            await asyncio.sleep(0.01)
                        out[server, client] = (
                            code_of(fault.value), code_of(refused.value),
                            code_of(late.value), hang.scorer.started,
                            hang.scorer.cancelled,
                            wrapped.breaker.state)
                    finally:
                        await c.aclose()
                        await slow.aclose()
                    out[server, client, "details"] = (
                        fault.value.details() if client == "ref"
                        else fault.value.status.message)
            finally:
                await srv.close()
                await hang.close()
        # a refused connection, through the breaker
        for client in ("port", "ref"):
            csc, _, res = SIDES[client]
            probe = await port_sidecar.ScorerSidecar(
                scorer=Hanging()).start()
            dead = probe.port
            await probe.close()
            c = csc.GrpcScorerClient(f"127.0.0.1:{dead}")
            wrapped = res.ResilientScorer(
                c, call_timeout_s=2.0,
                breaker=res.CircuitBreaker(failures=1))
            try:
                with pytest.raises(res.ScorerUnavailable):
                    await wrapped.score(np.zeros((4, 36), np.float32))
                out["refused", client] = wrapped.breaker.state
            finally:
                await c.aclose()
        return out

    out = run(go(), timeout=180)
    for server in ("port", "ref"):
        for client in ("port", "ref"):
            # UNKNOWN, UNKNOWN, DEADLINE_EXCEEDED; one hung call, cancelled
            assert out[server, client][:3] == (2, 2, 4), (server, client)
            assert out[server, client][3:] in ((1, 1, "closed"),
                                               (2, 2, "closed"))
        # grpcio's words for a handler's exception, from both servers
        assert out[server, "port", "details"] == \
            out[server, "ref", "details"]
        assert out[server, "port", "details"].startswith(
            "Unexpected <class "), out[server, "port", "details"]
    assert out["refused", "port"] == out["refused", "ref"] == "open"
