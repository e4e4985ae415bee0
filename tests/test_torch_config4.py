"""BASELINE config 4 (the io.l5d.k8s namer over a scripted API server,
the dtab in a ConfigMap, zipkin tracing, a rolling restart of svc-3
whose survivor degrades with latency alone) in both packages, on the
CPU: the port's ``linkerd_tpu_torch.testing.config4.bench`` against the
reference's ``benchmarks.config4_k8s.bench``.

The two runs see the same rows, so that their scores can be held row by
row, as ``tests/test_torch_config3.py`` arranges:

- each package's telemeter module reads a scripted clock, moved by 1-2
  ms in every pod's GET (drawn from one seeded generator a package, so
  the same in both) and by the FaultInjector's latency (its
  ``asyncio.sleep``), so every latency, rate and drift is the same (the
  collector's POSTs do not move it). The pods' time varies as a real
  pod's does: at a constant 1 ms every calm row of svc-3 is alike, the
  labeled rows share a few dozen bf16 scores, and the AUC turns on ties
  that score differences inside the bf16 bounds break either way (0.70
  against 0.68 at 300 requests, each package scoring within 5.6e-5 of
  the JAX fused scorer);
- both telemeters take scorers restored from one snapshot, the JAX train
  step compiled with ``xla_allow_excess_precision`` off. The port runs
  first; after each of its fits the reference's scorer fits the same
  batch from the same state and then takes the port's fitted state, so
  every batch is scored under one model in both packages;
- the port's schedule drains the ring empty where the benchmark calls
  ``drain_once`` once, and the reference's telemeter is given a
  ``drain_once`` that drains it empty, so both schedules are one.
  Which pod of a service answers does not enter a row (both of svc-3's
  pods sit behind the one injector and labeler), so the port's wait for
  the binding after each restart leaves the rows as they are.

Run at 300 requests (836 through the router) where the benchmark's
default is 600: each package's run then takes about a third of the
file's minute on one worker.

Bounds: the rows of every score call bit-equal; the port's scores of
them within the bf16 bounds in force (ROADMAP Queue 3): 1e-3 on every
row and 1e-5 on all but 1%, against the JAX package's fused scorer
(Pallas, interpreted, compiled with ``xla_allow_excess_precision`` off)
under the model the port scored with; ``fault_auc_subtle_k8s`` within
0.01 (ROADMAP Queue 1 item 5); the router's request counts and the
labeled rows equal; a span at the collector for every request in both.
"""

import asyncio
import random
import types

import jax
import numpy as np
import pytest

import benchmarks.config4_k8s as ref_bench
from linkerd_tpu.protocol.http import server as ref_server
from linkerd_tpu.router import service as ref_service
from linkerd_tpu.telemetry import anomaly as ref
from linkerd_tpu.testing import faults as ref_faults
from linkerd_tpu_torch.protocol.http import server as port_server
from linkerd_tpu_torch.router import service as port_service
from linkerd_tpu_torch.telemetry import anomaly as port
from linkerd_tpu_torch.testing import config4 as port_bench
from linkerd_tpu_torch.testing import faults as port_faults
from tests.test_torch_config3 import (
    OFF, Clock, ClockSleep, Recorder, to_port, to_ref,
)
from tests.test_torch_linker import jax_scores

N_REQUESTS = 300          # the benchmark's default: 600
AUC_TOL = 0.01            # ROADMAP Queue 1 item 5
ROW_TOL, ROW_SHARE, TOL = 1e-5, 0.01, 1e-3   # bf16 score bounds
BACKEND_S = 1e-3          # scripted time a downstream GET takes, at least
BACKEND_SEED = 11


def clocked_serve(serve, fn_service, clock):
    """``serve`` whose handlers move ``clock`` on a GET: BACKEND_S and
    up to as much again, drawn from a seeded generator a clock."""
    rng = random.Random(BACKEND_SEED)

    async def wrapped(service, *a, **kw):
        async def handle(req):
            if req.method == "GET":
                clock.now += BACKEND_S * (1.0 + rng.random())
            return await service(req)
        return await serve(fn_service(handle), *a, **kw)
    return wrapped


def draining_empty(drain_once):
    """A telemeter's ``drain_once`` that drains its ring empty."""
    async def drain(self, scorer=None):
        total = 0
        while self.ring:
            total += await drain_once(self, scorer)
        return total
    return drain


def scripted_runs(monkeypatch, port_mod, ref_mod, n_requests):
    """Both benchmarks under the scripted set-up: the port's result and
    recorder, then the reference's."""
    clocks = Clock(), Clock()
    for mod, clock in ((ref, clocks[0]), (port, clocks[1])):
        monkeypatch.setattr(mod, "time", clock)
    for mod, clock in ((ref_faults, clocks[0]), (port_faults, clocks[1])):
        monkeypatch.setattr(mod, "asyncio", ClockSleep(clock))
    monkeypatch.setattr(ref_server, "serve", clocked_serve(
        ref_server.serve, ref_service.FnService, clocks[0]))
    monkeypatch.setattr(port_server, "serve", clocked_serve(
        port_server.serve, port_service.FnService, clocks[1]))
    monkeypatch.setattr(ref.JaxAnomalyTelemeter, "drain_once",
                        draining_empty(ref.JaxAnomalyTelemeter.drain_once))

    rs = ref.InProcessScorer(devices=jax.devices()[:1], recon_weight=1.0)
    rs._train_step = jax.jit(rs._train_step.__wrapped__,
                             compiler_options=OFF)
    ps = port.InProcessScorer(device="cpu", recon_weight=1.0)
    ps.restore(to_port(rs.snapshot()))
    fitted = []
    port_rec = Recorder(ps, lambda i: fitted.append(ps.snapshot()))
    ref_rec = Recorder(rs, lambda i: rs.restore(to_ref(fitted[i])))
    monkeypatch.setattr(ref.JaxAnomalyTelemeter, "_mk_inprocess",
                        lambda self: rs)
    monkeypatch.setattr(port.JaxAnomalyTelemeter, "_mk_inprocess",
                        lambda self: ps)

    async def both():
        got = await port_mod.bench(n_requests, device="cpu")
        want = await ref_mod.bench(n_requests)
        return got, want

    got, want = asyncio.run(asyncio.wait_for(both(), 600))
    return types.SimpleNamespace(got=got, want=want, port=port_rec,
                                 ref=ref_rec)


def rows_and_fits_alike(runs, n_scored, n_fits):
    """Every score call's rows bit-equal in both packages, and the port's
    scores within the bf16 bounds of the JAX scorer under the same
    model; every fit on the same rows."""
    p, r = runs.port, runs.ref
    assert len(p.scored) == len(r.scored) == n_scored
    assert len(p.fits) == len(r.fits) == n_fits
    gaps, ref_gaps = [], []
    for (xp, sp, snap), (xr, sr, _) in zip(p.scored, r.scored):
        assert np.array_equal(xp, xr)
        gaps.append(np.abs(sp - jax_scores(to_ref(snap), xp)))
        ref_gaps.append(np.abs(sp - sr))
    gap, ref_gap = np.concatenate(gaps), np.concatenate(ref_gaps)
    print(f"scores: {len(gap)} rows, max|diff| {gap.max():.3e}, past "
          f"{ROW_TOL}: {(gap > ROW_TOL).sum()}; against the reference "
          f"run's own jit: max|diff| {ref_gap.max():.3e}")
    assert gap.max() <= TOL
    assert (gap > ROW_TOL).mean() <= ROW_SHARE
    for (xp, lp), (xr, lr) in zip(p.fits, r.fits):
        assert np.array_equal(xp, xr)
        print(f"fit loss port {lp} reference {lr} "
              f"relative {abs(lp - lr) / abs(lr):.2e}")


@pytest.fixture(scope="module")
def runs():
    with pytest.MonkeyPatch.context() as monkeypatch:
        return scripted_runs(monkeypatch, port_bench, ref_bench, N_REQUESTS)


def test_config_text_is_the_benchmarks():
    assert port_bench.CONFIG == ref_bench.CONFIG
    assert port_bench.N_SVCS == ref_bench.N_SVCS


def test_config4_alike(runs):
    got, want = runs.got, runs.want
    print(f"fault_auc_subtle_k8s port {got['fault_auc_subtle_k8s']} "
          f"reference {want['fault_auc_subtle_k8s']}; spans "
          f"{got['zipkin_spans']} / {want['zipkin_spans']}")
    assert abs(got["fault_auc_subtle_k8s"]
               - want["fault_auc_subtle_k8s"]) <= AUC_TOL
    # phase A's 300 requests, then in each of 4 windows 37 to svc-3 and
    # 30 over the ten services, with the pod gone and again with it back
    assert (got["requests"], got["labeled_n"], got["anomalous_n"]) == (
        want["requests"], want["labeled_n"], want["anomalous_n"]) == (
        836, 320, 160)
    assert got["restart_windows"] == want["restart_windows"] == 4
    for out in (got, want):
        assert out["zipkin_spans"] >= out["requests"]
    # every request answered by its own service; none reached a pod the
    # binding showed gone
    assert got["answers"] == {"right": 836, "wrong": 0, "failed": 0}
    assert got["strays"] == 0 and len(got["binding_ms"]) == 8


def test_config4_rows_and_fits_alike(runs):
    # 7 drains of phase A and the epochs, 2 score-only drains (536 rows
    # in batches of 512), the AUC's
    rows_and_fits_alike(runs, 10, 7)
