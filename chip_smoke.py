#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # the smoke run
    python3 chip_smoke.py --mutants  # self-test of its agreement checks
    python3 chip_smoke.py --sweep    # the kernel's row tiles and breakdown
    python3 chip_smoke.py --check telemeter  # the telemeter phase alone
    python3 chip_smoke.py --check linker     # the linker phase alone
    python3 chip_smoke.py --check fastpath   # the fastpath phase alone
    python3 chip_smoke.py --check fastpath_d # its part D alone
    python3 chip_smoke.py --check control    # the control phase alone
    python3 chip_smoke.py --check h2         # the h2 phase alone
    python3 chip_smoke.py --check h2fast     # the h2fast phase alone
    python3 chip_smoke.py --check mux        # the mux phase alone
    python3 chip_smoke.py --check k8s        # the k8s phase alone
    python3 chip_smoke.py --check edge       # the edge phase alone
    python3 chip_smoke.py --check sidecar    # the sidecar phase alone
    python3 chip_smoke.py --check discovery  # the discovery phase alone
    python3 chip_smoke.py --mutant one_rounding telemeter  # one mutant, one check
    python3 chip_smoke.py --witness  # the kernel's sums against exact ones
    python3 chip_smoke.py --repeat-control-a 16  # control part A, 16 times
    python3 chip_smoke.py --repeat-control-b 8   # control part B, 8 times

Builds every CUDA kernel of the scoring path, and the native engine
(``native/`` through ``linkerd_tpu_torch/native/_build.py``), from the
sources in this checkout, holds each against its plain PyTorch version on the card,
drives the scorer sidecar's request handlers (Restore, Score with
batches in flight, Snapshot) on the exact wire bytes, checks that every
batch went through the kernel, and times the kernel and the service.
Then the train phase, through the same handlers: (a) Fit calls on the
card held against the same calls on the CPU, and the fitted model's
served scores against its plain version; (b) Score batches while fits
run, each scored under one whole published model; (c) the lifecycle
manager promoting a good fit and rolling a poisoned one back to the
promoted scores, bit for bit; (d) fit, gated-cycle and Score-under-fit
times. Then the distill phase at ``DistillConfig()`` defaults: 34
drifted routes scored through a trained teacher fill a 32-head
specialist bank, checking (a) two kernel launches a retrain cycle, (b)
each head's kernel scores against plain, (c) ``distill_head`` on the
card against the CPU (the heads read through the float32 forward),
(d) the published blobs' fences and generations and (e) the lineage, with a NaN-poisoned candidate rejected, the last
route skipped with the bank full and one head rolled back; and its
times. Then the telemeter phase: the in-process ``io.l5d.jaxAnomaly``
telemeter's main path (recorder and ring appends -> the line-rate
micro-batcher in ``run()`` -> the scorer's ring -> the kernel ->
``ScoreBoard`` -> ``AnomalyFailureAccrualPolicy``) at the reference's
defaults: part A without training (kernel scores against plain, the
board against a plain fold, one launch a batch, every row scored, the
accrual policy tightening on the faulted routes), part B at the
reference's cadence (fits, a lifecycle with cycles by hand, a distill
block, spans, a weight sink; launches per batch, gate and retrain, the
republished blob's CRC in the manifest, hold-out batches kept from
fits); and its times. Then the linker phase: the port's HTTP linker
(``load_linker`` from JSON text: an ``io.l5d.fs`` namer over 40
destinations of 2 replicas, the ``io.l5d.jaxAnomaly`` telemeter at the
reference's defaults, its ``run()`` task on the router's event loop)
proxying 64 keep-alive connections from load processes to backend
processes, 4 destinations faulted in a labeled window: part A without
failure accrual (every calm request routed right, every recorded row
scored with no drop, one launch a batch, the board against a plain fold,
AUC, faulted destinations above calm ones), part B with the
``io.l5d.jaxAnomaly`` accrual (faulted endpoints removed, calm ones
not), part C with no telemetry block (the router's own cost); and its
times. Then the fastpath phase: the same topology and traffic through a
``fastPath: true`` router served by the native engine, every retired
request's engine row drained into the telemeter's native ring: part A
with ``nativeTier: off`` (every row through the kernel, one launch a
batch, kernel and board against plain, AUC over the window's rows
labeled by destination), part B with ``nativeTier: primary`` (the
telemeter's blob published into the engine, which scores the rows in
its data plane: its share of the window, its scores against the native
evaluator and the float32 plain forward, and against the kernel), part
C with no telemetry block, beside the window's traffic sent straight to
the backends, and part D: a router with ``workers: 4``, a cleartext and
a native-TLS server, ``connectionGuard`` and ``streamScoring``, the
telemeter at ``nativeTier: off`` (every worker accepted connections and
the merged stats equal the workers' sum, ``worker/<i>`` exported, the
engine's TLS handshakes equal the TLS connections and the answers equal
the cleartext ones, slow clients closed within the header budget, 101
tunnels counted and their kind-2 sample rows in the engine's tables, the
sentinel and the telemeter's batches alike, one launch a batch of at
most 1,024 rows, kernel and board against plain); and its times. Then
the control phase: the same topology
with the router bound through the port's namerd (a spawned process) over
``io.l5d.namerd.http``, ``admissionControl`` on the router and the
telemeter's ``control:`` block: part A (faults on one replica of each
faulted destination; the score-weighted balancer drains those replicas
to a trickle), part B (both replicas sick; one verified override
published per sick cluster through namerd, traffic answered by the
failover clusters, each override reverted after the faults clear, the
namespace back to its bytes, an oscillation publishing nothing, an
unsafe failover entry rejected), each holding what the linker phase
holds; and its times. Then the h2 phase: the port's h2 router
(``protocol: h2``, ``io.l5d.h2.grpc.default`` with service retries)
proxying gRPC calls from load processes on 8 connections of 16 streams
each, over a cleartext, a TLS (ALPN h2) and a clearContext server, to
40 destinations of 2 replicas served by the port's own gRPC runtime, 4
of them faulted (40 ms, then UNAVAILABLE at 0.9): part A without
training (every calm call answered by its destination, every row
scored and keyed to its call's destination, one launch a batch, the TLS
handshakes choosing h2, an h2c upgrade probe answered; for the faulted
calls a frozen model of random weights over the calm rows' stats,
every row's kernel score within 2e-3 of plain with at most 1% past
1e-5, and the board against a plain fold), part B with the
``io.l5d.jaxAnomaly`` accrual (faulted endpoints removed, calm ones
not), part C with no telemetry block, part D: server-streaming calls
through ``streamScoring`` (observe), whose sentinel's samples are what
the client's frames predict, and part E: the router served by
``python -m linkerd_tpu_torch`` on the card, every call answered,
counted and scored in that process. Then the h2fast phase: BASELINE
config 2 (an h2 router with ``fastPath: true`` and io.l5d.prometheus)
served by the port's native h2 engine on the h2 phase's topology: part
A with the io.l5d.jaxAnomaly telemeter at ``nativeTier: off`` (every
calm call answered by its destination, the injected UNAVAILABLE passed
through, every engine row scored under its call's destination, one
launch a batch, the faulted calls' kernel scores and the board against
plain under a frozen traffic-fitted model, the prometheus scrape's
route counters equal to the calls), the same router without the
telemeter, and ``h2bench load`` readings through the engine with 1 and
4 workers and straight to ``h2bench serve``; part B, the engine's
options (4 workers whose merged stats are their sum, native TLS with
ALPN h2, rapid-reset clients closed by ``connectionGuard``'s flood
caps, ``streamScoring`` samples of server-streaming calls as their
frames predict in the ring and the sentinel, a hung backend answered
504 within ``timeoutMs``); part C, the router bound through the port's
namerd CLI over the io.l5d.mesh API (a dtab write moving one
destination to other replicas, namerd stopped and started again, every
call answered as the dtab of the moment says and every row scored).
Then the mux phase: part A, BASELINE config 3 (an http router and a
thriftmux router in one linker, io.l5d.jaxAnomaly at maxBatch 512 with a
fit after every batch) on ``testing/config3.py``'s schedule at 2,048
requests from a spawned load process (every thriftmux call answered with
its own method and seqid, every calm http request by its destination,
the routers' request counters equal to what was sent, every http row
scored with one launch a batch, each batch's kernel scores and the board
against plain under the model it read, svc-a scored higher under the
faults than before them; its fault_auc printed beside BASELINE.json's
0.9); part B, a thrift router (TTwitter upgrade, thriftMethodInDst,
service retries) and a mux router beside the http one over 8
destinations of 2 replicas, one destination answering thrift EXCEPTION
replies, a thrift and a mux replica failing while the flag is up (every
calm call answered by its destination, the mux calls' downstream dest
the bound residual, a Tdispatch dtab override, retries counted, exactly
the faulted endpoints removed by failure accrual, the http rows scored
as in part A); part C, the three routers bound through the namerd CLI's
thrift interface (``io.l5d.namerd``) around a dtab write and a namerd
restart (every call answered as the dtab of the moment says, every http
row scored under its destination, the write- and restart-to-answer ms).
Then the k8s phase, in this process: part A, BASELINE config 4 (the
io.l5d.k8s namer over a scripted API server, the dtab in a ConfigMap
read by io.l5d.k8s.configMap, zipkin spans to a collector, a rolling
restart of svc-3 whose survivor answers 4-16 ms late) on
``testing/config4.py``'s schedule at 2,048 requests, one at a time
(every request answered by its own service, the router's counter equal
to what was sent, no request reaching a pod after the binding showed it
gone, a span for every request, every row scored with one launch a
batch, each batch's kernel scores and the board against plain under the
model it read, fault_auc_subtle_k8s printed beside BASELINE's 0.9 and
failing at 0.5 or less, a ConfigMap update timed to its first answer);
part B, BASELINE config 5 (two routers over 50 services in three tiers,
the io.l5d.istio telemeter reporting to a mixer on the port's gRPC
runtime, a latency-only cascade and 15% 503s) on ``testing/config5.py``'s
schedule at 1,024 front requests (a mixer report for every request of
either router, every 502 a svc-47 503 in its window, the kernel and
board checks of part A, both AUCs printed and failing at 0.5 or less);
part C, one linker of four routers: io.l5d.ingress (an Ingress update
moving a path, timed to its first answer), the io.l5d.k8s.istio
identifier, interpreter and namer over a fake pilot (an 80/20 route
rule answered within 5 points over 2,048 requests), io.l5d.k8s.ns and
io.l5d.k8s.external, each part's rows scored with one launch a batch and
held against plain. Then the edge phase, on the linker phases'
topology with closed-loop load from 16 tenants (the l5d-tenant header)
in three windows: calm, a storm (the faults on; 85% of the requests
``t15``'s, to the faulted destinations) and recovery. Part A, the
Python HTTP router with ``tenantIdentifier``, ``tenants``,
``admissionControl``, an ``io.l5d.http.file`` request logger,
``httpAccessLog``, an fs namer behind ``io.l5d.specificHost`` over disco
files that also name a dead host, and an ``io.l5d.fs`` announcer: every
batch's kernel scores and the board against plain under the model it
read, ``t15`` SICK and shed retryably at its sub-limit of 6 and
recovered with one transition each way, no calm tenant SICK or shed,
every other request answered by its destination or its fault,
``/tenants.json`` the board's and governor's state, one request log
line a request that reached a client and one access log line a request
served, the client scopes the transformed bound ids, the announcement
withdrawn by ``close()``; part B, the HTTP/1.1 engine with 4 workers
(``tenant_hash_native`` against ``tenant_hash``, the quota pushed as 1
a worker and the excess shed 503 + l5d-retryable in the engine, every
engine row's tenant column its request's, the
``rt/<label>/fastpath/tenant/*`` counters the engine's own, the kernel
on every batch); part C, the h2 engine with gRPC calls at ``nativeTier:
primary`` (the excess reset REFUSED_STREAM as often as the engine's
``tenant_shed`` says, each tenant's in-plane score EWMA on the board).
Then the sidecar phase, on the linker phases' topology, with scorer
replicas in processes of their own started through ``python -m
linkerd_tpu_torch.telemetry.sidecar`` and announced into its fs
directory, the hop on the port's own gRPC runtime: part A, a seeded
snapshot restored into two replicas and batches of 1, 37, 1024 and 4096
rows through the port's client, each reply held against the plain
version here, with the hop's Score p50/p99 and rows/s at 1024 rows x4
in flight beside the service phase's handlers alone; part B, the HTTP
router with ``sidecarTier: primary`` on ``/#/io.l5d.fs/l5d-scorer``
(every row scored, both replicas called, Fit across the hop with finite
losses, fault_auc of the faulted destinations at least 0.9); part C,
the reference's chaos drill under calm traffic (one replica SIGKILLed:
no degraded sample; the second: degraded and the breaker open within
scoreTimeoutMs and a probe, the board neutral; one started again on its
port: degraded 0 within a probe interval; every request 200 within its
budget); part D, ``sidecarTier: fallback`` (the in-process primary on
the card serves every batch and fit, then made to raise for a window:
its breaker opens, the sidecar tier scores every batch and no fit
reaches a replica, then a probe closes the breaker); part E, a
promotion restoring the checkpoint on both replicas, their scores held
against the router's. Then the discovery phase: the linkerd CLI on the
card (``main()`` in a spawned process) routing 22 destinations through
the io.l5d.consul, io.l5d.marathon, io.l5d.serversets, io.l5d.zkLeader
and io.l5d.curator namers over a scripted consul agent, a scripted
Marathon and the port's FakeZkServer, two downstream linkerds
announcing into the serversets through the io.l5d.serversets
announcer: part A, every request answered by its destination, a consul
and a Marathon replica replaced (ms to the first answer from the new
one), one replica failing until accrual removes it and its
destination's board margin rising; part B, a downstream linkerd
SIGKILLed (ms to its members gone, from the kill and from the reap, to
the router's re-read; no failed request after it), the leader changed
(ms), the curator instances; part C, ``/config-check.json`` clean on
the live config and the planted rule ids at their lines on a second
CLI, and the p99 of traffic while checks run; the kernel once a batch
against plain on every row. Prints the card, a JSON line of kernel and
service numbers, one of the train phase's, one of the distill
phase's, one of the telemeter phase's, one of the linker phase's, one
of the fastpath phase's, one of the control phase's, one of the cli
phase's, one of the h2 phase's, one of the h2fast phase's, one of the
mux phase's, one of the k8s phase's, one of the edge phase's, one of
the sidecar phase's, one of the discovery phase's, and as its last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero; with no CUDA device, or
outside the repository, it exits non-zero before printing any result.
Imports nothing of JAX.

``--mutants`` builds deliberately broken copies of the kernel in a
temporary copy of the port and runs the kernel and served checks
against each, and the linker, fastpath, control, cli, h2, h2fast, mux,
k8s, edge, sidecar and discovery phases against ``LINKER_MUTANT``, the
cli phase against ``CLI_MUTANTS``, part D
against ``FASTPATH_MUTANTS`` (the sharded engine's stats merge and
feature drain reading worker 0 alone), the h2 phase against
``H2_MUTANTS``, the h2fast phase against ``H2FAST_MUTANTS``, the
mux phase against ``MUX_MUTANTS``, the k8s phase against
``K8S_MUTANTS``, the edge phase against ``EDGE_MUTANTS``, the
sidecar phase against ``SIDECAR_MUTANTS`` and the discovery phase
against ``DISCOVERY_MUTANTS``, in a fresh
interpreter; it fails
unless every check fails on its mutant.

``--witness`` runs the linker phase's part A and, on its window rows,
holds the kernel and the plain version against an exact forward
(float64 sums, the kernel's rounding points), layer by layer.

``--repeat-control-a N`` runs the control phase's part A N times over
one topology and prints each run's weight margins (the faulted
replicas' weights under every calm replica's: averaged to the drain as
the check reads them, at the worst instant before it, and after it).
``--repeat-control-b N`` runs part B N times over one topology and
prints each run's events, the reactor's levels from the oscillation on,
its stalled steps and the interpreter's full collections, or its
failure.

``--sweep`` builds variants of the kernel in temporary copies and times
each at ``TIMED_ROWS``, one after another on this card: the row tiles
of ``TILES`` (rows a block owns), each checked against plain first, and
the ``BREAKDOWN`` variants, which skip part of the work and so compute
nothing checkable.
"""

from __future__ import annotations

import asyncio
import contextlib
import gc
import json
import os
import shutil
import signal
import struct
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
# Kernel against plain: every score within TOL, and at most ROW_SHARE
# of the rows (pooled over a phase) off by more than ROW_TOL. The two
# take every layer's sum exactly (float64) and round alike, so their
# bf16 activations agree and their scores differ by float32 rounding in
# the error, tanh and the sigmoid (about 1e-7); a kernel that misplaces
# a rounding point, a bias or the float32 input of the error moves
# nearly every row.
TOL = 2e-3
ROW_TOL = 1e-5
ROW_SHARE = 0.01
KERNEL_ROWS = (1, 37, 256, 1000, 1024, 4096)
SERVE_ROWS = (1, 37, 1024, 4096)
IN_FLIGHT = 4           # concurrent 1024-row batches through the ring
TIMED_ROWS = (1, 37, 1024, 4096)
TIMING_REPS = 60
SERVICE_ROUNDS = 100
TRACED_ROUNDS = 30      # the same load again, under the profiler
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
TILES = (8, 16, 32, 64)    # rows a block owns, for --sweep


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def make_stats(rng: np.random.Generator, in_dim: int):
    """Normalization stats of a feature stream: mean and variance."""
    return ((rng.standard_normal(in_dim) * 0.5).astype(np.float32),
            rng.uniform(0.05, 4.0, in_dim).astype(np.float32))


def make_inputs(rng: np.random.Generator, n: int, mu, var):
    """Feature rows at raw scale drawn from the stream ``mu``/``var``
    describe, so their z-scores are about standard normal."""
    z = rng.standard_normal((n, len(mu)))
    return (mu + np.sqrt(var) * z).astype(np.float32)


def random_params(seed: int, cfg):
    """Host float32 weights from a seed: He-normal weights with biases
    drawn around zero, every bias distinct, and the decoder's output
    layer scaled down so the reconstruction error lies where tanh still
    has slope, as a trained model's does. Both halves of the blend then
    move the score."""
    from linkerd_tpu_torch.models.anomaly import init_params
    from linkerd_tpu_torch.models.convert import params_to_numpy

    rng = np.random.default_rng(seed)
    params = params_to_numpy(init_params(seed, cfg, "cpu"))
    for group in ("enc", "dec", "cls"):
        for layer in params[group]:
            layer["b"] = (rng.standard_normal(layer["b"].shape)
                          * 0.1).astype(np.float32)
    params["dec"][-1]["w"] *= np.float32(0.3)
    return params


def make_snapshot(cfg, seed: int):
    """A checkpoint of random weights and stats, made by the port."""
    from linkerd_tpu_torch.lifecycle.store import ModelSnapshot
    from linkerd_tpu_torch.telemetry.anomaly import zero_adam_leaves

    mu, var = make_stats(np.random.default_rng(seed), cfg.in_dim)
    return ModelSnapshot(
        params=random_params(seed, cfg), opt_leaves=zero_adam_leaves(cfg),
        mu=mu, var=var, norm_initialized=True, step=7, cfg=cfg)


class Agreement:
    """Scores against their plain reference over one phase: the largest
    difference, and the rows off by more than ROW_TOL."""

    def __init__(self, phase: str):
        self.phase, self.worst, self.rows, self.off = phase, 0.0, 0, 0

    def add(self, got: np.ndarray, ref: np.ndarray, what: str) -> float:
        if got.shape != ref.shape or not np.isfinite(got).all():
            raise AssertionError(f"{self.phase}: bad output for {what}")
        diff = np.abs(got - ref)
        worst = float(diff.max()) if diff.size else 0.0
        if worst > TOL:
            raise AssertionError(
                f"{self.phase}: {what} off by {worst} > {TOL}")
        self.worst = max(self.worst, worst)
        self.rows += diff.size
        self.off += int((diff > ROW_TOL).sum())
        return worst

    def close(self) -> None:
        share = self.off / max(self.rows, 1)
        print(f"{self.phase}: max|diff| {self.worst:.3e}, {self.off} of "
              f"{self.rows} rows off by more than {ROW_TOL:g} "
              f"(share {share:.4f})")
        if share > ROW_SHARE:
            raise AssertionError(
                f"{self.phase}: {share:.4f} of rows off by more than "
                f"{ROW_TOL:g}, limit {ROW_SHARE}")


def flops_per_row(params) -> int:
    return 2 * sum(int(layer["w"].numel()) for g in ("enc", "dec", "cls")
                   for layer in params[g])


def bound_ms(params, n: int, in_dim: int):
    """Least time for the kernel's work on this card: each input read
    once (x, bf16 weights, mu, var), each score written once, against
    the bf16 dense peak for the operations. ``params`` is the model at
    its own widths (``KernelParams.params``), never the padded buffer,
    whose zeros are no work of the function."""
    weight_bytes = sum(t.numel() * t.element_size()
                       for g in ("enc", "dec", "cls")
                       for layer in params[g] for t in layer.values())
    nbytes = n * in_dim * 4 + n * 4 + weight_bytes + 2 * in_dim * 4
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops_per_row(params) * n / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def device_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median device time of ``fn`` by CUDA events, every launch queued
    behind a device sleep so host enqueue time stays out of the reading."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(200_000_000)
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def copy_ms(rows: int, in_dim: int):
    """Device time of one batch's copies through pinned memory:
    features host-to-device and scores device-to-host."""
    import torch

    host_x = torch.empty((rows, in_dim), dtype=torch.float32, pin_memory=True)
    host_s = torch.empty(rows, dtype=torch.float32, pin_memory=True)
    dev_x = torch.empty((rows, in_dim), dtype=torch.float32, device="cuda")
    dev_s = torch.empty(rows, dtype=torch.float32, device="cuda")
    return (device_ms(lambda: dev_x.copy_(host_x, non_blocking=True)),
            device_ms(lambda: host_s.copy_(dev_s, non_blocking=True)))


def check_kernel(cfg, rng):
    """Kernel against plain on the card at the path's row counts, with
    and without the folded z-score; returns the largest difference and
    the timed phase's inputs."""
    import torch

    from linkerd_tpu_torch.models.convert import params_from_numpy
    from linkerd_tpu_torch.ops.scoring import (
        fused_anomaly_scores, fused_anomaly_scores_plain, pack_params,
    )

    params = params_from_numpy(random_params(0, cfg), "cuda")
    packed = pack_params(params, cfg)
    mu_h, var_h = make_stats(rng, cfg.in_dim)
    mu, var = torch.tensor(mu_h, device="cuda"), torch.tensor(var_h,
                                                              device="cuda")
    agree = Agreement("kernel vs plain")
    for n in KERNEL_ROWS:
        raw = make_inputs(rng, n, mu_h, var_h)
        for folded in (False, True):
            if folded:
                m, v, x = mu, var, torch.tensor(raw, device="cuda")
            else:  # rows already normalized
                m = v = None
                x = torch.tensor((raw - mu_h) / np.sqrt(var_h + 1e-2),
                                 dtype=torch.float32, device="cuda")
            got = fused_anomaly_scores(packed, x, cfg, m, v).cpu().numpy()
            ref = fused_anomaly_scores_plain(params, x, cfg, m,
                                             v).cpu().numpy()
            worst = agree.add(got, ref, f"n={n} mu/var={folded}")
            print(f"kernel vs plain n={n} mu/var={folded}: "
                  f"max|diff|={worst:.3e}")
    agree.close()
    return agree.worst, params, packed, mu, var


async def drive_service(cfg, rng):
    """The main path: ScorerService over InProcessScorer on cuda, fed
    wire payloads. Returns (batches scored, largest diff vs plain)."""
    import torch

    from linkerd_tpu_torch.lifecycle.store import encode_snapshot
    from linkerd_tpu_torch.models.convert import params_from_numpy
    from linkerd_tpu_torch.ops.scoring import fused_anomaly_scores_plain
    from linkerd_tpu_torch.telemetry.anomaly import InProcessScorer
    from linkerd_tpu_torch.telemetry.sidecar import (
        ScorerService, encode_matrix,
    )

    scorer = InProcessScorer(device="cuda")
    svc = ScorerService(scorer)
    snap = make_snapshot(scorer.cfg, seed=1)
    ref_params = params_from_numpy(snap.params, "cuda")
    mu = torch.tensor(snap.mu, device="cuda")
    var = torch.tensor(snap.var, device="cuda")
    agree = Agreement("served vs plain")

    def check(x: np.ndarray, reply: bytes) -> None:
        ref = fused_anomaly_scores_plain(
            ref_params, torch.tensor(x, device="cuda"), scorer.cfg,
            mu, var).cpu().numpy()
        agree.add(np.frombuffer(reply, np.float32), ref, f"{len(x)} rows")

    def inputs(n: int) -> np.ndarray:
        return make_inputs(rng, n, snap.mu, snap.var)

    batches = 0
    try:
        step = np.frombuffer(
            await svc.handle_restore(encode_snapshot(snap)), "<u8")[0]
        if step != snap.step:
            raise AssertionError(f"restore echoed step {step}")
        payloads = {n: inputs(n) for n in SERVE_ROWS}
        for n, x in payloads.items():
            check(x, await svc.handle_score(encode_matrix(x)))
            batches += 1
        xs = [inputs(1024) for _ in range(IN_FLIGHT)]
        replies = await asyncio.gather(
            *(svc.handle_score(encode_matrix(x)) for x in xs))
        batches += IN_FLIGHT
        for x, r in zip(xs, replies):
            check(x, r)
        # snapshot -> restore round trip leaves the scores unchanged
        x = payloads[1024]
        before = await svc.handle_score(encode_matrix(x))
        blob = await svc.handle_snapshot(b"")
        if blob != encode_snapshot(snap):
            raise AssertionError("snapshot bytes differ from the restored")
        await svc.handle_restore(blob)
        after = await svc.handle_score(encode_matrix(x))
        batches += 2
        if before != after:
            raise AssertionError("scores changed across snapshot/restore")
    finally:
        scorer.close()
    agree.close()
    return batches, agree.worst


def device_busy_ms(trace_path: Path):
    """Milliseconds in which the card ran a kernel or a copy, from a
    profiler trace: the union of its device events' intervals. None
    when the trace holds no device event."""
    events = json.loads(trace_path.read_text()).get("traceEvents", [])
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                   and "dur" in e)
    if not spans:
        return None
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + hi - lo, a, b
        else:
            hi = max(hi, b)
    return (busy + hi - lo) / 1e3


async def time_service(cfg, rng):
    """Rows/s at 1024-row batches, IN_FLIGHT at a time, and the
    per-batch p50/p99 of handle_score (decode, ring, kernel, reply);
    then the same load again under the profiler, for the card's busy
    time per batch and busy share in that window."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from linkerd_tpu_torch.lifecycle.store import encode_snapshot
    from linkerd_tpu_torch.telemetry.anomaly import InProcessScorer
    from linkerd_tpu_torch.telemetry.sidecar import (
        ScorerService, encode_matrix,
    )

    scorer = InProcessScorer(device="cuda")
    svc = ScorerService(scorer)
    snap = make_snapshot(scorer.cfg, 1)
    lat = []

    async def one(payload: bytes) -> None:
        t0 = time.perf_counter()
        await svc.handle_score(payload)
        lat.append(time.perf_counter() - t0)

    async def rounds(k: int) -> float:
        t0 = time.perf_counter()
        for _ in range(k):
            await asyncio.gather(*(one(p) for p in payloads))
        return time.perf_counter() - t0

    try:
        await svc.handle_restore(encode_snapshot(snap))
        payloads = [encode_matrix(make_inputs(rng, 1024, snap.mu, snap.var))
                    for _ in range(IN_FLIGHT)]
        await rounds(5)
        lat.clear()
        wall = await rounds(SERVICE_ROUNDS)
        ms = np.asarray(lat) * 1e3
        with tempfile.TemporaryDirectory() as tmp:
            trace = Path(tmp) / "service.json"
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                traced_wall = await rounds(TRACED_ROUNDS)
            torch.cuda.synchronize()
            prof.export_chrome_trace(str(trace))
            busy = device_busy_ms(trace)
    finally:
        scorer.close()
    traced_batches = TRACED_ROUNDS * IN_FLIGHT
    return {"rows_per_s": SERVICE_ROUNDS * IN_FLIGHT * 1024 / wall,
            "batch_rows": 1024, "in_flight": IN_FLIGHT,
            "batches": SERVICE_ROUNDS * IN_FLIGHT,
            "batch_p50_ms": float(np.percentile(ms, 50)),
            "batch_p99_ms": float(np.percentile(ms, 99)),
            "traced_batches": traced_batches,
            "traced_rows_per_s": traced_batches * 1024 / traced_wall,
            "device_ms_per_batch": (None if busy is None
                                    else busy / traced_batches),
            "device_busy_share": (None if busy is None
                                  else busy / (traced_wall * 1e3))}


# -- train phase: online training and the model lifecycle -----------------
# (a) the same fit calls on the card and on the CPU; (b) Score batches in
# flight while fits run; (c) promotion, a poisoned fit and its rollback
# through ModelLifecycleManager; (d) times. All through ScorerService's
# wire bytes, as a router's Fit/Score/Snapshot/Restore calls arrive.
FIT_ROWS = 1024
FIT_CALLS = 3           # fit calls held against the same calls on the CPU
FIT_LOSS_REL = 1e-3     # a fit call's loss, card against CPU
MODEL_TOL = 3e-3        # card- against CPU-fitted model from one state
PARITY_SEEDS = (2, 3, 4, 5)  # snapshots and fit streams of phase (a)
DURING_FITS = 6         # fit calls while Score batches run
REPLAY_ROWS = 4096      # the lifecycle's held-out window
GOOD_FITS, POISON_FITS = 3, 12
FIT_TIMINGS = 30        # timed fit calls (after three untimed)
PROFILED_FITS = 10
CYCLE_TIMINGS = 5       # timed gated cycles
FIT_EVERY = 8           # batches per fit: the reference's trainEveryBatches
LOAD_ROUNDS = 50        # rounds of IN_FLIGHT batches, per run of a mode


def labeled_rows(rng: np.random.Generator, n: int, mu, var,
                 share: float = 0.25):
    """Rows of the stream ``mu``/``var`` describe, ``share`` of them
    anomalous (six features shifted by three of the stream's sigmas),
    about half of them labeled."""
    labels = (rng.random(n) < share).astype(np.float32)
    x = make_inputs(rng, n, mu, var)
    x[:, :6] += (3.0 * np.sqrt(var[:6]) * labels[:, None]).astype(np.float32)
    mask = (rng.random(n) < 0.5).astype(np.float32)
    return x, labels, mask


async def counted(aw):
    """Awaits ``aw`` with the kernel's launch count set to 0 just before;
    returns its result and the count just after."""
    from linkerd_tpu_torch.ops.scoring import fused_anomaly_scores

    fused_anomaly_scores.launches = 0
    out = await aw
    return out, fused_anomaly_scores.launches


def plain_scores(snap, x: np.ndarray, dev: str) -> np.ndarray:
    """A snapshot's scores for raw rows by the plain version on ``dev``."""
    import torch

    from linkerd_tpu_torch.models.convert import params_from_numpy
    from linkerd_tpu_torch.ops.scoring import fused_anomaly_scores_plain

    return fused_anomaly_scores_plain(
        params_from_numpy(snap.params, dev), torch.tensor(x, device=dev),
        snap.cfg, torch.tensor(snap.mu, device=dev),
        torch.tensor(snap.var, device=dev)).cpu().numpy()


def max_param_diff(a, b) -> float:
    return max(float(np.abs(la[k] - lb[k]).max())
               for g in ("enc", "dec", "cls")
               for la, lb in zip(a[g], b[g]) for k in ("w", "b"))


def record_publications(scorer) -> list:
    """Every serving tuple ``scorer`` publishes from now on, after the
    current one: its class gains a ``__setattr__`` that notes each
    assignment of ``_dev``."""
    published = [scorer._dev]

    class Recording(type(scorer)):
        def __setattr__(self, name, value):
            if name == "_dev":
                published.append(value)
            object.__setattr__(self, name, value)

    scorer.__class__ = Recording
    return published


def f32(reply: bytes) -> float:
    return float(np.frombuffer(reply, np.float32)[0])


async def train_parity(cfg, seed: int, dev: str = "cuda"):
    """(a) for one seed: a snapshot restored on the card, then FIT_CALLS
    Fit payloads. Before each call a CPU scorer restores the card's
    snapshot, so both fit the payload from one state: the losses agree
    within FIT_LOSS_REL, and the fitted models' scores within MODEL_TOL
    on every row. Then the card's served scores lie within the Agreement
    bounds of its own plain version on its fitted weights.

    Two more CPU scorers take the same calls from the snapshot and are
    never resynced; their readings have no bound. After the last call,
    the card's model against the first of them is the drift over all
    FIT_CALLS x fit_steps steps, and the first against the second, which
    fits the same rows in a permuted order, is the drift that summation
    order alone makes on one device."""
    from linkerd_tpu_torch.lifecycle.store import encode_snapshot
    from linkerd_tpu_torch.telemetry.anomaly import InProcessScorer
    from linkerd_tpu_torch.telemetry.sidecar import (
        ScorerService, encode_fit, encode_matrix,
    )

    rng = np.random.default_rng(seed)
    snap = make_snapshot(cfg, seed=seed)
    scorers = [InProcessScorer(device=dev)] + [
        InProcessScorer(device="cpu") for _ in range(3)]
    card_svc, cpu_svc, free_svc, perm_svc = (ScorerService(s)
                                              for s in scorers)
    x = make_inputs(rng, FIT_ROWS, snap.mu, snap.var)
    losses, model_diffs = [], []

    async def fit_both(payload: bytes):
        # the card's calls are this phase's main path, counted
        state, n0 = await counted(card_svc.handle_snapshot(b""))
        await cpu_svc.handle_restore(state)
        card, n1 = await counted(card_svc.handle_fit(payload))
        host = f32(await cpu_svc.handle_fit(payload))
        card = f32(card)
        if not abs(card - host) <= FIT_LOSS_REL * abs(host):
            raise AssertionError(
                f"seed {seed}: fit loss on the card {card} against {host} "
                f"on the CPU, limit {FIT_LOSS_REL} relative")
        fitted = [s.snapshot() for s in scorers[:2]]
        diff = float(np.abs(plain_scores(fitted[0], x, dev)
                            - plain_scores(fitted[1], x, dev)).max())
        if diff > MODEL_TOL:
            raise AssertionError(
                f"seed {seed}: card-fitted model off the CPU-fitted one "
                f"by {diff} > {MODEL_TOL} after one call from one state")
        losses.append([card, host])
        model_diffs.append(diff)
        return n0 + n1

    try:
        launches = (await counted(
            card_svc.handle_restore(encode_snapshot(snap))))[1]
        for svc in (free_svc, perm_svc):
            await svc.handle_restore(encode_snapshot(snap))
        for _ in range(FIT_CALLS):
            rows = labeled_rows(rng, FIT_ROWS, snap.mu, snap.var)
            launches += await fit_both(encode_fit(*rows))
            await free_svc.handle_fit(encode_fit(*rows))
            order = rng.permutation(FIT_ROWS)
            await perm_svc.handle_fit(encode_fit(*(r[order] for r in rows)))
        reply, n = await counted(card_svc.handle_score(encode_matrix(x)))
        launches += n
        served = np.frombuffer(reply, np.float32)
        card, free, perm = (s.snapshot() for s in (scorers[0], *scorers[2:]))
    finally:
        for s in scorers:
            s.close()
    agree = Agreement(f"fitted, seed {seed}: served vs plain")
    plain = plain_scores(card, x, dev)
    agree.add(served, plain, f"{FIT_ROWS} rows")
    agree.close()
    free_scores = plain_scores(free, x, dev)
    drift = float(np.abs(plain - free_scores).max())
    order_drift = float(np.abs(free_scores
                               - plain_scores(perm, x, dev)).max())
    print(f"fit parity, seed {seed}: losses card/CPU {losses}; card- vs "
          f"CPU-fitted model from one state, max|diff| each call "
          f"{[f'{d:.3e}' for d in model_diffs]}; fitted served vs plain "
          f"max|diff| {agree.worst:.3e}; after "
          f"{FIT_CALLS * scorers[0].fit_steps} steps apart, card vs CPU "
          f"{drift:.3e}, CPU vs CPU on permuted rows {order_drift:.3e}")
    return {"seed": seed, "launches": launches, "losses_card_cpu": losses,
            "loss_rel_max": max(abs(c - h) / abs(h) for c, h in losses),
            "served_vs_plain_max": agree.worst,
            "card_vs_cpu_model_by_call": model_diffs,
            "card_vs_cpu_model_max": max(model_diffs),
            "apart_card_vs_cpu": drift,
            "apart_cpu_vs_cpu_permuted": order_drift,
            "apart_param_max": max_param_diff(card.params, free.params),
            "step": card.step}


async def fit_parity(cfg, dev: str = "cuda"):
    """(a) over every seed of PARITY_SEEDS."""
    runs = [await train_parity(cfg, seed, dev) for seed in PARITY_SEEDS]
    return {"launches": sum(r["launches"] for r in runs),
            "card_vs_cpu_model_max": max(r["card_vs_cpu_model_max"]
                                         for r in runs),
            "by_seed": runs}


async def score_during_fit(cfg, rng, dev: str = "cuda"):
    """(b) IN_FLIGHT 1024-row Score batches at a time while DURING_FITS
    Fit calls run: each batch launches the kernel once, and each batch's
    scores equal, bit for bit, the kernel's for those rows under one of
    the serving tuples the scorer published."""
    import torch

    from linkerd_tpu_torch.lifecycle.store import encode_snapshot
    from linkerd_tpu_torch.ops.scoring import fused_anomaly_scores
    from linkerd_tpu_torch.telemetry.anomaly import InProcessScorer
    from linkerd_tpu_torch.telemetry.sidecar import (
        ScorerService, encode_fit, encode_matrix,
    )

    snap = make_snapshot(cfg, seed=3)
    scorer = InProcessScorer(device=dev)
    svc = ScorerService(scorer)
    fits = [encode_fit(*labeled_rows(rng, FIT_ROWS, snap.mu, snap.var))
            for _ in range(DURING_FITS)]
    xs = [make_inputs(rng, FIT_ROWS, snap.mu, snap.var)
          for _ in range(IN_FLIGHT)]
    payloads = [encode_matrix(x) for x in xs]
    served = []
    try:
        await svc.handle_restore(encode_snapshot(snap))
        published = record_publications(scorer)
        done = asyncio.Event()

        async def fitting():
            for p in fits:
                await svc.handle_fit(p)
            done.set()

        async def load():
            while not done.is_set():
                replies = await asyncio.gather(
                    *(svc.handle_score(p) for p in payloads))
                served.extend(enumerate(replies))

        _, launches = await counted(asyncio.gather(fitting(), load()))
    finally:
        scorer.close()
    if launches != len(served):
        raise AssertionError(f"{len(served)} batches during fits but the "
                             f"kernel launched {launches}")
    if len(published) != 1 + 2 * DURING_FITS:
        raise AssertionError(f"{len(published)} tuples published for "
                             f"{DURING_FITS} fits")
    # every published tuple's scores for each batch's rows (launches made
    # to compare, after the phase's count was read)
    under = [[fused_anomaly_scores(kp, torch.tensor(x, device=dev),
                                   scorer.cfg, mu, var).cpu().numpy()
              .tobytes() for x in xs] for kp, mu, var in published]
    seen = set()
    for i, reply in served:
        match = [t for t, by_x in enumerate(under) if by_x[i] == reply]
        if not match:
            raise AssertionError("a batch scored under no published "
                                 "serving tuple (torn params/mu/var)")
        seen.add(match[0])
    print(f"score during fit: {len(served)} batches, {launches} launches, "
          f"{len(published)} tuples published, batches scored under "
          f"{len(seen)} of them, none torn")
    return {"batches": len(served), "launches": launches,
            "tuples_published": len(published), "tuples_seen": len(seen)}


async def lifecycle_phase(cfg, rng, dev: str = "cuda"):
    """(c) ModelLifecycleManager over a CheckpointStore in a temporary
    directory: bootstrap promotion, a good fit promoted, a poisoned fit
    (POISON_FITS calls on flipped labels) rolled back. After the
    rollback Score returns the bytes it returned after the promotion,
    and each gated cycle launches the kernel exactly twice (candidate
    and serving evaluate_snapshot)."""
    from linkerd_tpu_torch.lifecycle import LifecycleConfig
    from linkerd_tpu_torch.lifecycle.store import encode_snapshot
    from linkerd_tpu_torch.telemetry.anomaly import InProcessScorer
    from linkerd_tpu_torch.telemetry.sidecar import (
        ScorerService, encode_fit, encode_matrix,
    )

    snap = make_snapshot(cfg, seed=4)
    scorer = InProcessScorer(device=dev)
    svc = ScorerService(scorer)
    x = encode_matrix(make_inputs(rng, FIT_ROWS, snap.mu, snap.var))
    gated, launches = [], 0

    async def step(aw):
        # every call of the phase's main path is a counted window
        nonlocal launches
        out, n = await counted(aw)
        launches += n
        return out

    async def cycle(mgr, want: str):
        nonlocal launches
        out, n = await counted(mgr.run_cycle(scorer))
        launches += n
        if out["action"] != want:
            raise AssertionError(f"lifecycle: {want} expected, got {out}")
        gated.append(n)
        if n != 2:
            raise AssertionError(f"a gated cycle launched the kernel {n} "
                                 f"times, not 2")
        return out

    try:
        with tempfile.TemporaryDirectory() as tmp:
            mgr = LifecycleConfig(directory=tmp, minReplayRows=REPLAY_ROWS
                                  ).mk_manager(device=dev)
            for _ in range(REPLAY_ROWS // FIT_ROWS):
                mgr.replay.add_batch(*labeled_rows(rng, FIT_ROWS, snap.mu,
                                                   snap.var))
            await step(svc.handle_restore(encode_snapshot(snap)))
            first = await step(mgr.run_cycle(scorer))
            if first["action"] != "promoted":
                raise AssertionError(f"bootstrap not promoted: {first}")
            for _ in range(GOOD_FITS):
                await step(svc.handle_fit(encode_fit(*labeled_rows(
                    rng, FIT_ROWS, snap.mu, snap.var))))
            good = await cycle(mgr, "promoted")
            promoted = await step(svc.handle_score(x))
            for _ in range(POISON_FITS):
                xp, labels, mask = labeled_rows(rng, FIT_ROWS, snap.mu,
                                                snap.var)
                await step(svc.handle_fit(encode_fit(xp, 1.0 - labels,
                                                     mask)))
            if await step(svc.handle_score(x)) == promoted:
                raise AssertionError("the poisoned fits left the scores")
            bad = await cycle(mgr, "rolled_back")
            if await step(svc.handle_score(x)) != promoted:
                raise AssertionError("scores after the rollback differ from "
                                     "those after the promotion")
            status = mgr.status()
    finally:
        scorer.close()
    reasons = [c["decision"]["reason"] for c in (good, bad)]
    print(f"lifecycle: bootstrap promoted, good fit promoted "
          f"({reasons[0]}), poisoned fit rolled back ({reasons[1]}); "
          f"scores after the rollback equal those after the promotion; "
          f"kernel launches per gated cycle {gated}")
    return {"launches": launches,
            "actions": ["promoted", good["action"], bad["action"]],
            "reasons": reasons, "launches_per_gated_cycle": gated,
            "versions": [(v["version"], v["status"])
                         for v in status["store"]["versions"]]}


def spread(ms) -> dict:
    ms = np.asarray(ms)
    return {"n": int(ms.size), "p50_ms": float(np.median(ms)),
            "min_ms": float(ms.min()), "max_ms": float(ms.max()),
            "p10_ms": float(np.percentile(ms, 10)),
            "p90_ms": float(np.percentile(ms, 90))}


def device_breakdown(trace_path: Path) -> dict:
    """Device milliseconds by kind of work in a profiler trace: matrix
    products, Adam's fused updates, copies each way, other kernels; and
    the count of kernels."""
    events = json.loads(trace_path.read_text()).get("traceEvents", [])
    out = {"gemm": 0.0, "adam": 0.0, "h2d": 0.0, "d2h": 0.0, "other": 0.0,
           "kernels": 0}
    for e in events:
        if "dur" not in e or e.get("cat") not in ("kernel", "gpu_memcpy",
                                                   "gpu_memset"):
            continue
        name = e.get("name", "").lower()
        out["kernels"] += e["cat"] == "kernel"
        if e["cat"] == "gpu_memcpy":
            key = "h2d" if "htod" in name else "d2h" if "dtoh" in name \
                else "other"
        elif "gemm" in name or "gemv" in name:
            key = "gemm"
        elif "multi_tensor" in name or "adam" in name:
            key = "adam"
        else:
            key = "other"
        out[key] += e["dur"] / 1e3
    return out


def fit_layers(scorer, x, labels, mask, dev: str, reps: int = 10):
    """Host ms, each ended by a device sync, of the layers of one Fit
    call, run one at a time as ``InProcessScorer._fit`` runs them: the
    stats update, the batch's H2D copy and z-score, one step's forward
    and backward, one Adam update, the pack of the fitted model for the
    kernel, and the loss readback. Medians of ``reps``."""
    import torch

    from linkerd_tpu_torch.models.anomaly import loss_fn, normalize_features

    def timed(fn):
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            if dev != "cpu":
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ms))

    def batch():
        return (normalize_features(torch.tensor(x, device=dev),
                                   torch.tensor(scorer._mu, device=dev),
                                   torch.tensor(scorer._var, device=dev)),
                torch.tensor(labels, device=dev),
                torch.tensor(mask, device=dev))

    loss = []

    def forward_backward():
        scorer._opt.zero_grad()
        loss[:] = [loss_fn(scorer._masters, xn, y, m, scorer.cfg)]
        loss[0].backward()

    with scorer._lock, scorer._train_context():
        out = {"stats_update": timed(
            lambda: scorer._update_norm(x, labels, mask))}
        out["h2d_zscore"] = timed(batch)
        xn, y, m = batch()
        out["forward_backward"] = timed(forward_backward)
        out["adam"] = timed(scorer._opt.step)
        out["pack"] = timed(scorer._pack)
        out["loss_readback"] = timed(lambda: float(loss[0].detach()))
    return out


async def time_training(cfg, rng, dev: str = "cuda"):
    """(d) One Fit call at FIT_ROWS rows x fit_steps (median of
    FIT_TIMINGS, with the spread), the card's share of a fit under the
    profiler, one gated cycle on a REPLAY_ROWS window, and the Score
    p50/p99 at 1024 rows x IN_FLIGHT with a fit every FIT_EVERY batches
    and with none (in turns: none, fit, fit, none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from linkerd_tpu_torch.lifecycle import LifecycleConfig
    from linkerd_tpu_torch.lifecycle.store import encode_snapshot
    from linkerd_tpu_torch.telemetry.anomaly import InProcessScorer
    from linkerd_tpu_torch.telemetry.sidecar import (
        ScorerService, encode_fit, encode_matrix,
    )

    snap = make_snapshot(cfg, seed=5)
    scorer = InProcessScorer(device=dev)
    svc = ScorerService(scorer)
    fits = [encode_fit(*labeled_rows(rng, FIT_ROWS, snap.mu, snap.var))
            for _ in range(4)]
    payloads = [encode_matrix(make_inputs(rng, FIT_ROWS, snap.mu, snap.var))
                for _ in range(IN_FLIGHT)]
    out = {"fit_rows": FIT_ROWS, "fit_steps": scorer.fit_steps}

    def sync():
        if dev != "cpu":
            torch.cuda.synchronize()

    try:
        await svc.handle_restore(encode_snapshot(snap))
        for p in fits[:3]:
            await svc.handle_fit(p)
        sync()
        fit_ms = []
        for i in range(FIT_TIMINGS):
            t0 = time.perf_counter()
            await svc.handle_fit(fits[i % len(fits)])
            sync()
            fit_ms.append((time.perf_counter() - t0) * 1e3)
        out["fit"] = spread(fit_ms)
        out["fit_layers_ms"] = fit_layers(
            scorer, *labeled_rows(rng, FIT_ROWS, snap.mu, snap.var), dev)
        with tempfile.TemporaryDirectory() as tmp:
            trace = Path(tmp) / "fit.json"
            activity = (ProfilerActivity.CPU if dev == "cpu"
                        else ProfilerActivity.CUDA)
            with profile(activities=[activity]) as prof:
                t0 = time.perf_counter()
                for i in range(PROFILED_FITS):
                    await svc.handle_fit(fits[i % len(fits)])
                sync()
                wall = (time.perf_counter() - t0) * 1e3
            prof.export_chrome_trace(str(trace))
            busy = device_busy_ms(trace)
            kinds = device_breakdown(trace)
        out["fit_profiled"] = {
            "fits": PROFILED_FITS, "wall_ms_per_fit": wall / PROFILED_FITS,
            "device_ms_per_fit": (None if busy is None
                                  else busy / PROFILED_FITS),
            "device_share": None if busy is None else busy / wall,
            "kernels_per_fit": kinds.pop("kernels") / PROFILED_FITS,
            "device_ms_per_fit_by_kind": {
                k: v / PROFILED_FITS for k, v in kinds.items()}}

        with tempfile.TemporaryDirectory() as tmp:
            mgr = LifecycleConfig(directory=tmp, minReplayRows=REPLAY_ROWS
                                  ).mk_manager(device=dev)
            for _ in range(REPLAY_ROWS // FIT_ROWS):
                mgr.replay.add_batch(*labeled_rows(rng, FIT_ROWS, snap.mu,
                                                   snap.var))
            await mgr.run_cycle(scorer)  # bootstrap
            cycle_ms, actions = [], []
            for i in range(CYCLE_TIMINGS):
                await svc.handle_fit(fits[i % len(fits)])
                sync()
                t0 = time.perf_counter()
                actions.append((await mgr.run_cycle(scorer))["action"])
                cycle_ms.append((time.perf_counter() - t0) * 1e3)
        out["gated_cycle"] = dict(spread(cycle_ms), replay_rows=REPLAY_ROWS,
                                  actions=actions)

        async def load(with_fits: bool):
            lat, fit_task, batches = [], None, 0

            async def one(p):
                t0 = time.perf_counter()
                await svc.handle_score(p)
                lat.append((time.perf_counter() - t0) * 1e3)

            for r in range(LOAD_ROUNDS):
                if with_fits and batches % FIT_EVERY == 0 and (
                        fit_task is None or fit_task.done()):
                    if fit_task is not None:
                        fit_task.result()
                    fit_task = asyncio.ensure_future(
                        svc.handle_fit(fits[r % len(fits)]))
                await asyncio.gather(*(one(p) for p in payloads))
                batches += len(payloads)
            if fit_task is not None:
                await fit_task
            return lat

        await load(False)  # warm
        lat = {"none": [], "fit_every_8": []}
        for mode in ("none", "fit_every_8", "fit_every_8", "none"):
            lat[mode] += await load(mode != "none")
        out["score_under_fit"] = {
            mode: {"batches": len(v),
                   "p50_ms": float(np.percentile(v, 50)),
                   "p99_ms": float(np.percentile(v, 99))}
            for mode, v in lat.items()}
    finally:
        scorer.close()
    f, fp, c = out["fit"], out["fit_profiled"], out["gated_cycle"]
    print(f"fit {FIT_ROWS} rows x {scorer.fit_steps} steps: p50 "
          f"{f['p50_ms']:.3f} ms (min {f['min_ms']:.3f}, max "
          f"{f['max_ms']:.3f}, n {f['n']})")
    print("fit layers, host ms each (ended by a sync): " + ", ".join(
        f"{k} {v:.3f}" for k, v in out["fit_layers_ms"].items()))
    if fp["device_share"] is None:
        print("fit under the profiler: not measured (no device event)")
    else:
        print(f"fit under the profiler: card busy "
              f"{fp['device_ms_per_fit']:.4f} ms of "
              f"{fp['wall_ms_per_fit']:.3f} ms a fit (share "
              f"{fp['device_share']:.3f}), {fp['kernels_per_fit']:.0f} "
              f"kernels a fit; by kind "
              + ", ".join(f"{k} {v:.4f}" for k, v in
                          fp["device_ms_per_fit_by_kind"].items()))
    print(f"gated cycle on {REPLAY_ROWS} rows: p50 {c['p50_ms']:.3f} ms "
          f"(min {c['min_ms']:.3f}, max {c['max_ms']:.3f}) {c['actions']}")
    for mode, v in out["score_under_fit"].items():
        print(f"score 1024 rows x{IN_FLIGHT}, {mode}: p50 "
              f"{v['p50_ms']:.3f} ms, p99 {v['p99_ms']:.3f} ms "
              f"({v['batches']} batches)")
    return out


async def train_phase(cfg, rng, dev: str = "cuda"):
    """(a)-(d) in order; returns their results and the kernel's launches
    on the path of each of (a)-(c), launches made only to compare left
    out. Each must launch the kernel."""
    res = {"fit_parity": await fit_parity(cfg, dev),
           "score_during_fit": await score_during_fit(cfg, rng, dev),
           "lifecycle": await lifecycle_phase(cfg, rng, dev)}
    launches = {k: r["launches"] for k, r in res.items()}
    for name, n in launches.items():
        if dev != "cpu" and not n:
            raise AssertionError(f"{name}: the kernel was never launched")
    res["times"] = await time_training(cfg, rng, dev)
    return res, launches


# -- distill phase: drift-triggered specialist heads ----------------------
# The reference's DistillConfig() defaults at full width: a teacher
# InProcessScorer trained by TEACHER_FITS fits; N_ROUTES routes scored
# through it in batches of N_ROUTES x ROUTE_ROWS rows; every route's rows
# shift after its anchor; run_once until the bank holds maxHeads heads,
# the POISON_CYCLE-th candidate poisoned with NaN; one rollback.
N_ROUTES = 34
ROUTE_ROWS = 30          # rows a route in each scored batch (1020 a batch)
ANCHOR_BATCHES = 3       # unshifted: each route anchors at 90 rows
SHIFTED_BATCHES = 30     # shifted after the anchor; replay keeps 512 rows
TEACHER_FITS = 20
ROUTE_ANOMALIES = 0.1    # share of a route's rows that are anomalous
POISON_CYCLE = 16        # retrain cycle whose candidate is poisoned
PARITY_STEPS = 4         # (c): card against CPU, bounded by MODEL_TOL
DISTILL_LAYER_REPS = 10


def route_names(n: int = N_ROUTES):
    return [f"/svc/route-{i:02d}" for i in range(n)]


async def distill_inputs(cfg, seed: int, dev: str):
    """The teacher, trained by TEACHER_FITS fit calls on labeled rows of
    a seeded stream, and the scored batches' inputs: per batch the rows
    of every route (ROUTE_ROWS each, in route order), labels and mask
    (every row labeled, ROUTE_ANOMALIES of them anomalous, so that each
    held-out window has enough of both for a steady AUC). After
    ANCHOR_BATCHES each route's rows move by its own shift, at
    least two of the stream's sigmas on 12 of the 30 features the
    anomalies leave alone, growing with the route's index."""
    from linkerd_tpu_torch.telemetry.anomaly import InProcessScorer

    rng = np.random.default_rng(seed)
    mu, var = make_stats(rng, cfg.in_dim)
    teacher = InProcessScorer(seed=seed, learning_rate=5e-3,
                              recon_weight=cfg.recon_weight, device=dev)
    try:
        for _ in range(TEACHER_FITS):
            await teacher.fit(*labeled_rows(rng, FIT_ROWS, mu, var))
    except BaseException:
        teacher.close()
        raise
    shifts = np.zeros((N_ROUTES, cfg.in_dim), np.float32)
    for r in range(N_ROUTES):
        cols = 6 + rng.choice(cfg.in_dim - 6, 12, replace=False)
        size = 2.0 + 2.0 * r / N_ROUTES
        shifts[r, cols] = size * np.sqrt(var[cols]) * rng.choice([-1, 1], 12)
    batches = []
    for b in range(ANCHOR_BATCHES + SHIFTED_BATCHES):
        x, labels, mask = labeled_rows(rng, N_ROUTES * ROUTE_ROWS, mu, var,
                                       ROUTE_ANOMALIES)
        mask[:] = 1.0
        if b >= ANCHOR_BATCHES:
            x += np.repeat(shifts, ROUTE_ROWS, axis=0)
        batches.append((x, labels, mask))
    return teacher, batches


class Stopwatch:
    """Wall ms of named calls, each wrapped in place (a module's
    function or an object's method) for the life of the stopwatch."""

    def __init__(self):
        self.ms, self._undo = {}, []

    def wrap(self, owner, attr: str, name: str) -> None:
        fn = getattr(owner, attr)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.ms[name] = (self.ms.get(name, 0.0)
                                 + (time.perf_counter() - t0) * 1e3)

        in_dict = attr in vars(owner)
        setattr(owner, attr, timed)
        self._undo.append((owner, attr, fn if in_dict else None))

    def take(self) -> dict:
        out, self.ms = self.ms, {}
        return out

    def close(self) -> None:
        for owner, attr, fn in reversed(self._undo):
            if fn is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, fn)
        self._undo.clear()


def poison(real):
    """``distill_head`` whose fitted candidate has NaN in its first
    encoder weights, as the reference's poisoned-candidate test makes
    it."""
    def poisoned(*args, **kwargs):
        bad = real(*args, **kwargs)
        bad.params["enc"][0]["w"] = np.full_like(bad.params["enc"][0]["w"],
                                                 np.nan)
        return bad
    return poisoned


def gate_margins(decision: dict, tol_loss: float, tol_auc: float) -> dict:
    """How far a decision sat from the gate's two edges: the loss room
    (serving x (1 + tol) - candidate, relative to serving) and the AUC
    room (candidate - serving + tol)."""
    c, s = decision["candidate"], decision["serving"]
    out = {"loss": (s["loss"] * (1 + tol_loss) - c["loss"]) / s["loss"]}
    if c["auc"] is not None and s["auc"] is not None:
        out["auc"] = c["auc"] - s["auc"] + tol_auc
    return out


async def distill_scenario(cfg, seed: int, dev: str = "cuda"):
    """The distill phase's main path and checks (a), (b), (d), (e), the
    poisoned rejection, the full-bank skip and the rollback; returns the
    results, with each cycle's wall ms split by part."""
    import torch

    from linkerd_tpu_torch.distill import DistillConfig
    from linkerd_tpu_torch.distill import pipeline as pipeline_mod
    from linkerd_tpu_torch.lifecycle.export import blob_meta, route_hash
    from linkerd_tpu_torch.lifecycle.store import CheckpointStore
    from linkerd_tpu_torch.models.convert import params_from_numpy
    from linkerd_tpu_torch.ops.scoring import (
        fused_anomaly_scores, fused_anomaly_scores_plain,
    )

    teacher, batches = await distill_inputs(cfg, seed, dev)
    routes = route_names()
    dsts = [d for d in routes for _ in range(ROUTE_ROWS)]
    dcfg = DistillConfig()
    launches, cycles, published = 0, [], []
    watch = Stopwatch()

    async def step(aw):
        nonlocal launches
        out, n = await counted(aw)
        launches += n
        return out

    def publisher(full, delta):
        t0 = time.perf_counter()
        published.append((full, delta))
        watch.ms["publish"] = (time.perf_counter() - t0) * 1e3
        return True

    try:
        with tempfile.TemporaryDirectory() as tmp:
            store = CheckpointStore(tmp)
            pipe = dcfg.mk(None, store=store, device=dev)
            pipe.set_publisher(publisher)
            for x, labels, mask in batches:
                scores = await step(teacher.score(x))
                pipe.observe_batch(dsts, x, scores, labels, mask)
            triggered = pipe.monitor.triggered()
            if sorted(triggered) != routes:
                raise AssertionError(
                    f"distill: {len(triggered)} of {N_ROUTES} routes "
                    f"triggered: {pipe.monitor.snapshot()}")
            watch.wrap(teacher, "snapshot", "snapshot")
            watch.wrap(pipeline_mod, "distill_head", "distill_head")
            watch.wrap(pipeline_mod, "evaluate_snapshot", "evaluations")
            watch.wrap(pipeline_mod, "export_delta_blob", "delta_export")
            watch.wrap(pipe.bank, "export_full", "full_export")
            watch.wrap(store, "record_specialist", "lineage")
            poisoned_route = None
            while len(pipe.bank) < dcfg.maxHeads:
                if len(cycles) > N_ROUTES:
                    raise AssertionError("distill: the bank did not fill")
                before = (len(published), pipe.bank.generation,
                          store.specialists())
                real = pipeline_mod.distill_head
                if len(cycles) == POISON_CYCLE:
                    pipeline_mod.distill_head = poison(real)
                try:
                    t0 = time.perf_counter()
                    out, n = await counted(pipe.run_once(teacher))
                    wall = (time.perf_counter() - t0) * 1e3
                finally:
                    pipeline_mod.distill_head = real
                launches += n
                if out is None:
                    raise AssertionError(
                        f"distill: nothing pending with {len(pipe.bank)} "
                        f"heads")
                if n != (0 if dev == "cpu" else 2):  # (a)
                    raise AssertionError(f"distill: a retrain cycle "
                                         f"launched the kernel {n} times")
                parts = watch.take()
                cycles.append(dict(
                    action=out["action"], route=out["route"], ms=wall,
                    launches=n,
                    parts=parts, margins=gate_margins(
                        out["decision"], dcfg.lossTolerance,
                        dcfg.aucTolerance)))
                if len(cycles) - 1 == POISON_CYCLE:
                    poisoned_route = out["route"]
                    if out["action"] != "rejected" or "not finite" not in \
                            out["decision"]["reason"]:
                        raise AssertionError(
                            f"distill: poisoned candidate not rejected: "
                            f"{out['decision']['reason']}")
                    if (len(published), pipe.bank.generation,
                            store.specialists()) != before:
                        raise AssertionError("distill: something was "
                                             "published for the poison")
                elif out["action"] != "promoted":
                    raise AssertionError(
                        f"distill: {out['route']} {out['action']}: "
                        f"{out['decision']['reason']}")
            left = [d for d in pipe.monitor.triggered()
                    if pipe.bank.head_for(d) is None and d != poisoned_route]
            if len(left) != 1 or pipe.pending_route() is not None \
                    or pipe.replay.rows(left[0]) < dcfg.minRouteRows:
                raise AssertionError(
                    f"distill: with the bank full, {left} left and "
                    f"pending {pipe.pending_route()}")
            watch.close()

            # (b) every head's kernel scores on its held-out rows against
            # plain, with the head's own mu/var (launches to compare)
            agree = Agreement("distill heads: kernel vs plain")
            for info in pipe.bank.heads.values():
                x, _, _ = pipe.replay.sample(info.dst)
                x_ho = torch.tensor(x[np.arange(len(x)) % 4 == 0],
                                    device=dev)
                head = info.snapshot
                params = params_from_numpy(head.params, dev)
                m = torch.tensor(head.mu, device=dev)
                v = torch.tensor(head.var, device=dev)
                got = fused_anomaly_scores(params, x_ho, head.cfg, m, v)
                ref = fused_anomaly_scores_plain(params, x_ho, head.cfg, m, v)
                agree.add(got.cpu().numpy(), ref.cpu().numpy(), info.dst)
            agree.close()

            sizes, export_ms = {}, {}
            base = pipe._base_snap
            for quant in ("f32", "int8", "int4"):
                t0 = time.perf_counter()
                blob = pipe.bank.export_full(base, pipe.bank.base_version,
                                             pipe.bank.generation, quant)
                export_ms[quant] = (time.perf_counter() - t0) * 1e3
                sizes[quant] = len(blob)
            heads_full = len(pipe.bank)
            victim = cycles[0]["route"]
            if not await step(pipe.rollback_route(victim)):
                raise AssertionError("distill: rollback found no head")

            # (d) fences and generations, publish by publish
            heads = 0
            for i, (full, delta) in enumerate(published):
                dm, fm = blob_meta(delta), blob_meta(full)
                op, rh = struct.unpack_from("<II", delta, 20)
                heads += 1 if op == 0 else -1
                if (dm["format"], dm["base_generation"], dm["new_generation"],
                        dm["ops"]) != ("delta", i, i + 1, 1):
                    raise AssertionError(f"distill: delta {i} meta {dm}")
                if (fm["format"], fm["generation"], fm["heads"]) != (
                        "bank", i + 1, heads):
                    raise AssertionError(f"distill: bank {i} meta {fm}")
            if (blob_meta(published[-2][0])["heads"],
                    blob_meta(published[-1][0])["heads"]) != (
                    dcfg.maxHeads, dcfg.maxHeads - 1) \
                    or rh != route_hash(victim) or op != 1:
                raise AssertionError("distill: the last publishes are not "
                                     "the full bank and its rollback")
            # (e) lineage lists exactly the bank's heads
            if set(store.specialists()) != {str(h) for h in pipe.bank.heads}:
                raise AssertionError("distill: lineage differs from the bank")
    finally:
        watch.close()
        teacher.close()
    promoted = [c for c in cycles if c["action"] == "promoted"]
    split = {k: spread([c["parts"].get(k, 0.0) for c in promoted])
             for k in ("snapshot", "distill_head", "evaluations",
                       "delta_export", "full_export", "publish", "lineage")}
    split["cycle"] = spread([c["ms"] for c in promoted])
    margins = {k: min(c["margins"][k] for c in promoted
                      if k in c["margins"]) for k in ("loss", "auc")}
    print(f"distill, seed {seed}: {len(promoted)} heads promoted over "
          f"{len(cycles)} cycles, poisoned {poisoned_route} rejected, "
          f"{left[0]} skipped (bank full), {victim} rolled back; "
          f"{cycles[0]['launches']} launches a cycle; heads vs plain max|diff| {agree.worst:.3e}; "
          f"least gate room: loss {margins['loss']:.4f} relative, AUC "
          f"{margins['auc']:.4f}; cycle p50 {split['cycle']['p50_ms']:.3f} "
          f"ms; full bank of {heads_full} heads: " + ", ".join(
              f"{q} {b} B" for q, b in sizes.items()))
    return {"seed": seed, "launches": launches, "cycles": len(cycles),
            "promoted": len(promoted), "poisoned_route": poisoned_route,
            "skipped_route": left[0], "rolled_back": victim,
            "launches_per_cycle": [c["launches"] for c in cycles],
            "heads_vs_plain_max": agree.worst, "gate_room_min": margins,
            "generation": pipe.bank.generation, "publishes": len(published),
            "cycle_ms": split, "bank_bytes": sizes,
            "bank_heads": heads_full, "bank_export_ms": export_ms}


def in_float32(snap):
    """``snap`` with a float32 compute dtype: the plain forward then
    rounds no activation to bfloat16."""
    import dataclasses

    import torch

    return dataclasses.replace(snap, cfg=dataclasses.replace(
        snap.cfg, compute_dtype=torch.float32))


async def parity_rows(cfg, seed: int, dev: str):
    """(c)'s inputs: the teacher's snapshot, one route's replay window
    (its last perRouteReplayRows rows), the rows a retrain cycle trains
    on (the window less its held-out rows) and the route."""
    from linkerd_tpu_torch.distill import DistillConfig

    teacher, batches = await distill_inputs(cfg, seed, dev)
    try:
        base = teacher.snapshot()
    finally:
        teacher.close()
    route = seed % N_ROUTES
    sel = slice(route * ROUTE_ROWS, (route + 1) * ROUTE_ROWS)
    x, labels, mask = (np.concatenate([b[k][sel] for b in batches])[
        -DistillConfig().perRouteReplayRows:] for k in range(3))
    train = np.arange(len(x)) % 4 != 0
    return base, x, (x[train], labels[train], mask[train]), route


def head_gap(a, b, x: np.ndarray, dev: str):
    """(float32 reading, bf16 reading) of two heads' largest score gap
    over ``x``."""
    return tuple(float(np.abs(plain_scores(f(a), x, dev)
                              - plain_scores(f(b), x, dev)).max())
                 for f in (in_float32, lambda s: s))


def distill_witness(cfg, seeds=(6, 10, 11, 12), perms: int = 30) -> dict:
    """(c)'s CPU witness: per seed, the 4-step head on the CPU against
    the same call on the rows permuted (``perms`` orders), read in
    float32 and in bf16; the largest of each. Runs on the CPU, with no
    card: ``PYTHONPATH=. python tests/test_torch_distill_cuda.py``."""
    from linkerd_tpu_torch.distill import DistillConfig
    from linkerd_tpu_torch.distill.pipeline import distill_head

    lr, out = DistillConfig().learningRate, {}
    for seed in seeds:
        base, x, rows, _ = asyncio.run(parity_rows(cfg, seed, "cpu"))
        host = distill_head(base, *rows, PARITY_STEPS, lr, "cpu")
        gaps = []
        for k in range(perms):
            order = np.random.default_rng(
                seed if k == 0 else 1000 * seed + k).permutation(len(rows[0]))
            gaps.append(head_gap(host, distill_head(
                base, *(r[order] for r in rows), PARITY_STEPS, lr, "cpu"),
                x, "cpu"))
        out[seed] = {"float32": max(g[0] for g in gaps),
                     "bf16": max(g[1] for g in gaps), "orders": perms}
        print(f"distill witness, seed {seed}: {PARITY_STEPS}-step head, CPU "
              f"vs CPU over {perms} row orders, max|diff| "
              f"{out[seed]['float32']:.3e} in float32, "
              f"{out[seed]['bf16']:.3e} in bf16")
    return out


async def distill_parity(cfg, seed: int, dev: str = "cuda"):
    """(c) From one teacher snapshot and one route's training rows (the
    rows a retrain cycle trains on: the route's replay window less its
    held-out rows): a PARITY_STEPS-step ``distill_head`` on ``dev``
    against the same call on the CPU, the two fitted heads' scores
    within MODEL_TOL on every row of the window, both read through the
    plain forward in float32 (``in_float32``). Read through the bf16
    forward instead, a parameter that two summation orders leave a
    rounding apart can tip one bf16 activation of a row, which moves
    that row's score a whole bf16 step (~1e-3-4e-3): the CPU against
    itself on permuted rows reads up to 3.5e-3 that way, and within
    1.3e-3 in float32 (``distill_witness``). Read with
    no bound beside it: the bf16 reading, the CPU against itself on the
    rows permuted (both readings), after PARITY_STEPS and after
    retrainSteps, and the card against the CPU after retrainSteps."""
    from linkerd_tpu_torch.distill import DistillConfig
    from linkerd_tpu_torch.distill.pipeline import distill_head

    base, x, rows, route = await parity_rows(cfg, seed, dev)
    dcfg = DistillConfig()
    lr, steps = dcfg.learningRate, dcfg.retrainSteps

    def gap(a, b):
        return head_gap(a, b, x, dev)

    card = distill_head(base, *rows, PARITY_STEPS, lr, dev)
    host = distill_head(base, *rows, PARITY_STEPS, lr, "cpu")
    if not (card.mu == host.mu).all() or not (card.var == host.var).all():
        raise AssertionError("distill: head stats differ card/CPU")
    short, short_bf16 = gap(card, host)
    if short > MODEL_TOL:
        raise AssertionError(
            f"seed {seed}: {PARITY_STEPS}-step head on the card off the "
            f"CPU's by {short} > {MODEL_TOL} (float32 forward)")
    order = np.random.default_rng(seed).permutation(len(rows[0]))
    permuted = tuple(r[order] for r in rows)
    short_order = gap(host, distill_head(base, *permuted, PARITY_STEPS, lr,
                                         "cpu"))
    host_long = distill_head(base, *rows, steps, lr, "cpu")
    long_gap = gap(distill_head(base, *rows, steps, lr, dev), host_long)
    long_order = gap(host_long, distill_head(base, *permuted, steps, lr,
                                             "cpu"))
    print(f"distill parity, seed {seed}: {PARITY_STEPS}-step head card vs "
          f"CPU max|diff| {short:.3e} in float32, {short_bf16:.3e} in bf16 "
          f"(CPU vs CPU on permuted rows {short_order[0]:.3e} / "
          f"{short_order[1]:.3e}); {steps} steps card vs CPU "
          f"{long_gap[0]:.3e} / {long_gap[1]:.3e}, CPU vs CPU on permuted "
          f"rows {long_order[0]:.3e} / {long_order[1]:.3e}")
    return {"seed": seed, "route": route, "rows": len(rows[0]),
            "card_vs_cpu": short, "card_vs_cpu_bf16": short_bf16,
            "cpu_vs_cpu_permuted": short_order,
            "long_card_vs_cpu": long_gap,
            "long_cpu_vs_cpu_permuted": long_order}


def distill_layers(base, x, labels, mask, dev: str,
                   reps: int = DISTILL_LAYER_REPS):
    """Host ms, each ended by a device sync, of the parts of one
    ``distill_head`` as it runs them: the stats blend, the copy of the
    base params to the device and a fresh Adam, the rows' H2D copy and
    z-score, one step's forward and backward, one Adam update, and the
    fitted params' readback. Medians of ``reps``."""
    import torch

    from linkerd_tpu_torch.models.anomaly import loss_fn, normalize_features
    from linkerd_tpu_torch.models.convert import (
        params_from_numpy, params_to_numpy,
    )
    from linkerd_tpu_torch.telemetry.anomaly import (
        adam_from_leaves, zero_adam_leaves,
    )

    def timed(fn):
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            if dev != "cpu":
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ms)), out

    def blend():
        mu = (0.5 * base.mu + 0.5 * x.mean(axis=0)).astype(np.float32)
        var = (0.5 * base.var + 0.5 * (x.var(axis=0) + 1e-6)).astype(
            np.float32)
        return mu, var

    def setup():
        params = params_from_numpy(base.params, dev)
        return params, adam_from_leaves(params, zero_adam_leaves(base.cfg),
                                        1e-3)

    out = {}
    out["blend"], (mu, var) = timed(blend)
    out["params_to_device_and_adam"], (params, opt) = timed(setup)
    out["h2d_zscore"], (xn, y, m) = timed(lambda: (
        normalize_features(torch.tensor(x, device=dev),
                           torch.tensor(mu, device=dev),
                           torch.tensor(var, device=dev)),
        torch.tensor(labels, device=dev), torch.tensor(mask, device=dev)))

    def forward_backward():
        opt.zero_grad()
        loss_fn(params, xn, y, m, base.cfg).backward()

    out["forward_backward"], _ = timed(forward_backward)
    out["adam"], _ = timed(opt.step)
    out["readback"], _ = timed(lambda: params_to_numpy(params))
    return out


async def time_distill(cfg, seed: int, dev: str = "cuda"):
    """The parts of one ``distill_head``, and Score p50/p99 at 1024 rows
    x IN_FLIGHT with a retrain cycle always in flight and with none (in
    turns: none, retrain, retrain, none), on a fresh pipeline at the
    defaults fed the same batches."""
    from linkerd_tpu_torch.distill import DistillConfig

    teacher, batches = await distill_inputs(cfg, seed, dev)
    routes = route_names()
    dsts = [d for d in routes for _ in range(ROUTE_ROWS)]
    rng = np.random.default_rng(seed)
    try:
        pipe = DistillConfig().mk(None, device=dev)
        for x, labels, mask in batches:
            pipe.observe_batch(dsts, x, await teacher.score(x), labels, mask)
        base = teacher.snapshot()
        x, labels, mask = pipe.replay.sample(routes[0])
        layers = distill_layers(base, x, labels, mask, dev)
        payloads = [make_inputs(rng, 1024, base.mu, base.var)
                    for _ in range(IN_FLIGHT)]
        retrains = []

        async def load(with_retrain: bool):
            lat, task = [], None

            async def one(p):
                t0 = time.perf_counter()
                await teacher.score(p)
                lat.append((time.perf_counter() - t0) * 1e3)

            for _ in range(LOAD_ROUNDS):
                if with_retrain and (task is None or task.done()):
                    if task is not None:
                        retrains.append(task.result())
                    task = asyncio.ensure_future(pipe.run_once(teacher))
                await asyncio.gather(*(one(p) for p in payloads))
            if task is not None:
                retrains.append(await task)
            return lat

        await load(False)  # warm
        lat = {"none": [], "retrain": []}
        for mode in ("none", "retrain", "retrain", "none"):
            lat[mode] += await load(mode == "retrain")
    finally:
        teacher.close()
    if any(r is None for r in retrains):
        raise AssertionError("distill: a load window found nothing pending")
    out = {"distill_head_layers_ms": layers,
           "retrains_under_load": len(retrains),
           "score_under_retrain": {
               mode: {"batches": len(v),
                      "p50_ms": float(np.percentile(v, 50)),
                      "p99_ms": float(np.percentile(v, 99))}
               for mode, v in lat.items()}}
    print("distill_head parts, host ms each (ended by a sync): " + ", ".join(
        f"{k} {v:.3f}" for k, v in layers.items()))
    for mode, v in out["score_under_retrain"].items():
        print(f"score 1024 rows x{IN_FLIGHT}, {mode}: p50 "
              f"{v['p50_ms']:.3f} ms, p99 {v['p99_ms']:.3f} ms "
              f"({v['batches']} batches)")
    return out


async def distill_phase(cfg, seed: int = 6, dev: str = "cuda"):
    """The scenario, then (c) and the times; returns the results and the
    kernel's launches on the scenario's path."""
    res = {"scenario": await distill_scenario(cfg, seed, dev),
           "parity": await distill_parity(cfg, seed, dev)}
    res["times"] = await time_distill(cfg, seed + 1, dev)
    return res, res["scenario"]["launches"]


# -- telemeter phase: the in-process io.l5d.jaxAnomaly main path ----------
# A request's feature row -> FeatureRecorder or a ring append -> the
# line-rate micro-batcher (run()) -> InProcessScorer.score -> the ring ->
# the kernel -> ScoreBoard -> AnomalyFailureAccrualPolicy, at the
# reference's defaults (maxBatch 1024, lineRate, maxLingerMs 2,
# scoreConcurrency 2) and full width. Part A: no training; part B: the
# reference's cadence (a fit every 8 batches, a lifecycle with cycles run
# by hand, a distill block, a span sink, a recording weight sink).
TELE_ROUTES = 40         # a tenth of them faulted
TELE_FAULTED = 4
TELE_BATCH = 1024        # the reference's maxBatch
TELE_BATCHES = 64        # full batches in each part
TELE_TEACHER_FITS = 20
TELE_SHIFTED = 4         # part B: routes shifted after TELE_ANCHOR batches
TELE_ANCHOR = 8
RECORDER_TIMINGS = 20000


def tele_routes():
    return [f"/svc/tele-{i:02d}" for i in range(TELE_ROUTES)]


def tele_traffic(rng, n: int, shift=None, faulted: int = TELE_FAULTED):
    """``n`` requests over ``tele_routes()``: about half through the
    recorder filter ("rec"), the rest appended to the ring ("ring"); the
    first ``faulted`` routes are faulted, their requests slow and 5xx
    and labeled 1. ``shift`` maps a route to a factor on the fields the
    faults leave alone (bytes, concurrency, rate)."""
    routes = tele_routes()
    out = []
    for i in range(n):
        r = int(rng.integers(TELE_ROUTES))
        bad = r < faulted
        k = 1.0 if shift is None else shift.get(routes[r], 1.0)
        out.append(("rec" if rng.random() < 0.5 else "ring", dict(
            dst_path=routes[r], label=1.0 if bad else 0.0,
            latency_ms=float(rng.gamma(2.0, 150.0 if bad else 4.0)),
            status=int(rng.choice([500, 503]) if bad
                       else rng.choice([200, 200, 200, 204, 404])),
            retries=int(rng.integers(2)),
            request_bytes=int(rng.integers(50, 2000) * k),
            response_bytes=int(rng.integers(100, 8000) * k),
            concurrency=int(rng.integers(1, 16) * k),
            dst_rps=float(rng.uniform(5, 50) * k),
            endpoint=f"10.1.{r}.{i % 3}:8080")))
    return out


def tele_items(rows):
    """Requests (recorder path) and ring tuples (ring path), in order:
    built before a timed window, as a router has them in hand, each
    request's ``dst`` bound as a router's identifier binds it."""
    import types

    from linkerd_tpu_torch.core.path import Path as NamePath
    from linkerd_tpu_torch.models.features import FeatureVector
    from linkerd_tpu_torch.protocol.http.message import Request

    items = []
    for kind, f in rows:
        if kind == "rec":
            req = Request()
            req.ctx.update(dst=types.SimpleNamespace(
                path=NamePath.read(f["dst_path"])), status=f["status"],
                           label=f["label"], retries=f["retries"],
                           endpoint=f["endpoint"])
            req.body = b"x" * (f["request_bytes"] % 4096)
            items.append(("rec", req))
        else:
            fv = FeatureVector(**{k: f[k] for k in (
                "dst_path", "latency_ms", "status", "retries",
                "request_bytes", "response_bytes", "concurrency",
                "dst_rps")})
            items.append(("ring", (fv, f["label"], None, None,
                                   f["endpoint"])))
    return items


async def tele_downstream(req):
    """The service behind the recorder: answers the request's status,
    with the fault label a fault-injection harness stamps."""
    from linkerd_tpu_torch.protocol.http.message import Response

    rsp = Response(req.ctx["status"], body=b"y" * 64)
    rsp.headers.set("l5d-fault-label", str(req.ctx["label"]))
    return rsp


async def push(ring, svc, items) -> None:
    """``items`` in without yielding to the loop: through ``svc`` (the
    recorder filter before a downstream that never suspends) or
    appended to ``ring``."""
    for kind, it in items:
        if kind == "rec":
            await svc(it)
        else:
            ring.append(it)


async def tele_teacher(cfg, seed: int, dev: str):
    """A snapshot of random weights from a seed (``make_snapshot``),
    trained by TELE_TEACHER_FITS fits at lr 5e-3 on labeled rows of the
    phase's traffic before any route faults, recorded and featurized as
    the telemeter does: a model of the calm mesh, to which the faults of
    the phase are new."""
    import collections

    from linkerd_tpu_torch.models.features import featurize_batch
    from linkerd_tpu_torch.router.service import FnService
    from linkerd_tpu_torch.telemetry.anomaly import (
        FeatureRecorder, InProcessScorer,
    )

    rng = np.random.default_rng(seed)
    ring = collections.deque()
    svc = FeatureRecorder(ring).and_then(FnService(tele_downstream))
    teacher = InProcessScorer(learning_rate=5e-3, device=dev)
    try:
        teacher.restore(make_snapshot(cfg, seed))
        for _ in range(TELE_TEACHER_FITS):
            await push(ring, svc, tele_items(
                tele_traffic(rng, FIT_ROWS, faulted=0)))
            items = [ring.popleft() for _ in range(len(ring))]
            x = featurize_batch([it[0] for it in items])
            labels = np.array([it[1] for it in items], np.float32)
            await teacher.fit(x, labels, np.ones(len(x), np.float32))
        return teacher.snapshot()
    finally:
        teacher.close()


class TeleRecorder:
    """Wraps, on one telemeter and its scorer, the calls the phase
    reads: every score call's rows and scores, every board fold (in
    fold order), and the host ms of ``_take_batch`` and of
    ``_score_and_publish``."""

    def __init__(self, tele):
        self.scored, self.folds = [], []
        self.take_ms, self.publish_ms, self.calls = [], [], 0
        scorer, board = tele._scorer, tele.board
        score, fold = scorer.score, board.update_batch
        take, publish = tele._take_batch, tele._score_and_publish

        async def scoring(x):
            self.calls += 1
            s = await score(x)
            self.scored.append((x, s))  # a fresh array each batch
            return s

        def folding(dsts, scores, endpoints=None):
            self.folds.append((list(dsts), scores, endpoints))
            return fold(dsts, scores, endpoints=endpoints)

        def taking():
            t0 = time.perf_counter()
            try:
                return take()
            finally:
                self.take_ms.append((time.perf_counter() - t0) * 1e3)

        async def publishing(s, b):
            t0 = time.perf_counter()
            try:
                return await publish(s, b)
            finally:
                self.publish_ms.append((time.perf_counter() - t0) * 1e3)

        scorer.score, board.update_batch = scoring, folding
        tele._take_batch, tele._score_and_publish = taking, publishing


async def tele_drive(tele, batches, hooks=None):
    """The main path: ``run()`` as a task, each batch's items pushed in
    one go (the batcher then finds a full batch) with at most two
    batches waiting in the ring, until every row is scored. Before batch
    ``i`` (``len(batches)``: after the last), once every row pushed so
    far is scored, ``hooks[i]()`` is awaited. Returns the wall seconds
    from the first push to the last row scored, the hooks' time left
    out."""
    from linkerd_tpu_torch.router.service import FnService

    svc = tele.recorder().and_then(FnService(tele_downstream))
    hooks = hooks or {}
    scored = tele._scored
    task = asyncio.ensure_future(tele.run())

    async def settle(rows: int) -> None:
        while scored.value < rows:
            if task.done():
                task.result()
                raise AssertionError("telemeter: run() ended early")
            await asyncio.sleep(2e-4)

    try:
        await asyncio.sleep(0.05)  # run()'s start: bootstrap, first publish
        t0, hook_s, pushed = time.perf_counter(), 0.0, 0
        for i in range(len(batches) + 1):
            if i in hooks:
                await settle(pushed)
                h0 = time.perf_counter()
                await hooks[i]()
                hook_s += time.perf_counter() - h0
            if i == len(batches):
                break
            while len(tele.ring) >= 2 * TELE_BATCH:
                await asyncio.sleep(2e-4)
            await push(tele.ring, svc, batches[i])
            pushed += len(batches[i])
            await asyncio.sleep(0)
        await settle(pushed)
        wall = time.perf_counter() - t0 - hook_s
    finally:
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
    return wall


async def tele_layers(tele, dev: str, reps: int = 20) -> dict:
    """Host ms of each layer of one TELE_BATCH-row batch, each run
    alone after the part (medians of ``reps``): the feature encoder, the
    score call through the ring (wait included), the board fold, the
    ``dst/*`` gauges, the lifecycle's drift monitor and the distill
    feed. Their launches fall outside the counted window."""
    from linkerd_tpu_torch.distill import DistillConfig
    from linkerd_tpu_torch.lifecycle.drift import DriftMonitor
    from linkerd_tpu_torch.models.features import featurize_batch
    from linkerd_tpu_torch.telemetry.anomaly import ScoreBoard

    rows = [("ring", f) for _, f in tele_traffic(
        np.random.default_rng(1), TELE_BATCH)]
    tuples = [it for _, it in tele_items(rows)]
    fvs, eps = [it[0] for it in tuples], [it[4] for it in tuples]
    dsts = [fv.dst_path for fv in fvs]
    x = featurize_batch(fvs)
    labels = np.array([it[1] for it in tuples], np.float32)
    mask = np.ones(len(x), np.float32)
    scorer = tele._scorer
    score = type(scorer).score  # the class's: past TeleRecorder's wrapper

    def med(fn) -> float:
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ms.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ms))

    s = await score(scorer, x)
    wait = []
    for _ in range(reps):
        t0 = time.perf_counter()
        await score(scorer, x)
        wait.append((time.perf_counter() - t0) * 1e3)
    drift = DriftMonitor()
    pipe = DistillConfig().mk(None, device=dev)
    return {"featurize": med(lambda: featurize_batch(fvs)),
            "score_ring_round_trip": float(np.median(wait)),
            "board_fold": med(lambda: ScoreBoard().update_batch(
                dsts, s, endpoints=eps)),
            "dst_gauges": med(tele._publish_gauges),
            "drift_observe": med(lambda: drift.observe(x, s)),
            "distill_observe": med(lambda: pipe.observe_batch(
                dsts, x, s, labels, mask))}


def batch_key(scores: np.ndarray) -> int:
    """One batch's scores, as a score call returned them or as a board
    fold took them (that array or a slice of it): the array that owns
    their memory."""
    while getattr(scores, "base", None) is not None:
        scores = scores.base
    return id(scores)


def tele_plain(snap, rec, dev: str):
    """The plain version's scores of every scored batch, on ``dev``."""
    return [plain_scores(snap, x, dev) for x, _ in rec.scored]


def tele_common_checks(tele, rec, rows: int, launches: int, extra: int,
                       part: str, dev: str):
    """Counters of a part: every row scored, nothing failed, dropped or
    degraded, and on the card one kernel launch a dispatched batch (plus
    ``extra`` for gates and retrains)."""
    flat = tele.metrics.flatten()
    bad = {k: flat[f"anomaly/{k}"] for k in ("score_failures",
                                             "dropped_batches", "degraded")
           if flat[f"anomaly/{k}"]}
    if bad:
        raise AssertionError(f"telemeter {part}: {bad}")
    if flat["anomaly/scored_total"] != rows or \
            flat["anomaly/scored_fraction"] != 1.0:
        raise AssertionError(
            f"telemeter {part}: scored {flat['anomaly/scored_total']} of "
            f"{rows} rows, fraction {flat['anomaly/scored_fraction']}")
    batches = flat["anomaly/batches"]
    if batches != rec.calls or len(rec.scored) != rec.calls:
        raise AssertionError(f"telemeter {part}: {batches} batches, "
                             f"{rec.calls} score calls")
    full = sum(len(x) == TELE_BATCH for x, _ in rec.scored)
    if full < TELE_BATCHES:
        raise AssertionError(f"telemeter {part}: {full} full batches")
    if launches != (0 if dev == "cpu" else batches + extra):
        raise AssertionError(
            f"telemeter {part}: {launches} kernel launches for {batches} "
            f"batches + {extra}")
    return flat, batches, full


def tele_times(rec, rows: int, wall: float) -> dict:
    pub = np.asarray(rec.publish_ms)
    return {"rows_per_s": rows / wall, "wall_s": wall,
            "take_batch_p50_ms": float(np.median(rec.take_ms)),
            "score_and_publish_p50_ms": float(np.percentile(pub, 50)),
            "score_and_publish_p99_ms": float(np.percentile(pub, 99))}


async def telemeter_part_a(cfg, snap, seed: int, dev: str = "cuda"):
    """Part A, no training: TELE_BATCHES full batches through run();
    kernel scores against plain (Agreement), the board against a fresh
    ScoreBoard folded with the plain scores in the same order, launches
    against batches, counters, and the accrual policy on the board."""
    from linkerd_tpu_torch.telemetry.anomaly import (
        AnomalyFailureAccrualConfig, InProcessScorer, JaxAnomalyConfig,
        JaxAnomalyTelemeter, ScoreBoard,
    )
    from linkerd_tpu_torch.telemetry.metrics import MetricsTree

    rng = np.random.default_rng(seed)
    batches = [tele_items(tele_traffic(rng, TELE_BATCH))
               for _ in range(TELE_BATCHES)]
    rows = TELE_BATCHES * TELE_BATCH
    recorded = sum(k == "rec" for b in batches for k, _ in b)
    scorer = InProcessScorer(device=dev)
    scorer.restore(snap)
    await scorer.warmup(TELE_BATCH)  # the kernel, its ring slots, a fit
    tele = JaxAnomalyTelemeter(JaxAnomalyConfig(trainEveryBatches=0),
                               MetricsTree(), scorer=scorer, device=dev)
    rec = TeleRecorder(tele)
    try:
        wall, launches = await counted(tele_drive(tele, batches))
        layers = await tele_layers(tele, dev)
    finally:
        tele.close()
    flat, n_batches, full = tele_common_checks(tele, rec, rows, launches, 0,
                                               "part A", dev)
    if flat["anomaly/requests_total"] != recorded:
        raise AssertionError("telemeter part A: requests_total "
                             f"{flat['anomaly/requests_total']} != "
                             f"{recorded} recorded")
    plain = tele_plain(snap, rec, dev)
    agree = Agreement("telemeter A: kernel vs plain")
    for (x, got), ref in zip(rec.scored, plain):
        agree.add(got, ref, f"batch of {len(x)}")
    agree.close()
    # a fresh board folded with the plain scores in the fold order
    by_id = {batch_key(s): p for (_, s), p in zip(rec.scored, plain)}
    fresh = ScoreBoard(ttl_s=tele.cfg.scoreTtlSecs)
    for dsts, s, eps in rec.folds:
        fresh.update_batch(dsts, by_id[batch_key(s)], endpoints=eps)
    got, want = tele.board.scores.sample(), fresh.scores.sample()
    got_ep, want_ep = (tele.board.effective_endpoint_scores(),
                       fresh.effective_endpoint_scores())
    if sorted(got) != sorted(want) or sorted(got_ep) != sorted(want_ep):
        raise AssertionError("telemeter A: board keys differ from the fold")
    board_gap = max(max(abs(got[k] - want[k]) for k in got),
                    max(abs(got_ep[k] - want_ep[k]) for k in got_ep))
    if board_gap > TOL:
        raise AssertionError(f"telemeter A: board off the plain fold by "
                             f"{board_gap} > {TOL}")
    # accrual: the mesh level with the faulted routes tightens the
    # policy to anomalousFailures; a board of the calm routes alone
    # keeps it at failures
    faulted = set(tele_routes()[:TELE_FAULTED])
    calm = ScoreBoard(ttl_s=tele.cfg.scoreTtlSecs)
    calm.update_batch([d for d in got if d not in faulted],
                      np.array([got[d] for d in got if d not in faulted]))
    acfg = AnomalyFailureAccrualConfig()

    def failures_to_dead(board) -> int:
        policy = type(acfg.mk(board))(board, acfg.failures,
                                      acfg.anomalousFailures,
                                      acfg.threshold, backoffs=iter([1.0]))
        for k in range(1, acfg.failures + 1):
            if policy.record_failure() is not None:
                return k
        return -1

    dead = {"mesh": failures_to_dead(tele.board),
            "calm_only": failures_to_dead(calm)}
    if dead != {"mesh": acfg.anomalousFailures, "calm_only": acfg.failures}:
        raise AssertionError(f"telemeter A: accrual {dead}, level "
                             f"{tele.board.anomaly_level()} / "
                             f"{calm.anomaly_level()}")
    levels = {"faulted_min": min(got[d] for d in faulted),
              "calm_max": max(v for d, v in got.items()
                              if d not in faulted)}
    out = dict(tele_times(rec, rows, wall), rows=rows, batches=n_batches,
               full_batches=full, launches=launches,
               kernel_vs_plain_max=agree.worst,
               rows_off=agree.off, board_vs_plain_fold_max=board_gap,
               failures_to_dead=dead, board_levels=levels,
               recorded_requests=recorded, layers_ms=layers)
    print(f"telemeter A, seed {seed}: {rows} rows in {n_batches} batches "
          f"({full} full), {launches} launches; kernel vs plain max|diff| "
          f"{agree.worst:.3e}, board vs plain fold {board_gap:.3e}; "
          f"accrual dead after {dead}; faulted routes >= "
          f"{levels['faulted_min']:.3f}, calm <= {levels['calm_max']:.3f}; "
          f"{out['rows_per_s']:.0f} rows/s, _take_batch p50 "
          f"{out['take_batch_p50_ms']:.3f} ms, _score_and_publish p50 "
          f"{out['score_and_publish_p50_ms']:.3f} p99 "
          f"{out['score_and_publish_p99_ms']:.3f} ms; a batch's layers "
          f"alone, host ms: " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in layers.items()))
    return out


class SpanSink:
    def __init__(self):
        self.spans = []

    def record(self, span: dict) -> None:
        self.spans.append(span)


async def telemeter_part_b(cfg, snap, seed: int, dev: str = "cuda"):
    """Part B, the reference's cadence: a fit every 8 batches, a
    ``lifecycle:`` block (cycles by hand), a small ``distill:`` block
    with TELE_SHIFTED routes shifted after TELE_ANCHOR batches, a span
    sink and a recording weight sink. Launches: one a batch, two a
    gated cycle, two a retrain cycle; a promotion republishes to the
    sink a blob whose CRC the manifest records; hold-out batches never
    reach a fit."""
    from linkerd_tpu_torch.distill import DistillConfig
    from linkerd_tpu_torch.lifecycle import LifecycleConfig
    from linkerd_tpu_torch.lifecycle.export import blob_meta
    from linkerd_tpu_torch.lifecycle.store import MANIFEST
    from linkerd_tpu_torch.telemetry.anomaly import (
        InProcessScorer, JaxAnomalyConfig, JaxAnomalyTelemeter,
    )
    from linkerd_tpu_torch.telemetry.metrics import MetricsTree

    rng = np.random.default_rng(seed)
    shift = {r: 20.0 * (1 + i) for i, r in
             enumerate(tele_routes()[-TELE_SHIFTED:])}
    batches = [tele_items(tele_traffic(
        rng, TELE_BATCH, shift=shift if b >= TELE_ANCHOR else None))
        for b in range(TELE_BATCHES)]
    rows = TELE_BATCHES * TELE_BATCH
    scorer = InProcessScorer(device=dev)
    scorer.restore(snap)
    await scorer.warmup(TELE_BATCH)  # the kernel, its ring slots, a fit
    with tempfile.TemporaryDirectory() as tmp:
        tcfg = JaxAnomalyConfig(
            lifecycle=LifecycleConfig(directory=tmp, checkpointEveryS=0,
                                      minReplayRows=TELE_BATCH),
            distill=DistillConfig(maxHeads=4, cooldownS=0.0, retrainSteps=2,
                                  minRouteRows=64))
        tele = JaxAnomalyTelemeter(tcfg, MetricsTree(), scorer=scorer,
                                   device=dev)
        rec = TeleRecorder(tele)
        blobs, spans = [], SpanSink()
        tele.register_weight_sink(lambda b: blobs.append(("full", b)),
                                  lambda b: blobs.append(("delta", b)))
        tele.set_tracer(spans)
        fits, holdouts, retrains, cycles = [], [], [], []
        fit, add, run_once = (scorer.fit, tele.lifecycle.replay.add_batch,
                              tele.distill.run_once)

        async def fitting(x, labels, mask):
            fits.append(x.tobytes())
            return await fit(x, labels, mask)

        def holding(x, labels, mask):
            holdouts.append(x.tobytes())
            return add(x, labels, mask)

        async def retraining(*a, **kw):
            out = await run_once(*a, **kw)
            if out is not None:
                retrains.append(out)
            return out

        scorer.fit, tele.lifecycle.replay.add_batch = fitting, holding
        tele.distill.run_once = retraining

        async def cycle():
            before = len(blobs)
            out = await tele.lifecycle_cycle()
            manifest = json.loads((Path(tmp) / MANIFEST).read_text())
            entry = {e["version"]: e for e in manifest["versions"]}[
                tele.lifecycle.serving_version]
            full = [b for k, b in blobs[before:] if k == "full"]
            if out["action"] in ("promoted", "rolled_back"):
                if len(full) != 1 or blob_meta(full[0])["crc"] != \
                        entry.get("native_blob", {}).get("crc"):
                    raise AssertionError(
                        f"telemeter B: {out['action']} republished "
                        f"{len(full)} blobs, manifest {entry}")
            cycles.append(dict(action=out["action"],
                               gated="decision" in out,
                               version=tele.lifecycle.serving_version,
                               crc=blob_meta(full[0])["crc"] if full
                               else None))
            return out

        async def main_path():
            # cycles by hand: after the first quarter of the traffic (the
            # bootstrap promotion) and after the last batch (gated)
            wall = await tele_drive(tele, batches, {
                TELE_BATCHES // 4: cycle, TELE_BATCHES: cycle})
            while tele.distill.busy:
                await asyncio.sleep(0.01)
            return wall

        try:
            wall, launches = await counted(main_path())
        finally:
            tele.close()
        gated = sum(c["gated"] for c in cycles)
        flat, n_batches, full_batches = tele_common_checks(
            tele, rec, rows, launches, 2 * gated + 2 * len(retrains),
            "part B", dev)
    # batch b (from 0) is held out when b % 4 == 0 and fits when
    # (b + 1) % 8 == 0 and it is not held out
    want = (sum((b + 1) % 8 == 0 and b % 4 != 0 for b in range(n_batches)),
            len(range(0, n_batches, 4)))
    if (len(fits), len(holdouts)) != want or set(fits) & set(holdouts):
        raise AssertionError(
            f"telemeter B: {len(fits)} fits and {len(holdouts)} hold-outs "
            f"(want {want}), {len(set(fits) & set(holdouts))} shared")
    if not retrains or not any(c["gated"] for c in cycles) or \
            cycles[0]["action"] != "promoted":
        raise AssertionError(f"telemeter B: retrains {len(retrains)}, "
                             f"cycles {cycles}")
    timing = scorer.timing_totals
    timed = -(-n_batches // tele.TIMING_SAMPLE_EVERY)
    if timing["calls"] != timed or sorted(scorer.last_timing) != [
            "bytes", "device_ms", "queue_ms", "transfer_ms"]:
        raise AssertionError(f"telemeter B: {timing['calls']} timed batches "
                             f"of {n_batches}")
    batch_spans = [s for s in spans.spans if s["name"] == "scorer.batch"]
    if len(batch_spans) != n_batches:
        raise AssertionError("telemeter B: a batch without its span")
    split = {k: timing[k] / timing["calls"]
             for k in ("queue_ms", "transfer_ms", "device_ms")}
    split["bytes"] = timing["bytes"] / timing["calls"]
    out = dict(tele_times(rec, rows, wall), rows=rows, batches=n_batches,
               full_batches=full_batches, launches=launches,
               gated_cycles=gated, retrain_cycles=len(retrains),
               retrains=[(r["route"], r["action"]) for r in retrains],
               cycles=cycles, fits=len(fits), holdouts=len(holdouts),
               train_loss=flat["anomaly/train_loss"],
               timed_batches=timing["calls"], last_timing_split=split,
               publishes=[k for k, _ in blobs], spans=len(spans.spans))
    print(f"telemeter B, seed {seed}: {rows} rows in {n_batches} batches "
          f"({full_batches} full), {launches} launches = batches + 2 x "
          f"{gated} gated + 2 x {len(retrains)} retrains; {len(fits)} "
          f"fits, {len(holdouts)} hold-outs, none shared; cycles "
          f"{[c['action'] for c in cycles]}; retrains {out['retrains']}; "
          f"{out['rows_per_s']:.0f} rows/s, _take_batch p50 "
          f"{out['take_batch_p50_ms']:.3f} ms, _score_and_publish p50 "
          f"{out['score_and_publish_p50_ms']:.3f} p99 "
          f"{out['score_and_publish_p99_ms']:.3f} ms; timed batches "
          f"{timing['calls']}: " + ", ".join(
              f"{k} {v:.4f}" for k, v in split.items()))
    return out


def recorder_us(n: int = RECORDER_TIMINGS) -> dict:
    """Host µs a request of the recorder filter in front of a downstream
    that answers at once, and of that downstream alone."""
    import collections

    from linkerd_tpu_torch.router.service import FnService
    from linkerd_tpu_torch.telemetry.anomaly import FeatureRecorder

    items = [it for _, it in tele_items(
        [("rec", f) for _, f in tele_traffic(np.random.default_rng(0), n)])]
    bare = FnService(tele_downstream)
    # a ring of one batch, as the batcher keeps it drained: an unbounded
    # one would time the collector's passes over the rows it holds
    svc = FeatureRecorder(collections.deque(maxlen=TELE_BATCH)).and_then(bare)

    async def go(s):
        t0 = time.perf_counter()
        for req in items:
            await s(req)
        return (time.perf_counter() - t0) / n * 1e6

    return {"recorder_us": asyncio.run(go(svc)),
            "downstream_alone_us": asyncio.run(go(bare))}


async def telemeter_phase(cfg, seed: int = 8, dev: str = "cuda"):
    """The teacher, part A and part B; returns the results and the
    kernel's launches on the two parts' main path."""
    snap = await tele_teacher(cfg, seed, dev)
    res = {"part_a": await telemeter_part_a(cfg, snap, seed, dev),
           "part_b": await telemeter_part_b(cfg, snap, seed + 1, dev)}
    return res, res["part_a"]["launches"] + res["part_b"]["launches"]


# -- linker phase: a request through the port's HTTP router ---------------
# The port's main path behind real sockets: a load client's request ->
# HttpServer -> the io.l5d.header.token identifier -> the Dtab and the
# io.l5d.fs namer -> the path stack (classifier, deadline, retries) -> the
# client stack (balancer, failure accrual a replica) -> a backend; on the
# way out the telemeter's recorder filter takes the request's row, which
# the line-rate micro-batcher scores through the kernel into the
# ScoreBoard that the io.l5d.jaxAnomaly accrual reads. Backends and the
# load client run in child processes; only the router and the telemeter
# share this process's event loop, as in a deployment.
LINKER_REPLICAS = 2        # replicas a destination, TELE_ROUTES of them
LINKER_CONNS = 64          # keep-alive client connections
LINKER_LOAD_PROCS = 2      # load client processes sharing the connections
LINKER_BACKEND_PROCS = 2   # backend processes sharing the destinations
LINKER_WARMUP = 8192       # calm requests, training on every batch in part A
LINKER_WINDOW = 16384      # labeled mixed requests, training off in part A
LINKER_ERROR_RATE = 0.9    # the reference test's FaultSpec
LINKER_FAULT_MS = 40.0
LINKER_BODY = 200          # response bytes, as the reference test's backend
LINKER_AUC_MIN = 0.9
LINKER_SETTLE_S = 60.0
FAILOVER_WHO = 10          # ``answerer`` code of the failover cluster's replica 0
# the last window the linker phase scored (rows, snapshot, kernel and
# plain scores), for the witness of the kernel's sums (``--witness``)
WINDOWS: dict = {}


def faulting(flag: int, d: int, replica: int) -> bool:
    """Whether replica ``replica`` of destination ``d`` injects faults
    while the flag reads ``flag``: 1, both replicas of the first
    TELE_FAULTED destinations; 2, replica 0 of those alone; 3, both
    replicas of the first TELE_FAULTED + 1 (the control phase's part B,
    whose one more sick destination has the unsafe failover entry)."""
    if flag == 2:
        return d < TELE_FAULTED and replica == 0
    if flag == 3:
        return d <= TELE_FAULTED
    return flag == 1 and d < TELE_FAULTED


def linker_backends(conn, dsts, flag, seed: int) -> None:
    """Child process: one HTTP server a replica of each destination index
    in ``dsts``; each answers ``tele-DD/R`` padded to LINKER_BODY bytes.
    The destinations ``faulting`` names for ``flag``'s value inject the
    reference test's faults (LINKER_FAULT_MS, then 503 at
    LINKER_ERROR_RATE); every response carries the fault label."""
    import random

    from linkerd_tpu_torch.protocol.http.message import Response
    from linkerd_tpu_torch.protocol.http.server import serve
    from linkerd_tpu_torch.router.service import FnService

    rng = random.Random(seed)

    def backend(name: str, d: int, replica: int):
        body = name.encode().ljust(LINKER_BODY, b"x")

        async def handle(req):
            if faulting(flag.value, d, replica):
                await asyncio.sleep(LINKER_FAULT_MS / 1e3)
                rsp = (Response(503, body=b"injected fault")
                       if rng.random() < LINKER_ERROR_RATE
                       else Response(200, body=body))
                rsp.headers.set("l5d-fault-label", "1")
                return rsp
            rsp = Response(200, body=body)
            rsp.headers.set("l5d-fault-label", "0")
            return rsp

        return FnService(handle)

    async def main():
        servers = [await serve(backend(f"tele-{d:02d}/{r}", d, r))
                   for d in dsts for r in range(LINKER_REPLICAS)]
        conn.send([s.bound_port for s in servers])
        await asyncio.get_running_loop().run_in_executor(None, conn.recv)
        for s in servers:
            await s.close()

    asyncio.run(main())


async def linker_connection(port, plan, out: dict, off: int) -> None:
    """One keep-alive connection sending ``plan``'s destinations in turn,
    each by its Host header; stores status, right replica, ms, the
    monotonic instant it completed and who answered (``answerer``).
    ``port`` is a port, or ``(port, cafile)`` for a TLS connection
    verifying the server as ``localhost`` against ``cafile``."""
    import ssl

    from linkerd_tpu_torch.protocol.http.client import HttpClient
    from linkerd_tpu_torch.protocol.http.message import Request

    tls = {}
    if isinstance(port, tuple):
        port, cafile = port
        tls = dict(ssl_context=ssl.create_default_context(cafile=cafile),
                   server_hostname="localhost")
    client = HttpClient("127.0.0.1", port, max_connections=1, **tls)
    try:
        for i, d in enumerate(plan):
            req = Request(uri="/")
            req.headers.set("Host", f"tele-{d:02d}")
            t0 = time.perf_counter()
            try:
                rsp = await client(req)
            except Exception:  # noqa: BLE001 — counted as status -1
                status, body = -1, b""
            else:
                status, body = rsp.status, rsp.body
            out["ms"][off + i] = (time.perf_counter() - t0) * 1e3
            out["t"][off + i] = time.monotonic()
            out["status"][off + i] = status
            out["right"][off + i] = body.startswith(f"tele-{d:02d}/".encode())
            out["who"][off + i] = answerer(body, d)
    finally:
        await client.close()


def answerer(body: bytes, d: int) -> int:
    """Which backend of destination ``d`` answered: its replica R for
    ``tele-DD/R``, FAILOVER_WHO + R for the failover cluster's
    ``tele-DD-b/R``, -1 for anything else (an error body)."""
    return answer_of(body, d)[0]


def answer_of(body: bytes, d: int) -> tuple:
    """``answerer``'s code, and the rest of the body after ``tele-DD/R``
    (empty with -1)."""
    for base, name in ((0, f"tele-{d:02d}/"), (FAILOVER_WHO,
                                              f"tele-{d:02d}-b/")):
        b = name.encode()
        if body.startswith(b) and body[len(b):len(b) + 1].isdigit():
            return base + int(body[len(b):len(b) + 1]), body[len(b) + 1:]
    return -1, b""


def linker_load(conn) -> None:
    """Child process: on each ``(ports, plans)`` from ``conn``, one
    connection a plan (to its port), all at once; sends back every
    request's destination, status, whether a replica of its destination
    answered, its ms, and the wall seconds. ``None`` ends it."""
    while True:
        msg = conn.recv()
        if msg is None:
            return
        ports, plans = msg
        n = sum(len(p) for p in plans)
        out = {"dst": np.concatenate(plans).astype(np.int16),
               "status": np.zeros(n, np.int16), "right": np.zeros(n, bool),
               "ms": np.zeros(n), "t": np.zeros(n),
               "who": np.zeros(n, np.int8)}
        offs = np.cumsum([0] + [len(p) for p in plans])

        async def run():
            t0 = time.perf_counter()
            await asyncio.gather(*(linker_connection(port, p, out, int(o))
                                   for port, p, o in zip(ports, plans, offs)))
            return time.perf_counter() - t0

        out["wall"] = asyncio.run(run())
        conn.send(out)


def linker_plans(rng, n: int, conns: int = LINKER_CONNS):
    """``n`` requests over the destinations, uniform, split over
    ``conns`` connections."""
    return np.array_split(rng.integers(TELE_ROUTES, size=n), conns)


async def linker_traffic(loads, port, plans, split: bool = False):
    """The load processes' share of ``plans`` at once, each plan to
    ``port`` (or to its own port, with a list); waits for every answer
    off the event loop, so the router keeps serving. With ``split``, also
    each load process's answers apart."""
    loop = asyncio.get_running_loop()
    ports = port if isinstance(port, list) else [port] * len(plans)
    shares = np.array_split(np.arange(len(plans)), len(loads))
    for (conn, _), idx in zip(loads, shares):
        conn.send(([ports[i] for i in idx], [plans[i] for i in idx]))
    outs = await asyncio.gather(*(loop.run_in_executor(None, conn.recv)
                                  for conn, _ in loads))
    res = {k: np.concatenate([o[k] for o in outs])
           for k in ("dst", "status", "right", "ms", "t", "who")}
    res["wall"] = max(o["wall"] for o in outs)
    return (res, outs) if split else res


def linker_traffic_checks(res: dict, what: str, faults_on: bool,
                          faulted: int = TELE_FAULTED) -> dict:
    """Every calm request (with ``faults_on``, of the destinations past
    the first ``faulted``) answered 200 by a replica of its destination;
    returns requests/s and ms percentiles."""
    calm = res["dst"] >= (faulted if faults_on else 0)
    wrong = calm & ~((res["status"] == 200) & res["right"])
    if wrong.any():
        i = int(np.flatnonzero(wrong)[0])
        raise AssertionError(
            f"linker {what}: {int(wrong.sum())} calm requests misrouted "
            f"or failed, e.g. tele-{res['dst'][i]:02d} -> status "
            f"{res['status'][i]}")
    ms = res["ms"]
    return {"requests": len(ms), "requests_per_s": len(ms) / res["wall"],
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "calm_p50_ms": float(np.percentile(ms[calm], 50)),
            "calm_p99_ms": float(np.percentile(ms[calm], 99))}


class LinkerTap:
    """Wraps, on the linker's telemeter, what the phase reads: each batch
    taken (its rows' labels), each score call's rows and scores, each
    board fold in order, the host ms of ``_score_and_publish`` and the
    batches in flight."""

    def __init__(self, tele):
        self.batches, self.scored, self.folds = [], [], []
        self.publish_ms, self.inflight = [], 0
        scorer, board = tele._ensure_scorer(), tele.board
        score, fold = scorer.score, board.update_batch
        take, publish = tele._take_batch, tele._score_and_publish

        def taking():
            b = take()
            if b is not None:
                self.batches.append(b)
            return b

        async def scoring(x):
            s = await score(x)
            self.scored.append((x, s))
            return s

        def folding(dsts, scores, endpoints=None):
            self.folds.append((list(dsts), scores, endpoints))
            return fold(dsts, scores, endpoints=endpoints)

        async def publishing(s, b):
            self.inflight += 1
            t0 = time.perf_counter()
            try:
                return await publish(s, b)
            finally:
                self.publish_ms.append((time.perf_counter() - t0) * 1e3)
                self.inflight -= 1

        scorer.score, board.update_batch = scoring, folding
        tele._take_batch, tele._score_and_publish = taking, publishing

    async def settle(self, tele, task, what: str) -> None:
        """Until every recorded row is scored and published."""
        t0 = time.monotonic()
        while (tele.ring or self.inflight
               or tele._scored.value != tele._requests.value):
            if task.done():
                task.result()
                raise AssertionError(f"linker {what}: run() ended early")
            if time.monotonic() - t0 > LINKER_SETTLE_S:
                raise AssertionError(
                    f"linker {what}: {tele._scored.value} of "
                    f"{tele._requests.value} rows scored after "
                    f"{LINKER_SETTLE_S} s")
            await asyncio.sleep(1e-3)


class AccrualTap:
    """Counts, per endpoint port, the failures failure accrual records and
    the failures before each removal (an endpoint marked dead); undone by
    ``close``."""

    def __init__(self):
        from linkerd_tpu_torch.router.failure_accrual import (
            FailureAccrualService,
        )

        self.cls, self.orig = FailureAccrualService, \
            FailureAccrualService._on_failure
        self.failures, self.removals = {}, {}
        tap = self

        def on_failure(svc, probing):
            port = svc._svc.port
            tap.failures[port] = tap.failures.get(port, 0) + 1
            alive = svc._dead_until is None
            tap.orig(svc, probing)
            if alive and svc._dead_until is not None:
                tap.removals.setdefault(port, []).append(tap.failures[port])

        FailureAccrualService._on_failure = on_failure

    def close(self) -> None:
        self.cls._on_failure = self.orig


def linker_config(disco: Path, telemetry: bool, accrual: str,
                  train_every: int) -> str:
    """The linker's config as JSON text: one HTTP router over the fs
    namer, and with ``telemetry`` the io.l5d.jaxAnomaly telemeter at the
    reference's defaults (the reference test's reconWeight)."""
    cfg = {"routers": [{
        "protocol": "http", "label": "tele",
        "identifier": {"kind": "io.l5d.header.token"},
        "dtab": "/svc => /#/io.l5d.fs ;",
        "servers": [{"port": 0}],
        "client": {"failureAccrual": {"kind": accrual}}}],
        "namers": [{"kind": "io.l5d.fs", "rootDir": str(disco)}]}
    if telemetry:
        cfg["telemetry"] = [{"kind": "io.l5d.jaxAnomaly",
                             "trainEveryBatches": train_every,
                             "reconWeight": 1.0}]
    return json.dumps(cfg)


def batch_sizes(tap) -> dict:
    """Rows a batch took, device- and engine-scored together."""
    n = np.array([len(b["x"]) + (len(b["nat_scored"]["x"])
                                 if b.get("nat_scored") else 0)
                  for b in tap.batches])
    return {"batches": len(n), "mean": float(n.mean()),
            **{f"p{q}": float(np.percentile(n, q)) for q in (10, 50, 90, 99)},
            "max": int(n.max())}


def linker_gap_report(got, plain, x, snap, labels, dev: str,
                      what: str = "linker A") -> dict:
    """How kernel and plain scores of the window's rows part: the largest
    gap, the rows past ROW_TOL and 1e-3, and the five widest gaps with
    each row's scores, label and largest z-score; beside it, a witness
    of the same model's plain version on the CPU against the card's.
    Fails if a row is past TOL or more than ROW_SHARE of the rows are
    past ROW_TOL."""
    gap = np.abs(got - plain)
    cpu = plain_scores(snap, x, "cpu") if dev != "cpu" else plain
    wit = np.abs(cpu - plain)
    z = np.abs((x - snap.mu) / np.sqrt(snap.var + 1e-2)).max(axis=1)
    top = np.argsort(gap)[::-1][:5]
    out = {"kernel_vs_plain_max": float(gap.max()),
           "rows_past_row_tol": int((gap > ROW_TOL).sum()),
           "rows_past_1e-3": int((gap > 1e-3).sum()),
           "cpu_plain_vs_card_plain_max": float(wit.max()),
           "cpu_rows_past_row_tol": int((wit > ROW_TOL).sum()),
           "widest": [{"gap": float(gap[i]), "kernel": float(got[i]),
                       "plain": float(plain[i]), "cpu_plain": float(cpu[i]),
                       "label": float(labels[i]), "max_abs_z": float(z[i])}
                      for i in top]}
    print(f"{what}: kernel vs plain max|diff| {out['kernel_vs_plain_max']:.3e}, "
          f"{out['rows_past_row_tol']} of {len(gap)} rows past {ROW_TOL}, "
          f"{out['rows_past_1e-3']} past 1e-3; the plain version on the CPU "
          f"vs the card's: max {out['cpu_plain_vs_card_plain_max']:.3e}, "
          f"{out['cpu_rows_past_row_tol']} rows past {ROW_TOL}; widest: "
          + "; ".join(f"{w['gap']:.3e} (kernel {w['kernel']:.6f}, plain "
                      f"{w['plain']:.6f}, CPU plain {w['cpu_plain']:.6f}, "
                      f"label {w['label']:.0f}, max|z| {w['max_abs_z']:.1f})"
                      for w in out["widest"]))
    if out["kernel_vs_plain_max"] > TOL:
        raise AssertionError(
            f"{what}: kernel vs plain off by {out['kernel_vs_plain_max']} "
            f"> {TOL} on a row")
    if out["rows_past_row_tol"] > ROW_SHARE * len(gap):
        raise AssertionError(
            f"{what}: kernel vs plain: {out['rows_past_row_tol']} of "
            f"{len(gap)} rows past {ROW_TOL} > {ROW_SHARE:.0%}")
    return out


def linker_board_check(tele, tap, start: int, plain_by_id: dict,
                       what: str = "linker A") -> float:
    """The board against a fresh ScoreBoard folded in the same order: with
    the kernel's scores before fold ``start`` and the plain version's
    from it on. Returns the largest gap."""
    from linkerd_tpu_torch.telemetry.anomaly import ScoreBoard

    fresh = ScoreBoard(ttl_s=tele.cfg.scoreTtlSecs)
    for i, (dsts, s, eps) in enumerate(tap.folds):
        fresh.update_batch(dsts, s if i < start else
                           plain_by_id[batch_key(s)],
                           endpoints=eps)
    got, want = tele.board.scores.sample(), fresh.scores.sample()
    got_ep, want_ep = (tele.board.effective_endpoint_scores(),
                       fresh.effective_endpoint_scores())
    if sorted(got) != sorted(want) or sorted(got_ep) != sorted(want_ep):
        raise AssertionError(f"{what}: board keys differ from the fold")
    return max(max(abs(got[k] - want[k]) for k in got),
               max(abs(got_ep[k] - want_ep[k]) for k in got_ep))


def scored_checks(what: str, tele, tap, sent: int, launches: int,
                  dev: str) -> dict:
    """Every request recorded and every recorded row scored, with no
    drop and no scorer failure; one kernel launch a batch. Returns the
    launches, batches, batch sizes and ``_score_and_publish`` ms."""
    flat = tele.metrics.flatten()
    bad = {k: flat[f"anomaly/{k}"] for k in (
        "score_failures", "dropped_batches", "degraded")
        if flat[f"anomaly/{k}"]}
    recorded, scored = flat["anomaly/requests_total"], \
        flat["anomaly/scored_total"]
    drops = recorded - scored - len(tele.ring)
    print(f"{what}: {sent} requests, {recorded} recorded, "
          f"{scored} scored, ring drops {drops}")
    if bad or drops or scored != recorded or recorded != sent:
        raise AssertionError(
            f"{what}: {sent} sent, {recorded} recorded, {scored} "
            f"scored, {drops} dropped, {bad}")
    batches = flat["anomaly/batches"]
    expect = 0 if dev == "cpu" else batches
    if launches != expect or len(tap.scored) != batches:
        raise AssertionError(
            f"{what}: {launches} kernel launches, {batches} "
            f"batches, {len(tap.scored)} score calls")
    pub = np.asarray(tap.publish_ms)
    return dict(launches=launches, batches=batches,
                batch_sizes=batch_sizes(tap),
                score_and_publish_p50_ms=float(np.percentile(pub, 50)),
                score_and_publish_p99_ms=float(np.percentile(pub, 99)))


def window_checks(what: str, tele, tap, snap, start: int, first: int,
                  dev: str):
    """The window's kernel scores (score calls from ``start``, batches
    from ``first``, one model ``snap``) against the plain version, and the
    board against a plain fold. Returns the readings, the kernel and plain
    scores and the rows."""
    xs = [x for x, _ in tap.scored[start:]]
    got = np.concatenate([s for _, s in tap.scored[start:]])
    plain = plain_scores(snap, np.concatenate(xs), dev)
    cuts = np.cumsum([len(x) for x in xs])[:-1]
    plain_by_id = {batch_key(s): p for (_, s), p in zip(
        tap.scored[start:], np.split(plain, cuts))}
    gap = linker_board_check(tele, tap, start, plain_by_id, what)
    print(f"{what}: board vs plain fold {gap:.3e}")
    if gap > TOL:
        raise AssertionError(f"{what}: board off the plain fold "
                             f"by {gap} > {TOL}")
    wb = tap.batches[first:]
    rows = linker_gap_report(
        got, plain, np.concatenate(xs), snap,
        np.concatenate([b["labels"] for b in wb]), dev, what)
    held = dict(board_vs_plain_fold_max=gap, kernel_vs_plain=rows,
                kernel_vs_plain_max=rows["kernel_vs_plain_max"],
                window_rows=len(got))
    return held, got, plain, xs


async def linker_part(part: str, text: str, loads, flag, plans, dev: str):
    """One linker from ``text`` driven with the warm-up, then the labeled
    window with faults on. Part A turns training off for the window and
    holds its scores, board and AUC against the plain version; part B
    reads failure accrual; part C has no telemeter."""
    from linkerd_tpu_torch.core.tasks import monitor
    from linkerd_tpu_torch.lifecycle.promote import auc
    from linkerd_tpu_torch.linker import load_linker
    from linkerd_tpu_torch.ops.scoring import fused_anomaly_scores

    linker = load_linker(text, device=dev)
    await linker.start()
    port = linker.routers[0].server_ports[0]
    tele = linker.telemeters[0] if linker.telemeters else None
    tap = accrual = task = None
    out = {}
    try:
        if tele is not None:
            tap = LinkerTap(tele)
            task = monitor(asyncio.create_task(tele.run()),
                           what=f"telemeter-{type(tele).__name__}")
        if part == "B":
            accrual = AccrualTap()
        fused_anomaly_scores.launches = 0
        flag.value = 0
        warm = await linker_traffic(loads, port, plans[0])
        if tele is not None:
            await tap.settle(tele, task, f"{part} warm-up")
        snap = start = None
        if part == "A":
            tele.cfg.trainEveryBatches = 0
            snap, start, first = tele._scorer.snapshot(), len(tap.folds), \
                len(tap.batches)
        flag.value = 1
        window = await linker_traffic(loads, port, plans[1])
        if tele is not None:
            await tap.settle(tele, task, f"{part} window")
        flag.value = 0
        launches = fused_anomaly_scores.launches
        out["warmup"] = linker_traffic_checks(warm, f"{part} warm-up", False)
        out["window"] = linker_traffic_checks(window, f"{part} window", True)
        out["router_ms"] = linker_stages(linker)
        if tele is None:
            return out, launches
        out.update(scored_checks(
            f"linker {part}", tele, tap,
            len(warm["ms"]) + len(window["ms"]), launches, dev))
        routes = tele_routes()
        board = {d: tele.board.score_of(d) for d in routes}
        faulted = routes[:TELE_FAULTED]
        out["board_levels"] = {
            "faulted_min": min(board[d] for d in faulted),
            "calm_max": max(board[d] for d in routes[TELE_FAULTED:])}
        if part == "A":
            held, got, plain, xs = window_checks(
                "linker A", tele, tap, snap, start, first, dev)
            wb = tap.batches[first:]
            labels = np.concatenate([b["labels"] for b in wb])
            mask = np.concatenate([b["mask"] for b in wb])
            if len(labels) != len(got) or mask.min() < 1:
                raise AssertionError("linker A: window rows unlabeled")
            got_auc = auc(labels.tolist(), got.tolist())
            if not got_auc >= LINKER_AUC_MIN:
                raise AssertionError(f"linker A: AUC {got_auc} < "
                                     f"{LINKER_AUC_MIN}")
            lv = out["board_levels"]
            if not lv["faulted_min"] > lv["calm_max"]:
                raise AssertionError(f"linker A: board {board}")
            out.update(held, positives=int(labels.sum()), auc=got_auc)
            WINDOWS["linker"] = dict(x=np.concatenate(xs), snap=snap,
                                     kernel=got, plain=plain)
        if part == "B":
            out.update(removal_checks("linker B", linker, accrual))
        return out, launches
    finally:
        if accrual is not None:
            accrual.close()
        if task is not None:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
        await linker.close()


def removal_checks(what: str, linker, accrual) -> dict:
    """Failure accrual removed every replica of the faulted destinations
    and none of the calm ones; returns the removals and the failures
    before each endpoint's first."""
    faulted = tele_routes()[:TELE_FAULTED]
    removed = {f"{d}/{r}": accrual.removals.get(p, [])
               for (d, r), p in linker_endpoints(linker).items()}
    bad_calm = {k: v for k, v in removed.items()
                if v and k.rsplit("/", 1)[0] not in faulted}
    kept = [k for k, v in removed.items()
            if not v and k.rsplit("/", 1)[0] in faulted]
    if bad_calm or kept:
        raise AssertionError(f"{what}: calm endpoints removed {bad_calm}; "
                             f"faulted kept {kept}")
    return {"failures_before_first_removal": {
                k: v[0] for k, v in removed.items() if v},
            "removals": {k: len(v) for k, v in removed.items() if v}}


def linker_stages(linker) -> dict:
    """The router's own ms over the part (warm-up and window), from its
    metrics: the server's request latency and the stage timer's
    identification, binding, service and total, p50 and p99 each."""
    return stage_ms(linker.metrics.flatten(), "tele")


def stage_ms(flat: dict, label: str) -> dict:
    """``linker_stages`` of router ``label`` from flattened metrics."""
    out = {}
    for name, key in (("server", f"rt/{label}/server/request_latency_ms"),
                      *((s, f"rt/{label}/stage/{s}_ms") for s in (
                          "identification", "binding", "service",
                          "total"))):
        if f"{key}/p50" in flat:
            out[name] = {q: flat[f"{key}/{q}"] for q in ("p50", "p99")}
    return out


def linker_endpoints(linker) -> dict:
    """(destination, replica) -> backend port, from the fs namer's
    directory."""
    root = Path(linker.spec.namers[0]["rootDir"])
    out = {}
    for d in tele_routes():
        name = d.rsplit("/", 1)[1]
        for r, line in enumerate((root / name).read_text().splitlines()):
            out[(d, r)] = int(line.split()[1])
    return out


@contextlib.asynccontextmanager
async def linker_topology(seed: int, sizes=(LINKER_WARMUP, LINKER_WINDOW),
                          backend=None, load=None, conns: int = LINKER_CONNS):
    """Backends and load clients in child processes (spawn; ``backend``
    and ``load`` name their targets, the HTTP ones by default) and the fs
    namer's directory over them; yields ``(loads, flag, plans, disco)``
    (one plan of each of ``sizes`` requests over ``conns`` connections)
    and stops every process after."""
    import multiprocessing

    mp = multiprocessing.get_context("spawn")
    flag = mp.RawValue("b", 0)
    rng = np.random.default_rng(seed)
    plans = tuple(linker_plans(rng, n, conns) for n in sizes)
    loop = asyncio.get_running_loop()
    procs, backs, loads = [], [], []
    try:
        for i, dsts in enumerate(np.array_split(np.arange(TELE_ROUTES),
                                                LINKER_BACKEND_PROCS)):
            ours, theirs = mp.Pipe()
            p = mp.Process(target=backend or linker_backends, daemon=True,
                           args=(theirs, dsts.tolist(), flag, seed + i))
            p.start()
            procs.append(p)
            backs.append((ours, dsts))
        for _ in range(LINKER_LOAD_PROCS):
            ours, theirs = mp.Pipe()
            p = mp.Process(target=load or linker_load, args=(theirs,),
                           daemon=True)
            p.start()
            procs.append(p)
            loads.append((ours, p))
        ports = await asyncio.gather(*(loop.run_in_executor(None, c.recv)
                                       for c, _ in backs))
        with tempfile.TemporaryDirectory() as disco:
            disco = Path(disco)
            for (_, dsts), pp in zip(backs, ports):
                for j, d in enumerate(dsts):
                    (disco / f"tele-{d:02d}").write_text("".join(
                        f"127.0.0.1 {pp[j * LINKER_REPLICAS + r]}\n"
                        for r in range(LINKER_REPLICAS)))
            yield loads, flag, plans, disco
    finally:
        for conn, _ in backs + loads:
            try:
                conn.send(None)
            except OSError:
                pass
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join()


async def linker_phase(seed: int = 12, dev: str = "cuda",
                       parts=("A", "B", "C")):
    """Parts A (failure accrual none, training during the warm-up only),
    B (io.l5d.jaxAnomaly accrual at the reference's cadence) and C (no
    telemetry block: the router's own cost) on the same traffic, over
    ``linker_topology``. Returns the results and the kernel's launches
    on parts A and B (with ``parts=("A",)``, part A's alone)."""
    res = {}
    async with linker_topology(seed) as (loads, flag, plans, disco):
        res["part_a"], la = await linker_part(
            "A", linker_config(disco, True, "none", 1), loads, flag,
            plans, dev)
        if parts == ("A",):
            return res, la
        res["part_b"], lb = await linker_part(
            "B", linker_config(disco, True, "io.l5d.jaxAnomaly", 8),
            loads, flag, plans, dev)
        res["no_telemetry"], _ = await linker_part(
            "C", linker_config(disco, False, "none", 0), loads, flag,
            plans, dev)
    a, b, c = res["part_a"], res["part_b"], res["no_telemetry"]
    print(f"linker, seed {seed}: {TELE_ROUTES} destinations x "
          f"{LINKER_REPLICAS} replicas, {LINKER_CONNS} connections; part A "
          f"{a['launches']} launches for {a['batches']} batches, kernel vs "
          f"plain max|diff| {a['kernel_vs_plain_max']:.3e}, board vs plain "
          f"fold {a['board_vs_plain_fold_max']:.3e}, AUC {a['auc']:.4f}; "
          f"part B {b['launches']} launches, failures before first removal "
          f"{b['failures_before_first_removal']}")
    for name, r in (("A", a), ("B", b), ("C no telemetry", c)):
        for w in ("warmup", "window"):
            t = r[w]
            print(f"linker {name} {w}: {t['requests_per_s']:.0f} requests/s, "
                  f"p50 {t['p50_ms']:.3f} ms, p99 {t['p99_ms']:.3f} ms "
                  f"(calm p50 {t['calm_p50_ms']:.3f}, p99 "
                  f"{t['calm_p99_ms']:.3f})")
        print(f"linker {name}: the router's own ms (p50/p99): " + ", ".join(
            f"{k} {v['p50']:.3f}/{v['p99']:.3f}"
            for k, v in r["router_ms"].items()))
        if "batch_sizes" in r:
            print(f"linker {name}: batch sizes {r['batch_sizes']}, "
                  f"_score_and_publish p50 "
                  f"{r['score_and_publish_p50_ms']:.3f} ms p99 "
                  f"{r['score_and_publish_p99_ms']:.3f} ms")
    return res, a["launches"] + b["launches"]


# The fastpath phase: the same topology and traffic through a
# ``fastPath: true`` router, served by the native engine that the port
# builds from native/. Every retired request's engine row is drained into
# the telemeter's native ring on the controller's stats tick (1 s) and
# featurized a block at a time. Part A, nativeTier off: every row scored
# by the kernel. Part B, nativeTier primary: the telemeter's model
# published into the engine, which scores rows in its data plane. Part
# C: no telemetry block, the engine's own cost, beside the same traffic
# sent straight to the backends.
FASTPATH_NATIVE_SHARE = 0.9   # part B's window rows scored in the engine
SATURATION_S = 5.0            # each h1load reading, through and around C
ENGINE_TOL = 1e-5             # engine against the float32 forward
ENGINE_KERNEL_MAX, ENGINE_KERNEL_MEAN = 0.05, 0.01  # f32 engine vs bf16


def fastpath_config(disco: Path, tier, train_every: int) -> str:
    """The fastPath router over the fs namer as JSON text; with ``tier``
    the io.l5d.jaxAnomaly telemeter at the reference's defaults (the
    linker phase's reconWeight) and that nativeTier."""
    cfg = {"routers": [{
        "protocol": "http", "label": "tele", "fastPath": True,
        "dtab": "/svc => /#/io.l5d.fs ;", "servers": [{"port": 0}]}],
        "namers": [{"kind": "io.l5d.fs", "rootDir": str(disco)}]}
    if tier is not None:
        cfg["telemetry"] = [{"kind": "io.l5d.jaxAnomaly",
                             "trainEveryBatches": train_every,
                             "reconWeight": 1.0, "nativeTier": tier}]
    return json.dumps(cfg)


class FastPathTap:
    """Wraps, on a fastPath linker's telemeter, what the phase reads:
    every raw engine block consumed from the native ring (copied, in
    order), each batch taken, each score call's rows and scores, each
    per-route fold (device-scored or engine-scored), the host ms of
    ``_score_and_publish`` and the batches in flight. Once a phase sets
    ``model`` (see ``SnapTap``), each score call's model is kept in
    ``snaps``."""

    def __init__(self, tele):
        self.raw, self.batches, self.scored, self.folds = [], [], [], []
        self.publish_ms, self.inflight, self._native = [], 0, False
        self.model, self.snaps = None, []
        scorer, ring = tele._ensure_scorer(), tele.native_ring
        score, consume = scorer.score, ring.consume
        take, publish = tele._take_batch, tele._score_and_publish
        means, native = tele._publish_route_means, tele._publish_native_batch

        def consuming(m):
            v = consume(m)
            self.raw.append(v.copy())
            return v

        def taking():
            b = take()
            if b is not None:
                self.batches.append(b)
            return b

        async def scoring(x):
            if self.model is not None:
                self.snaps.append(self.model)
            s = await score(x)
            self.scored.append((x, s))
            return s

        def folding(dsts, inv, scores):
            self.folds.append(("engine" if self._native else "device",
                               list(dsts), inv.copy(), scores.copy()))
            return means(dsts, inv, scores)

        def publishing_native(ns):
            self._native = True
            try:
                return native(ns)
            finally:
                self._native = False

        async def publishing(s, b):
            self.inflight += 1
            t0 = time.perf_counter()
            try:
                return await publish(s, b)
            finally:
                self.publish_ms.append((time.perf_counter() - t0) * 1e3)
                self.inflight -= 1

        scorer.score, ring.consume = scoring, consuming
        tele._take_batch, tele._score_and_publish = taking, publishing
        tele._publish_route_means = folding
        tele._publish_native_batch = publishing_native

    async def settle(self, tele, task, sent: int, what: str) -> None:
        """Until ``sent`` engine rows have reached the telemeter and
        every one is scored and published."""
        t0 = time.monotonic()
        while (tele._requests.value < sent or len(tele.native_ring)
               or self.inflight or tele._scored.value != tele._requests.value):
            if task.done():
                task.result()
                raise AssertionError(f"fastpath {what}: run() ended early")
            if time.monotonic() - t0 > LINKER_SETTLE_S:
                raise AssertionError(
                    f"fastpath {what}: {tele._requests.value} rows of "
                    f"{sent} requests reached the telemeter, "
                    f"{tele._scored.value} scored after {LINKER_SETTLE_S} s")
            await asyncio.sleep(1e-3)

    def window_rows(self, first: int, start: int):
        """Rows the device scored from batch ``first`` (score call
        ``start``) on: features, kernel scores and each row's
        destination."""
        dsts = [b["nat_dsts"][int(i)] for b in self.batches[first:]
                if b["nat_inv"] is not None for i in b["nat_inv"]]
        return (np.concatenate([x for x, _ in self.scored[start:]]),
                np.concatenate([s for _, s in self.scored[start:]]), dsts)


def fastpath_board_check(tele, tap, start: int, plain: list) -> float:
    """The board against a fresh ScoreBoard folded in the same order:
    device folds from ``start`` on with the plain version's scores of
    the same rows (``plain``, one array a score call from ``start``),
    every other fold as it was. Returns the largest gap."""
    import types

    from linkerd_tpu_torch.telemetry.anomaly import (
        JaxAnomalyTelemeter, ScoreBoard,
    )

    fresh = types.SimpleNamespace(board=ScoreBoard(ttl_s=tele.cfg.scoreTtlSecs))
    device = 0
    for kind, dsts, inv, scores in tap.folds:
        if kind == "device":
            if device >= start:
                p = plain[device - start]
                if len(p) != len(scores):
                    raise AssertionError("fastpath A: folds out of step "
                                         "with score calls")
                scores = p
            device += 1
        JaxAnomalyTelemeter._publish_route_means(fresh, dsts, inv, scores)
    got, want = tele.board.scores.sample(), fresh.board.scores.sample()
    if sorted(got) != sorted(want):
        raise AssertionError("fastpath A: board keys differ from the fold")
    return max(abs(got[k] - want[k]) for k in got)


def engine_check(tap, snap, blob: bytes, window_raw: int, route_dst,
                 dev: str) -> dict:
    """Part B's in-plane scores, on the window's engine-scored rows: the
    engine's scores against ``score_eval`` of the published blob and
    the float32 plain forward of ``snap`` within ENGINE_TOL, and against
    the kernel within ENGINE_KERNEL_MAX / MEAN, all on the rows' engine
    features (``engine_features``: every row the engine retired, in
    order, for its per-row drift)."""
    import dataclasses

    import torch

    from linkerd_tpu_torch import native
    from linkerd_tpu_torch.models.convert import params_from_numpy
    from linkerd_tpu_torch.ops.scoring import (
        fused_anomaly_scores, fused_anomaly_scores_plain,
    )
    from linkerd_tpu_torch.telemetry.linerate import (
        NATIVE_COL_SCORE, NATIVE_COL_SCORED,
    )

    rows = np.concatenate(tap.raw)
    x = engine_features(rows, route_dst)
    win = np.zeros(len(rows), bool)
    win[sum(len(r) for r in tap.raw[:window_raw]):] = True
    pick = win & (rows[:, NATIVE_COL_SCORED] > 0.5)
    got, xw = rows[pick, NATIVE_COL_SCORE], torch.tensor(x[pick], device=dev)
    lib = native.score_eval(blob, x[pick])
    params = params_from_numpy(snap.params, dev)
    mu = torch.tensor(snap.mu, device=dev)
    var = torch.tensor(snap.var, device=dev)
    f32 = fused_anomaly_scores_plain(
        params, xw, dataclasses.replace(snap.cfg, compute_dtype=torch.float32),
        mu, var).cpu().numpy()
    kernel = fused_anomaly_scores(params, xw, snap.cfg, mu, var).cpu().numpy()
    out = {"rows": int(pick.sum()),
           "engine_vs_score_eval_max": float(np.abs(got - lib).max()),
           "engine_vs_f32_plain_max": float(np.abs(got - f32).max()),
           "engine_vs_kernel_max": float(np.abs(got - kernel).max()),
           "engine_vs_kernel_mean": float(np.abs(got - kernel).mean())}
    print(f"fastpath B: {out['rows']} engine-scored window rows; engine vs "
          f"score_eval {out['engine_vs_score_eval_max']:.3e}, vs float32 "
          f"plain {out['engine_vs_f32_plain_max']:.3e}, vs kernel max "
          f"{out['engine_vs_kernel_max']:.3e} mean "
          f"{out['engine_vs_kernel_mean']:.3e}")
    if not out["rows"]:
        raise AssertionError("fastpath B: no engine-scored window rows")
    if max(out["engine_vs_score_eval_max"],
           out["engine_vs_f32_plain_max"]) > ENGINE_TOL:
        raise AssertionError(f"fastpath B: engine scores off by more than "
                             f"{ENGINE_TOL}: {out}")
    if out["engine_vs_kernel_max"] > ENGINE_KERNEL_MAX or \
            out["engine_vs_kernel_mean"] > ENGINE_KERNEL_MEAN:
        raise AssertionError(f"fastpath B: engine vs kernel {out}")
    return out


async def fastpath_part(part: str, text: str, loads, flag, plans, disco,
                        dev: str):
    """One fastPath linker from ``text`` driven with the warm-up, then
    the window with faults on. Part A holds the kernel's scores, the
    board and AUC (rows labeled by their destination) against the plain
    version; part B holds the engine's in-plane scores and its share of
    the window; part C has no telemeter."""
    from linkerd_tpu_torch.core.tasks import monitor
    from linkerd_tpu_torch.lifecycle.promote import auc
    from linkerd_tpu_torch.linker import load_linker
    from linkerd_tpu_torch.ops.scoring import fused_anomaly_scores

    linker = load_linker(text, device=dev)
    await linker.start()
    router = linker.routers[0]
    port = router.server_ports[0]
    tele = linker.telemeters[0] if linker.telemeters else None
    tap = task = None
    out = {}
    sent = 0
    try:
        if tele is not None:
            tap = FastPathTap(tele)
            task = monitor(asyncio.create_task(tele.run()),
                           what=f"telemeter-{type(tele).__name__}")
        fused_anomaly_scores.launches = 0
        flag.value = 0
        warm = await linker_traffic(loads, port, plans[0])
        sent += len(warm["ms"])
        if tele is not None:
            await tap.settle(tele, task, sent, f"{part} warm-up")
            tele.cfg.trainEveryBatches = 0
            snap, first, start = tele._scorer.snapshot(), len(tap.batches), \
                len(tap.scored)
            window_raw = len(tap.raw)
            if part == "B":
                # the window's model: published once more, so the engine
                # serves what the device holds (a fit may have followed
                # the last periodic publish)
                await tele.refresh_native_weights()
                blob = tele._last_blob
                nat0, sc0 = tele._native_scored.value, tele._scored.value
        flag.value = 1
        window = await linker_traffic(loads, port, plans[1])
        sent += len(window["ms"])
        if tele is not None:
            await tap.settle(tele, task, sent, f"{part} window")
        flag.value = 0
        launches = fused_anomaly_scores.launches
        router.controller._export_stats()
        engine = router.controller.engine.stats()
        out["warmup"] = linker_traffic_checks(warm, f"fastpath {part} warm-up",
                                              False)
        out["window"] = linker_traffic_checks(
            window, f"fastpath {part} window", True)
        served = sum(int(r["requests"]) for r in engine["routes"].values())
        out["engine"] = {"requests": served,
                         "features_dropped": engine.get("features_dropped"),
                         "native_scorer": {
                             k: engine["native_scorer"].get(k) for k in (
                                 "scored", "unscored", "weights", "version")}}
        if served != sent or engine.get("features_dropped"):
            raise AssertionError(f"fastpath {part}: {sent} sent, engine "
                                 f"{out['engine']}")
        if tele is None:
            out["saturation"] = await saturation(port, disco)
            return out, launches
        flat = tele.metrics.flatten()
        bad = {k: flat[f"anomaly/{k}"] for k in (
            "score_failures", "dropped_batches", "degraded")
            if flat[f"anomaly/{k}"]}
        rows, scored = flat["anomaly/requests_total"], \
            flat["anomaly/scored_total"]
        drops = flat["anomaly/native_ring_dropped"]
        print(f"fastpath {part}: {sent} requests, {rows} engine rows, "
              f"{scored} scored ({flat['anomaly/native_scored_total']} in "
              f"the engine), ring drops {drops}")
        if bad or drops or scored != rows or rows != sent:
            raise AssertionError(
                f"fastpath {part}: {sent} sent, {rows} rows, {scored} "
                f"scored, {drops} dropped, {bad}")
        batches = flat["anomaly/batches"]
        with_device = sum(len(b["x"]) > 0 for b in tap.batches)
        expect = 0 if dev == "cpu" else with_device
        if launches != expect or len(tap.scored) != with_device:
            raise AssertionError(
                f"fastpath {part}: {launches} kernel launches, "
                f"{with_device} batches with device rows of {batches}, "
                f"{len(tap.scored)} score calls")
        pub = np.asarray(tap.publish_ms)
        out.update(launches=launches, batches=batches,
                   batches_with_device_rows=with_device,
                   batch_sizes=batch_sizes(tap),
                   score_and_publish_p50_ms=float(np.percentile(pub, 50)),
                   score_and_publish_p99_ms=float(np.percentile(pub, 99)))
        routes = tele_routes()
        faulted = set(routes[:TELE_FAULTED])
        board = {d: tele.board.score_of(d) for d in routes}
        out["board_levels"] = {
            "faulted_min": min(board[d] for d in faulted),
            "calm_max": max(board[d] for d in routes[TELE_FAULTED:])}
        if part == "A":
            x, got, dsts = tap.window_rows(first, start)
            if len(dsts) != len(got) or len(got) != len(window["ms"]):
                raise AssertionError(f"fastpath A: {len(got)} window rows "
                                     f"scored, {len(window['ms'])} sent")
            plain = plain_scores(snap, x, dev)
            cuts = np.cumsum([len(xx) for xx, _ in tap.scored[start:]])[:-1]
            gap = fastpath_board_check(tele, tap, start,
                                       np.split(plain, cuts))
            print(f"fastpath A: board vs plain fold {gap:.3e}")
            if gap > TOL:
                raise AssertionError(f"fastpath A: board off the plain fold "
                                     f"by {gap} > {TOL}")
            labels = np.array([d in faulted for d in dsts], np.float32)
            rows_gap = linker_gap_report(got, plain, x, snap, labels, dev,
                                         what="fastpath A")
            got_auc = auc(labels.tolist(), got.tolist())
            if not got_auc >= LINKER_AUC_MIN:
                raise AssertionError(f"fastpath A: AUC {got_auc} < "
                                     f"{LINKER_AUC_MIN}")
            lv = out["board_levels"]
            if not lv["faulted_min"] > lv["calm_max"]:
                raise AssertionError(f"fastpath A: board {board}")
            out.update(board_vs_plain_fold_max=gap, kernel_vs_plain=rows_gap,
                       kernel_vs_plain_max=rows_gap["kernel_vs_plain_max"],
                       window_rows=len(got), positives=int(labels.sum()),
                       auc=got_auc)
        if part == "B":
            nat = tele._native_scored.value - nat0
            share = nat / max(tele._scored.value - sc0, 1)
            print(f"fastpath B: {share:.4f} of the window's rows scored in "
                  f"the engine")
            if share < FASTPATH_NATIVE_SHARE:
                raise AssertionError(f"fastpath B: native share {share} < "
                                     f"{FASTPATH_NATIVE_SHARE}")
            out["native_scored_share_window"] = share
            out["engine_vs"] = engine_check(
                tap, snap, blob, window_raw, router.controller._route_dst,
                dev)
        return out, launches
    finally:
        if task is not None:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
        await linker.close()


async def saturation(port: int, disco: Path) -> dict:
    """Closed-loop readings by the C++ load generator (``h2bench h1load``,
    LINKER_CONNS connections, one request in flight each, SATURATION_S
    seconds): through the engine at ``port`` to one calm destination,
    then straight to that destination's first replica."""
    from linkerd_tpu_torch.native import _build as native_build

    exe = native_build.build("h2bench")
    d = TELE_ROUTES // 4
    backend = int((disco / f"tele-{d:02d}").read_text().split()[1])
    out = {"destination": f"tele-{d:02d}"}
    for name, p in (("through_engine", port), ("direct", backend)):
        proc = await asyncio.create_subprocess_exec(
            str(exe), "h1load", "127.0.0.1", str(p), f"tele-{d:02d}",
            str(LINKER_CONNS), str(SATURATION_S), "--conns-per-worker",
            str(LINKER_CONNS), stdout=asyncio.subprocess.PIPE)
        stdout, _ = await asyncio.wait_for(proc.communicate(),
                                           SATURATION_S + 30)
        out[name] = json.loads(stdout.decode().strip().splitlines()[-1])
        if proc.returncode or out[name]["errors"] or not out[name]["reqs"]:
            raise AssertionError(f"h1load {name}: rc {proc.returncode}, "
                                 f"{out[name]}")
    print(f"h1load, {LINKER_CONNS} connections to {out['destination']}: "
          f"through the engine {out['through_engine']['rps']:.0f} "
          f"requests/s, p50 {out['through_engine']['p50_ms']:.3f} ms, p99 "
          f"{out['through_engine']['p99_ms']:.3f} ms; direct "
          f"{out['direct']['rps']:.0f} requests/s, p50 "
          f"{out['direct']['p50_ms']:.3f} ms, p99 "
          f"{out['direct']['p99_ms']:.3f} ms")
    return out


async def direct_traffic(loads, disco: Path, n: int) -> dict:
    """``n`` calm requests straight to the backends, no router: each
    connection to replica 0 of one calm destination."""
    ports, plans = [], []
    for i, plan in enumerate(np.array_split(np.zeros(n, np.int64),
                                            LINKER_CONNS)):
        d = TELE_FAULTED + i % (TELE_ROUTES - TELE_FAULTED)
        line = (disco / f"tele-{d:02d}").read_text().splitlines()[0]
        ports.append(int(line.split()[1]))
        plans.append(plan + d)
    res = await linker_traffic(loads, ports, plans)
    return linker_traffic_checks(res, "direct", False)


# Part D: the sharded, TLS, guarded and streaming engine. The same
# topology and a calm run of LINKER_WARMUP requests through a fastPath
# router with ``workers: 4``, a cleartext and a native-TLS server (half
# the connections each), ``connectionGuard`` and ``streamScoring``, the
# telemeter at ``nativeTier: off`` with training off (every row scored
# by the kernel under one model); beside that traffic, slow clients that
# send half a head and wait, 101 tunnels to an echo upstream, and probes
# of one single-replica destination through both servers.
SHARD_WORKERS = 4
SHARD_SLOW = 8                # slow clients
SHARD_HEADER_BUDGET_MS = 1000
SHARD_TUNNEL_IDLE_MS = 2000
SHARD_TUNNELS = 8
SHARD_TUNNEL_S = 3.0          # each tunnel exchanges frames this long
SHARD_SAMPLE_FRAMES = 8
SHARD_PROBES = 8              # answers compared, cleartext against TLS
SHARD_LABEL = "shard"


def shard_config(disco: Path, cert: str, key: str) -> str:
    return json.dumps({
        "routers": [{
            "protocol": "http", "label": SHARD_LABEL, "fastPath": True,
            "workers": SHARD_WORKERS, "dtab": "/svc => /#/io.l5d.fs ;",
            "servers": [{"port": 0}, {"port": 0, "tls": {
                "certPath": cert, "keyPath": key}}],
            "connectionGuard": {"headerBudgetMs": SHARD_HEADER_BUDGET_MS,
                                "tunnelIdleMs": SHARD_TUNNEL_IDLE_MS},
            "streamScoring": {"action": "observe",
                              "sampleEveryFrames": SHARD_SAMPLE_FRAMES}}],
        "namers": [{"kind": "io.l5d.fs", "rootDir": str(disco)}],
        "telemetry": [{"kind": "io.l5d.jaxAnomaly", "trainEveryBatches": 0,
                       "reconWeight": 1.0, "nativeTier": "off"}]})


def tunnel_child(conn) -> None:
    """Child process: an upstream that answers a 101 upgrade, then
    echoes each chunk as ``echo:<chunk>``; on each ``(port, n, seconds)``
    from ``conn``, ``n`` tunnels through the router at ``port`` (Host
    ``ws``), each exchanging frames for ``seconds``; sends back each
    tunnel's echoed rounds (or its error). ``None`` ends it."""
    async def on_conn(reader, writer):
        try:
            await reader.readuntil(b"\r\n\r\n")
            writer.write(b"HTTP/1.1 101 Switching Protocols\r\n"
                         b"Upgrade: echo\r\nConnection: Upgrade\r\n\r\n")
            await writer.drain()
            while chunk := await reader.read(65536):
                writer.write(b"echo:" + chunk)
                await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()

    async def one(port: int, seconds: float) -> int:
        r, w = await asyncio.open_connection("127.0.0.1", port)
        try:
            w.write(b"GET /ws HTTP/1.1\r\nHost: ws\r\nConnection: Upgrade"
                    b"\r\nUpgrade: echo\r\n\r\n")
            head = await asyncio.wait_for(r.readuntil(b"\r\n\r\n"), 10)
            if b" 101 " not in head.split(b"\r\n")[0]:
                raise AssertionError(f"no upgrade: {head!r}")
            rounds, t0 = 0, time.monotonic()
            while time.monotonic() - t0 < seconds:
                payload = b"%08d" % rounds + b"x" * 56
                w.write(payload)
                await w.drain()
                got = await asyncio.wait_for(
                    r.readexactly(5 + len(payload)), 10)
                if got != b"echo:" + payload:
                    raise AssertionError(f"tunnel echoed {got!r}")
                rounds += 1
                await asyncio.sleep(0.01)
            return rounds
        finally:
            w.close()

    async def main():
        srv = await asyncio.start_server(on_conn, "127.0.0.1", 0)
        conn.send(srv.sockets[0].getsockname()[1])
        loop = asyncio.get_running_loop()
        while (msg := await loop.run_in_executor(None, conn.recv)) \
                is not None:
            port, n, seconds = msg
            res = await asyncio.gather(*(one(port, seconds)
                                         for _ in range(n)),
                                       return_exceptions=True)
            conn.send([r if isinstance(r, int) else repr(r) for r in res])
        srv.close()

    asyncio.run(main())


async def slow_client(port: int) -> float:
    """Half a request head, then wait: seconds until the router closes
    the connection."""
    r, w = await asyncio.open_connection("127.0.0.1", port)
    try:
        w.write(b"GET / HTTP/1.1\r\nHost: tele-")
        await w.drain()
        t0 = time.monotonic()
        rest = await asyncio.wait_for(r.read(), LINKER_SETTLE_S)
        if rest:
            raise AssertionError(f"shard D: a slow client got {rest!r}")
        return time.monotonic() - t0
    finally:
        w.close()


async def raw_answer(port: int, host: str, cafile=None) -> bytes:
    """The bytes of one GET's answer on a fresh connection (TLS against
    ``cafile`` as ``localhost``), with ``Connection: close``."""
    import ssl

    ctx = ssl.create_default_context(cafile=cafile) if cafile else None
    r, w = await asyncio.open_connection(
        "127.0.0.1", port, ssl=ctx,
        server_hostname="localhost" if ctx else None)
    try:
        w.write(f"GET / HTTP/1.1\r\nHost: {host}\r\n"
                f"Connection: close\r\n\r\n".encode())
        await w.drain()
        return await asyncio.wait_for(r.read(), 30)
    finally:
        w.close()


def shard_worker_checks(stats: dict, flat: dict, label: str = SHARD_LABEL,
                        n_workers: int = SHARD_WORKERS,
                        what: str = "shard D") -> dict:
    """Every worker accepted connections and the merged view equals the
    sum of the workers; ``rt/<label>/fastpath/worker/<i>/*`` exported
    for each."""
    workers = stats["workers"]
    accepted = [int(w["accepted"]) for w in workers]
    requests = [sum(int(r["requests"]) for r in w["routes"].values())
                for w in workers]
    merged = sum(int(r["requests"]) for r in stats["routes"].values())
    if len(workers) != n_workers or min(accepted) <= 0:
        raise AssertionError(f"{what}: workers accepted {accepted}")
    if stats["accepted"] != sum(accepted) or merged != sum(requests):
        raise AssertionError(
            f"{what}: merged accepted {stats['accepted']}, requests "
            f"{merged}; the workers' {accepted}, {requests}")
    for host, r in stats["routes"].items():
        parts = sum(int(w["routes"].get(host, {}).get("requests", 0))
                    for w in workers)
        if int(r["requests"]) != parts or sum(r["hist"]) != parts:
            raise AssertionError(f"{what}: route {host} merged {r} vs "
                                 f"the workers' {parts}")
    exported = [flat.get(f"rt/{label}/fastpath/worker/{i}/accepted")
                for i in range(n_workers)]
    if exported != accepted:
        raise AssertionError(f"{what}: exported worker/<i>/accepted "
                             f"{exported} vs {accepted}")
    return {"accepted": accepted, "requests": requests,
            "merged_requests": merged}


async def fastpath_part_d(loads, flag, plans, disco: Path, dev: str):
    """Part D over ``linker_topology``: returns its results and the
    kernel's launches while its traffic ran."""
    import multiprocessing

    from linkerd_tpu_torch.core.tasks import monitor
    from linkerd_tpu_torch.linker import load_linker
    from linkerd_tpu_torch.ops.scoring import fused_anomaly_scores
    from linkerd_tpu_torch.telemetry.linerate import (
        NATIVE_COL_KIND, NATIVE_KIND_TUNNEL,
    )

    mp = multiprocessing.get_context("spawn")
    work = Path(tempfile.mkdtemp(prefix="shard-"))
    ours, theirs = mp.Pipe()
    child = mp.Process(target=tunnel_child, args=(theirs,), daemon=True)
    child.start()
    loop = asyncio.get_running_loop()
    linker = task = None
    try:
        ws_port = await loop.run_in_executor(None, ours.recv)
        (disco / "ws").write_text(f"127.0.0.1 {ws_port}\n")
        # one replica of a calm destination: its answers are the same
        # bytes whichever server carries the request
        calm = (disco / f"tele-{TELE_ROUTES - 1:02d}").read_text()
        (disco / "tele-ident").write_text(calm.splitlines()[0] + "\n")
        cert, key = cli_certs(work)
        linker = load_linker(shard_config(disco, cert, key), device=dev)
        router = linker.routers[0]
        if type(router).__name__ != "_FastPathRouter":
            raise AssertionError("shard D: the router stepped back to the "
                                 "Python data plane")
        ctl = router.controller
        await linker.start()
        clear, tls = router.server_ports
        tele = linker.telemeters[0]
        tap = FastPathTap(tele)
        snap = tele._scorer.snapshot()  # training off: the one model
        task = monitor(asyncio.create_task(tele.run()),
                       what=f"telemeter-{type(tele).__name__}")
        half = LINKER_CONNS // 2
        targets = [clear] * half + [(tls, cert)] * half
        fused_anomaly_scores.launches = 0
        flag.value = 0
        slow = [asyncio.ensure_future(slow_client(clear))
                for _ in range(SHARD_SLOW)]
        ours.send((clear, SHARD_TUNNELS, SHARD_TUNNEL_S))
        tunnels = loop.run_in_executor(None, ours.recv)
        t0 = time.perf_counter()
        both, outs = await linker_traffic(loads, targets, plans[0],
                                          split=True)
        wall = time.perf_counter() - t0
        rounds = await tunnels
        closed_s = await asyncio.gather(*slow)
        probes = []
        for i in range(SHARD_PROBES + 1):  # the first installs the route
            pair = (await raw_answer(clear, "tele-ident"),
                    await raw_answer(tls, "tele-ident", cert))
            if i:
                probes.append(pair)
        sent = len(both["ms"]) + 2 * (SHARD_PROBES + 1)
        # every tunnel has closed: the engines' tables hold each one's
        # samples, and each sample is a row on its way to the ring
        streams = ctl.engine.streams()
        samples = sum(int(e["samples"]) for w in streams["workers"]
                      for e in w["by_stream"].values())
        await tap.settle(tele, task, sent + samples, "D")
        launches = fused_anomaly_scores.launches
        ctl._export_stats()
        stats = ctl.engine.stats()
        flat = linker.metrics.flatten()
        sentinel = ctl.stream_sentinel.snapshot()
    finally:
        if task is not None:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
        if linker is not None:
            await linker.close()
        try:
            ours.send(None)
        except OSError:
            pass
        child.join(timeout=10)
        if child.is_alive():
            child.terminate()
            child.join()
        shutil.rmtree(work, ignore_errors=True)

    out = {"wall_s": wall, "traffic": {
        server: linker_traffic_checks(res, f"shard D {server}", False)
        for server, res in zip(("cleartext", "tls"), outs)}}
    out["traffic"]["both"] = linker_traffic_checks(both, "shard D", False)
    # where the run's time went: its slowest answer, and the rate over
    # its second half of answers (the first carries the cold misses)
    done, mid = np.sort(both["t"]), len(both["t"]) // 2
    out["traffic"]["both"].update(
        max_ms=float(both["ms"].max()),
        second_half_requests_per_s=(len(done) - mid) / (
            done[-1] - done[mid - 1]))
    out["workers"] = shard_worker_checks(stats, flat)
    if out["workers"]["merged_requests"] != sent:
        raise AssertionError(f"shard D: {sent} requests sent, the engine "
                             f"served {out['workers']['merged_requests']}")
    # TLS: the engine terminated every TLS connection itself
    tls_conns = half + SHARD_PROBES + 1
    out["tls"] = {k: int(stats["tls"][k]) for k in (
        "handshakes", "failures", "alpn_http1")}
    if out["tls"]["handshakes"] != tls_conns or out["tls"]["failures"]:
        raise AssertionError(f"shard D: {out['tls']} for {tls_conns} TLS "
                             f"connections")
    bad = [p for p in probes if p[0] != p[1] or not p[0].startswith(
        b"HTTP/1.1 200")]
    if bad:
        raise AssertionError(f"shard D: cleartext and TLS answers differ: "
                             f"{bad[0]}")
    budget = SHARD_HEADER_BUDGET_MS / 1e3 + 1.0
    guard = stats["guard"]
    out["guard"] = {"slowloris_closed": int(guard["slowloris_closed"]),
                    "slow_closed_after_s": sorted(closed_s)}
    if guard["slowloris_closed"] < SHARD_SLOW or max(closed_s) > budget:
        raise AssertionError(f"shard D: slow clients {out['guard']}, "
                             f"budget {budget} s")
    # tunnels: opened, counted, sampled into kind-2 rows that reach the
    # sentinel and the telemeter's batches alike
    errs = [r for r in rounds if not isinstance(r, int) or r <= 0]
    rows = np.concatenate(tap.raw)
    kind2 = int((rows[:, NATIVE_COL_KIND] == NATIVE_KIND_TUNNEL).sum())
    sent_samples = sum(int(e["samples"])
                       for e in sentinel["by_stream"].values())
    out["streams"] = {
        "tunnels_opened": int(streams["tunnels_opened"]),
        "tunnel_rounds": rounds, "engine_samples": samples,
        "kind2_rows_drained": kind2, "sentinel_samples": sent_samples,
        "sentinel_streams": sentinel["count"],
        "exported_tunnels_opened": flat.get(
            f"rt/{SHARD_LABEL}/fastpath/streams/tunnels_opened")}
    if errs or out["streams"]["tunnels_opened"] != SHARD_TUNNELS or \
            out["streams"]["exported_tunnels_opened"] != SHARD_TUNNELS:
        raise AssertionError(f"shard D: tunnels {out['streams']}")
    if not kind2 or not kind2 == samples == sent_samples:
        raise AssertionError(f"shard D: kind-2 rows {out['streams']}")
    # every row drained (requests and samples), scored, one launch a batch
    total = flat["anomaly/requests_total"]
    scored = flat["anomaly/scored_total"]
    drops = flat["anomaly/native_ring_dropped"]
    if total != len(rows) or scored != total or drops or \
            total != sent + samples or stats.get("features_dropped"):
        raise AssertionError(
            f"shard D: {len(rows)} rows drained, {total} counted, {scored} "
            f"scored, {drops} dropped; {sent} requests + {samples} samples")
    with_device = sum(len(b["x"]) > 0 for b in tap.batches)
    sizes = batch_sizes(tap)
    expect = 0 if dev == "cpu" else with_device
    if launches != expect or len(tap.scored) != with_device or \
            sizes["max"] > TELE_BATCH:
        raise AssertionError(
            f"shard D: {launches} launches, {with_device} batches with "
            f"device rows, {len(tap.scored)} score calls, sizes {sizes}")
    # each score call's rows against the plain version of the one model
    # (the tap holds each call's rows with its scores, so the check does
    # not depend on how the fan-in interleaved the workers' rows)
    x = np.concatenate([xx for xx, _ in tap.scored])
    got = np.concatenate([s for _, s in tap.scored])
    plain = plain_scores(snap, x, dev)
    cuts = np.cumsum([len(xx) for xx, _ in tap.scored])[:-1]
    board_gap = fastpath_board_check(tele, tap, 0, np.split(plain, cuts))
    if board_gap > TOL:
        raise AssertionError(f"shard D: board off the plain fold by "
                             f"{board_gap} > {TOL}")
    gap = linker_gap_report(got, plain, x, snap, np.zeros(len(got)), dev,
                            what="shard D")
    pub = np.asarray(tap.publish_ms)
    out.update(launches=launches, batches=flat["anomaly/batches"],
               batches_with_device_rows=with_device, batch_sizes=sizes,
               rows=len(rows), requests=sent,
               board_vs_plain_fold_max=board_gap, kernel_vs_plain=gap,
               kernel_vs_plain_max=gap["kernel_vs_plain_max"],
               score_and_publish_p50_ms=float(np.percentile(pub, 50)),
               score_and_publish_p99_ms=float(np.percentile(pub, 99)))
    print(f"fastpath D: {SHARD_WORKERS} workers accepted "
          f"{out['workers']['accepted']} (merged {stats['accepted']}), "
          f"served {out['workers']['requests']}; {out['tls']['handshakes']} "
          f"TLS handshakes for {tls_conns} connections; slow clients closed "
          f"after {min(closed_s):.3f}-{max(closed_s):.3f} s "
          f"(guard {guard['slowloris_closed']}); {SHARD_TUNNELS} tunnels, "
          f"{sum(rounds)} rounds, {kind2} kind-2 rows (engine {samples}, "
          f"sentinel {sent_samples}); {len(rows)} rows, {launches} launches "
          f"for {with_device} batches (max {sizes['max']} rows), board vs "
          f"plain fold {board_gap:.3e}")
    for server, t in out["traffic"].items():
        print(f"fastpath D {server}: {t['requests_per_s']:.0f} requests/s, "
              f"p50 {t['p50_ms']:.3f} ms, p99 {t['p99_ms']:.3f} ms" + (
                  f", max {t['max_ms']:.3f} ms; second half "
                  f"{t['second_half_requests_per_s']:.0f} requests/s"
                  if server == "both" else ""))
    return out, launches

async def fastpath_phase(seed: int = 12, dev: str = "cuda",
                         parts=("A", "B", "C", "D")):
    """Parts A (nativeTier off: training during the warm-up, every row
    through the kernel), B (nativeTier primary, a fit every 8 batches in
    the warm-up: rows scored in the engine) and C (no telemetry block),
    and the window's traffic straight to the backends, then part D (the
    sharded, TLS, guarded and streaming engine), over
    ``linker_topology``. Returns the results and the kernel's launches
    on parts A, B and D (with ``parts=("D",)``, part D's alone)."""
    res = {}
    async with linker_topology(seed) as (loads, flag, plans, disco):
        if parts == ("D",):
            return await fastpath_part_d(loads, flag, plans, disco, dev)
        res["part_a"], la = await fastpath_part(
            "A", fastpath_config(disco, "off", 1), loads, flag, plans,
            disco, dev)
        res["part_b"], lb = await fastpath_part(
            "B", fastpath_config(disco, "primary", 8), loads, flag, plans,
            disco, dev)
        res["no_telemetry"], _ = await fastpath_part(
            "C", fastpath_config(disco, None, 0), loads, flag, plans, disco,
            dev)
        res["direct"] = await direct_traffic(loads, disco, LINKER_WINDOW)
        res["part_d"], ld = await fastpath_part_d(loads, flag, plans, disco,
                                                  dev)
    a, b, c, d = (res[k] for k in ("part_a", "part_b", "no_telemetry",
                                   "direct"))
    print(f"fastpath, seed {seed}: part A {a['launches']} launches for "
          f"{a['batches']} batches, kernel vs plain max|diff| "
          f"{a['kernel_vs_plain_max']:.3e}, board vs plain fold "
          f"{a['board_vs_plain_fold_max']:.3e}, AUC {a['auc']:.4f}; part B "
          f"{b['launches']} launches for {b['batches_with_device_rows']} of "
          f"{b['batches']} batches with device rows, native share "
          f"{b['native_scored_share_window']:.4f}")
    for name, r in (("A", a), ("B", b), ("C no telemetry", c)):
        for w in ("warmup", "window"):
            t = r[w]
            print(f"fastpath {name} {w}: {t['requests_per_s']:.0f} "
                  f"requests/s, p50 {t['p50_ms']:.3f} ms, p99 "
                  f"{t['p99_ms']:.3f} ms (calm p50 {t['calm_p50_ms']:.3f}, "
                  f"p99 {t['calm_p99_ms']:.3f})")
        if "batch_sizes" in r:
            print(f"fastpath {name}: batch sizes {r['batch_sizes']}, "
                  f"_score_and_publish p50 "
                  f"{r['score_and_publish_p50_ms']:.3f} ms p99 "
                  f"{r['score_and_publish_p99_ms']:.3f} ms")
    print(f"direct to the backends: {d['requests_per_s']:.0f} requests/s, "
          f"p50 {d['p50_ms']:.3f} ms, p99 {d['p99_ms']:.3f} ms; fastpath C "
          f"window calm p99 {c['window']['calm_p99_ms']:.3f} ms")
    return res, a["launches"] + b["launches"] + ld


# The control phase: the linker phase's topology with the router bound
# through the port's namerd (a spawned process serving the HTTP control
# API over an in-memory store and the io.l5d.fs namer) with
# ``interpreter: {kind: io.l5d.namerd.http}``, and the telemeter's
# ``control:`` block at the reference's defaults. Part A (no failover
# map): faults on replica 0 of the 4 faulted destinations; the
# score-weighted balancer drains those replicas to a trickle. Part B:
# both replicas of the 4 go sick, with ``failover: /svc/tele-DD:
# /svc/tele-DD-b``, and a fifth with one deliberately unsafe entry
# (``/svc/tele-04: /svc/tele-04``, a self-shift: a cycle); the reactor
# publishes one
# verified override per sick cluster through namerd, the router rebinds
# over its namerd watch, traffic moves to the ``-b`` clusters, and each
# override reverts after the faults clear; then faults toggled faster
# than quorum x intervalMs publish nothing. Part B's model trains on at
# the reference's cadence, and nothing may actuate on the calm traffic
# between the cold-start guard's lift and the fault.
# ``admissionControl`` with a base limit of 256 in both (floor 0.25: 64,
# the connections in flight).
CONTROL_BASE_DTAB = "/svc => /#/io.l5d.fs ;"
# one more destination goes sick in part B, under a self-shift: a cycle
CONTROL_UNSAFE = (f"/svc/tele-{TELE_FAULTED:02d}",) * 2
CONTROL_ADMISSION = 256              # admissionControl.maxConcurrency
CONTROL_SEGMENT = 2048    # requests a traffic segment while part B runs
CONTROL_WAIT_S = 30.0     # longest wait for a publish or a revert
CONTROL_HOLD_S = 0.5      # faults stay on this long after the publishes
# The oscillation: faults on, then off, per cycle; a cycle (0.2 s) is
# under quorum x intervalMs. Its dose is small because the model's
# latency-drift feature reads the calm requests after a fault as
# anomalous for about a second (the per-destination latency baseline
# returns slowly): 10 cycles of 30 ms left an aftershock that held a
# cluster over enterThreshold for a quorum of steps after the toggles
# (on an NVIDIA H100 80GB HBM3 host; ROADMAP Queue 3). At this dose the
# board smooths the toggles and the levels have stayed under
# enterThreshold, so the segment holds that the toggles move nothing,
# not the governor's quorum and dwell: those are held on scripted
# levels by tests/test_torch_control.py (the oscillation scenario). The
# phase prints whether the segment reached enterThreshold.
CONTROL_OSC_ON_S = 0.02
CONTROL_OSC_OFF_S = 0.18
CONTROL_OSC_CYCLES = 5
CONTROL_FIT_EVERY = 8     # the second warm-up's cadence: the reference's
# The cold-start guard: no actuator before this many batches. The default
# (50) lifts inside the first warm-up, where the model still trains on a
# router slowed by a fit a batch, and the reactor published and reverted
# overrides on calm traffic there (ROADMAP Queue 3, open); the two
# warm-ups take ~170 batches at the linker phase's ~95 rows a batch
# (PERF.md §5), and the guard lifts near their end. Part B fails on any
# publish, revert, reject or governor transition between the guard's
# lift and the fault.
CONTROL_WARMUP_BATCHES = 150
# Part A's weights: the balancers' view is read this often while the
# window runs, and averaged from the window's median answer to the drain
# (its first connection done). At one instant the frozen model's view
# of calm replicas swings with the host's pace, most of all in the drain,
# where a few connections remain: read after it, the faulted replicas
# ranked above a calm one in 1 of 16 runs of ``--repeat-control-a 16``,
# averaged in none, the margin 0.204-0.858 (on an NVIDIA H100 80GB HBM3
# host; PERF.md §6).
CONTROL_WEIGHT_SAMPLE_S = 0.1
CONTROL_STEADY_SAMPLES = 10
CONTROL_READ_FOLDS = 20
CONTROL_KEYS = ("intervalMs", "weightThreshold", "weightFloor",
                "admissionThreshold", "admissionFloor", "enterThreshold",
                "exitThreshold", "quorum", "cooldownS", "warmupBatches")


def failover_backends(conn) -> None:
    """Child process: the failover cluster ``tele-DD-b`` of each faulted
    destination, one backend each answering ``tele-DD-b/0`` padded to
    LINKER_BODY bytes (never faulted)."""
    from linkerd_tpu_torch.protocol.http.message import Response
    from linkerd_tpu_torch.protocol.http.server import serve
    from linkerd_tpu_torch.router.service import FnService

    def backend(name: str):
        body = name.encode().ljust(LINKER_BODY, b"x")

        async def handle(req):
            rsp = Response(200, body=body)
            rsp.headers.set("l5d-fault-label", "0")
            return rsp

        return FnService(handle)

    async def main():
        servers = [await serve(backend(f"tele-{d:02d}-b/0"))
                   for d in range(TELE_FAULTED)]
        conn.send([s.bound_port for s in servers])
        await asyncio.get_running_loop().run_in_executor(None, conn.recv)
        for s in servers:
            await s.close()

    asyncio.run(main())


def control_namerd(conn, disco: str) -> None:
    """Child process: the port's namerd, the ``default`` namespace at
    CONTROL_BASE_DTAB in an in-memory store over the io.l5d.fs namer at
    ``disco``, served by its HTTP control API; sends the port, serves
    until told to stop."""
    from linkerd_tpu_torch.core import Dtab, Path as NPath
    from linkerd_tpu_torch.namer.fs import FsNamer
    from linkerd_tpu_torch.namerd import InMemoryDtabStore, Namerd
    from linkerd_tpu_torch.namerd.http_api import HttpControlService
    from linkerd_tpu_torch.protocol.http.server import serve

    async def main():
        namerd = Namerd(
            InMemoryDtabStore({"default": Dtab.read(CONTROL_BASE_DTAB)}),
            namers=[(NPath.read("/io.l5d.fs"), FsNamer(disco))])
        server = await serve(HttpControlService(namerd))
        conn.send(server.bound_port)
        await asyncio.get_running_loop().run_in_executor(None, conn.recv)
        await server.close()
        await namerd.close()

    asyncio.run(main())


def control_config(namerd_port: int, failover: bool) -> str:
    """The control phase's linker as JSON text: the linker phase's router
    with no dtab of its own, bound through namerd, with
    ``admissionControl``; the telemeter as in the linker phase's part A
    with a ``control:`` block at the reference's defaults but for
    ``warmupBatches`` (with ``failover`` the reactor's map, else none)."""
    control = {"namespace": "default",
               "namerdAddress": f"127.0.0.1:{namerd_port}",
               "warmupBatches": CONTROL_WARMUP_BATCHES}
    if failover:
        control["failover"] = {
            **{d: f"{d}-b" for d in tele_routes()[:TELE_FAULTED]},
            CONTROL_UNSAFE[0]: CONTROL_UNSAFE[1]}
    return json.dumps({
        "routers": [{
            "protocol": "http", "label": "tele",
            "identifier": {"kind": "io.l5d.header.token"},
            "interpreter": {"kind": "io.l5d.namerd.http",
                            "dst": f"/$/inet/127.0.0.1/{namerd_port}",
                            "namespace": "default"},
            "admissionControl": {"maxConcurrency": CONTROL_ADMISSION},
            "servers": [{"port": 0}],
            "client": {"failureAccrual": {"kind": "none"}}}],
        "telemetry": [{"kind": "io.l5d.jaxAnomaly", "trainEveryBatches": 1,
                       "reconWeight": 1.0, "control": control}]})


class HeldHeap:
    """The interpreter's heap held out of its full collections while a
    control part runs: ``freeze`` collects, then moves every live object
    to the permanent generation (``gc.freeze``), so a full collection
    scans only what was made after it. Unfrozen, a full collection on the
    router's loop took 0.13-0.53 s with the heap of imports and earlier
    runs, every 5-8 s; the stall held every request in flight, the model
    read the delay as a fault, and the reactor's levels rose by up to 0.5
    for a few steps after it (``--repeat-control-b``, on an NVIDIA H100
    80GB HBM3 host; PERF.md §6). Frozen, they took 9-101 ms. Objects
    still die by their counts. Records each full collection's ms but its
    own; ``close`` unfreezes."""

    def __init__(self):
        self.ms, self._began, self._own = [], 0.0, False
        gc.callbacks.append(self._time)
        self.freeze()

    def freeze(self) -> None:
        self._own = True
        try:
            gc.collect()
        finally:
            self._own = False
        gc.freeze()

    def _time(self, phase: str, info: dict) -> None:
        if info["generation"] != 2 or self._own:
            return
        if phase == "start":
            self._began = time.monotonic()
        else:
            self.ms.append((time.monotonic() - self._began) * 1e3)

    def close(self) -> None:
        gc.callbacks.remove(self._time)
        gc.unfreeze()


class ControlTap:
    """Records, on a linker's control loop, each admission factor and,
    with a reactor, each step's instant and cluster levels; and, on a
    namerd watch of the namespace, each dtab with the instant it
    arrived."""

    def __init__(self, ctl, namerd_port: int):
        from linkerd_tpu_torch.control.reactor import NamerdHttpStoreClient

        self.factors, self.levels, self.dtabs = [], [], []
        step = ctl.admission.step

        def stepping():
            f = step()
            self.factors.append(f)
            return f

        ctl.admission.step = stepping
        if ctl.reactor is not None:
            reactor, rstep = ctl.reactor, ctl.reactor.step

            async def rstepping(now=None):
                self.levels.append((time.monotonic(),
                                    reactor.cluster_levels()))
                return await rstep(now)

            ctl.reactor.step = rstepping
        self.client = NamerdHttpStoreClient(f"127.0.0.1:{namerd_port}")
        self.watch = asyncio.create_task(self._watch())

    async def _watch(self):
        async for dtab in self.client.watch("default"):
            self.dtabs.append((time.monotonic(), dtab.show))

    async def close(self) -> None:
        self.watch.cancel()
        await asyncio.gather(self.watch, return_exceptions=True)
        await self.client.aclose()


async def wait_for(pred, what: str, timeout: float = CONTROL_WAIT_S,
                   task=None) -> float:
    """Polls ``pred`` every 5 ms; returns the monotonic instant it held.
    Fails after ``timeout`` or when ``task`` (the telemeter) ends."""
    t0 = time.monotonic()
    while not pred():
        if task is not None and task.done():
            task.result()
            raise AssertionError(f"control: run() ended waiting for {what}")
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"control: no {what} after {timeout} s")
        await asyncio.sleep(5e-3)
    return time.monotonic()


def level_summary(levels, t0: float, t1: float, enter: float,
                  exit_: float) -> dict:
    """The failover clusters' levels the reactor observed at its steps in
    [t0, t1): the largest, the median and the least of each step's
    highest, the longest run of steps with one cluster at or over
    ``enter`` and the longest with one at or over ``exit_``."""
    steps = [{c: v for c, v in lv.items() if c != CONTROL_UNSAFE[0]}
             for t, lv in levels if t0 <= t < t1]
    if not steps:
        return {"steps": 0}

    def longest(bar):
        best = 0
        for c in steps[0]:
            run = 0
            for s in steps:
                run = run + 1 if s[c] >= bar else 0
                best = max(best, run)
        return best

    top = [max(s.values()) for s in steps]
    return {"steps": len(steps), "max": max(top),
            "p50": float(np.median(top)), "min": min(top),
            "longest_run_over_enter": longest(enter),
            "longest_run_over_exit": longest(exit_)}


def level_trace(levels, start: float, zero: float = None) -> list:
    """Each step's highest failover-cluster level from ``start``, with its
    instant in s from ``zero`` (default ``start``)."""
    zero = start if zero is None else zero
    return [(round(t - zero, 3), round(max(
        v for c, v in lv.items() if c != CONTROL_UNSAFE[0]), 3))
        for t, lv in levels if t >= start]


def settled(levels, cfg) -> bool:
    """The reactor's last ``quorum`` steps saw every failover cluster at
    or under ``exitThreshold``."""
    last = levels[-cfg.quorum:]
    return len(last) == cfg.quorum and all(
        v <= cfg.exitThreshold for _, lv in last
        for c, v in lv.items() if c != CONTROL_UNSAFE[0])


async def reactor_timeline(linker, tele, task, loads, port, flag, rng,
                           ctap):
    """Part B's events while traffic segments run back to back: faults on
    both replicas of the faulted destinations and of CONTROL_UNSAFE's
    (``faulting``'s flag 3) until every override is
    published (and CONTROL_HOLD_S more), off until every override is
    reverted; once the levels are calm again and after the governor's
    dwell, CONTROL_OSC_CYCLES fault toggles, then the dwell and a quorum
    of steps again. Returns the segments and the instants."""
    def counter(name):
        # the counter itself: flattening the tree, with its histograms,
        # on every poll would take the router's loop
        return linker.metrics.counter("control", "reactor", name).value

    cfg = tele.control.cfg
    stop, segments = asyncio.Event(), []

    async def pump():
        while not stop.is_set():
            segments.append(await linker_traffic(
                loads, port, linker_plans(rng, CONTROL_SEGMENT)))

    pumping = asyncio.create_task(pump())
    ev = {"start": time.monotonic()}
    reactor = tele.control.reactor
    try:
        await asyncio.sleep(1.0)   # traffic flowing, calm
        await wait_for(lambda: tele.control._warmed,
                       "the end of the control loop's warm-up", task=task)
        # a key's dwell runs from its first observation: the calm
        # traffic runs on past it, so the fault can trip the governor
        await asyncio.sleep(cfg.cooldownS + 0.5)
        ev["fault"] = time.monotonic()
        # no actuator fires before the guard lifts, so from its lift to
        # here the calm traffic must have moved nothing
        counts = {n: counter(n) for n in (
            "overrides_published", "overrides_reverted",
            "overrides_rejected")}
        moved = {c: s["transitions"] for c, s in
                 reactor.status()["governor"].items() if s["transitions"]}
        if any(counts.values()) or moved:
            raise AssertionError(
                f"control B: actuated on calm traffic before the fault: "
                f"{counts}, governor transitions {moved}")
        ev["guard_lifted"] = ctap.levels[0][0]
        flag.value = 3
        ev["published"] = await wait_for(
            lambda: counter("overrides_published") >= TELE_FAULTED,
            "publish of every override", task=task)
        await asyncio.sleep(CONTROL_HOLD_S)
        ev["clear"] = time.monotonic()
        flag.value = 0
        ev["reverted"] = await wait_for(
            lambda: counter("overrides_reverted") >= TELE_FAULTED,
            "revert of every override", task=task)
        # the oscillation starts on a calm mesh: every failover cluster
        # at or under exitThreshold for a quorum of steps, and the
        # governor's dwell past
        await wait_for(lambda: settled(ctap.levels, cfg), "calm levels "
                       "after the reverts", task=task)
        await asyncio.sleep(cfg.cooldownS)
        ev["osc"] = time.monotonic()
        ev["osc_counts"] = (counter("overrides_published"),
                            counter("overrides_reverted"))
        for _ in range(CONTROL_OSC_CYCLES):
            flag.value = 3
            await asyncio.sleep(CONTROL_OSC_ON_S)
            flag.value = 0
            await asyncio.sleep(CONTROL_OSC_OFF_S)
        ev["osc_toggled"] = time.monotonic()
        await asyncio.sleep(cfg.cooldownS
                            + cfg.quorum * cfg.intervalMs / 1e3 + 0.5)
        ev["osc_end"] = time.monotonic()
        ev["osc_after"] = (counter("overrides_published"),
                           counter("overrides_reverted"))
    except AssertionError as e:
        # what the reactor saw when the timeline stalled
        now = time.monotonic()
        last = level_summary(ctap.levels, now - 3, now, cfg.enterThreshold,
                             cfg.exitThreshold)
        before = (level_summary(ctap.levels, 0.0, ev["fault"],
                                cfg.enterThreshold, cfg.exitThreshold)
                  if "fault" in ev else None)
        eff = tele.board.effective_scores()
        calm = sorted(v for d, v in eff.items()
                      if d in tele_routes()[TELE_FAULTED:])
        print(f"control B: each step's highest failover-cluster level, "
              f"s from the timeline's start: "
              f"{level_trace(ctap.levels, ev['start'])}")
        raise AssertionError(
            f"{e}; levels {reactor.cluster_levels()}, governor "
            f"{reactor.status()['governor']}, the last 3 s {last}, "
            f"before the fault {before}, calm destinations now "
            f"{calm[0] if calm else None}-{calm[-1] if calm else None} "
            f"(median {np.median(calm) if calm else None}), "
            f"events {ev}") from None
    finally:
        flag.value = 0
        stop.set()
        await pumping
    return segments, ev


def merge_segments(segs) -> dict:
    res = {k: np.concatenate([s[k] for s in segs])
           for k in ("dst", "status", "right", "ms", "t", "who")}
    res["wall"] = sum(s["wall"] for s in segs)
    return res


def replica_shares(res: dict, dsts) -> dict:
    """Per destination index, the share of its answered requests that
    replica 0 served (of replicas 0 and 1)."""
    out = {}
    for d in dsts:
        mine = res["who"][res["dst"] == d]
        n0, n1 = int((mine == 0).sum()), int((mine == 1).sum())
        out[d] = n0 / max(1, n0 + n1)
    return out


def replica_hostports(disco: Path) -> dict:
    """hostport -> (destination index, replica), from the fs namer's
    directory."""
    out = {}
    for d in range(TELE_ROUTES):
        for r, line in enumerate(
                (disco / f"tele-{d:02d}").read_text().splitlines()):
            host, port = line.split()
            out[f"{host}:{port}"] = (d, r)
    return out


class WeightSampler:
    """Part A: the control loop's per-endpoint weights (``status()``),
    read every CONTROL_WEIGHT_SAMPLE_S while the window's traffic runs,
    each beside its monotonic instant."""

    def __init__(self, ctl):
        self.samples = []
        self._task = asyncio.create_task(self._run(ctl))

    async def _run(self, ctl):
        while True:
            self.samples.append((time.monotonic(),
                                 ctl.status()["endpoint_weights"]))
            await asyncio.sleep(CONTROL_WEIGHT_SAMPLE_S)

    async def close(self):
        self._task.cancel()
        await asyncio.gather(self._task, return_exceptions=True)


def steady_weights(res: dict, plans, samples) -> list:
    """The weight samples from the window's median answer to the instant
    its first connection finished its plan (the drain starts there:
    fewer connections, another pace). ``res`` holds the answers in
    ``plans``' order."""
    offs = np.cumsum([0] + [len(p) for p in plans])
    drain = min(float(res["t"][a:b].max())
                for a, b in zip(offs[:-1], offs[1:]))
    steady = [w for t, w in samples
              if np.median(res["t"]) <= t <= drain]
    if len(steady) < CONTROL_STEADY_SAMPLES:
        raise AssertionError(f"control A: {len(steady)} weight samples "
                             f"before the drain, under "
                             f"{CONTROL_STEADY_SAMPLES}")
    return steady


def calm_score_p50(tap, start: int) -> dict:
    """How the model reads calm destinations: the median score of their
    rows in the warm-up's last CONTROL_READ_FOLDS folds and in the
    window (the folds from ``start``)."""
    calm = set(tele_routes()[TELE_FAULTED:])

    def p50(folds):
        return float(np.median(np.concatenate([
            np.asarray(s)[[d in calm for d in dsts]]
            for dsts, s, _ in folds])))

    return {"warmup_end": p50(tap.folds[:start][-CONTROL_READ_FOLDS:]),
            "window": p50(tap.folds[start:])}


def weighting_checks(res: dict, ctl, disco: Path, plans,
                     samples) -> dict:
    """Part A: each faulted replica's share of its destination over the
    second half of the window well below a half, and its requests over
    the window above 0; each calm
    destination's replicas near an even split; the control loop's
    weights, averaged over the second half up to the drain
    (``steady_weights``), down on the faulted replicas alone."""
    half = res["t"] >= np.median(res["t"])
    second = {k: v[half] for k, v in res.items() if k != "wall"}
    faulted = range(TELE_FAULTED)
    calm = range(TELE_FAULTED, TELE_ROUTES)
    whole, late = replica_shares(res, faulted), replica_shares(second,
                                                              faulted)
    calm_shares = replica_shares(res, calm)
    counts = {d: int(((res["dst"] == d) & (res["who"] == 0)).sum())
              for d in faulted}
    steady = steady_weights(res, plans, samples)
    n_steady = len(steady)
    weights = {hp: float(np.mean([w[hp] for w in steady]))
               for hp in steady[-1]}
    end = ctl.status()["endpoint_weights"]
    where = replica_hostports(disco)
    sick = {hp: w for hp, w in weights.items()
            if where[hp][0] < TELE_FAULTED and where[hp][1] == 0}
    rest = [w for hp, w in weights.items() if hp not in sick]

    def margin(w: dict) -> float:
        return min(v for hp, v in w.items() if hp not in sick) - max(
            w[hp] for hp in sick)
    out = {"faulted_replica_share": {f"tele-{d:02d}": whole[d]
                                     for d in faulted},
           "faulted_replica_share_second_half": {
               f"tele-{d:02d}": late[d] for d in faulted},
           "faulted_replica_requests": {f"tele-{d:02d}": counts[d]
                                        for d in faulted},
           "calm_replica0_share_min": min(calm_shares.values()),
           "calm_replica0_share_max": max(calm_shares.values()),
           "faulted_replica_weights": sorted(sick.values()),
           "other_weights_min": min(rest),
           "steady_weight_samples": n_steady,
           "weight_margin": margin(weights),
           "instant_weight_margin_min": min(margin(w) for w in steady),
           "end_weight_margin": margin(end),
           "end_faulted_replica_weights": sorted(end[hp] for hp in sick),
           "end_other_weights_min": min(w for hp, w in end.items()
                                        if hp not in sick)}
    print("control A: faulted replicas' share of their destination "
          + ", ".join(f"tele-{d:02d} {whole[d]:.3f} (second half "
                      f"{late[d]:.3f}, {counts[d]} requests)"
                      for d in faulted)
          + f"; calm replica 0 share {out['calm_replica0_share_min']:.3f}"
          f"-{out['calm_replica0_share_max']:.3f}; weights over "
          f"{n_steady} samples to the drain: faulted "
          + ", ".join(f"{w:.3f}" for w in out["faulted_replica_weights"])
          + f", others from {out['other_weights_min']:.3f} (after the "
          f"drain: faulted up to "
          f"{max(out['end_faulted_replica_weights']):.3f}, others from "
          f"{out['end_other_weights_min']:.3f})")
    if len(sick) != TELE_FAULTED or not max(sick.values()) < min(rest):
        raise AssertionError(f"control A: mean weights to the drain "
                             f"{weights}")
    if not all(late[d] < 0.25 and counts[d] > 0 for d in faulted):
        raise AssertionError(
            f"control A: faulted replicas' share {late} (second half), "
            f"requests {counts}: not drained to a trickle above 0")
    if not 0.3 < out["calm_replica0_share_min"] <= \
            out["calm_replica0_share_max"] < 0.7:
        raise AssertionError(f"control A: calm replicas unevenly split "
                             f"{calm_shares}")
    return out


def shift_checks(res: dict, ev: dict, dtabs) -> dict:
    """Part B, read on the namespace watch and at the load clients: one
    publish and one revert of each override, never the unsafe one, the
    namespace back to its bytes; every request of a faulted destination
    started after its first failover answer and before the first revert
    answered by its failover cluster; and the latencies."""
    from linkerd_tpu_torch.core import Dtab

    base = Dtab.read(CONTROL_BASE_DTAB).show
    start = res["t"] - res["ms"] / 1e3
    faulted = tele_routes()[:TELE_FAULTED]
    appeared, gone = {}, {}
    prev = set(base.split(";"))
    if dtabs[0][1] != base:
        raise AssertionError(f"control B: namespace starts {dtabs[0][1]!r}")
    for t, show in dtabs:
        now = set(show.split(";"))
        if t < ev["fault"] and show != base:
            raise AssertionError(f"control B: namespace {show!r} before "
                                 f"the fault")
        for d in faulted:
            entry = f"{d} => {d}-b"
            if entry in now and entry not in prev:
                appeared.setdefault(d, []).append(t)
            if entry in prev and entry not in now:
                gone.setdefault(d, []).append(t)
        if f"{CONTROL_UNSAFE[0]} => {CONTROL_UNSAFE[1]}" in now:
            raise AssertionError(f"control B: the unsafe entry was "
                                 f"published: {show}")
        prev = now
    if any(len(appeared.get(d, ())) != 1 or len(gone.get(d, ())) != 1
           for d in faulted):
        rel = {k: {d: [round(x - ev["fault"], 3) for x in v]
                   for d, v in m.items()}
               for k, m in (("publishes", appeared), ("reverts", gone))}
        raise AssertionError(f"control B: {rel} s from the fault (one "
                             f"publish and one revert each per sick "
                             f"cluster)")
    if dtabs[-1][1] != base:
        raise AssertionError(f"control B: namespace ends {dtabs[-1][1]!r}, "
                             f"not {base!r}")
    first_revert = min(v[0] for v in gone.values())
    moved, first_b = 0, {}
    for i, d in enumerate(faulted):
        mine = res["dst"] == i
        b = mine & (res["who"] >= FAILOVER_WHO)
        if not b.any():
            raise AssertionError(f"control B: no request for {d} answered "
                                 f"by {d}-b")
        j = int(np.argmin(np.where(b, res["t"], np.inf)))
        first_b[d] = float(res["t"][j])
        window = mine & (start > res["t"][j]) & (res["t"] < first_revert)
        wrong = window & (res["who"] < FAILOVER_WHO)
        if wrong.any() or not window.any():
            raise AssertionError(
                f"control B: {int(wrong.sum())} of {int(window.sum())} "
                f"requests for {d} after the shift not answered by {d}-b")
        moved += int(window.sum())
        back = mine & (start > max(gone[d]) + 1.0)
        if not (back.any() and (res["who"][back] < FAILOVER_WHO).all()):
            raise AssertionError(f"control B: traffic for {d} did not "
                                 f"return after the revert")
    ms = lambda a, b: (b - a) * 1e3  # noqa: E731
    return {
        "fault_to_first_publish_ms": ms(ev["fault"], min(
            v[0] for v in appeared.values())),
        "fault_to_last_publish_ms": ms(ev["fault"], max(
            v[0] for v in appeared.values())),
        "fault_to_first_failover_answer_ms": ms(ev["fault"],
                                                min(first_b.values())),
        "clear_to_first_revert_ms": ms(ev["clear"], first_revert),
        "clear_to_last_revert_ms": ms(ev["clear"], max(
            v[0] for v in gone.values())),
        "requests_moved": moved,
    }


async def trained_window_checks(what: str, tele, tap, start: int,
                                first: int, dev: str) -> dict:
    """A window whose model trained as it scored: the board against a
    plain fold of the kernel's own scores, and the kernel against the
    plain version on the window's rows (score calls from ``start``,
    batches from ``first``) under the model the window ended with. Call
    after the main path's launches are read: it launches the kernel."""
    gap = linker_board_check(tele, tap, len(tap.folds), {}, what)
    print(f"{what}: board vs plain fold of the kernel's scores {gap:.3e}")
    if gap > TOL:
        raise AssertionError(f"{what}: board off the plain fold "
                             f"by {gap} > {TOL}")
    x = np.concatenate([x for x, _ in tap.scored[start:]])
    labels = np.concatenate([b["labels"] for b in tap.batches[first:]])
    snap = tele._scorer.snapshot()
    got = np.concatenate([await tele._scorer.score(x[i:i + 1024])
                          for i in range(0, len(x), 1024)])
    rows = linker_gap_report(got, plain_scores(snap, x, dev), x, snap,
                             labels, dev, what)
    return dict(board_vs_plain_fold_max=gap, kernel_vs_plain=rows,
                kernel_vs_plain_max=rows["kernel_vs_plain_max"],
                window_rows=len(got))


async def control_part(part: str, text: str, loads, flag, plans, disco,
                       namerd_port: int, dev: str):
    """One linker from ``text`` with the control loop: the warm-up
    (training every batch, then the same calm traffic again at the
    reference's cadence of a fit every CONTROL_FIT_EVERY batches, so the
    model last learns the router's pace without a fit every batch), then
    with training off part A's labeled window with faults on replica 0 of
    the faulted destinations (the weigher on one model: a model training
    on a lasting fault learns it, and the faulted replicas' weights come
    back), or part B's ``reactor_timeline`` with the model still training
    at the reference's cadence, as a deployment's does (a frozen model
    reads the router's faster pace as anomalous, mesh-wide, and the
    reactor then acts on calm traffic). Holds what the linker phase
    holds (every row scored, one launch a batch, kernel and board against
    plain) and the control loop's own checks."""
    from linkerd_tpu_torch.core.tasks import monitor
    from linkerd_tpu_torch.linker import load_linker
    from linkerd_tpu_torch.ops.scoring import fused_anomaly_scores

    linker = load_linker(text, device=dev)
    await linker.start()
    port = linker.routers[0].server_ports[0]
    tele = linker.telemeters[0]
    ctl = tele.control
    tap = LinkerTap(tele)
    ctap = ControlTap(ctl, namerd_port)
    heap = HeldHeap()
    task = monitor(asyncio.create_task(tele.run()),
                   what="telemeter-control")
    what = f"control {part}"
    out = {"thresholds": {k: getattr(ctl.cfg, k) for k in CONTROL_KEYS}}
    try:
        fused_anomaly_scores.launches = 0
        flag.value = 0
        warm = await linker_traffic(loads, port, plans[0])
        tele.cfg.trainEveryBatches = CONTROL_FIT_EVERY
        warm = merge_segments([warm, await linker_traffic(loads, port,
                                                          plans[0])])
        await tap.settle(tele, task, f"{part} warm-up")
        heap.freeze()       # the warm-up's rows too, before the window
        start, first = len(tap.folds), len(tap.batches)
        if part == "A":
            tele.cfg.trainEveryBatches = 0
            snap = tele._scorer.snapshot()
            flag.value = 2
            sampler = WeightSampler(ctl)
            try:
                window = await linker_traffic(loads, port, plans[1])
            finally:
                await sampler.close()
            flag.value = 0
            ev = None
        else:
            segs, ev = await reactor_timeline(
                linker, tele, task, loads, port, flag,
                np.random.default_rng(len(plans[0])), ctap)
            window = merge_segments(segs)
        tele.cfg.trainEveryBatches = 0
        await tap.settle(tele, task, f"{part} window")
        await asyncio.sleep(0.3)     # the namespace watch catches up
        launches = fused_anomaly_scores.launches
        out["warmup"] = linker_traffic_checks(warm, f"{what} warm-up", False)
        out["window"] = linker_traffic_checks(
            window, f"{what} window", True,
            TELE_FAULTED + (part == "B"))
        out.update(scored_checks(what, tele, tap,
                                 len(warm["ms"]) + len(window["ms"]),
                                 launches, dev))
        if part == "A":
            held = window_checks(what, tele, tap, snap, start, first,
                                 dev)[0]
        else:
            held = await trained_window_checks(what, tele, tap, start,
                                               first, dev)
        out.update(held)
        out["gc_full_ms"] = [round(ms, 1) for ms in heap.ms]
        flat = linker.metrics.flatten()
        status = ctl.status()
        out["admission"] = {
            "factor_min": min(ctap.factors),
            "limit_min": round(CONTROL_ADMISSION * min(ctap.factors)),
            "sheds": flat["rt/tele/server/admission/shed_total"],
            "status": status["admission"]}
        counters = {k.rsplit("/", 1)[1]: v for k, v in flat.items()
                    if k.startswith("control/reactor/")}
        out["control_steps"] = flat["control/steps"]
        if status["steps"] != flat["control/steps"] or not \
                status["warmed_up"] or out["control_steps"] < 1 or \
                round(ctl.admission.factor, 4) != \
                status["admission"]["factor"]:
            raise AssertionError(f"{what}: status {status}")
        if part == "A":
            out.update(weighting_checks(window, ctl, disco, plans[1],
                                        sampler.samples))
            out["calm_score_p50"] = calm_score_p50(tap, start)
            out.update(publishes=0, reverts=0, rejects=0, flaps=0)
            if status["actuators"]["mesh_reactor"] or counters:
                raise AssertionError(f"{what}: a reactor without failover")
        else:
            c = ctl.cfg
            out["levels"] = {
                name: level_summary(ctap.levels, ev[a], ev[b],
                                    c.enterThreshold, c.exitThreshold)
                for name, a, b in (
                    ("calm", "start", "fault"),
                    ("calm_since_guard", "guard_lifted", "fault"),
                    ("faulted", "fault", "clear"),
                    ("recovery", "clear", "reverted"),
                    ("settle", "reverted", "osc"),
                    ("oscillation", "osc", "osc_toggled"),
                    ("after", "osc_toggled", "osc_end"))}
            out["events_s"] = {k: v - ev["fault"] for k, v in ev.items()
                               if isinstance(v, float)}
            out["level_trace"] = level_trace(ctap.levels, ev["start"],
                                             ev["fault"])
            print(f"{what}: events (s from the fault) {out['events_s']}; "
                  f"levels {out['levels']}")
            try:
                out.update(shift_checks(window, ev, ctap.dtabs))
            except AssertionError as e:
                # the driver's log keeps standard error's end: what the
                # reactor saw from the oscillation on goes there too
                raise AssertionError(
                    f"{e}; events (s from the fault) "
                    f"{ {k: round(v, 3) for k, v in out['events_s'].items()} }"
                    f"; each step's highest level from the oscillation "
                    f"{level_trace(ctap.levels, ev['osc'], ev['fault'])}"
                ) from None
            osc = (ev["osc_after"][0] - ev["osc_counts"][0],
                   ev["osc_after"][1] - ev["osc_counts"][1])
            calm = out["levels"]["calm_since_guard"]
            osc_lv = out["levels"]["oscillation"]
            out.update(publishes=counters["overrides_published"],
                       reverts=counters["overrides_reverted"],
                       calm_steps_before_fault=calm["steps"],
                       calm_s_before_fault=ev["fault"] - ev["guard_lifted"],
                       oscillation_reached_enter=osc_lv.get(
                           "longest_run_over_enter", 0) > 0,
                       rejects=counters["overrides_rejected"],
                       flaps=sum(osc), oscillation_publishes=osc[0],
                       oscillation_reverts=osc[1],
                       cas_conflicts=counters["cas_conflicts"],
                       errors=counters["errors"])
            rs = status["reactor"]
            gov = rs["governor"]
            unsafe = rs["rejected"].get(CONTROL_UNSAFE[0], "")
            if out["publishes"] != TELE_FAULTED or out["reverts"] != \
                    TELE_FAULTED or rs["active_overrides"] or \
                    out["flaps"] or not out["rejects"] or \
                    "cycle" not in unsafe or any(
                        gov[d]["transitions"] != 2
                        for d in tele_routes()[:TELE_FAULTED]):
                raise AssertionError(f"{what}: counters {counters}, "
                                     f"reactor status {rs}")
            out["unsafe_rejected"] = unsafe
        return out, launches
    finally:
        heap.close()
        await ctap.close()
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        await linker.close()


@contextlib.asynccontextmanager
async def control_topology(seed: int):
    """``linker_topology`` with the failover clusters and the port's
    namerd in spawned processes; yields ``(loads, flag, plans, disco,
    namerd_port)`` and stops every process after."""
    import multiprocessing

    mp = multiprocessing.get_context("spawn")
    loop = asyncio.get_running_loop()
    async with linker_topology(seed) as (loads, flag, plans, disco):
        procs, conns = [], []
        try:
            ours, theirs = mp.Pipe()
            p = mp.Process(target=failover_backends, args=(theirs,),
                           daemon=True)
            p.start()
            procs.append(p)
            conns.append(ours)
            ports = await loop.run_in_executor(None, ours.recv)
            for d, pp in zip(range(TELE_FAULTED), ports):
                (disco / f"tele-{d:02d}-b").write_text(f"127.0.0.1 {pp}\n")
            ours, theirs = mp.Pipe()
            p = mp.Process(target=control_namerd, args=(theirs, str(disco)),
                           daemon=True)
            p.start()
            procs.append(p)
            conns.append(ours)
            namerd_port = await loop.run_in_executor(None, ours.recv)
            yield loads, flag, plans, disco, namerd_port
        finally:
            for conn in conns:
                try:
                    conn.send(None)
                except OSError:
                    pass
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.terminate()
                    p.join()


async def control_phase(seed: int = 12, dev: str = "cuda", linker_a=None):
    """Parts A (balancer weighting, no failover map) and B (the reactor)
    over ``control_topology``. ``linker_a``: the linker phase's part A
    on this host, printed beside. Returns the results and the kernel's
    launches on both parts."""
    res = {}
    async with control_topology(seed) as (loads, flag, plans, disco,
                                          namerd_port):
        res["part_a"], la = await control_part(
            "A", control_config(namerd_port, False), loads, flag, plans,
            disco, namerd_port, dev)
        res["part_b"], lb = await control_part(
            "B", control_config(namerd_port, True), loads, flag, plans,
            disco, namerd_port, dev)
    a, b = res["part_a"], res["part_b"]
    res["linker_a_same_host"] = None if linker_a is None else {
        w: linker_a[w] for w in ("warmup", "window")}
    print(f"control, seed {seed}: part A {a['launches']} launches for "
          f"{a['batches']} batches, kernel vs plain max|diff| "
          f"{a['kernel_vs_plain_max']:.3e}, board vs plain fold "
          f"{a['board_vs_plain_fold_max']:.3e}; part B {b['launches']} "
          f"launches for {b['batches']} batches, kernel vs plain "
          f"{b['kernel_vs_plain_max']:.3e}, board {b['board_vs_plain_fold_max']:.3e}")
    print("control: the interpreter's full collections, heap frozen: "
          + "; ".join(f"part {name} {len(r['gc_full_ms'])}, longest "
                      f"{max(r['gc_full_ms'], default=0.0):.1f} ms"
                      for name, r in (("A", a), ("B", b))))
    print(f"control B: fault to first publish "
          f"{b['fault_to_first_publish_ms']:.1f} ms (last "
          f"{b['fault_to_last_publish_ms']:.1f}), to first failover answer "
          f"{b['fault_to_first_failover_answer_ms']:.1f} ms; clear to first "
          f"revert {b['clear_to_first_revert_ms']:.1f} ms (last "
          f"{b['clear_to_last_revert_ms']:.1f}); publishes "
          f"{b['publishes']}, reverts {b['reverts']}, rejects "
          f"{b['rejects']} ({b['unsafe_rejected'][:60]}...), flaps "
          f"{b['flaps']}, {b['requests_moved']} requests moved; no "
          f"actuation over {b['calm_steps_before_fault']} steps "
          f"({b['calm_s_before_fault']:.3f} s) of calm traffic from the "
          f"guard's lift to the fault")
    osc = b["levels"]["oscillation"]
    print(f"control B: oscillation levels max {osc.get('max', 0.0):.3f} "
          f"over {osc['steps']} steps (enterThreshold "
          f"{b['thresholds']['enterThreshold']}): "
          + ("reached enterThreshold, the quorum guard exercised"
             if b["oscillation_reached_enter"] else
             "under enterThreshold; the quorum guard is held on scripted "
             "levels by tests/test_torch_control.py"))
    for name, r in (("A", a), ("B", b)):
        t = r["window"]
        print(f"control {name} window: {t['requests_per_s']:.0f} "
              f"requests/s, p50 {t['p50_ms']:.3f} ms, p99 {t['p99_ms']:.3f} "
              f"ms (calm p50 {t['calm_p50_ms']:.3f}, p99 "
              f"{t['calm_p99_ms']:.3f}); admission factor min "
              f"{r['admission']['factor_min']:.4f}, sheds "
              f"{r['admission']['sheds']}")
    if linker_a is not None:
        t = linker_a["window"]
        print(f"linker A window on this host: {t['requests_per_s']:.0f} "
              f"requests/s, p50 {t['p50_ms']:.3f} ms, p99 "
              f"{t['p99_ms']:.3f} ms")
    return res, a["launches"] + b["launches"]


# The cli phase: the port as users start it. namerd through ``python -m
# linkerd_tpu_torch.namerd``; linkerd through ``linkerd_tpu_torch.__main__
# .main()`` in a child process on the card, with a cleartext and a TLS
# server, the io.l5d.jaxAnomaly telemeter at the reference's defaults,
# io.l5d.recentRequests, io.l5d.prometheus and io.l5d.zipkin (to a span
# collector in this process), over the linker phase's topology. What the
# phase reads of the router it reads from the admin server, the
# collector, the load clients and the child's taps (``CliTap``).
CLI_CALM = 4096            # calm requests, then
CLI_FAULTED = 8192         # requests with faults on, both on both servers
CLI_SAMPLE_RATE = 0.02     # recentRequests and zipkin, as BASELINE config 1
CLI_BOOT_S = 300.0         # to the first /ping, a cold nvcc build included
CLI_STOP_S = 10.0          # from SIGTERM to exit
CLI_LABEL = "cli"
CLI_COUNTERS = ("server/requests", "server/success", "server/failures",
                "server/status/200", "server/status/503")
CLI_TELE_COUNTERS = ("requests_total", "scored_total", "batches")


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def cli_certs(d: Path) -> tuple:
    """A self-signed pair for ``localhost``, minted with the openssl CLI
    as the reference's TLS tests mint theirs."""
    if shutil.which("openssl") is None:
        raise AssertionError("cli: no openssl CLI to mint the TLS "
                             "server's certificate")
    cert, key = d / "cert.pem", d / "key.pem"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(cert), "-days", "2",
         "-subj", "/CN=localhost",
         "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1"],
        check=True, capture_output=True)
    return str(cert), str(key)


def cli_config(namerd_port: int, collector_port: int, ports, admin: int,
               cert: str, key: str) -> dict:
    """The CLI's linker config: the linker phase's router bound through
    namerd over ``io.l5d.namerd.http``, a cleartext and a TLS server,
    the telemeter at the reference's defaults beside the recentRequests,
    prometheus and zipkin telemeters; usage off (no network)."""
    return {
        "routers": [{
            "protocol": "http", "label": CLI_LABEL,
            "identifier": {"kind": "io.l5d.header.token"},
            "interpreter": {"kind": "io.l5d.namerd.http",
                            "dst": f"/$/inet/127.0.0.1/{namerd_port}",
                            "namespace": "default"},
            "servers": [{"port": ports[0]},
                        {"port": ports[1],
                         "tls": {"certPath": cert, "keyPath": key}}],
            "client": {"failureAccrual": {"kind": "none"}}}],
        "telemetry": [
            {"kind": "io.l5d.jaxAnomaly"},
            {"kind": "io.l5d.recentRequests",
             "sampleRate": CLI_SAMPLE_RATE},
            {"kind": "io.l5d.prometheus"},
            {"kind": "io.l5d.zipkin", "port": collector_port,
             "sampleRate": CLI_SAMPLE_RATE}],
        "admin": {"port": admin},
        "usage": {"enabled": False}}


class CliTap:
    """What the cli phase's linker child reads of its own telemeter,
    installed on the classes before ``main()`` builds the linker: each
    kernel step's inputs and output (held against the plain version
    after the run), each score call's labels, scores and instant, the
    host ms of each ``_score_and_publish``, the telemeters, and the
    kernel steps of the scorer's warm-up (``run()`` builds the scorer on
    a worker thread and warms it before the first batch) with the instant
    it ended."""

    def __init__(self):
        from linkerd_tpu_torch.telemetry import anomaly

        self.steps, self.scored, self.publish_ms, self.teles = [], [], [], []
        self.pending, self.cfg, self.boot = {}, None, {}
        self.warming, self.warmup_steps, self.warm_at = False, 0, None
        tap = self
        cls, tcls = anomaly.InProcessScorer, anomaly.JaxAnomalyTelemeter
        init, tinit, publish = cls.__init__, tcls.__init__, \
            tcls._score_and_publish
        warmup = cls.warmup

        def scorer_init(scorer, *a, **kw):
            init(scorer, *a, **kw)
            step, score = scorer._scorer, scorer.score
            tap.cfg = scorer.cfg

            def stepping(params, x, mu=None, var=None):
                out = step(params, x, mu, var)
                # a CPU step reads the ring's staging rows in place; a
                # card step, a copy of them of its own
                tap.steps.append((params, x if x.is_cuda else x.clone(),
                                  mu, var, out))
                tap.warmup_steps += tap.warming
                return out

            async def scoring(x):
                s = await score(x)
                labels, mask = tap.pending.pop(id(x), (None, None))
                tap.scored.append((np.asarray(s), labels, mask,
                                   time.monotonic()))
                return s

            scorer._scorer, scorer.score = stepping, scoring

        def tele_init(tele, *a, **kw):
            tinit(tele, *a, **kw)
            tap.teles.append(tele)

        async def publishing(tele, scorer, b):
            tap.pending[id(b["x"])] = (b["labels"], b["mask"])
            t0 = time.perf_counter()
            try:
                return await publish(tele, scorer, b)
            finally:
                tap.publish_ms.append((time.perf_counter() - t0) * 1e3)

        async def warming(scorer, *a, **kw):
            tap.warming = True
            try:
                return await warmup(scorer, *a, **kw)
            finally:
                tap.warming, tap.warm_at = False, time.monotonic()

        cls.__init__, tcls.__init__ = scorer_init, tele_init
        tcls._score_and_publish = publishing
        cls.warmup = warming

    def write(self, path: str, launches: int) -> None:
        """The launches, steps, batches and scored rows, and each step's
        kernel scores beside the plain version's on the same device
        tensors, to ``path`` (npz)."""
        import torch

        from linkerd_tpu_torch.ops.scoring import fused_anomaly_scores_plain

        torch.backends.cuda.matmul.allow_tf32 = False
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        got, plain, cuda_steps = [], [], 0
        for params, x, mu, var, out in self.steps:
            cuda_steps += x.is_cuda
            got.append(out.float().cpu().numpy())
            plain.append(fused_anomaly_scores_plain(
                params.params, x, self.cfg, mu, var).float().cpu().numpy())
        (tele,) = self.teles
        flat = tele.metrics.flatten()
        rows = [(s, lab, m, t) for s, lab, m, t in self.scored
                if lab is not None]
        np.savez(
            path, launches=launches, cuda_steps=cuda_steps,
            boot=np.array([self.boot[k] for k in BOOT_MARKS]),
            warm_at=np.nan if self.warm_at is None else self.warm_at,
            steps=len(self.steps), warmup_steps=self.warmup_steps,
            batches=flat["anomaly/batches"],
            requests_total=flat["anomaly/requests_total"],
            scored_total=flat["anomaly/scored_total"],
            kernel=np.concatenate(got), plain=np.concatenate(plain),
            scores=np.concatenate([s for s, _, _, _ in rows]),
            labels=np.concatenate([lab for _, lab, _, _ in rows]),
            mask=np.concatenate([m for _, _, m, _ in rows]),
            t=np.concatenate([np.full(len(s), t) for s, _, _, t in rows]),
            publish_ms=np.asarray(self.publish_ms))


# instants the linker child notes on its way to serving (monotonic,
# which the phase reads against its own clock)
BOOT_MARKS = ("entered", "imported", "loading", "loaded")


def cli_child(cfg_path: str, out_path: str, dev: str = "cuda") -> None:
    """Child process: the linker CLI on the card, as ``python -m
    linkerd_tpu_torch <cfg_path>`` runs it (with ``dev`` "cpu", as
    ``--device cpu`` runs it), with ``CliTap`` installed before
    ``main()``; on SIGTERM ``main()`` returns and the tap's readings go
    to ``out_path``."""
    boot = {"entered": time.monotonic()}
    from linkerd_tpu_torch import __main__ as cli
    from linkerd_tpu_torch.ops.scoring import fused_anomaly_scores

    boot["imported"] = time.monotonic()
    tap = CliTap()
    fused_anomaly_scores.launches = 0
    load = cli.load_linker

    def loading(*a, **kw):
        boot["loading"] = time.monotonic()
        linker = load(*a, **kw)
        boot["loaded"] = time.monotonic()
        return linker

    cli.load_linker = loading
    sys.argv = ["linkerd_tpu_torch", cfg_path]
    if dev == "cpu":
        sys.argv[1:1] = ["--device", "cpu"]
    cli.main()
    tap.boot = boot
    tap.write(out_path, fused_anomaly_scores.launches)


async def http_get(port: int, path: str) -> tuple:
    """(status, body) of one GET to 127.0.0.1:``port``."""
    from linkerd_tpu_torch.protocol.http.client import HttpClient
    from linkerd_tpu_torch.protocol.http.message import Request

    client = HttpClient("127.0.0.1", port, max_connections=1)
    try:
        rsp = await client(Request(uri=path))
        return rsp.status, rsp.body
    finally:
        await client.close()


async def wait_ping(port: int, proc_alive, what: str,
                    timeout: float = CLI_BOOT_S) -> float:
    """ms until ``/ping`` on ``port`` answers pong; fails if
    ``proc_alive()`` turns false or after ``timeout`` s."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if not proc_alive():
            raise AssertionError(f"cli: {what} exited before serving")
        try:
            if await http_get(port, "/ping") == (200, b"pong"):
                return (time.perf_counter() - t0) * 1e3
        except OSError:
            pass
        await asyncio.sleep(0.05)
    raise AssertionError(f"cli: no /ping from {what} after {timeout} s")


async def wait_json(port: int, path: str, pred, what: str,
                    timeout: float = LINKER_SETTLE_S) -> dict:
    """Polls ``path`` every 50 ms until ``pred(body)`` holds."""
    t0 = time.monotonic()
    while True:
        body = json.loads((await http_get(port, path))[1])
        if pred(body):
            return body
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"cli: {what} after {timeout} s: {body}")
        await asyncio.sleep(0.05)


async def wait_shipped(admin: int, spans: list,
                       quiet_s: float = 2.0) -> dict:
    """/tracer.json once the zipkin buffer is empty and the collector has
    taken no span for ``quiet_s`` (two of the telemeter's 1 s flushes):
    every span recorded has been shipped or dropped."""
    t0 = last_t = time.monotonic()
    last = -1
    while True:
        tracer = json.loads((await http_get(admin, "/tracer.json"))[1])
        now = time.monotonic()
        if len(spans) != last:
            last, last_t = len(spans), now
        if tracer["buffer_depth"] == 0 and now - last_t > quiet_s:
            return tracer
        if now - t0 > LINKER_SETTLE_S:
            raise AssertionError(f"cli: spans still buffered after "
                                 f"{LINKER_SETTLE_S} s: {tracer}")
        await asyncio.sleep(0.05)


def prometheus_values(text: str) -> dict:
    """``name{labels}`` -> value of a Prometheus text scrape."""
    out = {}
    for ln in text.splitlines():
        if ln and not ln.startswith("#"):
            name, _, value = ln.rpartition(" ")
            out[name] = float(value)
    return out


def cli_checks(flat: dict, prom: dict, model: dict, board: dict,
               recent: list, spans: list, sent: int) -> dict:
    """The admin server's and the collector's readings against what was
    sent: the router's request counter, the same counters in the
    Prometheus scrape, every row scored, every destination on the board
    with each faulted one above the calm median, sampled SERVER spans in
    /requests.json, and scorer.batch spans with their device ms at the
    collector."""
    key = f"rt/{CLI_LABEL}/server/requests"
    if flat.get(key) != sent:
        raise AssertionError(f"cli: {key} = {flat.get(key)}, {sent} sent")
    for c in CLI_COUNTERS + tuple(f"anomaly/{c}" for c in CLI_TELE_COUNTERS):
        name = (f"anomaly_{c.split('/', 1)[1]}" if c.startswith("anomaly/")
                else c.split("/", 1)[1].replace("/", "_")
                + f'{{rt="{CLI_LABEL}"}}')
        k = c if c.startswith("anomaly/") else f"rt/{CLI_LABEL}/{c}"
        if prom.get(name) != flat[k]:
            raise AssertionError(f"cli: prometheus {name} = "
                                 f"{prom.get(name)}, metrics.json {flat[k]}")
    if not (model["scored_fraction"] == 1.0 and model["requests_total"]
            == model["scored_total"] == sent):
        raise AssertionError(f"cli: /model.json {model}")
    routes = tele_routes()
    if sorted(board) != sorted(routes):
        raise AssertionError(f"cli: /anomaly.json lists {sorted(board)}")
    calm = float(np.median([board[d] for d in routes[TELE_FAULTED:]]))
    low = {d: board[d] for d in routes[:TELE_FAULTED] if board[d] <= calm}
    if low:
        raise AssertionError(f"cli: faulted destinations at or under the "
                             f"calm median {calm}: {low}")
    if not recent or any(s["kind"] != "SERVER" for s in recent):
        raise AssertionError(f"cli: /requests.json holds {len(recent)} "
                             f"spans, not all SERVER")
    batch = [s for s in spans if s["name"] == "scorer.batch"]
    timed = [s for s in batch if "scorer.device_ms" in s["tags"]]
    if not timed:
        raise AssertionError(f"cli: {len(batch)} scorer.batch spans at "
                             f"the collector, none with scorer.device_ms")
    return {"board_faulted_min": min(board[d] for d in routes[:TELE_FAULTED]),
            "board_calm_median": calm, "recent_requests": len(recent),
            "spans_collected": len(spans), "scorer_batch_spans": len(batch),
            "timed_batch_spans": len(timed),
            "server_spans": sum(s["kind"] == "SERVER" for s in spans),
            "device_ms_p50": float(np.median([float(
                s["tags"]["scorer.device_ms"]) for s in timed]))}


def cli_tap_checks(tap: dict, window_t: float, dev: str) -> dict:
    """The child's tap: one kernel launch a scored batch (timed batches
    included) and a step of the scorer's warm-up, every step on the card,
    kernel vs plain within the linker phase's share; the window's AUC.
    (On the CPU: no launch, no step on the card.)"""
    from linkerd_tpu_torch.lifecycle.promote import auc

    launches, steps, warm, batches = (int(tap[k]) for k in (
        "launches", "steps", "warmup_steps", "batches"))
    on_card = steps if dev == "cuda" else 0
    if not (launches == int(tap["cuda_steps"]) == on_card
            and steps - warm == batches and warm > 0):
        raise AssertionError(
            f"cli: {launches} kernel launches, {steps} steps "
            f"({int(tap['cuda_steps'])} on the card, {warm} of the "
            f"warm-up), {batches} batches")
    gap = np.abs(tap["kernel"] - tap["plain"])
    past = int((gap > ROW_TOL).sum())
    print(f"cli: kernel vs plain max|diff| {gap.max():.3e}, {past} of "
          f"{len(gap)} rows past {ROW_TOL}, {int((gap > 1e-3).sum())} past "
          f"1e-3")
    if gap.max() > TOL:
        raise AssertionError(f"cli: kernel vs plain off by {gap.max()} > "
                             f"{TOL} on a row")
    if past > ROW_SHARE * len(gap):
        raise AssertionError(f"cli: kernel vs plain: {past} of {len(gap)} "
                             f"rows past {ROW_TOL} > {ROW_SHARE:.0%}")
    win = (tap["t"] >= window_t) & (tap["mask"] > 0)
    pub = tap["publish_ms"]
    return {"launches": launches, "batches": batches,
            "warmup_launches": warm if dev == "cuda" else 0,
            "kernel_vs_plain_max": float(gap.max()),
            "rows_past_row_tol": past, "rows_past_1e-3":
            int((gap > 1e-3).sum()), "rows": len(gap),
            "window_rows": int(win.sum()),
            "window_auc": auc(tap["labels"][win].tolist(),
                              tap["scores"][win].tolist()),
            "score_and_publish_p50_ms": float(np.percentile(pub, 50)),
            "score_and_publish_p99_ms": float(np.percentile(pub, 99))}


def stop_process(proc, what: str) -> dict:
    """SIGTERM, then the exit code and ms to exit; fails unless 0 within
    CLI_STOP_S. ``proc``: a Popen or a multiprocessing Process."""
    t0 = time.perf_counter()
    if hasattr(proc, "send_signal"):
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=CLI_STOP_S)
        except subprocess.TimeoutExpired:
            rc = None
    else:
        proc.terminate()
        proc.join(timeout=CLI_STOP_S)
        rc = proc.exitcode
    ms = (time.perf_counter() - t0) * 1e3
    if rc != 0:
        raise AssertionError(f"cli: {what} exit code {rc} {ms:.0f} ms "
                             f"after SIGTERM")
    return {"exit_code": rc, "stop_ms": ms}


async def cli_phase(seed: int = 12, linker_a=None, dev: str = "cuda"):
    """namerd and the linker CLI (spawned), the linker phase's backends
    and load clients, a span collector here: a calm run, then a run with
    faults on, each half through the TLS server; then the checks of
    ``cli_checks`` on the admin server and the collector and of
    ``cli_tap_checks`` on the child's readings, and both processes'
    exits. ``linker_a``: the linker phase's part A on this host, printed
    beside. Returns the results and the kernel's launches."""
    import multiprocessing

    from linkerd_tpu_torch.protocol.http.message import Response
    from linkerd_tpu_torch.protocol.http.server import serve
    from linkerd_tpu_torch.router.service import FnService

    mp = multiprocessing.get_context("spawn")
    spans = []

    async def collect(req):
        spans.extend(json.loads(req.body))
        return Response(202)

    res = {}
    async with linker_topology(seed, (CLI_CALM, CLI_FAULTED)) as (
            loads, flag, plans, disco):
        work = Path(tempfile.mkdtemp(prefix="cli-"))
        collector = await serve(FnService(collect))
        namerd = child = None
        try:
            cert, key = cli_certs(work)
            n_api, n_admin, admin = free_port(), free_port(), free_port()
            ports = [free_port(), free_port()]
            (work / "namerd.json").write_text(json.dumps({
                "storage": {"kind": "io.l5d.inMemory", "namespaces": {
                    "default": CONTROL_BASE_DTAB}},
                "interfaces": [{"kind": "io.l5d.httpController",
                                "port": n_api}],
                "namers": [{"kind": "io.l5d.fs", "rootDir": str(disco)}],
                "admin": {"port": n_admin}}))
            (work / "linker.json").write_text(json.dumps(cli_config(
                n_api, collector.bound_port, ports, admin, cert, key)))
            with open(work / "namerd.log", "w") as log:
                namerd = subprocess.Popen(
                    [sys.executable, "-m", "linkerd_tpu_torch.namerd",
                     str(work / "namerd.json")], cwd=ROOT, stdout=log,
                    stderr=subprocess.STDOUT,
                    env=dict(os.environ, PYTHONPATH=str(ROOT)))
            await wait_ping(n_admin, lambda: namerd.poll() is None,
                            "namerd", timeout=60.0)
            child = mp.Process(target=cli_child, daemon=True, args=(
                str(work / "linker.json"), str(work / "tap.npz"), dev))
            spawned = time.monotonic()
            child.start()
            startup_ms = await wait_ping(admin, child.is_alive, "linkerd")
            served = time.monotonic()
            print(f"cli: linkerd CLI up (first /ping) after "
                  f"{startup_ms:.1f} ms")
            half = LINKER_CONNS // 2
            targets = [ports[0]] * half + [(ports[1], cert)] * half
            runs = {}
            for name, plan, fault in (("calm", plans[0], 0),
                                      ("faulted", plans[1], 1)):
                flag.value = fault
                if fault:
                    window_t = time.monotonic()
                both, outs = await linker_traffic(loads, targets, plan,
                                                  split=True)
                runs[name] = {
                    server: linker_traffic_checks(
                        out, f"cli {name} {server}", bool(fault))
                    for server, out in zip(("cleartext", "tls"), outs)}
                runs[name]["both"] = linker_traffic_checks(
                    both, f"cli {name}", bool(fault))
                # the rate over the run's second half of answers: the
                # first carries the child's cold start
                done, mid = np.sort(both["t"]), len(both["t"]) // 2
                runs[name]["both"]["first_half_requests_per_s"] = (
                    mid - 1) / (done[mid - 1] - done[0])
                runs[name]["both"]["second_half_requests_per_s"] = (
                    len(done) - mid) / (done[-1] - done[mid - 1])
            flag.value = 0
            sent = CLI_CALM + CLI_FAULTED
            model = await wait_json(
                admin, "/model.json", lambda m: m["scored_total"] ==
                m["requests_total"] == sent, "every request scored")
            tracer = await wait_shipped(admin, spans)
            flat = json.loads((await http_get(
                admin, "/admin/metrics.json"))[1])
            t0 = time.perf_counter()
            status, text = await http_get(admin, "/admin/metrics/prometheus")
            scrape_ms = (time.perf_counter() - t0) * 1e3
            board = json.loads((await http_get(admin, "/anomaly.json"))[1])
            recent = json.loads((await http_get(admin, "/requests.json"))[1])
            held = cli_checks(flat, prometheus_values(text.decode()), model,
                              board["scores"], recent, spans, sent)
            held["router_ms"] = stage_ms(flat, CLI_LABEL)
            stops = {"linkerd": stop_process(child, "linkerd")}
            stops["namerd"] = stop_process(namerd, "namerd")
            tap = dict(np.load(work / "tap.npz"))
            res.update(cli_tap_checks(tap, window_t, dev), **held)
            marks = [spawned, *tap["boot"].tolist(), served]
            res["boot_ms"] = {
                f"{a}_to_{b}": (tb - ta) * 1e3 for a, b, ta, tb in zip(
                    ("spawn",) + BOOT_MARKS, BOOT_MARKS + ("ping",),
                    marks, marks[1:])}
            # the scorer is built and warmed off the router's loop: the
            # first /ping does not wait for it
            res["ping_to_scorer_warm_ms"] = (float(tap["warm_at"])
                                             - served) * 1e3
            res.update(startup_ms=startup_ms, runs=runs, stops=stops,
                       prometheus_scrape_ms=scrape_ms,
                       prometheus_lines=len(text.splitlines()),
                       spans_sent=tracer["sent_spans"],
                       spans_dropped=tracer["dropped_spans"],
                       zipkin_posts=tracer["posts"],
                       zipkin_failed_posts=tracer["failed_posts"])
        finally:
            for proc in (child, namerd):
                if proc is None:
                    continue
                alive = (proc.poll() is None if hasattr(proc, "poll")
                         else proc.is_alive())
                if alive:
                    proc.kill()
                    (proc.wait if hasattr(proc, "poll") else proc.join)()
            await collector.close()
            shutil.rmtree(work, ignore_errors=True)
    res["linker_a_same_host"] = None if linker_a is None else {
        w: linker_a[w] for w in ("warmup", "window")}
    print(f"cli, seed {seed}: {res['launches']} launches for "
          f"{res['batches']} batches; kernel vs plain max|diff| "
          f"{res['kernel_vs_plain_max']:.3e} ({res['rows_past_row_tol']} of "
          f"{res['rows']} rows past {ROW_TOL}); window AUC "
          f"{res['window_auc']:.4f}; board faulted min "
          f"{res['board_faulted_min']:.4f} vs calm median "
          f"{res['board_calm_median']:.4f}")
    for name, r in res["runs"].items():
        for server in ("cleartext", "tls", "both"):
            s = r[server]
            print(f"cli {name} {server}: {s['requests_per_s']:.0f} "
                  f"requests/s, p50 {s['p50_ms']:.3f} ms, p99 "
                  f"{s['p99_ms']:.3f} ms (calm p50 {s['calm_p50_ms']:.3f}, "
                  f"p99 {s['calm_p99_ms']:.3f})" + (
                      f"; first half {s['first_half_requests_per_s']:.0f}, "
                      f"second half {s['second_half_requests_per_s']:.0f}"
                      f" requests/s" if server == "both" else ""))
    if linker_a is not None:
        for w in ("warmup", "window"):
            t = linker_a[w]
            print(f"linker A {w} on this host: {t['requests_per_s']:.0f} "
                  f"requests/s, p50 {t['p50_ms']:.3f} ms, p99 "
                  f"{t['p99_ms']:.3f} ms")
    print("cli: startup " + ", ".join(f"{k} {v:.1f} ms"
                                      for k, v in res["boot_ms"].items())
          + f"; the scorer warm {res['ping_to_scorer_warm_ms']:.1f} ms "
          f"after the first /ping ({res['warmup_launches']} warm-up "
          f"launches)")
    print("cli: the router's own ms (p50/p99) over both runs: " + ", ".join(
        f"{k} {v['p50']:.3f}/{v['p99']:.3f}"
        for k, v in res["router_ms"].items()))
    print(f"cli: _score_and_publish p50 {res['score_and_publish_p50_ms']:.3f}"
          f" ms p99 {res['score_and_publish_p99_ms']:.3f} ms; spans sent "
          f"{res['spans_sent']}, dropped {res['spans_dropped']} "
          f"({res['zipkin_posts']} posts, {res['zipkin_failed_posts']} "
          f"failed); prometheus scrape {res['prometheus_scrape_ms']:.3f} ms "
          f"({res['prometheus_lines']} lines); /requests.json "
          f"{res['recent_requests']} spans; stops "
          + ", ".join(f"{k} {v['stop_ms']:.0f} ms"
                      for k, v in res["stops"].items()))
    return res, res["launches"]


# The h2 phase: the port's h2 router (``protocol: h2``, the Python HTTP/2
# stack, io.l5d.h2.grpc.default with service retries) proxying gRPC calls
# from load processes on H2_CONNS connections of H2_STREAMS concurrent
# streams to gRPC backends built on the port's own
# grpc/dispatch.py in child processes; 40 destinations of 2 replicas, 4
# of them faulted (40 ms, then UNAVAILABLE at LINKER_ERROR_RATE). The
# router has a cleartext server, a TLS server (ALPN h2) and a
# prior-knowledge server with clearContext that also takes an h2c
# upgrade. The telemeter's recorder on the router's server stack takes
# each call's row, which the micro-batcher scores through the kernel.
H2_CONNS = 8               # connections, over the router's three servers
H2_STREAMS = 16            # concurrent streams a connection
H2_CALM = 4096             # calm calls, then
H2_FAULTED = 8192          # calls with the faults on, in each part
# the h2 phase's own parts A-C run half as many (2,048 and 4,096), to
# keep a whole run inside its limit; the h2fast phase keeps the above
H2_PHASE_SIZES = (H2_CALM // 2, H2_FAULTED // 2)
H2_STREAM_CALLS = 8        # part D: server-streaming calls at once
H2_STREAM_MSGS = 256       # messages a streaming call
H2_STREAM_BYTES = 8192     # padding a streamed message (2 MiB a call)
H2_SAMPLE_FRAMES = 2       # part D's sampleEveryFrames (minGapMs 0)
H2_LABEL = "h2"
H2_SERVICE = "l5d.smoke.Tele"
H2_SERVERS = ("cleartext", "tls", "prior_knowledge")
H2_PROBE_DST = 5           # the h2c upgrade probe's destination
H2_MODEL_SEED = 12         # part A's frozen model (random_params)
H2_CLI_CALLS = 1024        # part E: calm calls through the CLI's router
_H2_PROTO: dict = {}


def h2_proto():
    """The phase's gRPC service: unary ``Echo`` and server-streaming
    ``Watch`` over one message (text, count, padding)."""
    if not _H2_PROTO:
        from linkerd_tpu_torch.grpc import (
            Field, ProtoMessage, Rpc, ServiceDef,
        )

        class Tele(ProtoMessage):
            FIELDS = {"text": Field(1, "string"), "n": Field(2, "int32"),
                      "pad": Field(3, "bytes")}

        _H2_PROTO.update(msg=Tele, svc=ServiceDef(H2_SERVICE, [
            Rpc("Echo", Tele, Tele),
            Rpc("Watch", Tele, Tele, server_streaming=True)]))
    return _H2_PROTO["msg"], _H2_PROTO["svc"]


def h2_backends(conn, dsts, flag, seed: int) -> None:
    """Child process: one gRPC server (the port's ``ServerDispatcher``
    on its ``H2Server``) a replica of each destination index in
    ``dsts``. ``Echo`` answers ``tele-DD/R``; ``Watch`` streams ``n``
    messages of it. While ``faulting`` names a replica, it waits
    LINKER_FAULT_MS, then answers UNAVAILABLE at LINKER_ERROR_RATE as a
    Trailers-Only response with ``:status 503`` (the form an overloaded
    hop answers in, and the one failure accrual, which reads the HTTP
    status as the reference's does, counts). Every response carries the
    fault label."""
    import random

    from linkerd_tpu_torch.grpc import ServerDispatcher
    from linkerd_tpu_torch.protocol.h2.messages import H2Response, Headers
    from linkerd_tpu_torch.protocol.h2.server import H2Server
    from linkerd_tpu_torch.router.service import FnService

    rng = random.Random(seed)
    tele_msg, svc = h2_proto()
    pad = bytes(H2_STREAM_BYTES)

    def backend(name: str, d: int, replica: int):
        disp = ServerDispatcher()

        async def echo(req):
            return tele_msg(text=name)

        async def watch(req):
            async def gen():
                for i in range(req.n):
                    yield tele_msg(text=name, n=i, pad=pad)
            return gen()

        disp.register_all(svc, {"Echo": echo, "Watch": watch})

        async def handle(req):
            label = "0"
            if faulting(flag.value, d, replica):
                label = "1"
                await asyncio.sleep(LINKER_FAULT_MS / 1e3)
                if rng.random() < LINKER_ERROR_RATE:
                    return H2Response(status=503, headers=Headers([
                        ("content-type", "application/grpc"),
                        ("grpc-status", "14"),
                        ("grpc-message", "injected%20fault"),
                        ("l5d-fault-label", label)]), body=b"")
            rsp = await disp(req)
            rsp.headers.set("l5d-fault-label", label)
            return rsp

        return FnService(handle)

    async def main():
        servers = [await H2Server(backend(f"tele-{d:02d}/{r}", d,
                                          r)).start()
                   for d in dsts for r in range(LINKER_REPLICAS)]
        conn.send([s.bound_port for s in servers])
        await asyncio.get_running_loop().run_in_executor(None, conn.recv)
        for s in servers:
            await s.close()

    asyncio.run(main())


def h2_client(target):
    """An ``H2Client`` to ``target``: a port, or ``(port, cafile)`` for
    TLS verifying the server as ``localhost`` against ``cafile``."""
    import ssl

    from linkerd_tpu_torch.protocol.h2.client import H2Client

    port, cafile = target if isinstance(target, tuple) else (target, None)
    if cafile is None:
        return H2Client("127.0.0.1", port)
    return H2Client("127.0.0.1", port,
                    ssl_context=ssl.create_default_context(cafile=cafile),
                    server_hostname="localhost")


async def h2_connection(target, plan, out: dict, off: int) -> None:
    """One h2 connection carrying ``plan``'s unary calls on H2_STREAMS
    concurrent streams, each call to its destination by ``:authority``;
    stores the grpc code (-1: no status), right replica, ms, the instant
    it completed and who answered."""
    from linkerd_tpu_torch.grpc import ClientDispatcher, GrpcError

    tele_msg, svc = h2_proto()
    client = h2_client(target)
    stubs: dict = {}
    todo = iter(range(len(plan)))

    async def worker():
        for i in todo:
            d = int(plan[i])
            stub = stubs.get(d)
            if stub is None:
                stub = stubs[d] = ClientDispatcher(
                    client, authority=f"tele-{d:02d}")
            t0 = time.perf_counter()
            text = ""
            try:
                rep = await stub.unary(svc, "Echo", tele_msg(text="x"))
            except GrpcError as e:
                code = e.status.code
            except Exception:  # noqa: BLE001 — counted as code -1
                code = -1
            else:
                code, text = 0, rep.text
            out["ms"][off + i] = (time.perf_counter() - t0) * 1e3
            out["t"][off + i] = time.monotonic()
            out["status"][off + i] = code
            out["right"][off + i] = text.startswith(f"tele-{d:02d}/")
            out["who"][off + i] = answerer(text.encode(), d)

    try:
        await asyncio.gather(*(worker() for _ in range(H2_STREAMS)))
    finally:
        await client.close()


def h2_load(conn) -> None:
    """Child process: on each ``(targets, plans)`` from ``conn``, one h2
    connection a plan (to its target), all at once; sends back every
    call's destination, grpc code, right replica, ms, instant and
    answerer, and the wall seconds. ``None`` ends it."""
    while True:
        msg = conn.recv()
        if msg is None:
            return
        targets, plans = msg
        n = sum(len(p) for p in plans)
        out = {"dst": np.concatenate(plans).astype(np.int16),
               "status": np.zeros(n, np.int16), "right": np.zeros(n, bool),
               "ms": np.zeros(n), "t": np.zeros(n),
               "who": np.zeros(n, np.int8)}
        offs = np.cumsum([0] + [len(p) for p in plans])

        async def run():
            t0 = time.perf_counter()
            await asyncio.gather(*(h2_connection(t, p, out, int(o))
                                   for t, p, o in zip(targets, plans, offs)))
            return time.perf_counter() - t0

        out["wall"] = asyncio.run(run())
        conn.send(out)


def h2_conn_servers() -> list:
    """The router server each connection goes to, by index into
    H2_SERVERS: round robin."""
    return [i % len(H2_SERVERS) for i in range(H2_CONNS)]


async def h2_traffic(loads, targets, plans) -> dict:
    """``linker_traffic`` for the h2 load processes: each plan to its
    target; adds each call's server index (``server``)."""
    res = await linker_traffic(loads, targets, plans)
    res["server"] = np.concatenate([np.full(len(p), s, np.int8) for p, s in
                                    zip(plans, h2_conn_servers())])
    return res


def h2_call_checks(res: dict, what: str, faults_on: bool) -> dict:
    """Every calm call (with ``faults_on``, of the destinations past the
    first TELE_FAULTED) answered OK by a replica of its destination;
    returns calls/s and ms percentiles overall and for each server."""
    calm = res["dst"] >= (TELE_FAULTED if faults_on else 0)
    wrong = calm & ~((res["status"] == 0) & res["right"])
    if wrong.any():
        i = int(np.flatnonzero(wrong)[0])
        raise AssertionError(
            f"h2 {what}: {int(wrong.sum())} calm calls misrouted or "
            f"failed, e.g. tele-{res['dst'][i]:02d} -> grpc code "
            f"{res['status'][i]}")

    def stats(sel) -> dict:
        ms = res["ms"][sel]
        return {"calls": int(sel.sum()), "calls_per_s": float(
            sel.sum() / res["wall"]),
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99))}

    everything = np.ones(len(res["ms"]), bool)
    out = {**stats(everything),
           "calm_p50_ms": float(np.percentile(res["ms"][calm], 50)),
           "calm_p99_ms": float(np.percentile(res["ms"][calm], 99)),
           "unavailable": int((res["status"] == 14).sum()),
           "by_server": {name: stats(res["server"] == i)
                         for i, name in enumerate(H2_SERVERS)}
           if "server" in res else {}}
    return out


class H2ServerTap:
    """Counts, on each of a router's ``H2Server``s, the connections it
    accepts, and on its TLS server the completed handshakes that chose
    ALPN ``h2``. Installed before the router starts."""

    def __init__(self, router):
        self.conns = [0] * len(router.servers)
        self.tls_h2 = 0
        for i, srv in enumerate(router.servers):
            srv._on_conn = self._wrap(i, srv._on_conn)

    def _wrap(self, i: int, on_conn):
        async def counted(reader, writer):
            self.conns[i] += 1
            ssl_obj = writer.get_extra_info("ssl_object")
            if ssl_obj is not None and ssl_obj.selected_alpn_protocol() \
                    == "h2":
                self.tls_h2 += 1
            return await on_conn(reader, writer)
        return counted


async def h2c_probe(port: int, d: int) -> dict:
    """RFC 7540 §3.2 from a raw HTTP/1.1 client: an ``Echo`` call to
    ``tele-DD`` sent as an ``Upgrade: h2c`` request with its gRPC body;
    after the 101, the client preface and SETTINGS, then the h2 response
    to stream 1. Returns the upgrade's status line, the response's
    ``:status``, the reply's text and the grpc-status trailer."""
    import base64

    from linkerd_tpu_torch.grpc.codec import Codec, GrpcFramer
    from linkerd_tpu_torch.protocol.h2 import frames, hpack

    tele_msg, _ = h2_proto()
    codec = Codec(tele_msg)
    body = codec.encode_frame(tele_msg(text="probe"))
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    out = {"upgrade": None, "status": None, "text": None,
           "grpc_status": None}
    try:
        settings = base64.urlsafe_b64encode(b"").decode()
        writer.write(
            (f"POST /{H2_SERVICE}/Echo HTTP/1.1\r\nHost: tele-{d:02d}\r\n"
             f"Connection: Upgrade, HTTP2-Settings\r\nUpgrade: h2c\r\n"
             f"HTTP2-Settings: {settings}\r\n"
             f"Content-Type: application/grpc\r\nTE: trailers\r\n"
             f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
        await writer.drain()
        line = await asyncio.wait_for(reader.readline(), 10)
        out["upgrade"] = line.decode().strip()
        if b" 101 " not in line:
            return out
        while (await reader.readline()) not in (b"\r\n", b""):
            pass
        writer.write(frames.CONNECTION_PREFACE + frames.pack_settings([]))
        await writer.drain()
        dec, data = hpack.Decoder(), b""
        while True:
            fh = frames.unpack_header(
                await asyncio.wait_for(reader.readexactly(9), 10))
            payload = (await reader.readexactly(fh.length)
                       if fh.length else b"")
            if fh.type == frames.SETTINGS and not fh.flags & frames.FLAG_ACK:
                writer.write(frames.pack_settings([], ack=True))
                await writer.drain()
            elif fh.type == frames.HEADERS and fh.stream_id == 1:
                hdrs = dict(dec.decode(frames.strip_padding(fh.flags,
                                                            payload)))
                if out["status"] is None:
                    out["status"] = int(hdrs[":status"])
                if "grpc-status" in hdrs:
                    out["grpc_status"] = int(hdrs["grpc-status"])
            elif fh.type == frames.DATA and fh.stream_id == 1:
                data += frames.strip_padding(fh.flags, payload)
            elif fh.type == frames.GOAWAY:
                break
            if fh.stream_id == 1 and fh.flags & frames.FLAG_END_STREAM:
                break
        msgs = GrpcFramer().feed(data)
        if msgs:
            out["text"] = codec.decode_payload(*msgs[0]).text
        return out
    finally:
        writer.close()


def h2_config(disco: Path, cert: str, key: str, telemetry: bool,
              accrual: str, train_every: int,
              stream_scoring: bool = False) -> str:
    """The h2 router's config as JSON text: the io.l5d.fs namer,
    io.l5d.h2.grpc.default with service retries, the three servers, and
    with ``telemetry`` the io.l5d.jaxAnomaly telemeter at the reference's
    defaults (the reference test's reconWeight)."""
    router = {
        "protocol": "h2", "label": H2_LABEL,
        "identifier": {"kind": "io.l5d.header.token"},
        "dtab": "/svc => /#/io.l5d.fs ;",
        "servers": [{"port": 0},
                    {"port": 0, "tls": {"certPath": cert, "keyPath": key}},
                    {"port": 0, "clearContext": True}],
        "client": {"failureAccrual": {"kind": accrual}},
        "service": {"responseClassifier": {
            "kind": "io.l5d.h2.grpc.default"}}}
    if stream_scoring:
        router["streamScoring"] = {"sampleEveryFrames": H2_SAMPLE_FRAMES,
                                   "minGapMs": 0, "action": "observe"}
    cfg = {"routers": [router],
           "namers": [{"kind": "io.l5d.fs", "rootDir": str(disco)}]}
    if telemetry:
        cfg["telemetry"] = [{"kind": "io.l5d.jaxAnomaly",
                             "trainEveryBatches": train_every,
                             "reconWeight": 1.0}]
    return json.dumps(cfg)


def traffic_model(tele, tap, seed: int = H2_MODEL_SEED):
    """Restores into the telemeter's scorer, and returns, a frozen model
    for the rows still to come: ``random_params`` (every bias distinct
    from zero, so both of a layer's bf16 roundings matter) over the
    mean and variance of the rows scored so far, so that the scores lie
    where the sigmoid and tanh still have slope."""
    x = np.concatenate([x for x, _ in tap.scored])
    snap = tele._scorer.snapshot()
    snap.params = random_params(seed, snap.cfg)
    snap.mu = x.mean(axis=0).astype(np.float32)
    snap.var = (x.var(axis=0) + 1e-6).astype(np.float32)
    snap.norm_initialized = True
    tele._scorer.restore(snap)
    return tele._scorer.snapshot()


def h2_retries(flat: dict) -> int:
    """Service retries over every destination, from the router's
    metrics."""
    return int(sum(v for k, v in flat.items()
                   if k.startswith(f"rt/{H2_LABEL}/service/")
                   and k.endswith("/retries/total")))


def h2_row_checks(what: str, tap, expect: dict) -> None:
    """The rows the board folded, by destination, equal the calls each
    destination was sent (``expect``): no row keyed to another."""
    got: dict = {}
    for dsts, _, _ in tap.folds:
        for d in dsts:
            got[d] = got.get(d, 0) + 1
    if got != expect:
        diff = {k: (got.get(k, 0), expect.get(k, 0))
                for k in sorted(set(got) | set(expect))
                if got.get(k, 0) != expect.get(k, 0)}
        raise AssertionError(f"h2 {what}: rows by destination differ from "
                             f"the calls sent (rows, calls): {diff}")


async def h2_part(part: str, text: str, loads, flag, plans, cafile: str,
                  dev: str):
    """One h2 router from ``text``: the plans' calm calls, then the
    faulted ones with the faults on. Part A sends the h2c probe, then freezes a model
    fitted to the calm rows' stats (``traffic_model``) and holds the
    faulted calls' kernel scores and the board against the plain
    version; part B reads failure accrual; part C has no telemeter."""
    from linkerd_tpu_torch.core.tasks import monitor
    from linkerd_tpu_torch.linker import load_linker
    from linkerd_tpu_torch.ops.scoring import fused_anomaly_scores

    linker = load_linker(text, device=dev)
    srv_tap = H2ServerTap(linker.routers[0])
    await linker.start()
    ports = linker.routers[0].server_ports
    targets = [(ports[s], cafile) if H2_SERVERS[s] == "tls" else ports[s]
               for s in h2_conn_servers()]
    tele = linker.telemeters[0] if linker.telemeters else None
    tap = accrual = task = None
    out = {}
    try:
        if tele is not None:
            tap = LinkerTap(tele)
            task = monitor(asyncio.create_task(tele.run()),
                           what=f"telemeter-{type(tele).__name__}")
        if part == "B":
            accrual = AccrualTap()
        fused_anomaly_scores.launches = 0
        flag.value = 0
        expect: dict = {}
        if part == "A":
            out["h2c_probe"] = probe = await h2c_probe(ports[2],
                                                       H2_PROBE_DST)
            if not (probe["upgrade"] or "").startswith("HTTP/1.1 101") or \
                    probe["status"] != 200 or probe["grpc_status"] != 0 or \
                    not (probe["text"] or "").startswith(
                        f"tele-{H2_PROBE_DST:02d}/"):
                raise AssertionError(f"h2 A: the h2c upgrade probe: {probe}")
            expect[f"/svc/tele-{H2_PROBE_DST:02d}"] = 1
        calm = await h2_traffic(loads, targets, plans[0])
        if tele is not None:
            await tap.settle(tele, task, f"h2 {part} calm")
        if part == "A":
            if not tap.scored:
                raise AssertionError("h2 A: no row of the calm calls was "
                                     "scored")
            snap = traffic_model(tele, tap)
            start, first = len(tap.folds), len(tap.batches)
        flag.value = 1
        faulted = await h2_traffic(loads, targets, plans[1])
        if tele is not None:
            await tap.settle(tele, task, f"h2 {part} faulted")
        flag.value = 0
        launches = fused_anomaly_scores.launches
        out["calm"] = h2_call_checks(calm, f"{part} calm", False)
        out["faulted"] = h2_call_checks(faulted, f"{part} faulted", True)
        flat = linker.metrics.flatten()
        out["retries"] = h2_retries(flat)
        if not out["retries"]:
            raise AssertionError(f"h2 {part}: no service retries of the "
                                 f"UNAVAILABLE answers")
        tls_conns = 2 * h2_conn_servers().count(H2_SERVERS.index("tls"))
        out["tls_handshakes"] = srv_tap.tls_h2
        out["connections_by_server"] = dict(zip(H2_SERVERS, srv_tap.conns))
        if srv_tap.tls_h2 != tls_conns:
            raise AssertionError(f"h2 {part}: {srv_tap.tls_h2} TLS "
                                 f"handshakes chose h2, for {tls_conns} "
                                 f"TLS connections")
        out["router_ms"] = stage_ms(flat, H2_LABEL)
        if tele is None:
            return out, launches
        sent = len(calm["ms"]) + len(faulted["ms"]) + sum(expect.values())
        out.update(scored_checks(f"h2 {part}", tele, tap, sent, launches,
                                 dev))
        for res in (calm, faulted):
            for d in res["dst"]:
                key = f"/svc/tele-{d:02d}"
                expect[key] = expect.get(key, 0) + 1
        h2_row_checks(part, tap, expect)
        routes = tele_routes()
        board = {d: tele.board.score_of(d) for d in routes}
        out["board_levels"] = {
            "faulted_min": min(board[d] for d in routes[:TELE_FAULTED]),
            "calm_max": max(board[d] for d in routes[TELE_FAULTED:])}
        if part == "A":
            held, _, _, _ = window_checks("h2 A", tele, tap, snap, start,
                                          first, dev)
            if held["kernel_vs_plain_max"] > TOL:
                raise AssertionError(
                    f"h2 A: kernel vs plain {held['kernel_vs_plain_max']} "
                    f"> {TOL} on a row")
            out.update(held)
        if part == "B":
            out.update(removal_checks("h2 B", linker, accrual))
        return out, launches
    finally:
        if accrual is not None:
            accrual.close()
        if task is not None:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
        await linker.close()


class FrameCount:
    """Counts the DATA and WINDOW_UPDATE frames an h2 client connection
    writes on each stream, by parsing what it hands its writer."""

    def __init__(self, conn):
        from linkerd_tpu_torch.protocol.h2 import frames

        self.frames, self.data, self.window = frames, {}, {}
        self._buf = b""
        write = conn._write

        def counting(data: bytes) -> None:
            self._feed(bytes(data))
            write(data)

        conn._write = counting

    def _feed(self, data: bytes) -> None:
        f = self.frames
        self._buf += data
        while len(self._buf) >= 9:
            fh = f.unpack_header(self._buf[:9])
            if len(self._buf) < 9 + fh.length:
                return
            self._buf = self._buf[9 + fh.length:]
            if fh.stream_id and fh.type == f.DATA:
                self.data[fh.stream_id] = self.data.get(fh.stream_id, 0) + 1
            elif fh.stream_id and fh.type == f.WINDOW_UPDATE:
                self.window[fh.stream_id] = \
                    self.window.get(fh.stream_id, 0) + 1


async def h2_part_d(text: str, dev: str):
    """H2_STREAM_CALLS server-streaming calls of H2_STREAM_MSGS messages
    at once through a router with ``streamScoring`` (action observe, no
    scorer, as in the reference), from a client in this process whose
    frames are counted: every message arrives; the sentinel holds one
    stream a call, in the order the client opened them, and each
    stream's samples are what the client's frames on it predict: one
    each H2_SAMPLE_FRAMES of its DATA and WINDOW_UPDATE frames (the
    observer sees the frames a client sends), or the count without the
    last WINDOW_UPDATE, which may reach the router after the stream has
    ended there; every call's row is scored, one launch a batch."""
    from linkerd_tpu_torch.core.tasks import monitor
    from linkerd_tpu_torch.grpc import ClientDispatcher
    from linkerd_tpu_torch.linker import load_linker
    from linkerd_tpu_torch.ops.scoring import fused_anomaly_scores

    tele_msg, svc = h2_proto()
    linker = load_linker(text, device=dev)
    await linker.start()
    tele = linker.telemeters[0]
    tap = LinkerTap(tele)
    task = monitor(asyncio.create_task(tele.run()),
                   what=f"telemeter-{type(tele).__name__}")
    client = h2_client(linker.routers[0].server_ports[0])
    try:
        fused_anomaly_scores.launches = 0
        count = FrameCount(await client._get_conn())
        dsts = [TELE_FAULTED + i for i in range(H2_STREAM_CALLS)]

        async def one(d: int):
            stub = ClientDispatcher(client, authority=f"tele-{d:02d}")
            reps = await stub.server_stream(svc, "Watch",
                                            tele_msg(n=H2_STREAM_MSGS))
            return [m async for m in reps]

        t0 = time.perf_counter()
        got = await asyncio.gather(*(one(d) for d in dsts))
        wall = time.perf_counter() - t0
        for d, msgs in zip(dsts, got):
            if len(msgs) != H2_STREAM_MSGS or any(
                    not m.text.startswith(f"tele-{d:02d}/") or m.n != i
                    for i, m in enumerate(msgs)):
                raise AssertionError(
                    f"h2 D: tele-{d:02d} streamed {len(msgs)} messages, "
                    f"not {H2_STREAM_MSGS} of its own in order")
        await tap.settle(tele, task, "h2 D")
        launches = fused_anomaly_scores.launches
        (_, sentinel), = linker.stream_sentinels
        snap = sentinel.snapshot()
        streams = list(snap["by_stream"].values())
        sids = sorted(set(count.data) | set(count.window))
        per, late, every = [], 0, H2_SAMPLE_FRAMES
        for sid, s in zip(sids, streams):
            sent = count.data.get(sid, 0) + count.window.get(sid, 0)
            per.append([sent, s["samples"], s["frames"]])
            late += s["samples"] != sent // every
            if not (sent - 1) // every <= s["samples"] <= sent // every \
                    or s["frames"] != s["samples"] * every:
                late = None
                break
        out = {"streams": len(streams),
               "client_data_frames": sum(count.data.values()),
               "client_window_update_frames": sum(count.window.values()),
               "samples": sum(s["samples"] for s in streams),
               "predicted_samples": sum(p[0] // every for p in per),
               "streams_without_last_window_update": late,
               "by_stream": per,
               "scored_samples": sum(s["scored"] for s in streams),
               "sick_transitions": snap["sick_transitions"],
               "actions_fired": snap["actions_fired"],
               "messages_per_s": H2_STREAM_CALLS * H2_STREAM_MSGS / wall,
               "mib_per_s": H2_STREAM_CALLS * H2_STREAM_MSGS
               * H2_STREAM_BYTES / wall / 2 ** 20}
        if (len(streams) != H2_STREAM_CALLS or len(sids) != len(streams)
                or late is None or snap["actions_fired"]
                or out["scored_samples"]):
            raise AssertionError(f"h2 D: the sentinel's table disagrees "
                                 f"with the client's frames: {out}")
        out.update(scored_checks("h2 D", tele, tap, H2_STREAM_CALLS,
                                 launches, dev))
        return out, launches
    finally:
        await client.close()
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        await linker.close()


async def h2_part_e(loads, plans, disco: Path, dev: str):
    """The CLI: ``python -m linkerd_tpu_torch`` (with ``--device cpu``
    only when ``dev`` is the CPU) on the phase's h2 config with the
    telemeter and an admin server; H2_CLI_CALLS calm calls through its
    router, each answered by its destination, every one counted by the
    router and scored by the child's telemeter (read from
    ``/admin/metrics.json``); SIGTERM then exits 0."""
    port, admin = free_port(), free_port()
    cfg = json.loads(h2_config(disco, "", "", True, "none", 0))
    cfg["routers"][0]["servers"] = [{"port": port}]
    cfg.update(admin={"port": admin}, usage={"enabled": False})
    with tempfile.TemporaryDirectory() as work:
        path = Path(work) / "h2.json"
        path.write_text(json.dumps(cfg))
        argv = [sys.executable, "-m", "linkerd_tpu_torch", str(path)]
        if dev == "cpu":
            argv[3:3] = ["--device", "cpu"]
        with open(Path(work) / "linkerd.log", "w") as log:
            proc = subprocess.Popen(argv, cwd=ROOT, stdout=log,
                                    stderr=subprocess.STDOUT,
                                    env=dict(os.environ,
                                             PYTHONPATH=str(ROOT)))
        try:
            boot = await wait_ping(admin, lambda: proc.poll() is None,
                                   "h2 linkerd")
            res = await h2_traffic(loads, [port] * H2_CONNS, [
                p[:H2_CLI_CALLS // H2_CONNS] for p in plans[0]])
            calls = h2_call_checks(res, "E", False)
            calls.pop("by_server")
            n = len(res["ms"])
            flat = await wait_json(
                admin, "/admin/metrics.json",
                lambda f: f.get("anomaly/scored_total") == n,
                "h2 E: every call's row scored")
            counted = (flat[f"rt/{H2_LABEL}/server/requests"],
                       flat["anomaly/requests_total"])
            if counted != (n, n):
                raise AssertionError(f"h2 E: {n} calls, router and "
                                     f"telemeter counted {counted}")
        finally:
            stop = stop_process(proc, "h2 linkerd")
    return {"boot_ms": boot, **calls, "scored": n,
            "batches": flat["anomaly/batches"], **stop}


@contextlib.asynccontextmanager
async def h2_topology(seed: int, sizes=(H2_CALM, H2_FAULTED)):
    """``linker_topology`` with the gRPC backends and the h2 load
    clients, ``sizes`` calm and faulted calls over H2_CONNS connections,
    and a self-signed pair for the TLS server; yields ``(loads, flag,
    plans, disco, cert, key)``."""
    async with linker_topology(seed, sizes,
                               backend=h2_backends, load=h2_load,
                               conns=H2_CONNS) as (loads, flag, plans,
                                                   disco):
        with tempfile.TemporaryDirectory() as certs:
            yield (loads, flag, plans, disco, *cli_certs(Path(certs)))


async def h2_phase(seed: int = 12, dev: str = "cuda",
                   parts=("A", "B", "C", "D", "E")):
    """Parts A (io.l5d.jaxAnomaly without accrual or training), B
    (the io.l5d.jaxAnomaly accrual, training at the reference's
    cadence), C (no telemetry block: the router's own rate) and D
    (server-streaming calls through ``streamScoring``) and E (the same
    router through the linkerd CLI) over ``h2_topology``. Returns the
    results and the kernel's launches in this process."""
    res, launches = {}, 0
    async with h2_topology(seed, H2_PHASE_SIZES) as (
            loads, flag, plans, disco, cert, key):
        runs = {"A": ("part_a", (True, "none", 0)),
                "B": ("part_b", (True, "io.l5d.jaxAnomaly", 8)),
                "C": ("no_telemetry", (False, "none", 0))}
        for part in parts:
            if part == "E":
                res["part_e"], n = await h2_part_e(loads, plans, disco,
                                                   dev), 0
            elif part == "D":
                res["part_d"], n = await h2_part_d(h2_config(
                    disco, cert, key, True, "none", 0,
                    stream_scoring=True), dev)
            else:
                name, args = runs[part]
                res[name], n = await h2_part(
                    part, h2_config(disco, cert, key, *args), loads, flag,
                    plans, cert, dev)
            launches += n
    for name, r in res.items():
        if name == "part_e":
            print(f"h2 E (the CLI): /ping after {r['boot_ms']:.1f} ms; "
                  f"{r['calls']} calls at {r['calls_per_s']:.0f} calls/s, "
                  f"p50 {r['p50_ms']:.3f} ms, p99 {r['p99_ms']:.3f} ms; "
                  f"{r['scored']} rows scored in {r['batches']} batches; "
                  f"stopped in {r['stop_ms']:.0f} ms")
            continue
        if name == "part_d":
            print(f"h2 D: {r['streams']} streams; the client sent "
                  f"{r['client_data_frames']} DATA and "
                  f"{r['client_window_update_frames']} WINDOW_UPDATE "
                  f"frames; {r['samples']} samples for "
                  f"{r['predicted_samples']} predicted "
                  f"({r['streams_without_last_window_update']} streams "
                  f"without their last WINDOW_UPDATE); "
                  f"{r['messages_per_s']:.0f} messages/s, "
                  f"{r['mib_per_s']:.1f} MiB/s; {r['launches']} launches "
                  f"for {r['batches']} batches")
            continue
        for w in ("calm", "faulted"):
            t = r[w]
            print(f"h2 {name} {w}: {t['calls_per_s']:.0f} calls/s, p50 "
                  f"{t['p50_ms']:.3f} ms, p99 {t['p99_ms']:.3f} ms, "
                  f"{t['unavailable']} UNAVAILABLE; " + ", ".join(
                      f"{s} {v['calls_per_s']:.0f}/s p50 {v['p50_ms']:.3f} "
                      f"p99 {v['p99_ms']:.3f}"
                      for s, v in t["by_server"].items()))
        print(f"h2 {name}: {r['retries']} retries, {r['tls_handshakes']} TLS "
              f"handshakes (ALPN h2); the router's own ms (p50/p99): "
              + ", ".join(f"{k} {v['p50']:.3f}/{v['p99']:.3f}"
                          for k, v in r["router_ms"].items()))
        if "launches" in r:
            print(f"h2 {name}: {r['launches']} launches for {r['batches']} "
                  f"batches, batch sizes {r['batch_sizes']}")
    if "part_a" in res:
        a = res["part_a"]
        print(f"h2 A: kernel vs plain max|diff| {a['kernel_vs_plain_max']:.3e}"
              f", board vs plain fold {a['board_vs_plain_fold_max']:.3e}; "
              f"h2c probe {a['h2c_probe']}")
    if "part_b" in res:
        print(f"h2 B: removals {res['part_b']['removals']}")
    return res, launches


# The h2fast phase: BASELINE config 2 (benchmarks/config2_grpc.py: an h2
# router with ``fastPath: true`` and io.l5d.prometheus) served by the
# port's native h2 engine (native/h2_fastpath.cpp through
# ``native.H2FastPathEngine``), over the h2 phase's topology: 40 × 2 gRPC
# backends of the port's runtime in 2 processes (4 faulted: 40 ms, then
# UNAVAILABLE as a Trailers-Only ``:status 503`` at 0.9) and 8 h2
# connections × 16 streams from 2 load processes. Part A: the router
# with io.l5d.jaxAnomaly at ``nativeTier: off`` (every engine row
# drained into the telemeter's native ring and scored by the kernel);
# the same router with no telemeter, then saturation readings by
# ``h2bench load`` through the engine (1 and 4 workers) and straight to
# ``h2bench serve``. Part B: the engine's options: ``workers: 4``, a
# cleartext and a native-TLS server (ALPN h2), ``connectionGuard``'s
# flood caps against rapid-reset clients, ``streamScoring`` on
# server-streaming calls, a server ``timeoutMs`` against a hung backend.
# Part C: the part-A router bound through the port's namerd (``python -m
# linkerd_tpu_torch.namerd``, io.l5d.mesh and httpController) with
# ``interpreter: io.l5d.mesh``: a dtab write moves one destination to
# other replicas, then namerd restarts.
H2FAST_LABEL = "h2fast"
H2FAST_WORKERS = 4
H2FAST_RST_BURST = 20         # part B's connectionGuard.rstBurst
H2FAST_FLOODERS = 4           # rapid-reset clients in part B, each
H2FAST_FLOOD_RESETS = 100     # ... resetting this many streams (the
                              # engine's default cap is 200)
H2FAST_TIMEOUT_MS = 500       # part B's servers[].timeoutMs
H2FAST_WATCHES = 8            # part B's server-streaming calls, one at a
H2FAST_WATCH_MSGS = 64        # time, of this many messages each
H2FAST_SAMPLE_FRAMES = 8      # part B's sampleEveryFrames (minGapMs 0)
H2FAST_PROBES = 16            # part B's one-call connections
H2FAST_MOVED = 5              # part C's moved destination
H2FAST_BURST = 256            # part C's calls a connection a burst
H2FAST_REROUTE_S = 5.0        # part C's loose bound on a reroute
H2FAST_RECONNECT_S = 30.0     # ... and on following namerd's restart
                              # (its boot, ~8 s, then the backoff,
                              # up to 10 s an attempt)
H2FAST_PARTS = ("A", "B", "C")


def h2fast_config(disco: Path, telemetry: bool, **router) -> str:
    """BASELINE config 2 as JSON text (the h2 engine, io.l5d.prometheus,
    the fs namer), with ``telemetry`` the io.l5d.jaxAnomaly telemeter at
    ``nativeTier: off`` with training off; ``router`` adds or replaces
    router keys (an ``interpreter`` drops the router's dtab)."""
    r = {"protocol": "h2", "label": H2FAST_LABEL, "fastPath": True,
         "dtab": "/svc => /#/io.l5d.fs ;", "servers": [{"port": 0}]}
    r.update(router)
    if "interpreter" in router:
        del r["dtab"]
    tele = [{"kind": "io.l5d.prometheus"}]
    if telemetry:
        tele.append({"kind": "io.l5d.jaxAnomaly", "trainEveryBatches": 0,
                     "reconWeight": 1.0, "nativeTier": "off"})
    return json.dumps({"routers": [r], "telemetry": tele, "namers": [
        {"kind": "io.l5d.fs", "rootDir": str(disco)}]})


def h2fast_linker(text: str, dev: str, what: str):
    """The linker of ``text``, failing unless its router is served by the
    h2 engine (never the Python data plane it falls back to without
    OpenSSL)."""
    from linkerd_tpu_torch import native
    from linkerd_tpu_torch.linker import load_linker

    if not native.H2FastPathEngine.tls_runtime_available():
        raise AssertionError(f"h2fast {what}: the engine cannot load the "
                             f"OpenSSL runtime")
    linker = load_linker(text, device=dev)
    router = linker.routers[0]
    kinds = (type(router).__name__,
             type(getattr(getattr(router, "controller", None), "engine",
                          None)).__name__)
    if kinds != ("_FastPathRouter", "H2FastPathEngine"):
        raise AssertionError(f"h2fast {what}: a fastPath: true router came "
                             f"up as {kinds}")
    return linker, router


def h2fast_call_checks(res: dict, what: str, faults_on: bool,
                       moved: dict = None) -> dict:
    """``h2_call_checks``, and with the faults on every call that failed
    was to a faulted destination and carried grpc-status 14 (the engine
    passes the backend's trailers through). ``moved``: destination ->
    the answerer codes that must answer it instead of its own replicas
    (part C)."""
    res = dict(res)
    moved = moved or {}
    sel = np.isin(res["dst"], list(moved))
    if sel.any():
        ok = np.array([w in moved[d] for d, w in zip(res["dst"][sel],
                                                     res["who"][sel])])
        if not (ok & (res["status"][sel] == 0)).all():
            raise AssertionError(f"h2fast {what}: calls to the moved "
                                 f"destination answered by "
                                 f"{sorted(set(res['who'][sel].tolist()))}")
        res["right"] = res["right"] | sel
    out = h2_call_checks(res, what, faults_on)
    out.pop("by_server")
    bad = (res["status"] != 0) & ~((res["dst"] < TELE_FAULTED) & faults_on
                                   & (res["status"] == 14))
    if bad.any():
        i = int(np.flatnonzero(bad)[0])
        raise AssertionError(f"h2fast {what}: tele-{res['dst'][i]:02d} "
                             f"answered grpc code {res['status'][i]}")
    if faults_on and not out["unavailable"]:
        raise AssertionError(f"h2fast {what}: no injected UNAVAILABLE "
                             f"passed through")
    return out


async def prometheus_scrape(linker) -> dict:
    """The io.l5d.prometheus telemeter's scrape, through its own handler:
    the engine's route counters (``rt/<label>/fastpath/route/*``) summed
    by counter."""
    from linkerd_tpu_torch.protocol.http.message import Request

    prom = next(t for t in linker.telemeters
                if type(t).__name__ == "PrometheusTelemeter")
    (_, handler), = prom.admin_handlers()
    t0 = time.perf_counter()
    body = (await handler(Request(uri="/admin/metrics/prometheus"))).body
    ms = (time.perf_counter() - t0) * 1e3
    values = prometheus_values(body.decode())
    tail = f'{{rt="{H2FAST_LABEL}"}}'
    out = {"scrape_ms": ms, "lines": len(values)}
    for counter in ("requests", "success", "f5xx"):
        out[counter] = int(sum(
            v for k, v in values.items() if k.startswith("fastpath_route_")
            and k.endswith(f"_{counter}{tail}")))
    return out


def fold_counts(tap) -> dict:
    """Rows folded into the board, by destination, over every fold."""
    got: dict = {}
    for _, dsts, inv, _ in tap.folds:
        for d, n in zip(dsts, np.bincount(inv, minlength=len(dsts))):
            got[d] = got.get(d, 0) + int(n)
    return got


def dst_counts(*results, extra: dict = None) -> dict:
    """Calls sent, by destination path, over load results."""
    out = dict(extra or {})
    for res in results:
        for d, n in zip(*np.unique(res["dst"], return_counts=True)):
            key = f"/svc/tele-{int(d):02d}"
            out[key] = out.get(key, 0) + int(n)
    return out


def h2fast_row_checks(what: str, tele, tap, ctl, sent: int, launches: int,
                      expect: dict, dev: str, samples: int = 0) -> dict:
    """Every engine row (``sent`` requests and ``samples`` stream
    samples) reached the telemeter and was scored, no drop; the rows
    folded by destination equal ``expect`` (a stream's samples fold under
    its destination); one launch a batch with device rows."""
    flat = tele.metrics.flatten()
    bad = {k: flat[f"anomaly/{k}"] for k in (
        "score_failures", "dropped_batches", "degraded")
        if flat[f"anomaly/{k}"]}
    rows, scored = flat["anomaly/requests_total"], flat["anomaly/scored_total"]
    drops = flat["anomaly/native_ring_dropped"]
    engine = ctl.engine.stats()
    print(f"h2fast {what}: {sent} calls, {samples} stream samples, {rows} "
          f"engine rows, {scored} scored, ring drops {drops}")
    if bad or drops or engine.get("features_dropped") or scored != rows \
            or rows != sent + samples:
        raise AssertionError(f"h2fast {what}: {sent} calls + {samples} "
                             f"samples, {rows} rows, {scored} scored, "
                             f"{drops} dropped, {bad}")
    got = fold_counts(tap)
    if got != expect:
        diff = {k: (got.get(k, 0), expect.get(k, 0))
                for k in sorted(set(got) | set(expect))
                if got.get(k, 0) != expect.get(k, 0)}
        raise AssertionError(f"h2fast {what}: rows by destination differ "
                             f"from the calls sent (rows, calls): {diff}")
    with_device = sum(len(b["x"]) > 0 for b in tap.batches)
    if launches != (0 if dev == "cpu" else with_device) or \
            len(tap.scored) != with_device:
        raise AssertionError(
            f"h2fast {what}: {launches} kernel launches, {with_device} "
            f"batches with device rows, {len(tap.scored)} score calls")
    pub = np.asarray(tap.publish_ms)
    return dict(launches=launches, batches=flat["anomaly/batches"],
                batches_with_device_rows=with_device,
                batch_sizes=batch_sizes(tap), rows=rows,
                score_and_publish_p50_ms=float(np.percentile(pub, 50)),
                score_and_publish_p99_ms=float(np.percentile(pub, 99)))


def h2fast_window_checks(what: str, tele, tap, snap, start: int,
                         first: int, dev: str) -> dict:
    """The faulted calls' rows (score calls from ``start``, batches from
    ``first``) under the frozen model ``snap``: the kernel against the
    plain version on every row, and the board against a plain fold."""
    x, got, dsts = tap.window_rows(first, start)
    plain = plain_scores(snap, x, dev)
    cuts = np.cumsum([len(xx) for xx, _ in tap.scored[start:]])[:-1]
    gap = fastpath_board_check(tele, tap, start, np.split(plain, cuts))
    print(f"h2fast {what}: board vs plain fold {gap:.3e}")
    if gap > TOL:
        raise AssertionError(f"h2fast {what}: board off the plain fold by "
                             f"{gap} > {TOL}")
    faulted = set(tele_routes()[:TELE_FAULTED])
    labels = np.array([d in faulted for d in dsts], np.float32)
    rows = linker_gap_report(got, plain, x, snap, labels, dev,
                             what=f"h2fast {what}")
    return dict(board_vs_plain_fold_max=gap, kernel_vs_plain=rows,
                kernel_vs_plain_max=rows["kernel_vs_plain_max"],
                window_rows=len(got))


async def h2fast_part_a(text: str, loads, flag, plans, dev: str):
    """One config-2 router from ``text`` (with or without the telemeter)
    under H2_CALM calm calls, then H2_FAULTED faulted ones. With the
    telemeter: a frozen traffic-fitted model for the faulted calls, held
    against plain."""
    from linkerd_tpu_torch.core.tasks import monitor
    from linkerd_tpu_torch.ops.scoring import fused_anomaly_scores

    linker, router = h2fast_linker(text, dev, "A")
    await linker.start()
    ctl, port = router.controller, router.server_ports[0]
    tele = next((t for t in linker.telemeters
                 if hasattr(t, "native_ring")), None)
    tap = task = None
    out = {}
    try:
        if tele is not None:
            tap = FastPathTap(tele)
            task = monitor(asyncio.create_task(tele.run()),
                           what=f"telemeter-{type(tele).__name__}")
        fused_anomaly_scores.launches = 0
        flag.value = 0
        calm = await linker_traffic(loads, [port] * H2_CONNS, plans[0])
        sent = len(calm["ms"])
        if tele is not None:
            await tap.settle(tele, task, sent, "h2fast A calm")
            if not tap.scored:
                raise AssertionError("h2fast A: no row of the calm calls "
                                     "was scored")
            snap = traffic_model(tele, tap)
            start, first = len(tap.scored), len(tap.batches)
        flag.value = 1
        faulted = await linker_traffic(loads, [port] * H2_CONNS, plans[1])
        sent += len(faulted["ms"])
        if tele is not None:
            await tap.settle(tele, task, sent, "h2fast A faulted")
        flag.value = 0
        launches = fused_anomaly_scores.launches
        out["calm"] = h2fast_call_checks(calm, "A calm", False)
        out["faulted"] = h2fast_call_checks(faulted, "A faulted", True)
        ctl._export_stats()
        stats = ctl.engine.stats()
        served = sum(int(r["requests"]) for r in stats["routes"].values())
        out["prometheus"] = prom = await prometheus_scrape(linker)
        if served != sent or prom["requests"] != sent:
            raise AssertionError(f"h2fast A: {sent} calls sent, the engine "
                                 f"served {served}, the scrape counts "
                                 f"{prom['requests']}")
        if tele is None:
            return out, launches
        out.update(h2fast_row_checks("A", tele, tap, ctl, sent, launches,
                                     dst_counts(calm, faulted), dev))
        out.update(h2fast_window_checks("A", tele, tap, snap, start, first,
                                        dev))
        routes = tele_routes()
        board = {d: tele.board.score_of(d) for d in routes}
        out["board_levels"] = {
            "faulted_min": min(board[d] for d in routes[:TELE_FAULTED]),
            "calm_max": max(board[d] for d in routes[TELE_FAULTED:])}
        return out, launches
    finally:
        if task is not None:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
        await linker.close()


async def h2bench_load(port: int, what: str) -> dict:
    """``h2bench load``: 8 connections × 16 streams (2 connections for
    each of 4 workers), 128-byte echo messages, SATURATION_S seconds,
    closed loop, to authority ``echo``."""
    from linkerd_tpu_torch.native import _build as native_build

    proc = await asyncio.create_subprocess_exec(
        str(native_build.build("h2bench")), "load", "127.0.0.1", str(port),
        "echo", str(H2_CONNS * H2_STREAMS), str(SATURATION_S), "128",
        "--conns-per-worker", str(H2_CONNS // H2FAST_WORKERS), "--workers",
        str(H2FAST_WORKERS), stdout=asyncio.subprocess.PIPE)
    stdout, _ = await asyncio.wait_for(proc.communicate(), SATURATION_S + 30)
    res = json.loads(stdout.decode().strip().splitlines()[-1])
    if proc.returncode or res["errors"] or not res["reqs"]:
        raise AssertionError(f"h2bench load {what}: rc {proc.returncode}, "
                             f"{res}")
    return res


async def h2fast_saturation(disco: Path, dev: str) -> dict:
    """Closed-loop readings by ``h2bench load`` with ``h2bench serve`` as
    the backend: through the config-2 router's engine with one worker
    and with H2FAST_WORKERS, then straight to the backend."""
    from linkerd_tpu_torch.native import _build as native_build

    serve = await asyncio.create_subprocess_exec(
        str(native_build.build("h2bench")), "serve", "0",
        stdout=asyncio.subprocess.PIPE)
    out = {}
    try:
        line = await asyncio.wait_for(serve.stdout.readline(), 30)
        backend = json.loads(line)["listening"]
        (disco / "echo").write_text(f"127.0.0.1 {backend}\n")
        for workers in (1, H2FAST_WORKERS):
            name = f"engine_{workers}_worker{'s' if workers > 1 else ''}"
            linker, router = h2fast_linker(
                h2fast_config(disco, False, workers=workers), dev, name)
            await linker.start()
            try:
                out[name] = await h2bench_load(router.server_ports[0], name)
            finally:
                await linker.close()
        out["direct"] = await h2bench_load(backend, "direct")
    finally:
        serve.send_signal(signal.SIGTERM)
        await asyncio.wait_for(serve.communicate(), 30)
        (disco / "echo").unlink()
    print(f"h2bench load, {H2_CONNS} connections x {H2_STREAMS} streams: " +
          "; ".join(f"{k} {v['rps']:.0f} calls/s, p50 {v['p50_ms']:.3f} ms, "
                    f"p99 {v['p99_ms']:.3f} ms" for k, v in out.items()))
    return out


async def grpc_backend(name: str, hang: asyncio.Event = None):
    """An in-process gRPC backend of the phase's service answering
    ``name``; with ``hang``, one that starts no response until it is
    set. Its server connections count the DATA frames they write on each
    stream (``FrameCount``)."""
    from linkerd_tpu_torch.grpc import ServerDispatcher
    from linkerd_tpu_torch.protocol.h2.server import H2Server
    from linkerd_tpu_torch.router.service import FnService

    tele_msg, svc = h2_proto()
    pad = bytes(H2_STREAM_BYTES)
    disp = ServerDispatcher()

    async def echo(req):
        return tele_msg(text=name)

    async def watch(req):
        async def gen():
            for i in range(req.n):
                yield tele_msg(text=name, n=i, pad=pad)
        return gen()

    disp.register_all(svc, {"Echo": echo, "Watch": watch})
    service = disp
    if hang is not None:
        async def never(req):
            await hang.wait()
            return await disp(req)
        service = FnService(never)
    counts: list = []

    class Counting(set):
        """The server's connection set: each connection is added before
        it starts, and its writes are counted from then on."""

        def add(self, conn):
            counts.append(FrameCount(conn))
            super().add(conn)

    srv = H2Server(service)
    srv._conns = Counting()
    srv.frame_counts = counts
    return await srv.start()


async def rapid_reset_client(port: int, authority: str) -> str:
    """One connection that opens H2FAST_FLOOD_RESETS streams to
    ``authority`` and resets each at once (CVE-2023-44487): "closed"
    when the router ends the connection within 5 s (a GOAWAY, or a
    reset of the unread frames), else "open"."""
    from linkerd_tpu_torch.protocol.h2 import frames, hpack

    r, w = await asyncio.open_connection("127.0.0.1", port)
    enc = hpack.Encoder()
    try:
        w.write(frames.CONNECTION_PREFACE + frames.pack_settings([]))
        for i in range(H2FAST_FLOOD_RESETS):
            sid = 2 * i + 1
            block = enc.encode([
                (":method", "POST"), (":scheme", "http"),
                (":path", f"/{H2_SERVICE}/Echo"), (":authority", authority),
                ("content-type", "application/grpc"), ("te", "trailers")])
            w.write(frames.pack_frame(frames.HEADERS,
                                      frames.FLAG_END_HEADERS, sid, block)
                    + frames.pack_rst(sid, frames.CANCEL))
        await w.drain()
        t0 = time.monotonic()
        while time.monotonic() - t0 < 5.0:
            head = await asyncio.wait_for(r.read(9), 5.0)
            if len(head) < 9:
                return "closed"
            fh = frames.unpack_header(head)
            payload = await r.readexactly(fh.length)
            if fh.type == frames.GOAWAY and int.from_bytes(
                    payload[4:8], "big") == frames.ENHANCE_YOUR_CALM:
                return "closed"
        return "open"
    except asyncio.TimeoutError:
        return "open"
    except (ConnectionError, asyncio.IncompleteReadError):
        return "closed"
    finally:
        w.close()


async def hung_call(port: int) -> dict:
    """One Echo call to ``h2fast-hang``, whose backend never starts its
    response: the status the router answers and the ms it took."""
    from linkerd_tpu_torch.grpc.codec import Codec
    from linkerd_tpu_torch.protocol.h2.client import H2Client
    from linkerd_tpu_torch.protocol.h2.messages import H2Request

    tele_msg, _ = h2_proto()
    body = Codec(tele_msg).encode_frame(tele_msg(text="hung"))
    h2 = H2Client("127.0.0.1", port)
    try:
        t0 = time.perf_counter()
        rsp = await asyncio.wait_for(h2(H2Request(
            method="POST", path=f"/{H2_SERVICE}/Echo",
            authority="h2fast-hang", body=body)), 10 + H2FAST_TIMEOUT_MS / 1e3)
        await asyncio.wait_for(rsp.stream.read_all(max_bytes=1 << 20), 10)
        return {"status": rsp.status, "ms": (time.perf_counter() - t0) * 1e3,
                "l5d_err": rsp.headers.get("l5d-err")}
    finally:
        await h2.close()


async def watch_calls(port: int, backend) -> dict:
    """H2FAST_WATCHES server-streaming calls of H2FAST_WATCH_MSGS messages
    to ``h2fast-stream``, one at a time on one connection whose frames
    are counted, as the backend counts its own: the frames the engine
    sees on each call (the client's DATA and WINDOW_UPDATE frames, the
    backend's DATA frames) and the samples they predict, one each
    H2FAST_SAMPLE_FRAMES frames (one fewer frame when the client's last
    WINDOW_UPDATE reaches the engine after the stream has ended)."""
    from linkerd_tpu_torch.grpc import ClientDispatcher
    from linkerd_tpu_torch.protocol.h2.client import H2Client

    tele_msg, svc = h2_proto()
    h2 = H2Client("127.0.0.1", port)
    try:
        count = FrameCount(await h2._get_conn())
        stub = ClientDispatcher(h2, authority="h2fast-stream")
        t0 = time.perf_counter()
        for _ in range(H2FAST_WATCHES):
            reps = await stub.server_stream(svc, "Watch",
                                            tele_msg(n=H2FAST_WATCH_MSGS))
            got = [m.n async for m in reps]
            if got != list(range(H2FAST_WATCH_MSGS)):
                raise AssertionError(f"h2fast B: a Watch call streamed "
                                     f"{len(got)} messages out of order")
        wall = time.perf_counter() - t0
    finally:
        await h2.close()
    sids = sorted(set(count.data) | set(count.window))
    up = [n for c in backend.frame_counts for _, n in sorted(c.data.items())]
    if len(sids) != H2FAST_WATCHES or len(up) != H2FAST_WATCHES:
        raise AssertionError(f"h2fast B: {len(sids)} client streams, "
                             f"{len(up)} upstream streams for "
                             f"{H2FAST_WATCHES} Watch calls")
    every = H2FAST_SAMPLE_FRAMES
    calls = []
    for sid, u in zip(sids, up):
        frames_ = count.data.get(sid, 0) + count.window.get(sid, 0) + u
        calls.append({"frames": frames_, "upstream_data": u,
                      "predicted": [(frames_ - 1) // every,
                                    frames_ // every]})
    return {"calls": calls, "wall_s": wall,
            "messages_per_s": H2FAST_WATCHES * H2FAST_WATCH_MSGS / wall}


async def h2fast_part_b(loads, flag, plans, disco: Path, cert: str,
                        key: str, dev: str):
    """The engine's options on one router: ``workers``, a cleartext and a
    native-TLS server with ``timeoutMs``, ``connectionGuard``'s flood
    caps and ``streamScoring``, the telemeter at ``nativeTier: off`` with
    its untrained model. Beside H2_CALM calm calls (half the connections
    over TLS): rapid-reset clients, the Watch calls, a call to a hung
    backend and H2FAST_PROBES one-call connections."""
    from linkerd_tpu_torch.core.tasks import monitor
    from linkerd_tpu_torch.ops.scoring import fused_anomaly_scores
    from linkerd_tpu_torch.telemetry.linerate import (
        NATIVE_COL_KIND, NATIVE_KIND_STREAM,
    )

    hang = asyncio.Event()
    stream_be = await grpc_backend("h2fast-stream/0")
    hung_be = await grpc_backend("h2fast-hang/0", hang)
    (disco / "h2fast-stream").write_text(
        f"127.0.0.1 {stream_be.bound_port}\n")
    (disco / "h2fast-hang").write_text(f"127.0.0.1 {hung_be.bound_port}\n")
    servers = [{"port": 0, "timeoutMs": H2FAST_TIMEOUT_MS},
               {"port": 0, "timeoutMs": H2FAST_TIMEOUT_MS,
                "tls": {"certPath": cert, "keyPath": key}}]
    linker, router = h2fast_linker(h2fast_config(
        disco, True, workers=H2FAST_WORKERS, servers=servers,
        connectionGuard={"rstBurst": H2FAST_RST_BURST},
        streamScoring={"sampleEveryFrames": H2FAST_SAMPLE_FRAMES,
                       "minGapMs": 0, "tableCap": 65536,
                       "action": "observe"}), dev, "B")
    task = None
    try:
        await linker.start()
        ctl = router.controller
        clear, tls = router.server_ports
        tele = next(t for t in linker.telemeters
                    if hasattr(t, "native_ring"))
        tap = FastPathTap(tele)
        snap = tele._scorer.snapshot()  # training off: the one model
        task = monitor(asyncio.create_task(tele.run()),
                       what=f"telemeter-{type(tele).__name__}")
        fused_anomaly_scores.launches = 0
        flag.value = 0
        targets = [clear if i % 2 == 0 else (tls, cert)
                   for i in range(H2_CONNS)]
        traffic = asyncio.ensure_future(linker_traffic(loads, targets,
                                                       plans[0]))
        floods = [asyncio.ensure_future(rapid_reset_client(
            clear, f"tele-{TELE_ROUTES - 1:02d}"))
            for _ in range(H2FAST_FLOODERS)]
        hung = asyncio.ensure_future(hung_call(clear))
        watch = await watch_calls(clear, stream_be)
        probes = []
        for i in range(H2FAST_PROBES):
            d = TELE_FAULTED + i % (TELE_ROUTES - TELE_FAULTED)
            client = h2_client(clear)
            try:
                probes.append(await h2_probe_call(client, d))
            finally:
                await client.close()
        flooded = await asyncio.gather(*floods)
        hung_res = await hung
        calm = await traffic
        sent = len(calm["ms"]) + H2FAST_WATCHES + 1 + H2FAST_PROBES
        streams = ctl.engine.streams()
        samples = sum(int(e["samples"]) for w in streams["workers"]
                      for e in w["by_stream"].values())
        await tap.settle(tele, task, sent + samples, "h2fast B")
        launches = fused_anomaly_scores.launches
        ctl._export_stats()
        stats = ctl.engine.stats()
        flat = linker.metrics.flatten()
        sentinel = ctl.stream_sentinel.snapshot()
        out = {"calm": h2fast_call_checks(calm, "B", False)}
        bad = [d for d, ok in probes if not ok]
        if bad:
            raise AssertionError(f"h2fast B: one-call connections to {bad} "
                                 f"not answered by their destination")
        expect = dst_counts(calm, extra={"/svc/h2fast-hang": 1})
        for d, _ in probes:
            key_ = f"/svc/tele-{d:02d}"
            expect[key_] = expect.get(key_, 0) + 1
        expect["/svc/h2fast-stream"] = H2FAST_WATCHES + samples
        out.update(h2fast_row_checks("B", tele, tap, ctl, sent, launches,
                                     expect, dev, samples=samples))
        out["workers"] = shard_worker_checks(
            stats, flat, H2FAST_LABEL, H2FAST_WORKERS, "h2fast B")
        if out["workers"]["merged_requests"] != sent:
            raise AssertionError(
                f"h2fast B: {sent} calls sent, the engine served "
                f"{out['workers']['merged_requests']}")
        tls_conns = sum(isinstance(t, tuple) for t in targets)
        out["tls"] = {k: int(stats["tls"][k]) for k in (
            "handshakes", "failures", "alpn_h2", "alpn_http1")}
        if out["tls"] != {"handshakes": tls_conns, "failures": 0,
                          "alpn_h2": tls_conns, "alpn_http1": 0}:
            raise AssertionError(f"h2fast B: {out['tls']} for {tls_conns} "
                                 f"TLS connections")
        guard = stats["guard"]
        out["flood"] = {"clients": flooded, "rapid_reset_closed": int(
            guard["rapid_reset_closed"]), "flood_closed": int(
            guard["flood_closed"]), "exported": flat.get(
            f"rt/{H2FAST_LABEL}/fastpath/guard/rapid_reset_closed")}
        if flooded != ["closed"] * H2FAST_FLOODERS or \
                out["flood"]["rapid_reset_closed"] != H2FAST_FLOODERS or \
                out["flood"]["exported"] != H2FAST_FLOODERS:
            raise AssertionError(f"h2fast B: rapid-reset clients "
                                 f"{out['flood']}")
        out["hung"] = hung_res
        if hung_res["status"] != 504 or not H2FAST_TIMEOUT_MS * 0.9 <= \
                hung_res["ms"] <= H2FAST_TIMEOUT_MS + 1000:
            raise AssertionError(f"h2fast B: the hung backend's call "
                                 f"{hung_res}, timeoutMs {H2FAST_TIMEOUT_MS}")
        rows = np.concatenate(tap.raw)
        kind1 = int((rows[:, NATIVE_COL_KIND] == NATIVE_KIND_STREAM).sum())
        sent_samples = sorted(
            (int(k), int(e["samples"]))
            for k, e in sentinel["by_stream"].items())
        out["streams"] = {**watch, "engine_samples": samples,
                          "kind1_rows_drained": kind1,
                          "sentinel_samples": [s for _, s in sent_samples]}
        within = len(sent_samples) == H2FAST_WATCHES and all(
            lo <= s <= hi for (_, s), (lo, hi) in zip(
                sent_samples, (c["predicted"] for c in watch["calls"])))
        if not samples or not kind1 == samples == sum(
                s for _, s in sent_samples) or not within:
            raise AssertionError(f"h2fast B: stream samples {out['streams']}")
        x = np.concatenate([xx for xx, _ in tap.scored])
        got = np.concatenate([s for _, s in tap.scored])
        plain = plain_scores(snap, x, dev)
        cuts = np.cumsum([len(xx) for xx, _ in tap.scored])[:-1]
        gap = fastpath_board_check(tele, tap, 0, np.split(plain, cuts))
        if gap > TOL:
            raise AssertionError(f"h2fast B: board off the plain fold by "
                                 f"{gap} > {TOL}")
        out.update(board_vs_plain_fold_max=gap,
                   kernel_vs_plain=linker_gap_report(
                       got, plain, x, snap, np.zeros(len(got)), dev,
                       what="h2fast B"))
        out["kernel_vs_plain_max"] = out["kernel_vs_plain"][
            "kernel_vs_plain_max"]
        return out, launches
    finally:
        if task is not None:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
        await linker.close()
        hang.set()
        await stream_be.close()
        await hung_be.close()
        for name in ("h2fast-stream", "h2fast-hang"):
            (disco / name).unlink()


async def h2_probe_call(client, d: int) -> tuple:
    """One Echo call to ``tele-DD`` on ``client``: (d, answered by a
    replica of its destination)."""
    from linkerd_tpu_torch.grpc import ClientDispatcher

    tele_msg, svc = h2_proto()
    rep = await asyncio.wait_for(ClientDispatcher(
        client, authority=f"tele-{d:02d}").unary(svc, "Echo",
                                                 tele_msg(text="p")), 10)
    return d, rep.text.startswith(f"tele-{d:02d}/")


async def until_answered_by(client, d: int, prefix: str,
                            timeout: float) -> tuple:
    """Echo calls to ``tele-DD``, one after another, until one is
    answered by a backend whose name starts with ``prefix``: (ms to that
    answer, calls made). Fails after ``timeout`` s."""
    from linkerd_tpu_torch.grpc import ClientDispatcher, GrpcError

    tele_msg, svc = h2_proto()
    stub = ClientDispatcher(client, authority=f"tele-{d:02d}")
    t0, calls = time.perf_counter(), 0
    while time.perf_counter() - t0 < timeout:
        calls += 1
        try:
            rep = await asyncio.wait_for(stub.unary(svc, "Echo", tele_msg(
                text="r")), 10)
        except GrpcError:
            continue
        if rep.text.startswith(prefix):
            return (time.perf_counter() - t0) * 1e3, calls
        await asyncio.sleep(0.002)
    raise AssertionError(f"h2fast C: tele-{d:02d} not answered by {prefix}* "
                         f"within {timeout} s")


async def namerd_put(port: int, dtab: str) -> int:
    """PUT the ``default`` namespace through namerd's HTTP API."""
    from linkerd_tpu_torch.protocol.http.client import HttpClient
    from linkerd_tpu_torch.protocol.http.message import Request

    client = HttpClient("127.0.0.1", port, max_connections=1)
    try:
        req = Request(method="PUT", uri="/api/1/dtabs/default",
                      body=dtab.encode())
        req.headers.set("Content-Type", "application/dtab")
        rsp = await asyncio.wait_for(client(req), 10)
    finally:
        await client.close()
    if rsp.status != 204:
        raise AssertionError(f"h2fast C: namerd PUT answered {rsp.status}")
    return rsp.status


def start_namerd(cfg: Path, log_path: Path):
    """``python -m linkerd_tpu_torch.namerd`` on ``cfg``, its output
    appended to ``log_path``."""
    with open(log_path, "a") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "linkerd_tpu_torch.namerd", str(cfg)],
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
            env=dict(os.environ, PYTHONPATH=str(ROOT)))


async def h2fast_part_c(loads, flag, plans, disco: Path, dev: str):
    """The config-2 router with the telemeter bound through the port's
    namerd CLI over the mesh API: a burst of calls; a dtab write moving
    ``tele-05`` to the ``tele-05-b`` replicas (in this process), the ms
    to their first answer, a burst; namerd stopped, a burst (the held
    state serves), namerd started again on its ports (its in-memory
    namespace back to the base dtab), the ms to the first answer of
    ``tele-05``'s own replicas, a burst. Every call answered by the
    replicas its dtab names, every row scored under its destination."""
    from linkerd_tpu_torch.core.tasks import monitor
    from linkerd_tpu_torch.ops.scoring import fused_anomaly_scores

    moved = f"tele-{H2FAST_MOVED:02d}"
    work = Path(tempfile.mkdtemp(prefix="h2fast-"))
    backs = [await grpc_backend(f"{moved}-b/{r}")
             for r in range(LINKER_REPLICAS)]
    (disco / f"{moved}-b").write_text("".join(
        f"127.0.0.1 {b.bound_port}\n" for b in backs))
    mesh, api, admin = free_port(), free_port(), free_port()
    cfg = work / "namerd.json"
    cfg.write_text(json.dumps({
        "storage": {"kind": "io.l5d.inMemory",
                    "namespaces": {"default": CONTROL_BASE_DTAB}},
        "interfaces": [{"kind": "io.l5d.mesh", "port": mesh},
                       {"kind": "io.l5d.httpController", "port": api}],
        "namers": [{"kind": "io.l5d.fs", "rootDir": str(disco)}],
        "admin": {"port": admin}}))
    namerd = start_namerd(cfg, work / "namerd.log")
    linker = task = client = None
    out = {}
    try:
        out["namerd_boot_ms"] = await wait_ping(
            admin, lambda: namerd.poll() is None, "namerd", timeout=60.0)
        linker, router = h2fast_linker(h2fast_config(
            disco, True, interpreter={
                "kind": "io.l5d.mesh", "dst": f"/$/inet/127.0.0.1/{mesh}",
                "root": "/default"}), dev, "C")
        await linker.start()
        port = router.server_ports[0]
        tele = next(t for t in linker.telemeters
                    if hasattr(t, "native_ring"))
        tap = FastPathTap(tele)
        task = monitor(asyncio.create_task(tele.run()),
                       what=f"telemeter-{type(tele).__name__}")
        fused_anomaly_scores.launches = 0
        flag.value = 0
        burst = [p[:H2FAST_BURST] for p in plans[1]]
        targets = [port] * H2_CONNS
        b_who = {H2FAST_MOVED: {FAILOVER_WHO + r
                                for r in range(LINKER_REPLICAS)}}
        client = h2_client(port)
        runs, calls = {}, 0
        runs["before"] = await linker_traffic(loads, targets, burst)
        out["before"] = h2fast_call_checks(runs["before"], "C before", False)
        # the write removes the destination's route and installs it again
        # (its new replicas resolve after the new tree arrives), under a
        # new route id; the rows of a route id the controller never read
        # on a stats tick stay under a placeholder (ROADMAP Queue 3):
        # one tick first
        await asyncio.sleep(router.controller.stats_poll_s + 0.2)
        t0 = time.perf_counter()
        await namerd_put(api, CONTROL_BASE_DTAB +
                         f" /svc/{moved} => /#/io.l5d.fs/{moved}-b ;")
        put_ms = (time.perf_counter() - t0) * 1e3
        ms, n = await until_answered_by(client, H2FAST_MOVED, f"{moved}-b/",
                                        H2FAST_REROUTE_S)
        calls += n
        out["reroute"] = {"put_ms": put_ms, "write_to_first_answer_ms":
                          put_ms + ms, "calls": n}
        runs["moved"] = await linker_traffic(loads, targets, burst)
        out["moved"] = h2fast_call_checks(runs["moved"], "C moved", False,
                                          moved=b_who)
        out["namerd_stop"] = stop_process(namerd, "namerd")
        runs["outage"] = await linker_traffic(loads, targets, burst)
        out["outage"] = h2fast_call_checks(runs["outage"], "C namerd down",
                                           False, moved=b_who)
        t0 = time.perf_counter()
        namerd = start_namerd(cfg, work / "namerd.log")
        ms, n = await until_answered_by(client, H2FAST_MOVED, f"{moved}/",
                                        H2FAST_RECONNECT_S)
        calls += n
        out["restart"] = {"start_to_first_answer_ms":
                          (time.perf_counter() - t0) * 1e3, "calls": n}
        runs["after"] = await linker_traffic(loads, targets, burst)
        out["after"] = h2fast_call_checks(runs["after"], "C after", False)
        sent = sum(len(r["ms"]) for r in runs.values()) + calls
        await tap.settle(tele, task, sent, "h2fast C")
        launches = fused_anomaly_scores.launches
        out.update(h2fast_row_checks(
            "C", tele, tap, router.controller, sent, launches,
            dst_counts(*runs.values(), extra={f"/svc/{moved}": calls}),
            dev))
        out["namerd_reboot_ms"] = await wait_ping(
            admin, lambda: namerd.poll() is None, "namerd", timeout=60.0)
        return out, launches
    finally:
        if client is not None:
            await client.close()
        if task is not None:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
        if linker is not None:
            await linker.close()
        if namerd.poll() is None:
            stop_process(namerd, "namerd")
        for b in backs:
            await b.close()
        (disco / f"{moved}-b").unlink()
        shutil.rmtree(work, ignore_errors=True)


async def h2fast_phase(seed: int = 12, dev: str = "cuda",
                       parts=H2FAST_PARTS):
    """Parts A (config 2 with the telemeter; then without it, and the
    saturation readings), B (the engine's options) and C (bound through
    namerd's mesh API) over ``h2_topology``. Returns the results and
    the kernel's launches."""
    res, launches = {}, 0
    async with h2_topology(seed) as (loads, flag, plans, disco, cert, key):
        if "A" in parts:
            res["part_a"], n = await h2fast_part_a(
                h2fast_config(disco, True), loads, flag, plans, dev)
            launches += n
            res["no_telemetry"], _ = await h2fast_part_a(
                h2fast_config(disco, False), loads, flag, plans, dev)
            res["saturation"] = await h2fast_saturation(disco, dev)
        if "B" in parts:
            res["part_b"], n = await h2fast_part_b(loads, flag, plans, disco,
                                                   cert, key, dev)
            launches += n
        if "C" in parts:
            res["part_c"], n = await h2fast_part_c(loads, flag, plans, disco,
                                                   dev)
            launches += n
    for name in ("part_a", "no_telemetry"):
        for w in ("calm", "faulted"):
            if name in res:
                t = res[name][w]
                print(f"h2fast {name} {w}: {t['calls_per_s']:.0f} calls/s, "
                      f"p50 {t['p50_ms']:.3f} ms, p99 {t['p99_ms']:.3f} ms, "
                      f"{t['unavailable']} UNAVAILABLE passed through")
    if "part_a" in res:
        a = res["part_a"]
        print(f"h2fast A: {a['launches']} launches for {a['batches']} "
              f"batches; kernel vs plain max|diff| "
              f"{a['kernel_vs_plain_max']:.3e}, board vs plain fold "
              f"{a['board_vs_plain_fold_max']:.3e}; scrape "
              f"{a['prometheus']['requests']} requests in "
              f"{a['prometheus']['scrape_ms']:.3f} ms")
    if "part_b" in res:
        b = res["part_b"]
        print(f"h2fast B: {b['calm']['calls_per_s']:.0f} calls/s (p50 "
              f"{b['calm']['p50_ms']:.3f}, p99 {b['calm']['p99_ms']:.3f}); "
              f"workers accepted {b['workers']['accepted']}; TLS {b['tls']};"
              f" flood {b['flood']['clients']}, rapid_reset_closed "
              f"{b['flood']['rapid_reset_closed']}; hung call "
              f"{b['hung']['status']} after {b['hung']['ms']:.1f} ms; "
              f"{b['streams']['engine_samples']} stream samples (sentinel "
              f"{b['streams']['sentinel_samples']}), "
              f"{b['streams']['messages_per_s']:.0f} messages/s; "
              f"{b['launches']} launches for {b['batches']} batches")
    if "part_c" in res:
        c = res["part_c"]
        print(f"h2fast C: namerd /ping after {c['namerd_boot_ms']:.1f} ms; "
              f"write to the first -b answer "
              f"{c['reroute']['write_to_first_answer_ms']:.1f} ms (PUT "
              f"{c['reroute']['put_ms']:.1f} ms); namerd restart to the "
              f"first own-replica answer "
              f"{c['restart']['start_to_first_answer_ms']:.1f} ms; "
              + ", ".join(f"{k} {c[k]['calls_per_s']:.0f} calls/s"
                          for k in ("before", "moved", "outage", "after"))
              + f"; {c['launches']} launches for {c['batches']} batches")
    return res, launches


# The mux phase: the thrift, mux and thriftmux routers, namerd's thrift
# interface and BASELINE config 3. Part A runs config 3's config and
# schedule (``linkerd_tpu_torch/testing/config3.py``) at MUX_REQUESTS
# requests: an http router ``web`` and a thriftmux router ``tmx`` in one
# linker under io.l5d.jaxAnomaly (maxBatch 512, a fit after every batch),
# svc-a behind the reference's FaultInjector; the thriftmux router
# carries no recorder (as the reference's), so the kernel scores the
# http rows. Part B: a thrift router (framed binary, the TTwitter
# upgrade, thriftMethodInDst, service retries) and a mux router beside
# the http one, over MUX_DSTS destinations of two replicas each, faults
# on three of them while the flag is up. Part C: the three routers bound
# through the namerd CLI's thrift interface (``io.l5d.namerd``) around a
# dtab write and a namerd restart. Backends and load run in spawned
# processes; the load process runs each job (a sender of config 3, or
# a plan of calls) as a task of its own, so concurrent senders stay
# concurrent.
MUX_REQUESTS = 2048        # config 3's requests (the benchmark: 120)
MUX_CONNS = 16             # keep-alive connections of a sender
MUX_DSTS = 8               # part B and C destinations, 2 replicas each
MUX_EXCEPTION_DST = 0      # thrift: EXCEPTION replies while the flag is up
MUX_DROP_DST = 1           # thrift: replica 0 drops its connections
MUX_RERR_DST = 2           # mux: replica 0 answers Rerr
MUX_MOVED = 5              # part C: the destination the dtab write moves
MUX_CALLS = 4096           # part B calls of each protocol a window
MUX_HTTP = 1024            # part B and C http requests a window
MUX_BURST = 512            # part C calls of each protocol a burst
MUX_AUC_TARGET = 0.9       # BASELINE.json's fault_auc target (printed)
MUX_REROUTE_S = 30.0       # part C: a write to the first answer it routes
# Part C: namerd's restart to the first answer it routes. namerd's CLI
# boots in 6-8 s on the card machine (h2fast C), and the interpreter's
# long poll retries on a jittered backoff that doubles from 0.1 s up to
# 10 s a try: up to 10 s past the boot, and a slow boot, fit in 60 s.
MUX_RESTART_S = 60.0
MUX_METHOD = "ping"


def mux_reply(name: str, seqid: int, body: bytes = b"") -> bytes:
    """A strict REPLY whose result struct's field 0 is ``body``."""
    from linkerd_tpu_torch.protocol.thrift.codec import REPLY, VERSION_1

    nb = name.encode()
    return (struct.pack(">I", (VERSION_1 | REPLY) & 0xFFFFFFFF)
            + struct.pack(">I", len(nb)) + nb + struct.pack(">i", seqid)
            + b"\x0b" + struct.pack(">hI", 0, len(body)) + body + b"\x00")


def mux_body(reply: bytes) -> bytes:
    """``mux_reply``'s body back."""
    from linkerd_tpu_torch.protocol.thrift.binary import header_len

    h = header_len(reply)
    (n,) = struct.unpack(">I", reply[h + 3:h + 7])
    return reply[h + 7:h + 7 + n]


def mux_config3_backends(conn, flag) -> None:
    """Child process: config 3's downstreams, svc-a (behind the
    reference's FaultInjector, active while ``flag`` is up), svc-b and
    the thriftmux echo; sends back their ports."""
    from linkerd_tpu_torch.protocol.http.message import Response
    from linkerd_tpu_torch.protocol.http.server import serve
    from linkerd_tpu_torch.protocol.mux.server import MuxServer
    from linkerd_tpu_torch.router.service import FnService
    from linkerd_tpu_torch.testing.config3 import mux_echo
    from linkerd_tpu_torch.testing.faults import FaultInjector, FaultSpec

    injector = FaultInjector(FaultSpec(error_rate=0.9, latency_ms=40.0))

    async def backend_a(req):
        return Response(200, body=b"a" * 200)

    async def backend_b(req):
        return Response(200, body=b"b" * 120)

    class Flagged:
        async def __call__(self, req):
            injector.active = bool(flag.value)
            return await injector.and_then(FnService(backend_a))(req)

    async def main():
        servers = [await serve(FnService(Flagged())),
                   await serve(FnService(backend_b)),
                   await MuxServer(FnService(mux_echo)).start()]
        conn.send([s.bound_port for s in servers])
        await asyncio.get_running_loop().run_in_executor(None, conn.recv)
        for s in servers:
            await s.close()

    asyncio.run(main())


async def thrift_answerer(name: str, mode):
    """A framed-binary thrift server that takes the TTwitter upgrade and
    answers every call with ``mux_reply(method, seqid, name)``; while
    ``mode()`` reads "exception" it answers a TApplicationException, and
    while it reads "drop" it closes the connection on each message."""
    from linkerd_tpu_torch.protocol.thrift import ttwitter as ttw
    from linkerd_tpu_torch.protocol.thrift.codec import (
        encode_exception, parse_message_header, read_framed, write_framed,
    )

    async def on_conn(reader, writer):
        upgraded = False
        try:
            while True:
                payload = await read_framed(reader)
                if payload is None or mode() == "drop":
                    return
                if upgraded:
                    _, payload = ttw.peel_struct(ttw.TRequestHeader, payload)
                method, seqid, _ = parse_message_header(payload)
                if method == ttw.CAN_TRACE_METHOD and not upgraded:
                    upgraded = True
                    write_framed(writer, ttw.encode_upgrade_reply(seqid))
                    await writer.drain()
                    continue
                reply = (encode_exception(method, seqid, f"{name} faulted")
                         if mode() == "exception" else
                         mux_reply(method, seqid, name.encode()))
                if upgraded:
                    reply = ttw.prepend_struct(ttw.TResponseHeader(), reply)
                write_framed(writer, reply)
                await writer.drain()
        except (OSError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()

    return await asyncio.start_server(on_conn, "127.0.0.1", 0)


def mux_service(name: str, faulted=lambda: False):
    """A mux backend: a REPLY of the call's method and seqid whose body
    is ``name:<the Tdispatch dest>``; an Rerr while ``faulted()``."""
    from linkerd_tpu_torch.protocol.thrift.codec import parse_message_header
    from linkerd_tpu_torch.router.service import FnService

    async def handle(td):
        if faulted():
            raise RuntimeError(f"{name} faulted")
        method, seqid, _ = parse_message_header(td.payload)
        return mux_reply(method, seqid, f"{name}:{td.dest}".encode())

    return FnService(handle)


def mux_dst_backends(conn, dsts, flag) -> None:
    """Child process: for each destination index of ``dsts``, two
    replicas of a thrift server (``thrift_answerer``) and of a mux server
    (``MuxServer``), named ``tele-DD/R``; a mux answer's body is the name
    and the Tdispatch dest it got. While ``flag`` is up, MUX_EXCEPTION_DST
    answers thrift EXCEPTION replies, MUX_DROP_DST's replica 0 drops its
    thrift connections and MUX_RERR_DST's replica 0 answers mux Rerr.
    Sends back ``{(kind, d, r): port}``."""
    from linkerd_tpu_torch.protocol.mux.server import MuxServer

    def thrift_mode(d, r):
        def mode():
            if not flag.value:
                return None
            if d == MUX_EXCEPTION_DST:
                return "exception"
            return "drop" if d == MUX_DROP_DST and r == 0 else None
        return mode

    def mux_handler(name, d, r):
        return mux_service(name, lambda: bool(
            flag.value and d == MUX_RERR_DST and r == 0))

    async def main():
        ports, servers = {}, []
        for d in dsts:
            for r in range(LINKER_REPLICAS):
                name = f"tele-{d:02d}/{r}"
                t = await thrift_answerer(name, thrift_mode(d, r))
                m = await MuxServer(mux_handler(name, d, r)).start()
                servers += [t, m]
                ports[("thrift", d, r)] = t.sockets[0].getsockname()[1]
                ports[("mux", d, r)] = m.bound_port
        conn.send(ports)
        await asyncio.get_running_loop().run_in_executor(None, conn.recv)
        for s in servers:
            if isinstance(s, asyncio.base_events.Server):
                s.close()
                await s.wait_closed()
            else:
                await s.close()

    asyncio.run(main())


async def mux_job(job) -> dict:
    """One job of the load process. ``("http", port, host, n, conns)``: n
    requests with that Host over ``conns`` keep-alive connections;
    ``("tmx", port, n, conns, seq0)``: n thriftmux calls of MUX_METHOD;
    ``("thrift", port, plans, seq0)`` and ``("mux", port, plans, seq0)``:
    a connection a plan, each call to ``tele-DD`` of its plan (the thrift
    method, or the mux dest ``/mtele-DD/rK``). Returns per call: status
    (http status; 2 REPLY, 3 EXCEPTION; 0 answered; -1 an error), who
    answered, whether the answer was right for the call, and ms."""
    from linkerd_tpu_torch.protocol.http.client import HttpClient
    from linkerd_tpu_torch.protocol.http.message import Request
    from linkerd_tpu_torch.protocol.mux.client import MuxClient
    from linkerd_tpu_torch.protocol.mux.codec import Tdispatch
    from linkerd_tpu_torch.protocol.thrift.client import ThriftClient
    from linkerd_tpu_torch.protocol.thrift.codec import (
        CALL, ThriftCall, parse_message_header,
    )
    from linkerd_tpu_torch.testing.config3 import mk_call

    kind, port = job[0], job[1]
    if kind == "http":
        _, _, host, n, conns = job
        plans = np.array_split(np.zeros(n, np.int16), conns)
    elif kind == "tmx":
        _, _, n, conns, seq0 = job
        plans = np.array_split(np.zeros(n, np.int16), conns)
    else:
        _, _, plans, seq0 = job
    n = sum(len(p) for p in plans)
    out = {"dst": np.concatenate(plans).astype(np.int16),
           "status": np.zeros(n, np.int16), "who": np.zeros(n, np.int8),
           "right": np.zeros(n, bool), "ms": np.zeros(n)}
    offs = np.cumsum([0] + [len(p) for p in plans])

    async def one_conn(plan, off):
        if kind == "http":
            client = HttpClient("127.0.0.1", port, max_connections=1)
        elif kind == "thrift":
            client = ThriftClient("127.0.0.1", port, attempt_ttwitter=True)
        else:
            client = MuxClient("127.0.0.1", port)
        try:
            for i, d in enumerate(plan):
                k, d = off + i, int(d)
                seqid = seq0 + k + 1 if kind != "http" else 0
                t0 = time.perf_counter()
                try:
                    if kind == "http":
                        req = Request(uri="/")
                        req.headers.set("Host", host)
                        rsp = await client(req)
                        status, body = rsp.status, rsp.body
                        who = {b"a" * 200: 0, b"b" * 120: 1}.get(body, -1)
                        right = who == {"svc-a": 0, "svc-b": 1}[host]
                    elif kind == "tmx":
                        rsp = await client(Tdispatch(
                            0, [], "", [], mk_call(MUX_METHOD, seqid)))
                        status, who = 0, 0
                        right = parse_message_header(rsp)[:2] == (
                            MUX_METHOD, seqid)
                    elif kind == "thrift":
                        method = f"tele-{d:02d}"
                        rsp = await client(ThriftCall(
                            mk_call(method, seqid), method, seqid, CALL))
                        m, s, status = parse_message_header(rsp)
                        who = answer_of(mux_body(rsp), d)[0] \
                            if status == 2 else -1
                        right = (m, s) == (method, seqid)
                    else:
                        dest = f"/mtele-{d:02d}/r{k % 3}"
                        rsp = await client(Tdispatch(
                            0, [], dest, [], mk_call(MUX_METHOD, seqid)))
                        who, rest = answer_of(mux_body(rsp), d)
                        status = 0
                        # the bound residual, never the logical dest
                        right = parse_message_header(rsp)[:2] == (
                            MUX_METHOD, seqid) and rest == \
                            f":/r{k % 3}".encode()
                except Exception:  # noqa: BLE001 — counted as status -1
                    status, who, right = -1, -1, False
                out["ms"][k] = (time.perf_counter() - t0) * 1e3
                out["status"][k], out["who"][k] = status, who
                out["right"][k] = right
        finally:
            await client.close()

    t0 = time.perf_counter()
    await asyncio.gather(*(one_conn(p, int(o))
                           for p, o in zip(plans, offs)))
    out["wall"] = time.perf_counter() - t0
    out["kind"] = kind
    return out


def mux_load(conn) -> None:
    """Child process: runs each ``(id, job)`` from ``conn`` as a task of
    its own (``mux_job``) and sends back ``(id, result)`` when it ends;
    ``None`` ends it."""
    import threading

    async def main():
        loop = asyncio.get_running_loop()
        done, lock = asyncio.Event(), threading.Lock()

        async def run(jid, job):
            res = await mux_job(job)
            with lock:
                conn.send((jid, res))

        def reader():
            while True:
                msg = conn.recv()
                if msg is None:
                    loop.call_soon_threadsafe(done.set)
                    return
                asyncio.run_coroutine_threadsafe(run(*msg), loop)

        threading.Thread(target=reader, daemon=True).start()
        await done.wait()

    asyncio.run(main())


class MuxLoad:
    """The parent's side of ``mux_load``: ``await run(job)``."""

    def __init__(self, conn):
        import threading

        self.conn, self.futs, self.n = conn, {}, 0
        self.loop = None
        self.thread = threading.Thread(target=self._reader, daemon=True)

    def _reader(self):
        while True:
            try:
                jid, res = self.conn.recv()
            except (EOFError, OSError):
                return
            self.loop.call_soon_threadsafe(
                lambda j=jid, r=res: self.futs.pop(j).set_result(r))

    async def run(self, job) -> dict:
        if self.loop is None:
            self.loop = asyncio.get_running_loop()
            self.thread.start()
        jid, self.n = self.n, self.n + 1
        fut = self.futs[jid] = self.loop.create_future()
        self.conn.send((jid, job))
        return await fut


def mux_times(res: dict) -> dict:
    ms = res["ms"]
    return {"calls": len(ms), "calls_per_s": len(ms) / res["wall"],
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99))}


def merge_results(results) -> dict:
    """One job result of several (walls overlapping: the longest)."""
    out = {k: np.concatenate([r[k] for r in results])
           for k in ("dst", "status", "who", "right", "ms")}
    out["wall"] = max(r["wall"] for r in results)
    return out


class SnapTap:
    """Wraps, on a telemeter, its scorer's ``score`` (each call's rows,
    scores and the model it read) and its board's folds, in order. The
    model a call read is a snapshot taken just before, under the lock a
    fit holds; or, once a phase whose telemeter does not train sets
    ``model`` (``freeze_model``), that one, the model it set last, so
    that no snapshot holds the router's loop a batch."""

    def __init__(self, tele):
        self.scored, self.folds = [], []
        self.tele, self.model = tele, None
        scorer, board = tele._ensure_scorer(), tele.board
        score, fold = scorer.score, board.update_batch

        async def scoring(x):
            snap = scorer.snapshot() if self.model is None else self.model
            s = await score(x)
            self.scored.append((x, s, snap))
            return s

        def folding(dsts, scores, endpoints=None):
            self.folds.append((list(dsts), scores, endpoints))
            return fold(dsts, scores, endpoints=endpoints)

        scorer.score, board.update_batch = scoring, folding

    async def settle(self, what: str, task=None) -> None:
        """Until every recorded row is scored (``run()``'s task, when
        given, still alive)."""
        tele, t0 = self.tele, time.monotonic()
        while tele.ring or tele._scored.value != tele._requests.value:
            if task is not None and task.done():
                task.result()
                raise AssertionError(f"mux {what}: run() ended early")
            if time.monotonic() - t0 > LINKER_SETTLE_S:
                raise AssertionError(
                    f"mux {what}: {tele._scored.value} of "
                    f"{tele._requests.value} rows scored after "
                    f"{LINKER_SETTLE_S} s")
            await asyncio.sleep(1e-3)


def snap_checks(what: str, tele, tap, calls: int, launches: int,
                dev: str, phase: str = "mux") -> dict:
    """The first ``calls`` score calls, each under the model it read:
    kernel against plain on every row (TOL; at most ROW_SHARE of every
    batch's rows past ROW_TOL), one launch a call with rows, and the
    board against a fresh one folded in the same order with the plain
    scores."""
    scored = tap.scored[:calls]
    plain = [plain_scores(snap, x, dev) for x, _, snap in scored]
    with_rows = sum(len(x) > 0 for x, _, _ in scored)
    if launches != (0 if dev == "cpu" else with_rows):
        raise AssertionError(f"{phase} {what}: {launches} kernel launches for "
                             f"{with_rows} batches with rows")
    gaps = [np.abs(s - p) for (_, s, _), p in zip(scored, plain)]
    gap = np.concatenate(gaps)
    past = int((gap > ROW_TOL).sum())
    worst_share = max((g > ROW_TOL).mean() for g in gaps if len(g))
    print(f"{phase} {what}: {len(scored)} batches, {launches} launches, "
          f"kernel vs plain max|diff| {gap.max():.3e}, {past} of "
          f"{len(gap)} rows past {ROW_TOL} (at most {worst_share:.4f} of "
          f"a batch)")
    if gap.max() > TOL or worst_share > ROW_SHARE:
        raise AssertionError(f"{phase} {what}: kernel vs plain max "
                             f"{gap.max()}, {past} of {len(gap)} rows past "
                             f"{ROW_TOL}, up to {worst_share} of a batch")
    board = linker_board_check(tele, tap, 0, {
        batch_key(s): p for (_, s, _), p in zip(scored, plain)},
        f"{phase} {what}")
    print(f"{phase} {what}: board vs plain fold {board:.3e}")
    if board > TOL:
        raise AssertionError(f"{phase} {what}: board off the plain fold by "
                             f"{board} > {TOL}")
    return {"launches": launches, "batches": len(scored),
            "batches_with_rows": with_rows, "rows": len(gap),
            "kernel_vs_plain_max": float(gap.max()),
            "rows_past_row_tol": past, "board_vs_plain_fold_max": board}


def http_checks(res: dict, what: str, host: str, faulted: bool) -> dict:
    """Every request answered 200 by its destination (with ``faulted``,
    svc-a's may be the injected 503 after the latency)."""
    ok = (res["status"] == 200) & res["right"]
    if faulted:
        ok |= res["status"] == 503
    if not ok.all():
        i = int(np.flatnonzero(~ok)[0])
        raise AssertionError(f"mux {what}: {int((~ok).sum())} {host} "
                             f"requests misrouted or failed, e.g. status "
                             f"{res['status'][i]}")
    return mux_times(res)


async def mux_part_a(loads, flag, ports, dev: str):
    """BASELINE config 3 through ``testing/config3.drive`` at MUX_REQUESTS,
    the senders jobs of the load process. Launches counted over the
    drive; the fault window's AUC scored after it."""
    from linkerd_tpu_torch.linker import load_linker
    from linkerd_tpu_torch.ops.scoring import fused_anomaly_scores
    from linkerd_tpu_torch.testing import config3

    load = loads[0]
    with tempfile.TemporaryDirectory() as disco:
        for name, port in zip(("svc-a", "svc-b", "thriftmux"), ports):
            (Path(disco) / name).write_text(f"127.0.0.1 {port}\n")
        linker = load_linker(config3.CONFIG.format(disco=disco), device=dev)
        await linker.start()
        tele = linker.telemeters[0]
        tap = SnapTap(tele)
        http_port, tmx_port = (r.server_ports[0] for r in linker.routers)
        sent = {"http": [], "tmx": []}
        seq = [0]

        async def send_http(host: str, n: int):
            res = await load.run(("http", http_port, host, n, MUX_CONNS))
            sent["http"].append((host, bool(flag.value), res))

        async def send_tmx(n: int):
            seq[0] += n
            res = await load.run(("tmx", tmx_port, n, MUX_CONNS,
                                  seq[0] - n))
            sent["tmx"].append(res)

        def set_fault(on: bool):
            flag.value = int(on)

        try:
            fused_anomaly_scores.launches = 0
            t0 = time.perf_counter()
            out = await config3.drive(
                linker, config3.Traffic(send_http, send_tmx, set_fault),
                MUX_REQUESTS)
            drive_s = time.perf_counter() - t0
            launches = fused_anomaly_scores.launches
            calls = len(tap.scored)
            n_http = sum(len(r["ms"]) for _, _, r in sent["http"])
            n_tmx = sum(len(r["ms"]) for r in sent["tmx"])
            recorded = tele._requests.value
            if recorded != n_http:
                raise AssertionError(f"mux A: {n_http} http requests, "
                                     f"{recorded} rows recorded")
            items = out.pop("items")
            out.update(await config3.evaluate(tele, items))
            flat = linker.metrics.flatten()
        finally:
            flag.value = 0
            await linker.close()
    for key, n in (("rt/web/server/requests", n_http),
                   ("rt/tmx/server/requests", n_tmx)):
        if flat[key] != n:
            raise AssertionError(f"mux A: {key} {flat[key]}, sent {n}")
    for r in sent["tmx"]:
        if not r["right"].all():
            raise AssertionError(f"mux A: {int((~r['right']).sum())} tmx "
                                 f"calls without their method and seqid")
    times = {"tmx": mux_times(merge_results(sent["tmx"]))}
    for host in ("svc-a", "svc-b"):
        for faulted in (False, True):
            rs = [r for h, f, r in sent["http"] if h == host and f == faulted]
            if rs:
                times[f"{host}{' faulted' if faulted else ''}"] = \
                    http_checks(merge_results(rs), "A", host, faulted)
    # every recorded row scored once, and the epochs' copies again
    rows = flat["anomaly/scored_total"]
    if flat["anomaly/requests_total"] != n_http or \
            rows != n_http + config3.EPOCHS * out["ring_copy"] or \
            flat["anomaly/score_failures"] or flat["anomaly/dropped_batches"]:
        raise AssertionError(
            f"mux A: {n_http} http requests, "
            f"{flat['anomaly/requests_total']} recorded, {rows} scored "
            f"(epochs {config3.EPOCHS} x {out['ring_copy']})")
    out.update(snap_checks("A", tele, tap, calls, launches, dev))
    if not out["score_anomalous"] > out["score_baseline"]:
        raise AssertionError(f"mux A: /svc/svc-a scored "
                             f"{out['score_anomalous']} under the faults, "
                             f"{out['score_baseline']} before them")
    out.update(http_requests=n_http, tmx_requests=n_tmx, drive_s=drive_s,
               times=times, fault_auc_target=MUX_AUC_TARGET)
    print(f"mux A (config 3, {MUX_REQUESTS} requests): fault_auc "
          f"{out['fault_auc']:.4f} (BASELINE target {MUX_AUC_TARGET}), "
          f"score_baseline {out['score_baseline']:.4f}, score_anomalous "
          f"{out['score_anomalous']:.4f}; {n_http} http + {n_tmx} tmx "
          f"requests, {rows} rows scored in {out['batches']} batches, "
          f"drive {drive_s:.2f} s; " + ", ".join(
              f"{k} {v['calls_per_s']:.0f}/s p50 {v['p50_ms']:.2f} p99 "
              f"{v['p99_ms']:.2f} ms" for k, v in times.items()))
    return out, launches


MUX_DTAB = "/svc => /#/io.l5d.fs ;"


def mux_config(work: Path, interpreter=None) -> str:
    """Part B and C's linker as JSON text: the http router of config 3,
    a thrift router (thriftMethodInDst, service retries) and a mux router
    over one fs namer's directory (``mux_discos``), and io.l5d.jaxAnomaly
    without training; with ``interpreter``, every router binds through
    it instead of MUX_DTAB. (One namer: an io.l5d.fs namer names its ids
    /#/io.l5d.fs/<file> whatever its prefix, so two would share ids
    through namerd; ROADMAP Queue 3.)"""
    retries = {"retries": {"budget": {"minRetriesPerSec": 1000,
                                      "percentCanRetry": 1.0}}}
    routers = [
        {"protocol": "http", "label": "web",
         "client": {"failureAccrual": {"kind": "none"}}},
        {"protocol": "thrift", "label": "thr", "thriftMethodInDst": True,
         "attemptTTwitterUpgrade": True, "service": retries},
        {"protocol": "mux", "label": "mx"}]
    for r in routers:
        r["servers"] = [{"port": 0}]
        if interpreter is None:
            r["dtab"] = MUX_DTAB
        else:
            r["interpreter"] = interpreter
    return json.dumps({
        "routers": routers,
        "telemetry": [{"kind": "io.l5d.jaxAnomaly", "maxBatch": 512,
                       "trainEveryBatches": 0, "reconWeight": 1.0}],
        "namers": mux_namers(work)})


def mux_namers(work: Path) -> list:
    return [{"kind": "io.l5d.fs", "rootDir": str(work / "disco")}]


def mux_discos(work: Path, ports, dports) -> None:
    """The fs namer's directory ``work/disco``: svc-a and svc-b, and for
    each destination ``tele-DD`` over its thrift replicas and
    ``mtele-DD`` over its mux replicas."""
    disco = work / "disco"
    disco.mkdir()
    for name, port in zip(("svc-a", "svc-b"), ports):
        (disco / name).write_text(f"127.0.0.1 {port}\n")
    for k, file in (("thrift", "tele"), ("mux", "mtele")):
        for d in range(MUX_DSTS):
            (disco / f"{file}-{d:02d}").write_text("".join(
                f"127.0.0.1 {dports[(k, d, r)]}\n"
                for r in range(LINKER_REPLICAS)))


def mux_plans(rng, n: int, conns: int = MUX_CONNS):
    return np.array_split(rng.integers(MUX_DSTS, size=n), conns)


def proto_checks(res: dict, what: str, faults_on: bool,
                 moved: dict = None) -> dict:
    """Every calm call answered by a replica of its destination (``moved``:
    destination -> the ``who`` codes that must answer it instead), right
    for the call (thrift: its method and seqid; mux: the bound residual as
    dest). With ``faults_on``: MUX_EXCEPTION_DST's thrift calls come back
    EXCEPTION, MUX_DROP_DST's are answered (retried onto replica 1 when
    replica 0 drops), MUX_RERR_DST's mux calls are answered or fail."""
    moved = moved or {}
    dst, who, st = res["dst"], res["who"], res["status"]
    own = np.array([w in moved.get(int(d), (0, 1)) for d, w in zip(dst, who)])
    answered = (st >= 0) & (st != 3) & res["right"] & own
    calm = np.ones(len(dst), bool)
    if faults_on:
        calm &= ~np.isin(dst, (MUX_EXCEPTION_DST, MUX_RERR_DST))
        exc = dst == MUX_EXCEPTION_DST
        if what.startswith("thrift") and not ((st[exc] == 3).all()
                                              and exc.any()):
            raise AssertionError(f"mux {what}: tele-{MUX_EXCEPTION_DST:02d}"
                                 f" calls not passed through as EXCEPTION")
    bad = calm & ~answered
    if bad.any():
        i = int(np.flatnonzero(bad)[0])
        raise AssertionError(
            f"mux {what}: {int(bad.sum())} calls not answered by their "
            f"destination, e.g. tele-{dst[i]:02d} -> status {st[i]}, who "
            f"{who[i]}, right {res['right'][i]}")
    return mux_times(res)


async def mux_part_b(loads, flag, ports, dports, dev: str):
    """Part B: the http, thrift and mux routers in one linker over the
    destination backends; a calm window, then one with the faults up.
    Every calm call answered by its destination, the faulted thrift
    endpoint retried around and removed by failure accrual (the mux one
    too), the calm ones kept; a Tdispatch dtab override; the http rows
    scored as in part A."""
    from linkerd_tpu_torch.core.tasks import monitor
    from linkerd_tpu_torch.linker import load_linker
    from linkerd_tpu_torch.ops.scoring import fused_anomaly_scores
    from linkerd_tpu_torch.protocol.mux.client import MuxClient
    from linkerd_tpu_torch.protocol.mux.codec import Tdispatch
    from linkerd_tpu_torch.testing.config3 import mk_call

    load, rng = loads[0], np.random.default_rng(14)
    work = Path(tempfile.mkdtemp(prefix="mux-b-"))
    mux_discos(work, ports, dports)
    linker = load_linker(mux_config(work), device=dev)
    await linker.start()
    tele = linker.telemeters[0]
    tap, accrual = SnapTap(tele), AccrualTap()
    task = monitor(asyncio.create_task(tele.run()),
                   what=f"telemeter-{type(tele).__name__}")
    web, thr, mx = (r.server_ports[0] for r in linker.routers)
    out, runs, seq = {}, {}, 0
    try:
        fused_anomaly_scores.launches = 0
        for window in ("calm", "faulted"):
            flag.value = int(window == "faulted")
            jobs = [("thrift", thr, mux_plans(rng, MUX_CALLS), seq),
                    ("mux", mx, mux_plans(rng, MUX_CALLS), seq + MUX_CALLS),
                    ("http", web, "svc-b", MUX_HTTP, MUX_CONNS)]
            seq += 2 * MUX_CALLS
            thrift, mux, http = await asyncio.gather(
                *(load.run(j) for j in jobs))
            runs[window] = (thrift, mux, http)
            faults = window == "faulted"
            out[window] = {
                "thrift": proto_checks(thrift, f"thrift B {window}", faults),
                "mux": proto_checks(mux, f"mux B {window}", faults),
                "http": http_checks(http, f"B {window}", "svc-b", False)}
        flag.value = 0
        client = MuxClient("127.0.0.1", mx)
        try:
            # the caller's dtab moves mtele-03 onto tele-04's replicas
            rsp = await asyncio.wait_for(client(Tdispatch(
                0, [], "/mtele-03/x", [("/svc/mtele-03",
                                        "/#/io.l5d.fs/mtele-04")],
                mk_call(MUX_METHOD, seq + 1))), 10)
        finally:
            await client.close()
        who, rest = answer_of(mux_body(rsp), 4)
        if who < 0 or rest != b":/x":
            raise AssertionError(f"mux B: the dtab override was answered "
                                 f"{mux_body(rsp)}")
        out["override_answer"] = mux_body(rsp).decode()
        sent_http = MUX_HTTP * 2
        await tap.settle("B", task)
        launches = fused_anomaly_scores.launches
        flat = linker.metrics.flatten()
    finally:
        flag.value = 0
        accrual.close()
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        await linker.close()
        shutil.rmtree(work, ignore_errors=True)
    for label, kind in (("thr", "thrift"), ("mx", "mux")):
        n = sum(len(r[0 if kind == "thrift" else 1]["ms"])
                for r in runs.values()) + (kind == "mux")
        if flat[f"rt/{label}/server/requests"] != n:
            raise AssertionError(f"mux B: rt/{label}/server/requests "
                                 f"{flat[f'rt/{label}/server/requests']}, "
                                 f"sent {n}")
    retries = flat.get(f"rt/thr/service/svc.tele-{MUX_DROP_DST:02d}/"
                       f"retries/total", 0)
    exceptions = flat.get(f"rt/thr/service/svc.tele-"
                          f"{MUX_EXCEPTION_DST:02d}/failures", 0)
    faulted_ports = {dports[("thrift", MUX_DROP_DST, 0)],
                     dports[("mux", MUX_RERR_DST, 0)]}
    removed = set(accrual.removals)
    print(f"mux B: thrift retries on tele-{MUX_DROP_DST:02d} {retries}, "
          f"EXCEPTION replies counted as failures {exceptions}, endpoints "
          f"removed {sorted(removed)} (faulted {sorted(faulted_ports)})")
    if not retries or not exceptions or removed != faulted_ports:
        raise AssertionError(
            f"mux B: retries {retries}, EXCEPTION failures {exceptions}, "
            f"removed {sorted(removed)}, faulted {sorted(faulted_ports)}")
    if flat["anomaly/requests_total"] != sent_http:
        raise AssertionError(f"mux B: {flat['anomaly/requests_total']} http "
                             f"rows recorded, {sent_http} sent")
    out.update(snap_checks("B", tele, tap, len(tap.scored), launches, dev))
    out.update(retries=retries, exception_failures=exceptions,
               removed=len(removed))
    return out, launches


async def until_answered(kind: str, port: int, prefix: str, t0: float,
                         timeout: float, seq0: int, dest: str = "") -> tuple:
    """Calls of tele-<MUX_MOVED> through the ``kind`` ("thrift" or "mux",
    to the Tdispatch ``dest``) router on ``port``, one after another,
    until one is answered by a backend whose name starts with
    ``prefix``: (ms from the ``time.perf_counter()`` instant ``t0`` to
    that answer, calls made). Fails ``timeout`` s after ``t0``."""
    from linkerd_tpu_torch.protocol.mux.client import MuxClient
    from linkerd_tpu_torch.protocol.mux.codec import Tdispatch
    from linkerd_tpu_torch.protocol.thrift.client import ThriftClient
    from linkerd_tpu_torch.protocol.thrift.codec import (
        CALL, ThriftCall, parse_message_header,
    )
    from linkerd_tpu_torch.testing.config3 import mk_call

    method = f"tele-{MUX_MOVED:02d}"
    client = (ThriftClient("127.0.0.1", port, attempt_ttwitter=True)
              if kind == "thrift" else MuxClient("127.0.0.1", port))
    calls = 0
    try:
        while time.perf_counter() - t0 < timeout:
            calls += 1
            seqid = seq0 + calls
            call = (ThriftCall(mk_call(method, seqid), method, seqid, CALL)
                    if kind == "thrift" else
                    Tdispatch(0, [], dest, [], mk_call(MUX_METHOD, seqid)))
            try:
                rsp = await asyncio.wait_for(client(call), 10)
            except Exception:  # noqa: BLE001 — unbound for now: again
                await asyncio.sleep(0.002)
                continue
            if parse_message_header(rsp)[2] == 2 and \
                    mux_body(rsp).startswith(prefix.encode()):
                return (time.perf_counter() - t0) * 1e3, calls
            await asyncio.sleep(0.002)
    finally:
        await client.close()
    raise AssertionError(f"mux C: the {kind} router's {method} {dest} "
                         f"not answered by {prefix}* within {timeout} s")


async def both_answered(thr: int, mx: int, prefix: str, t0: float,
                        timeout: float, seq0: int) -> dict:
    """``until_answered`` on the thrift router, then on the mux router
    for each dest the bursts send (each of its paths binds through a
    long poll of its own): ms from ``t0`` until every one answers from
    ``prefix``."""
    out, calls = {"mux_ms": 0.0}, 0
    out["thrift_ms"], calls = await until_answered(
        "thrift", thr, prefix, t0, timeout, seq0)
    for k in range(3):  # mux_job's dests /mtele-DD/r0, r1, r2
        ms, n = await until_answered(
            "mux", mx, prefix, t0, timeout, seq0 + calls,
            dest=f"/mtele-{MUX_MOVED:02d}/r{k}")
        out["mux_ms"], calls = max(out["mux_ms"], ms), calls + n
    out["calls"] = calls
    return out


async def mux_part_c(loads, flag, ports, dports, dev: str):
    """Part C: the http, thrift and mux routers bound through the namerd
    CLI's thrift interface (``io.l5d.namerd``): a burst; a dtab write
    through namerd's HTTP API moving tele-<MUX_MOVED> (thrift and mux) to
    its -b replicas (in this process), the ms to their first answer, a
    burst; namerd stopped, a burst (the held bindings serve); namerd
    started again (its in-memory namespace back to MUX_DTAB), the ms to
    the first answer of the destination's own replicas, a burst. Every
    call answered as the dtab of the moment says, every http row scored
    under its destination."""
    from linkerd_tpu_torch.core.tasks import monitor
    from linkerd_tpu_torch.linker import load_linker
    from linkerd_tpu_torch.ops.scoring import fused_anomaly_scores
    from linkerd_tpu_torch.protocol.mux.server import MuxServer

    load, rng = loads[0], np.random.default_rng(15)
    moved = f"tele-{MUX_MOVED:02d}"
    work = Path(tempfile.mkdtemp(prefix="mux-c-"))
    mux_discos(work, ports, dports)
    backs = []
    for r in range(LINKER_REPLICAS):
        t = await thrift_answerer(f"{moved}-b/{r}", lambda: None)
        m = await MuxServer(mux_service(f"{moved}-b/{r}")).start()
        backs.append((t, m))
    (work / "disco" / f"{moved}-b").write_text("".join(
        f"127.0.0.1 {t.sockets[0].getsockname()[1]}\n" for t, _ in backs))
    (work / "disco" / f"m{moved}-b").write_text("".join(
        f"127.0.0.1 {m.bound_port}\n" for _, m in backs))
    thrift_port, api, admin = free_port(), free_port(), free_port()
    cfg = work / "namerd.json"
    cfg.write_text(json.dumps({
        "storage": {"kind": "io.l5d.inMemory",
                    "namespaces": {"default": MUX_DTAB}},
        "interfaces": [
            {"kind": "io.l5d.thriftNameInterpreter", "port": thrift_port},
            {"kind": "io.l5d.httpController", "port": api}],
        "namers": mux_namers(work), "admin": {"port": admin}}))
    namerd = start_namerd(cfg, work / "namerd.log")
    linker = task = None
    out, runs, seq = {}, {}, 10**6
    b_who = {MUX_MOVED: (FAILOVER_WHO, FAILOVER_WHO + 1)}
    try:
        out["namerd_boot_ms"] = await wait_ping(
            admin, lambda: namerd.poll() is None, "namerd", timeout=60.0)
        linker = load_linker(mux_config(work, interpreter={
            "kind": "io.l5d.namerd",
            "dst": f"/$/inet/127.0.0.1/{thrift_port}",
            "namespace": "default"}), device=dev)
        await linker.start()
        tele = linker.telemeters[0]
        tap = SnapTap(tele)
        task = monitor(asyncio.create_task(tele.run()),
                       what=f"telemeter-{type(tele).__name__}")
        web, thr, mx = (r.server_ports[0] for r in linker.routers)
        fused_anomaly_scores.launches = 0

        async def burst(name: str, moved_to=None):
            nonlocal seq
            jobs = [("thrift", thr, mux_plans(rng, MUX_BURST), seq),
                    ("mux", mx, mux_plans(rng, MUX_BURST), seq + MUX_BURST),
                    ("http", web, "svc-b", MUX_HTTP // 2, MUX_CONNS)]
            seq += 2 * MUX_BURST
            thrift, mux, http = await asyncio.gather(
                *(load.run(j) for j in jobs))
            runs[name] = (thrift, mux, http)
            out[name] = {
                "thrift": proto_checks(thrift, f"thrift C {name}", False,
                                       moved_to),
                "mux": proto_checks(mux, f"mux C {name}", False, moved_to),
                "http": http_checks(http, f"C {name}", "svc-b", False)}

        await burst("before")
        t0 = time.perf_counter()
        await namerd_put(api, MUX_DTAB + f" /svc/{moved} => "
                         f"/#/io.l5d.fs/{moved}-b ; /svc/m{moved} => "
                         f"/#/io.l5d.fs/m{moved}-b ;")
        put_ms = (time.perf_counter() - t0) * 1e3
        out["reroute"] = await both_answered(thr, mx, f"{moved}-b/", t0,
                                             MUX_REROUTE_S, seq)
        seq += out["reroute"]["calls"] + 1
        out["reroute"].update(put_ms=put_ms, write_to_first_answer_ms=max(
            out["reroute"]["thrift_ms"], out["reroute"]["mux_ms"]))
        await burst("moved", b_who)
        out["namerd_stop"] = stop_process(namerd, "namerd")
        await burst("outage", b_who)
        t0 = time.perf_counter()
        namerd = start_namerd(cfg, work / "namerd.log")
        out["restart"] = await both_answered(thr, mx, f"{moved}/", t0,
                                             MUX_RESTART_S, seq)
        seq += out["restart"]["calls"] + 1
        out["restart"]["start_to_first_answer_ms"] = max(
            out["restart"]["thrift_ms"], out["restart"]["mux_ms"])
        await burst("after")
        await tap.settle("C", task)
        launches = fused_anomaly_scores.launches
        http_sent = sum(len(r[2]["ms"]) for r in runs.values())
        folded: dict = {}
        for dsts, _, _ in tap.folds:
            for d in dsts:
                folded[d] = folded.get(d, 0) + 1
        if folded != {"/svc/svc-b": http_sent}:
            raise AssertionError(f"mux C: http rows folded {folded}, "
                                 f"{http_sent} sent to /svc/svc-b")
        out.update(snap_checks("C", tele, tap, len(tap.scored), launches,
                               dev))
        out["namerd_reboot_ms"] = await wait_ping(
            admin, lambda: namerd.poll() is None, "namerd", timeout=60.0)
        return out, launches
    finally:
        if task is not None:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
        if linker is not None:
            await linker.close()
        if namerd.poll() is None:
            stop_process(namerd, "namerd")
        for t, m in backs:
            t.close()
            await t.wait_closed()
            await m.close()
        shutil.rmtree(work, ignore_errors=True)


@contextlib.asynccontextmanager
async def mux_topology():
    """Config 3's downstreams, the destination backends and the load
    client in spawned processes; yields ``(loads, flag, ports, dports)``
    and stops every process after."""
    import multiprocessing

    mp = multiprocessing.get_context("spawn")
    flag = mp.RawValue("b", 0)
    loop = asyncio.get_running_loop()
    procs, conns = [], []
    try:
        for target, args in ((mux_config3_backends, (flag,)),
                             (mux_dst_backends,
                              (list(range(MUX_DSTS)), flag)),
                             (mux_load, ())):
            ours, theirs = mp.Pipe()
            p = mp.Process(target=target, args=(theirs, *args), daemon=True)
            p.start()
            procs.append(p)
            conns.append(ours)
        ports, dports = await asyncio.gather(
            *(loop.run_in_executor(None, c.recv) for c in conns[:2]))
        yield [MuxLoad(conns[2])], flag, ports, dports
    finally:
        for conn in conns:
            try:
                conn.send(None)
            except OSError:
                pass
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join()


async def mux_phase(dev: str = "cuda", parts=("A", "B", "C")):
    """Parts A (BASELINE config 3), B (the thrift and mux routers) and C
    (bound through namerd's thrift interface) over ``mux_topology``.
    Returns the results and the kernel's launches."""
    res, launches = {}, 0
    async with mux_topology() as (loads, flag, ports, dports):
        if "A" in parts:
            res["part_a"], n = await mux_part_a(loads, flag, ports[:3], dev)
            launches += n
        if "B" in parts:
            res["part_b"], n = await mux_part_b(loads, flag, ports[:2],
                                                dports, dev)
            launches += n
        if "C" in parts:
            res["part_c"], n = await mux_part_c(loads, flag, ports[:2],
                                                dports, dev)
            launches += n
    if "part_b" in res:
        b = res["part_b"]
        for w in ("calm", "faulted"):
            print(f"mux B {w}: " + ", ".join(
                f"{k} {v['calls_per_s']:.0f} calls/s p50 {v['p50_ms']:.3f} "
                f"p99 {v['p99_ms']:.3f} ms" for k, v in b[w].items()))
        print(f"mux B: {b['launches']} launches for {b['batches']} batches, "
              f"kernel vs plain max|diff| {b['kernel_vs_plain_max']:.3e}; "
              f"override answered by {b['override_answer']}")
    if "part_c" in res:
        c = res["part_c"]
        print(f"mux C: namerd /ping after {c['namerd_boot_ms']:.1f} ms; "
              f"write to the first -b answer "
              f"{c['reroute']['write_to_first_answer_ms']:.1f} ms (PUT "
              f"{c['reroute']['put_ms']:.1f} ms); namerd restart to the "
              f"first own-replica answer "
              f"{c['restart']['start_to_first_answer_ms']:.1f} ms; "
              + ", ".join(f"{k} thrift {c[k]['thrift']['calls_per_s']:.0f}"
                          f"/s mux {c[k]['mux']['calls_per_s']:.0f}/s"
                          for k in ("before", "moved", "outage", "after"))
              + f"; {c['launches']} launches for {c['batches']} batches")
    return res, launches


K8S_REQUESTS = 2048        # config 4's requests (the benchmark: 600)
ISTIO_REQUESTS = 1024      # config 5's front requests (the benchmark: 500)
K8S_AUC_TARGET = 0.9       # BASELINE.json's fault_auc targets (printed)
K8S_WAIT_S = 10.0          # a ConfigMap or Ingress update to its answer
K8S_TEARDOWN_S = 10.0      # a part's process, from its result to its end
K8S_INGRESS = 1024         # part C requests through the ingress router
K8S_SPLIT = 2048           # ... through the istio router (80/20 route)
K8S_SPLIT_POINTS = 5.0     # the split's tolerance, in points of share
K8S_NAMERS = 512           # ... through each of the ns and external routers
K8S_SVCS = ("ing-a", "ing-b", "reviews-v1", "reviews-v2", "ext")


class KTap(SnapTap):
    """A SnapTap that also keeps the host time spent in the scorer's
    score and fit calls (each returns once the card is done with it)."""

    def __init__(self, tele):
        super().__init__(tele)
        self.scorer_s = 0.0
        scorer = tele._ensure_scorer()
        score, fit = scorer.score, scorer.fit

        async def scoring(x):
            t0 = time.perf_counter()
            try:
                return await score(x)
            finally:
                self.scorer_s += time.perf_counter() - t0

        async def fitting(*a):
            t0 = time.perf_counter()
            try:
                return await fit(*a)
            finally:
                self.scorer_s += time.perf_counter() - t0

        scorer.score, scorer.fit = scoring, fitting


async def answered_by(proxy, host: str, uri: str = "/") -> tuple:
    """One request's (status, body) through ``proxy``."""
    from linkerd_tpu_torch.protocol.http import Request

    req = Request(method="GET", uri=uri)
    req.headers.set("Host", host)
    rsp = await proxy(req)
    return rsp.status, rsp.body


async def until_answer(proxy, host: str, want: bytes, what: str,
                       uri: str = "/") -> tuple:
    """Seconds until a request to ``host`` is answered ``want``, and the
    requests sent; raises after K8S_WAIT_S."""
    t0, sent = time.perf_counter(), 0
    while True:
        status, body = await answered_by(proxy, host, uri)
        sent += 1
        if status == 200 and body == want:
            return time.perf_counter() - t0, sent
        if time.perf_counter() - t0 > K8S_WAIT_S:
            raise AssertionError(f"k8s {what}: still answered {status} "
                                 f"{body[:40]!r} after {K8S_WAIT_S} s")
        await asyncio.sleep(0.01)


def auc_check(what: str, name: str, got: float) -> None:
    print(f"k8s {what}: {name} {got:.4f} (BASELINE target "
          f"{K8S_AUC_TARGET}, not gated; fails at <= 0.5)")
    if not got > 0.5:
        raise AssertionError(f"k8s {what}: {name} {got} <= 0.5")


async def k8s_part_a(dev: str, n_requests: int = K8S_REQUESTS):
    """BASELINE config 4 through ``testing/config4.py``'s schedule at
    ``n_requests`` on its topology; then a ConfigMap update moving svc-0
    to svc-1, timed to its first answer."""
    from linkerd_tpu_torch.testing import config4

    async with config4.Topology(dev) as top:
        tele = top.linker.telemeters[0]
        tap = KTap(tele)
        t0 = time.perf_counter()
        out, launches = await counted(config4.run_schedule(
            top.linker, top.traffic(), n_requests))
        drive_s = time.perf_counter() - t0
        calls = len(tap.scored)
        out.update(snap_checks("A", tele, tap, calls, launches, dev,
                               phase="k8s"))
        sent = sum(top.answers.values())
        requests = top.linker.metrics.counter(
            "rt", "k8s", "server", "requests").value
        if top.answers != {"right": sent, "wrong": 0, "failed": 0} or \
                requests != sent:
            raise AssertionError(f"k8s A: answers {top.answers}, router "
                                 f"counted {requests}")
        if top.strays:
            raise AssertionError(f"k8s A: {top.strays} requests reached a "
                                 f"pod after the binding showed it gone")
        served = {f"{s}/{p}": n for (s, p), n in sorted(top.served.items())}
        spans_s = await top.wait_spans(sent)
        if len(top.spans) < sent:
            raise AssertionError(f"k8s A: {len(top.spans)} spans at the "
                                 f"collector for {sent} requests")
        # the ConfigMap's dtab moves svc-0 to svc-1's pods, then back
        top.fake.set_dtab(config4.DTAB + " /svc/svc-0 => "
                          "/#/io.l5d.k8s/default/http/svc-1 ;")
        to_moved, _ = await until_answer(top.proxy, "svc-0",
                                         config4.body_of("svc-1"),
                                         "A ConfigMap update")
        top.fake.set_dtab(config4.DTAB)
        to_back, _ = await until_answer(top.proxy, "svc-0",
                                        config4.body_of("svc-0"),
                                        "A ConfigMap restore")
    auc_check("A", "fault_auc_subtle_k8s", out["fault_auc_subtle_k8s"])
    out.update(requests=sent, served=served, strays=top.strays,
               binding_ms=[s * 1e3 for s in top.binding_s],
               spans=len(top.spans), spans_wait_s=spans_s,
               configmap_update_to_answer_ms=to_moved * 1e3,
               configmap_restore_to_answer_ms=to_back * 1e3,
               drive_s=drive_s, req_per_s=sent / drive_s,
               scorer_s=tap.scorer_s, scorer_share=tap.scorer_s / drive_s,
               fault_auc_target=K8S_AUC_TARGET)
    print(f"k8s A (config 4, {n_requests} requests): "
          f"fault_auc_subtle_k8s {out['fault_auc_subtle_k8s']:.4f}; {sent} "
          f"requests in {drive_s:.2f} s ({out['req_per_s']:.0f}/s, one "
          f"sender), scorer calls {tap.scorer_s:.2f} s "
          f"({out['scorer_share']:.3f} of the drive); binding after a "
          f"restart {min(out['binding_ms']):.1f}-"
          f"{max(out['binding_ms']):.1f} ms; {len(top.spans)} spans; "
          f"ConfigMap update to answer {to_moved * 1e3:.1f} ms")
    return out, launches


async def k8s_part_b(dev: str, n_requests: int = ISTIO_REQUESTS):
    """BASELINE config 5 through ``testing/config5.py``'s schedule at
    ``n_requests`` front requests on its topology, with both routers and
    the mixer."""
    from linkerd_tpu_torch.testing import config5

    async with config5.Topology(dev) as top:
        tele = top.linker.telemeters[0]
        tap = KTap(tele)
        t0 = time.perf_counter()
        out, launches = await counted(config5.run_schedule(
            top.linker, top.traffic(), n_requests))
        drive_s = time.perf_counter() - t0
        calls = len(tap.scored)
        out.update(snap_checks("B", tele, tap, calls, launches, dev,
                               phase="k8s"))
        drain_s = await top.wait_reports()
        front, back = top.served()
        reports = len(top.reports)
        injected = top.err_injector.injected
    if reports != front + back:
        raise AssertionError(f"k8s B: {reports} mixer reports for {front} "
                             f"front and {back} back requests")
    errors = int(config5.ERRORS.split("-")[1])
    fronts = {i for i in range(config5.N_FRONT)
              if config5.db_of(config5.mid_of(i)) == errors}
    statuses = {}
    for frontend, status, window in top.answers:
        statuses[status] = statuses.get(status, 0) + 1
        if status == 502 and (window != "errors" or frontend not in fronts):
            raise AssertionError(f"k8s B: a 502 for svc-{frontend} in "
                                 f"window {window}, not a {config5.ERRORS} "
                                 f"503 window")
    if set(statuses) - {200, 502} or statuses.get(502, 0) != injected or \
            len(top.answers) != front:
        raise AssertionError(f"k8s B: statuses {statuses}, {injected} "
                             f"injected 503s, {len(top.answers)} sent, "
                             f"{front} served")
    for name in ("fault_auc_subtle_istio", "fault_auc_latency_only"):
        auc_check("B", name, out[name])
    out.update(front_requests=front, back_requests=back,
               mixer_reports=reports, reports_drain_s=drain_s,
               statuses=statuses, injected_503=injected,
               drive_s=drive_s, front_req_per_s=front / drive_s,
               router_req_per_s=(front + back) / drive_s,
               scorer_s=tap.scorer_s, scorer_share=tap.scorer_s / drive_s,
               fault_auc_target=K8S_AUC_TARGET)
    print(f"k8s B (config 5, {n_requests} front requests): "
          f"fault_auc_subtle_istio {out['fault_auc_subtle_istio']:.4f}, "
          f"fault_auc_latency_only {out['fault_auc_latency_only']:.4f}; "
          f"{front} front + {back} back requests in {drive_s:.2f} s "
          f"({out['front_req_per_s']:.0f} front/s), {reports} mixer "
          f"reports, {statuses.get(502, 0)} 502s from {injected} injected "
          f"503s; scorer calls {out['scorer_share']:.3f} of the drive")
    return out, launches


class NamingFake:
    """Part C's API server: config 4's fake (Endpoints by service) with
    Services whose LoadBalancer ingress is a local pod, and Ingresses
    listed and watched."""

    def __init__(self, pods, lb):
        from linkerd_tpu_torch.testing import config4

        self.k8s = config4.FakeK8s(pods)
        self.lb = lb  # service -> port
        self.ingresses = []
        self.ingress_queues = []

    def ingress(self, paths, version: int) -> dict:
        return {"kind": "Ingress",
                "metadata": {"name": "shop", "namespace": "default",
                             "resourceVersion": str(version)},
                "spec": {"rules": [{"host": "shop.example.com", "http": {
                    "paths": [{"path": p, "backend": {
                        "serviceName": s, "servicePort": "http"}}
                        for p, s in paths]}}]}}

    def set_ingress(self, paths, version: int) -> None:
        obj = self.ingress(paths, version)
        evt = "MODIFIED" if self.ingresses else "ADDED"
        self.ingresses[:] = [obj]
        for q in self.ingress_queues:
            q.put_nowait({"type": evt, "object": obj})

    def service(self):
        from linkerd_tpu_torch.protocol.http.message import Response
        from linkerd_tpu_torch.router.service import FnService

        inner = self.k8s.service()

        async def handler(req):
            uri = req.uri
            if "/ingresses" in uri:
                if "watch=true" in uri:
                    q = asyncio.Queue()
                    self.ingress_queues.append(q)
                    return Response(status=200, body_stream=self.k8s._stream(
                        self.ingress_queues, q))
                return Response(status=200, body=json.dumps({
                    "kind": "IngressList",
                    "metadata": {"resourceVersion": "1"},
                    "items": self.ingresses}).encode())
            if "/services/" in uri:
                svc = uri.split("?")[0].rsplit("/", 1)[1]
                if svc in self.lb:
                    return Response(status=200, body=json.dumps({
                        "kind": "Service",
                        "metadata": {"name": svc, "namespace": "default",
                                     "resourceVersion": "1"},
                        "spec": {"ports": [{"name": "http",
                                            "port": self.lb[svc]}]},
                        "status": {"loadBalancer": {"ingress": [
                            {"ip": "127.0.0.1"}]}}}).encode())
            return await inner(req)
        return FnService(handler)

    def close_watches(self) -> None:
        self.k8s.close_watches()
        for q in self.ingress_queues:
            q.put_nowait(None)


class NamingPilot:
    """Part C's pilot: SDS for two versions of ``reviews``, RDS naming
    it, and one route rule splitting it 80/20."""

    DEST = "reviews.default.svc.cluster.local"

    def __init__(self, v1: int, v2: int):
        self.registrations = {f"{self.DEST}|http|version=v1":
                              [("127.0.0.1", v1)],
                              f"{self.DEST}|http|version=v2":
                              [("127.0.0.1", v2)]}
        self.routes = [{"virtual_hosts": [
            {"name": f"{self.DEST}|http", "domains": ["reviews"]}]}]
        self.rules = [{"type": "route-rule", "name": "split", "spec": {
            "destination": self.DEST, "precedence": 1,
            "route": [{"tags": {"version": "v1"}, "weight": 80},
                      {"tags": {"version": "v2"}, "weight": 20}]}}]

    def service(self):
        from linkerd_tpu_torch.protocol.http.message import Response
        from linkerd_tpu_torch.router.service import FnService

        async def handler(req):
            path = req.uri.split("?", 1)[0]
            if path.startswith("/v1/registration/"):
                hosts = [{"ip_address": ip, "port": p} for ip, p in
                         self.registrations.get(
                             path[len("/v1/registration/"):], [])]
                return Response(200, body=json.dumps(
                    {"hosts": hosts}).encode())
            if path == "/v1/routes":
                return Response(200, body=json.dumps(self.routes).encode())
            if path == "/v1alpha1/config/route-rule":
                return Response(200, body=json.dumps(self.rules).encode())
            return Response(404)
        return FnService(handler)


def k8s_naming_config(k8s: int, pilot: int) -> str:
    """Part C's linker: four routers over the k8s API server and pilot,
    io.l5d.jaxAnomaly (frozen: no fit) on every router."""
    api = f"host: 127.0.0.1, port: {k8s}"
    pil = f"host: 127.0.0.1, port: {pilot}, pollIntervalMs: 100"
    return f"""
routers:
- protocol: http
  label: ingress
  identifier: {{kind: io.l5d.ingress, {api}}}
  dtab: |
    /svc => /#/io.l5d.k8s ;
  servers: [{{port: 0}}]
- protocol: http
  label: istio
  identifier: {{kind: io.l5d.k8s.istio, {pil}, discoveryPort: {pilot}}}
  interpreter: {{kind: io.l5d.k8s.istio, {pil}}}
  servers: [{{port: 0}}]
- protocol: http
  label: ns
  dtab: |
    /svc => /#/io.l5d.k8s.ns/http ;
  servers: [{{port: 0}}]
- protocol: http
  label: external
  dtab: |
    /svc => /#/io.l5d.k8s.external/default/http ;
  servers: [{{port: 0}}]
telemetry:
- kind: io.l5d.jaxAnomaly
  maxBatch: 1024
  trainEveryBatches: 0
namers:
- {{kind: io.l5d.k8s, {api}}}
- {{kind: io.l5d.k8s.ns, namespace: default, {api}}}
- {{kind: io.l5d.k8s.external, {api}}}
- {{kind: io.l5d.k8s.istio, {pil}}}
"""


async def bounded_teardown(closers) -> list:
    """Runs ``closers`` last first, each bounded by K8S_TEARDOWN_S; after
    the linker's, cancels the watch loops and pilot polls that outlive
    it (ROADMAP Queue 3: an identifier's watchers outlive its linker).
    Returns the closers that did not end in time (reported, not
    failed: a server's ``wait_closed`` held by a reconnecting watch once
    held a whole run past its limit)."""
    stuck = []
    for close in reversed(closers):
        try:
            await asyncio.wait_for(close(), K8S_TEARDOWN_S)
        except asyncio.TimeoutError:
            stuck.append(getattr(close, "__qualname__", repr(close)))
        if getattr(close, "__qualname__", "") == "Linker.close":
            for t in asyncio.all_tasks():
                if not t.done() and t.get_coro().__qualname__ in (
                        "Watcher._run", "_PollingClient._poll"):
                    t.cancel()
    if stuck:
        print(f"k8s C: teardown: {stuck} did not end within "
              f"{K8S_TEARDOWN_S} s and were left")
    return stuck


async def k8s_part_c(dev: str):
    """The naming pieces at traffic, one router each in one linker: the
    io.l5d.ingress identifier (an Ingress update moving a path, timed to
    its first answer), the io.l5d.k8s.istio identifier, interpreter and
    namer over a fake pilot (an 80/20 route rule, answers split within
    K8S_SPLIT_POINTS), an io.l5d.k8s.ns and an io.l5d.k8s.external
    router; each part's rows drained and checked, launches = batches."""
    from linkerd_tpu_torch.linker import load_linker
    from linkerd_tpu_torch.protocol.http import Request, Response
    from linkerd_tpu_torch.protocol.http.client import HttpClient
    from linkerd_tpu_torch.protocol.http.server import HttpServer, serve
    from linkerd_tpu_torch.router.service import FnService
    from linkerd_tpu_torch.testing import config4

    closers = []
    res, launches_all = {}, 0
    try:
        ports = {}
        for svc in K8S_SVCS:
            async def handler(req: Request, _svc=svc) -> Response:
                return Response(200, body=config4.body_of(_svc))
            server = await serve(FnService(handler))
            closers.append(server.close)
            ports[svc] = server.bound_port
        fake = NamingFake({s: [("127.0.0.1", p)] for s, p in ports.items()},
                          {"ext": ports["ext"]})
        fake.set_ingress([("/a/.*", "ing-a"), ("/b/.*", "ing-b")], 10)
        k8s_srv = await HttpServer(fake.service()).start()
        closers.append(k8s_srv.close)
        pilot_srv = await HttpServer(NamingPilot(
            ports["reviews-v1"], ports["reviews-v2"]).service()).start()
        closers.append(pilot_srv.close)

        async def end_watches():
            fake.close_watches()
            await asyncio.sleep(0)
        closers.append(end_watches)
        linker = load_linker(k8s_naming_config(
            k8s_srv.bound_port, pilot_srv.bound_port), device=dev)
        await linker.start()
        closers.append(linker.close)
        tele = linker.telemeters[0]
        tap = KTap(tele)
        proxies = {}
        for r in linker.routers:
            proxies[r.label] = HttpClient("127.0.0.1", r.server_ports[0])
            closers.append(proxies[r.label].close)

        async def part(label: str, plan, after=None):
            """``plan``: [(host, uri, answers allowed)]; every request
            answered 200 by an allowed service; then ``after()`` (its
            result and the requests it sent), the ring drained and the
            part's batches checked."""
            start = len(tap.scored)
            counts = {}
            t0 = time.perf_counter()
            for host, uri, allowed in plan:
                status, body = await answered_by(proxies[label], host, uri)
                who = next((s for s in K8S_SVCS
                            if body == config4.body_of(s)), None)
                if status != 200 or who not in allowed:
                    raise AssertionError(
                        f"k8s C {label}: {host}{uri} answered {status} by "
                        f"{who}, not one of {allowed}")
                counts[who] = counts.get(who, 0) + 1
            wall = time.perf_counter() - t0
            extra, probes = await after() if after else (None, 0)
            rows, n = await counted(config4.drain(tele))
            batches = len(tap.scored) - start
            if rows != len(plan) + probes or \
                    n != (0 if dev == "cpu" else batches):
                raise AssertionError(
                    f"k8s C {label}: {rows} rows scored for "
                    f"{len(plan) + probes} requests, {n} launches for "
                    f"{batches} batches")
            return {"counts": counts, "requests": len(plan) + probes,
                    "launches": n, "batches": batches, "wall_s": wall,
                    "req_per_s": len(plan) / wall, "after": extra}, n

        async def move_path():
            """An Ingress update sends /a/ to ing-b: seconds to the
            first answer by ing-b."""
            fake.set_ingress([("/a/.*", "ing-b"), ("/b/.*", "ing-b")], 11)
            return await until_answer(
                proxies["ingress"], "shop.example.com",
                config4.body_of("ing-b"), "C ingress update", uri="/a/x")

        # the ingress router: rules by host and path
        plan = [("shop.example.com", f"/{c}/x", (f"ing-{c}",))
                for c in "ab" * (K8S_INGRESS // 2)]
        res["ingress"], n = await part("ingress", plan, move_path)
        launches_all += n
        res["ingress"]["update_to_answer_ms"] = \
            1e3 * res["ingress"].pop("after")
        # the istio router: an 80/20 route rule over two versions
        plan = [("reviews", "/", ("reviews-v1", "reviews-v2"))] * K8S_SPLIT
        res["istio"], n = await part("istio", plan)
        launches_all += n
        counts = res["istio"]["counts"]
        share = 100.0 * counts.get("reviews-v1", 0) / K8S_SPLIT
        res["istio"]["v1_share_points"] = share
        print(f"k8s C istio: v1 {share:.1f}% of {K8S_SPLIT} (route 80/20)")
        if abs(share - 80.0) > K8S_SPLIT_POINTS:
            raise AssertionError(f"k8s C istio: v1 answered {share:.1f}% "
                                 f"of {K8S_SPLIT}, not 80 +- "
                                 f"{K8S_SPLIT_POINTS}")
        # the namespaced and external namers
        plan = [(s, "/", (s,)) for s in ("ing-a", "ing-b", "ext")] * (
            K8S_NAMERS // 3)
        res["ns"], n = await part("ns", plan)
        launches_all += n
        res["external"], n = await part(
            "external", [("ext", "/", ("ext",))] * K8S_NAMERS)
        launches_all += n
        # every part's batches, each under the model it read, and the
        # board
        res.update(snap_checks("C", tele, tap, len(tap.scored),
                               launches_all, dev, phase="k8s"))
    finally:
        res["teardown_stuck"] = await bounded_teardown(closers)
    print("k8s C: " + "; ".join(
        f"{k} {res[k]['requests']} requests {res[k]['req_per_s']:.0f}/s, "
        f"{res[k]['launches']} launches for {res[k]['batches']} batches"
        for k in ("ingress", "istio", "ns", "external"))
        + f"; Ingress update to answer "
        f"{res['ingress']['update_to_answer_ms']:.1f} ms")
    return res, launches_all


def k8s_wait(conn, proc, part: str) -> tuple:
    """(part, kind, what, exit_s) from a part's process once it sends
    them, or (part, "crash", its exit code, None) once it ends without
    sending: ``exit_s`` is the seconds from what it sent to its end, or
    None if it did not end within K8S_TEARDOWN_S."""
    while not conn.poll(0.2):
        if not proc.is_alive() and not conn.poll(0):
            return part, "crash", f"exited with {proc.exitcode}", None
    got = conn.recv()
    t0 = time.perf_counter()
    proc.join(K8S_TEARDOWN_S)
    return (part, *got,
            None if proc.is_alive() else time.perf_counter() - t0)


def k8s_child(conn, part: str, dev: str, n_requests: int) -> None:
    """Part A or B of the k8s phase in a spawned process of its own; sends
    back ("ok", (results, launches)), or the failure: ("assert", its
    message) or ("crash", the traceback)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fn = {"A": k8s_part_a, "B": k8s_part_b}[part]

    async def run_and_send():
        # sent from inside the loop, with what the part left running: a
        # part's result reaches the parent even when the loop's teardown
        # (those tasks, the executor's threads) does not end; the parent
        # times the teardown and stops the process after K8S_TEARDOWN_S
        res, launches = await fn(dev, n_requests)
        left = [t for t in asyncio.all_tasks()
                if t is not asyncio.current_task()]
        res["teardown"] = {
            "tasks_left": len(left),
            "task_kinds": sorted({t.get_coro().__qualname__
                                  for t in left}),
            "threads_left": threading.active_count() - 1}
        conn.send(("ok", (res, launches)))

    try:
        asyncio.run(run_and_send())
    except AssertionError as e:
        conn.send(("assert", str(e)))
    except BaseException:  # noqa: BLE001 — reported to the parent
        import traceback
        conn.send(("crash", traceback.format_exc()))
    finally:
        conn.close()


async def k8s_phase(dev: str = "cuda", parts=("A", "B", "C")):
    """Parts A (BASELINE config 4) and B (BASELINE config 5), each in a
    spawned process of its own, beside part C (the ingress, istio, ns
    and external naming pieces) in this one: each part sends its
    requests one at a time, as the benchmarks do, and the three run at
    once. Returns the results and the kernel's launches."""
    import multiprocessing

    mp = multiprocessing.get_context("spawn")
    loop = asyncio.get_running_loop()
    res, launches, procs, waits = {}, 0, [], {}
    t0 = time.perf_counter()
    try:
        for part, n in (("A", K8S_REQUESTS), ("B", ISTIO_REQUESTS)):
            if part in parts:
                ours, theirs = mp.Pipe(duplex=False)
                p = mp.Process(target=k8s_child, args=(theirs, part, dev, n),
                               daemon=True)
                p.start()
                theirs.close()
                procs.append(p)
                waits[part] = loop.run_in_executor(
                    None, k8s_wait, ours, p, part)
        if "C" in parts:
            res["part_c"], n = await k8s_part_c(dev)
            launches += n
        for fut in asyncio.as_completed(list(waits.values())):
            part, kind, got, exit_s = await fut
            if kind == "assert":
                raise AssertionError(got)
            if kind == "crash":
                raise RuntimeError(f"k8s part {part}:\n{got}")
            res[f"part_{part.lower()}"], n = got
            launches += n
            down = got[0]["teardown"]
            down["exit_after_s"] = exit_s
            print(f"k8s {part}: teardown left {down['tasks_left']} tasks "
                  f"({', '.join(down['task_kinds']) or 'none'}) and "
                  f"{down['threads_left']} threads; " + (
                      f"the process did not end within {K8S_TEARDOWN_S} s "
                      f"of its result and was stopped" if exit_s is None
                      else f"the process ended {exit_s:.2f} s after its "
                      f"result"))
    finally:
        # a part that failed stops the others at once
        for p in procs:
            for stop in (p.terminate, p.kill):
                if p.is_alive():
                    stop()
                    p.join(timeout=10)
        await asyncio.gather(*waits.values(), return_exceptions=True)
    res["phase_s"] = time.perf_counter() - t0
    print(f"k8s: {launches} launches, {res['phase_s']:.1f} s")
    return res, launches


# The edge phase: tenant isolation, the request loggers, the access log,
# a namer's transformers and the fs announcer, on the linker phases'
# topology (seed 12), each router with the io.l5d.jaxAnomaly telemeter.
# Spawned closed-loop load processes send with 16 tenants in the
# l5d-tenant header, in three windows: calm (every tenant at an equal
# share over every destination), storm (the faults on; EDGE_STORM_SHARE
# of the requests carry EDGE_STORMER to the faulted destinations, a
# retry storm against a failing service, the rest spread over the other
# tenants and every destination) and recovery (calm again, until the
# stormer's quota clears or EDGE_RECOVERY_S pass). Part A, the Python
# HTTP router; part B, the native HTTP/1.1 engine with 4 workers
# (nativeTier off: every row through the kernel); part C, the native h2
# engine with gRPC calls (nativeTier primary: the engine scores its rows
# with the published model and keeps each tenant's score EWMA).
EDGE_TENANTS = tuple(f"t{i:02d}" for i in range(16))
EDGE_STORMER = EDGE_TENANTS[-1]
EDGE_STORM_SHARE = 0.85
EDGE_CALM_S, EDGE_STORM_S, EDGE_RECOVERY_S = 5.0, 15.0, 15.0
EDGE_WARM_S = 1.0          # a settled segment before the calm window
EDGE_SEGMENT_S = 1.0       # the load's segments (the recovery test's cadence)
EDGE_SAMPLE_S = 0.1        # the governor's sick set, sampled this often
EDGE_TENANT_CFG = {"floor": 0.1, "enterThreshold": 0.7,
                   "exitThreshold": 0.3, "quorum": 3, "cooldownS": 2}
EDGE_ADMISSION = 64        # part A's maxConcurrency
EDGE_SUBLIMIT = 6          # round(0.1 x 64): the stormer's quota, A and C
EDGE_WORKERS = 4           # part B: 6 // 4 = 1 a worker
EDGE_HASH_IDS = 10_000
EDGE_LABEL = "edge"
EDGE_DEAD_HOST = "127.0.0.2"   # in the disco files; the transformer drops it
EDGE_MODEL_SEED = 16
EDGE_CALM_LOGIT = -4.0     # part C: the calm rows' mean classifier logit
EDGE_C_RECON_WEIGHT = 0.2
EDGE_H2_CONNS, EDGE_H2_STREAMS = 8, 8
EDGE_COLS = ("tenant", "dst", "status", "shed", "right", "fault", "t", "ms")
REFUSED_STREAM_CODE = -7   # a call reset REFUSED_STREAM, in the load's columns


def edge_pick(rng, mix: str):
    """One request's (tenant index, destination index) for ``mix``."""
    if mix == "storm":
        if rng.random() < EDGE_STORM_SHARE:
            return len(EDGE_TENANTS) - 1, int(rng.integers(TELE_FAULTED))
        return (int(rng.integers(len(EDGE_TENANTS) - 1)),
                int(rng.integers(TELE_ROUTES)))
    return int(rng.integers(len(EDGE_TENANTS))), int(rng.integers(TELE_ROUTES))


class _Tenanted:
    """An h2 service that stamps ``tenant`` into each request's
    l5d-tenant header."""

    def __init__(self, svc):
        self.svc, self.tenant = svc, ""

    async def __call__(self, req):
        req.headers.set("l5d-tenant", self.tenant)
        return await self.svc(req)


async def edge_segment(clients: dict, kind: str, port: int, conns,
                       seconds: float, mix: str, seed: int) -> dict:
    """``edge_load``'s work for one message: closed-loop requests on the
    connections ``conns`` (indices into ``clients``, opened on first use)
    for ``seconds``."""
    from linkerd_tpu_torch.grpc import ClientDispatcher, GrpcError
    from linkerd_tpu_torch.protocol.h2.client import H2Client
    from linkerd_tpu_torch.protocol.h2.stream import StreamReset
    from linkerd_tpu_torch.protocol.http.client import HttpClient
    from linkerd_tpu_torch.protocol.http.message import Request

    cols = {k: [] for k in EDGE_COLS}
    deadline = time.monotonic() + seconds

    def record(tn, d, status, shed, right, fault, t0):
        now = time.monotonic()
        for k, v in zip(EDGE_COLS, (tn, d, status, shed, right, fault,
                                    now, (now - t0) * 1e3)):
            cols[k].append(v)

    async def http_conn(i):
        rng = np.random.default_rng([seed, i])
        client = clients.get((kind, port, i))
        if client is None:
            client = clients[(kind, port, i)] = HttpClient(
                "127.0.0.1", port, max_connections=1)
        while time.monotonic() < deadline:
            tn, d = edge_pick(rng, mix)
            req = Request(uri="/")
            req.headers.set("Host", f"tele-{d:02d}")
            req.headers.set("l5d-tenant", EDGE_TENANTS[tn])
            t0 = time.monotonic()
            try:
                rsp = await client(req)
            except Exception:  # noqa: BLE001 — counted as status -1
                record(tn, d, -1, False, False, False, t0)
                continue
            body = rsp.body
            record(tn, d, rsp.status,
                   rsp.status == 503
                   and rsp.headers.get("l5d-retryable") == "true",
                   body.startswith(f"tele-{d:02d}/".encode()),
                   rsp.status == 503 and body == b"injected fault", t0)

    async def h2_stream(i, j):
        tele_msg, svc = h2_proto()
        rng = np.random.default_rng([seed, i, j])
        client = clients.get((kind, port, i))
        if client is None:
            client = clients[(kind, port, i)] = H2Client("127.0.0.1", port)
        tenanted = _Tenanted(client)
        stubs: dict = {}
        while time.monotonic() < deadline:
            tn, d = edge_pick(rng, mix)
            tenanted.tenant = EDGE_TENANTS[tn]
            stub = stubs.get(d)
            if stub is None:
                stub = stubs[d] = ClientDispatcher(
                    tenanted, authority=f"tele-{d:02d}")
            text, code, t0 = "", 0, time.monotonic()
            try:
                rep = await stub.unary(svc, "Echo", tele_msg(text="x"))
                text = rep.text
            except GrpcError as e:
                code = e.status.code
            except StreamReset as e:
                code = (REFUSED_STREAM_CODE if e.error_code == 7
                        else -1)
            except Exception:  # noqa: BLE001 — counted as code -1
                code = -1
            record(tn, d, code, code == REFUSED_STREAM_CODE,
                   text.startswith(f"tele-{d:02d}/"), code == 14, t0)

    if kind == "http":
        await asyncio.gather(*(http_conn(i) for i in conns))
    else:
        await asyncio.gather(*(h2_stream(i, j) for i in conns
                               for j in range(EDGE_H2_STREAMS)))
    return {k: np.asarray(v) for k, v in cols.items()}


def edge_load(conn) -> None:
    """Child process: on each ``(kind, port, conns, seconds, mix,
    seed)`` from ``conn``, closed-loop load with a tenant a request
    (``edge_segment``) for ``seconds``, then every request's tenant,
    destination, status (the grpc code for h2, REFUSED_STREAM_CODE for a
    REFUSED_STREAM reset), whether it was shed (a 503 with
    ``l5d-retryable: true``, or that reset), whether a replica of its
    destination answered, whether its destination's injected fault did,
    the instant it completed and its ms. Connections stay open from
    message to message; ``None`` ends it."""
    # the clients' modules (torch under the package) load while the
    # topology starts, not in the first window
    import linkerd_tpu_torch.grpc  # noqa: F401
    import linkerd_tpu_torch.protocol.h2.client  # noqa: F401
    import linkerd_tpu_torch.protocol.http.client  # noqa: F401

    async def main():
        loop = asyncio.get_running_loop()
        clients: dict = {}
        try:
            while True:
                msg = await loop.run_in_executor(None, conn.recv)
                if msg is None:
                    return
                conn.send(await edge_segment(clients, *msg))
        finally:
            for c in clients.values():
                await c.close()

    asyncio.run(main())


async def edge_window(loads, kind: str, port: int, seconds: float,
                      mix: str, seed: int, until=None) -> dict:
    """Closed-loop load through the router at ``port`` for ``seconds``,
    in segments of EDGE_SEGMENT_S (with ``until``, it ends after the
    first segment after which ``until()`` holds): every request's
    columns, the wall seconds and whether ``until`` ended it."""
    loop = asyncio.get_running_loop()
    conns = LINKER_CONNS if kind == "http" else EDGE_H2_CONNS
    shares = np.array_split(np.arange(conns), len(loads))
    t0, parts, seg, ended = time.monotonic(), [], 0, False
    while True:
        left = seconds - (time.monotonic() - t0)
        if left <= 0.05:
            break
        for (c, _), idx in zip(loads, shares):
            c.send((kind, port, idx.tolist(), min(EDGE_SEGMENT_S, left),
                    mix, seed * 1000 + seg))
        parts += await asyncio.gather(*(loop.run_in_executor(None, c.recv)
                                        for c, _ in loads))
        seg += 1
        if until is not None and until():
            ended = True
            break
    res = {k: np.concatenate([p[k] for p in parts]) for k in EDGE_COLS}
    res["wall"], res["ended"] = time.monotonic() - t0, ended
    return res


class EdgeSampler:
    """Samples the quota governor's sick set (by tenant name) every
    EDGE_SAMPLE_S on the router's loop."""

    def __init__(self, adm, names: dict):
        self.adm, self.names, self.samples = adm, names, []
        self._task = asyncio.create_task(self._run())

    def sick(self) -> tuple:
        return tuple(sorted(self.names.get(k, k)
                            for k in self.adm.status()["sick"]))

    async def _run(self):
        while True:
            self.samples.append((time.monotonic(), self.sick()))
            await asyncio.sleep(EDGE_SAMPLE_S)

    async def stop(self) -> None:
        if not self._task.done():
            self._task.cancel()
            await asyncio.gather(self._task, return_exceptions=True)
            self.samples.append((time.monotonic(), self.sick()))

    def between(self, t0: float, t1: float) -> list:
        return [s for t, s in self.samples if t0 <= t < t1]


def edge_hashes() -> dict:
    """The board's key of each tenant on an engine (``#<hash>``) ->
    its name."""
    from linkerd_tpu_torch.router.tenancy import tenant_hash

    return {f"#{tenant_hash(t):08x}": t for t in EDGE_TENANTS}


def edge_config(part: str, disco: Path, work: Path) -> str:
    """The edge router of part A (the Python HTTP router with admission,
    a file request logger, the access log and an announced server), B
    (the HTTP/1.1 engine, 4 workers) or C (the h2 engine) as JSON text:
    tenants by the l5d-tenant header at the reference's defaults, the fs
    namer (behind io.l5d.specificHost on A and B) and the telemeter
    without training."""
    router = {"protocol": "http", "label": EDGE_LABEL,
              "dtab": "/svc => /#/io.l5d.fs ;", "servers": [{"port": 0}],
              "tenantIdentifier": {"kind": "header"},
              "tenants": dict(EDGE_TENANT_CFG)}
    namer = {"kind": "io.l5d.fs", "rootDir": str(disco)}
    tele = {"kind": "io.l5d.jaxAnomaly", "trainEveryBatches": 0,
            "reconWeight": 1.0}
    cfg = {"routers": [router], "namers": [namer], "telemetry": [tele]}
    if part in ("A", "B"):
        namer["transformers"] = [{"kind": "io.l5d.specificHost",
                                  "host": "127.0.0.1"}]
    if part == "A":
        router.update(
            admissionControl={"maxConcurrency": EDGE_ADMISSION},
            client={"failureAccrual": {"kind": "none"}},
            loggers=[{"kind": "io.l5d.http.file",
                      "path": str(work / "requests.log")}],
            httpAccessLog=str(work / "access.log"),
            servers=[{"port": 0,
                      "announce": [f"/#/io.l5d.fs/{EDGE_LABEL}"]}])
        cfg["announcers"] = [{"kind": "io.l5d.fs",
                              "rootDir": str(work / "announce")}]
    elif part == "B":
        router.update(fastPath=True, workers=EDGE_WORKERS)
        tele["nativeTier"] = "off"
    else:
        router.update(protocol="h2", fastPath=True)
        tele.update(nativeTier="primary", reconWeight=EDGE_C_RECON_WEIGHT)
    return json.dumps(cfg)


def edge_model(tele, x: np.ndarray, seed: int = EDGE_MODEL_SEED,
               calm_logit=None):
    """Restores into the telemeter's scorer, and returns, a frozen model
    for the rows still to come, as ``traffic_model`` makes it from the
    rows ``x`` seen so far. With ``calm_logit`` the classifier's output
    bias moves so that those rows' mean logit is ``calm_logit``: calm
    traffic then scores low, as under a trained model, and every
    tenant's score EWMA in an engine can fall under exitThreshold."""
    import torch

    from linkerd_tpu_torch.models.anomaly import (
        apply_model, normalize_features,
    )
    from linkerd_tpu_torch.models.convert import params_from_numpy

    snap = tele._scorer.snapshot()
    snap.params = random_params(seed, snap.cfg)
    snap.mu = x.mean(axis=0).astype(np.float32)
    snap.var = (x.var(axis=0) + 1e-6).astype(np.float32)
    snap.norm_initialized = True
    if calm_logit is not None:
        z = normalize_features(torch.tensor(x), torch.tensor(snap.mu),
                               torch.tensor(snap.var))
        _, _, logits = apply_model(params_from_numpy(snap.params, "cpu"),
                                   z, snap.cfg, exact_sums=True)
        cls = snap.params["cls"][-1]
        cls["b"] = (cls["b"] - np.float32(float(logits.mean())
                                          - calm_logit)).astype(np.float32)
    tele._scorer.restore(snap)
    return tele._scorer.snapshot()


def batch_rows(tap) -> np.ndarray:
    """The features of every row of every batch a FastPathTap saw,
    device- and engine-scored."""
    return np.concatenate(
        [b["x"] for b in tap.batches]
        + [b["nat_scored"]["x"] for b in tap.batches
           if b.get("nat_scored")])


def freeze_model(tap, tele):
    """Sets ``tap.model`` (a ``SnapTap``'s or a ``FastPathTap``'s) to
    the model ``tele``'s scorer holds now, for a telemeter that does not
    train: each score call then records it, or the one the phase sets
    after it, as the model it read. Returns the tap."""
    tap.model = tele._ensure_scorer().snapshot()
    return tap


def edge_engine_checks(what: str, tele, tap, launches: int,
                       dev: str) -> dict:
    """Every device score call of an engine part under the model it
    read: kernel against plain on every row (TOL; at most ROW_SHARE of a
    batch's rows past ROW_TOL), one launch a call, and the board against
    a fold with the plain scores."""
    plain = [plain_scores(snap, x, dev)
             for (x, _), snap in zip(tap.scored, tap.snaps)]
    if launches != (0 if dev == "cpu" else len(tap.scored)):
        raise AssertionError(f"edge {what}: {launches} kernel launches for "
                             f"{len(tap.scored)} batches with device rows")
    gaps = [np.abs(s - p) for (_, s), p in zip(tap.scored, plain)]
    out = {"launches": launches, "batches": len(tap.batches),
           "device_batches": len(tap.scored),
           "device_rows": int(sum(len(g) for g in gaps))}
    if gaps:
        gap = np.concatenate(gaps)
        share = max((g > ROW_TOL).mean() for g in gaps if len(g))
        out.update(kernel_vs_plain_max=float(gap.max()),
                   rows_past_row_tol=int((gap > ROW_TOL).sum()),
                   worst_batch_share_past_row_tol=float(share))
        if gap.max() > TOL or share > ROW_SHARE:
            raise AssertionError(f"edge {what}: kernel vs plain max "
                                 f"{gap.max()}, up to {share} of a batch's "
                                 f"rows past {ROW_TOL}")
    out["board_vs_plain_fold_max"] = fastpath_board_check(tele, tap, 0,
                                                          plain)
    if out["board_vs_plain_fold_max"] > TOL:
        raise AssertionError(f"edge {what}: board off the plain fold by "
                             f"{out['board_vs_plain_fold_max']}")
    print(f"edge {what}: {launches} launches for {len(tap.scored)} batches "
          f"with device rows ({out['device_rows']} rows) of "
          f"{len(tap.batches)}; kernel vs plain max "
          f"{out.get('kernel_vs_plain_max', 0.0):.3e}; board vs plain "
          f"fold {out['board_vs_plain_fold_max']:.3e}")
    return out


def edge_answer_checks(what: str, windows: dict) -> dict:
    """Every request not shed was answered by the destination it named,
    or in the storm by its faulted destination's injected fault; no
    tenant but the stormer was ever shed; the stormer was shed in the
    storm. Returns requests/s, counts and the calm tenants' p50/p99 ms
    (their faulted answers apart) a window."""
    out = {}
    stormer = len(EDGE_TENANTS) - 1
    for name, r in windows.items():
        faulted = (r["dst"] < TELE_FAULTED) & (name == "storm")
        ok = r["shed"] | r["right"] | (faulted & r["fault"])
        if not ok.all():
            i = int(np.flatnonzero(~ok)[0])
            raise AssertionError(
                f"edge {what} {name}: {int((~ok).sum())} requests not "
                f"answered by their destination, e.g. tenant "
                f"{EDGE_TENANTS[r['tenant'][i]]} to tele-{r['dst'][i]:02d} "
                f"-> status {r['status'][i]}")
        calm_shed = r["shed"] & (r["tenant"] != stormer)
        if calm_shed.any():
            raise AssertionError(
                f"edge {what} {name}: {int(calm_shed.sum())} requests of "
                f"calm tenants shed, e.g. "
                f"{EDGE_TENANTS[r['tenant'][np.flatnonzero(calm_shed)[0]]]}")
        st = r["tenant"] == stormer
        calm_ms = r["ms"][~st & ~r["fault"]]
        out[name] = {"requests": len(r["t"]),
                     "calm_p50_ms": float(np.percentile(calm_ms, 50)),
                     "calm_p99_ms": float(np.percentile(calm_ms, 99)),
                     "requests_per_s": len(r["t"]) / r["wall"],
                     "stormer": int(st.sum()),
                     "stormer_shed": int((st & r["shed"]).sum()),
                     "injected_faults": int(r["fault"].sum()),
                     "wall_s": r["wall"]}
    if not out["storm"]["stormer_shed"]:
        raise AssertionError(f"edge {what}: {EDGE_STORMER} was never shed "
                             f"in the storm")
    return out


def edge_sick_checks(what: str, sampler, t_storm: float, t_rec: float,
                     adm, ended: bool) -> dict:
    """The governor's sick set: never a calm tenant; the stormer SICK at
    the end of the storm and cleared in the recovery window, with one
    transition each way (no flap)."""
    calm = {s for t, sick in sampler.samples for s in sick
            if s != EDGE_STORMER}
    if calm:
        raise AssertionError(f"edge {what}: calm tenants SICK: {calm}")
    storm = sampler.between(t_storm, t_rec)
    first = next((t for t, sick in sampler.samples
                  if t >= t_storm and EDGE_STORMER in sick), None)
    if not storm or EDGE_STORMER not in storm[-1]:
        raise AssertionError(f"edge {what}: {EDGE_STORMER} not SICK at the "
                             f"end of the storm")
    cleared = next((t for t, sick in sampler.samples
                    if t >= t_rec and EDGE_STORMER not in sick), None)
    if not ended or cleared is None:
        raise AssertionError(f"edge {what}: {EDGE_STORMER} still SICK "
                             f"{EDGE_RECOVERY_S} s into the recovery")
    flips = sum(1 for (_, a), (_, b) in zip(sampler.samples,
                                            sampler.samples[1:])
                if (EDGE_STORMER in a) != (EDGE_STORMER in b))
    if adm.transitions != 2 or flips != 2:
        raise AssertionError(f"edge {what}: {adm.transitions} quota "
                             f"transitions ({flips} in the samples), want "
                             f"SICK and back: it flapped")
    return {"stormer_sick_after_s": first - t_storm,
            "stormer_cleared_after_s": cleared - t_rec,
            "transitions": adm.transitions}


async def edge_windows(loads, kind: str, port: int, flag, settle,
                       set_model, cleared, storm_end) -> tuple:
    """A warm-up segment, then calm, storm and recovery through the
    router at ``port``. ``settle(*windows)`` waits for the rows of the
    windows so far to be scored (after the warm-up, so that the
    scorer's first build and warm-up fall before the calm window, and
    after the calm window); ``set_model()`` then sets the model of the
    storm and the recovery; ``storm_end()`` runs as the storm's load
    ends (the faults still on); ``cleared()`` ends the recovery. Returns
    the windows, what ``storm_end`` returned, and the storm's and
    recovery's start instants."""
    flag.value = 0
    warm = await edge_window(loads, kind, port, EDGE_WARM_S, "calm", 0)
    await settle(warm)
    calm = await edge_window(loads, kind, port, EDGE_CALM_S, "calm", 1)
    await settle(warm, calm)
    await set_model()
    flag.value = 1
    t_storm = time.monotonic()
    storm = await edge_window(loads, kind, port, EDGE_STORM_S, "storm", 2)
    at_end = storm_end()
    flag.value = 0
    t_rec = time.monotonic()
    rec = await edge_window(loads, kind, port, EDGE_RECOVERY_S, "calm", 3,
                            until=cleared)
    return ({"warm": warm, "calm": calm, "storm": storm, "recovery": rec},
            at_end, t_storm, t_rec)


async def edge_part_a(loads, flag, disco: Path, work: Path, dev: str):
    """The Python HTTP router (``edge_config("A")``) through the three
    windows: kernel and board against plain under the model each batch
    read, the stormer SICK and shed at its sub-limit with retryable 503s
    and recovered, no calm tenant SICK or shed, every other request
    answered by its destination or its fault, /tenants.json, one file
    log line a request that reached a client, one access log line a
    request the server answered, the client scopes the transformed
    bound ids, and the announcement while the router runs and withdrawn
    after."""
    from linkerd_tpu_torch.admin.handlers import mk_tenants_handler
    from linkerd_tpu_torch.core.tasks import monitor
    from linkerd_tpu_torch.linker import load_linker
    from linkerd_tpu_torch.ops.scoring import fused_anomaly_scores
    from linkerd_tpu_torch.protocol.http.message import Request
    from linkerd_tpu_torch.router.tenancy import tenant_hash

    linker = load_linker(edge_config("A", disco, work), device=dev)
    await linker.start()
    port = linker.routers[0].server_ports[0]
    tele = linker.telemeters[0]
    _, board, adm = linker.tenant_views[0]
    admission = adm._filters[0]
    announced = work / "announce" / EDGE_LABEL
    out = {"announced": announced.read_text()}
    if out["announced"] != f"127.0.0.1 {port}\n":
        raise AssertionError(f"edge A: announce file {out['announced']!r}")
    tap = freeze_model(SnapTap(tele), tele)
    task = monitor(asyncio.create_task(tele.run()), what="telemeter-edge-A")
    sampler = EdgeSampler(adm, {})
    th = tenant_hash(EDGE_STORMER)
    closed = False
    try:
        fused_anomaly_scores.launches = 0

        async def settle(*_windows):
            await tap.settle("edge A", task)

        async def set_model():
            tap.model = edge_model(
                tele, np.concatenate([x for x, _, _ in tap.scored]))

        def cleared():
            return (EDGE_STORMER not in sampler.sick()
                    and admission.tenant_limit_of(th) is None)

        windows, limit, t_storm, t_rec = await edge_windows(
            loads, "http", port, flag, settle, set_model, cleared,
            lambda: admission.tenant_limit_of(th))
        await tap.settle("edge A recovery", task)
        launches = fused_anomaly_scores.launches
        await sampler.stop()
        out.update(snap_checks("A", tele, tap, len(tap.scored), launches,
                               dev, phase="edge"))
        out["windows"] = edge_answer_checks("A", windows)
        out["sick"] = edge_sick_checks("A", sampler, t_storm, t_rec, adm,
                                       windows["recovery"]["ended"])
        out["stormer_sublimit"] = limit
        if limit != EDGE_SUBLIMIT:
            raise AssertionError(f"edge A: {EDGE_STORMER}'s sub-limit "
                                 f"{limit} at the end of the storm, want "
                                 f"{EDGE_SUBLIMIT}")
        flat = linker.metrics.flatten()
        out["router_ms"] = stage_ms(flat, EDGE_LABEL)
        out["tenant_transitions"] = flat[
            f"rt/{EDGE_LABEL}/server/tenants/tenant_transitions"]
        out["tenant_shed_total"] = flat[
            f"rt/{EDGE_LABEL}/server/admission/tenant_shed_total"]
        print(f"edge A: rt/{EDGE_LABEL}/server/tenants/tenant_transitions "
              f"{out['tenant_transitions']} (SICK at "
              f"+{out['sick']['stormer_sick_after_s']:.2f} s into the "
              f"storm, cleared +{out['sick']['stormer_cleared_after_s']:.2f}"
              f" s into the recovery); tenant sheds "
              f"{out['tenant_shed_total']}")
        rsp = await mk_tenants_handler(linker)(Request(uri="/tenants.json"))
        got = json.loads(rsp.body)[EDGE_LABEL]
        status = adm.status()
        want = json.loads(json.dumps({
            "tenants": board.snapshot(), "evicted": board.evicted,
            "quotas": {k: v for k, v in status.items() if k != "tenants"}}))
        if got != want:
            raise AssertionError("edge A: /tenants.json differs from the "
                                 "board's snapshot and the governor's status")
        clients = {k.split("/")[3] for k in flat
                   if k.startswith(f"rt/{EDGE_LABEL}/client/")}
        want_clients = {f"%.io.l5d.specificHost.#.io.l5d.fs.tele-{d:02d}"
                        for d in range(TELE_ROUTES)}
        if clients != want_clients:
            raise AssertionError(f"edge A: client scopes "
                                 f"{sorted(clients)[:3]}..., want the "
                                 f"transformed bound ids")
        endpoints = set(tele.board.effective_endpoint_scores())
        if any(not e.startswith("127.0.0.1:") for e in endpoints):
            raise AssertionError(f"edge A: endpoints {sorted(endpoints)[:3]}")
        client_requests = sum(
            v for k, v in flat.items()
            if k.startswith(f"rt/{EDGE_LABEL}/client/")
            and k.endswith("/requests"))
        served = flat[f"rt/{EDGE_LABEL}/server/requests"]
        sent = sum(len(w["t"]) for w in windows.values())
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        await linker.close()
        closed = True
        log_lines = len((work / "requests.log").read_text().splitlines())
        access_lines = len((work / "access.log").read_text().splitlines())
        out.update(sent=sent, served=served, client_requests=client_requests,
                   request_log_lines=log_lines,
                   access_log_lines=access_lines,
                   withdrawn=not announced.exists(),
                   board_keys=len(tele.board.effective_scores()))
        if log_lines != client_requests:
            raise AssertionError(f"edge A: {log_lines} request log lines, "
                                 f"{client_requests} requests reached a "
                                 f"client")
        if access_lines != served or served != sent:
            raise AssertionError(f"edge A: {access_lines} access log lines, "
                                 f"{served} requests served, {sent} sent")
        if announced.exists():
            raise AssertionError("edge A: the announcement outlived "
                                 "close()")
        return out, launches
    finally:
        await sampler.stop()
        if not closed:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
            await linker.close()


def edge_hash_check() -> dict:
    """The engines' ``tenant_hash_native`` against the port's
    ``tenant_hash`` on the 16 tenants and EDGE_HASH_IDS seeded ids."""
    from linkerd_tpu_torch import native
    from linkerd_tpu_torch.router.tenancy import tenant_hash

    rng = np.random.default_rng(EDGE_MODEL_SEED)
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz0123456789-_."))
    ids = list(EDGE_TENANTS) + ["".join(rng.choice(alphabet,
                                                   rng.integers(1, 41)))
                                for _ in range(EDGE_HASH_IDS)]
    bad = [i for i in ids
           if native.tenant_hash_native(i.encode()) != tenant_hash(i)]
    if bad:
        raise AssertionError(f"edge: tenant_hash_native differs from "
                             f"tenant_hash on {len(bad)} ids, e.g. {bad[0]!r}")
    return {"ids": len(ids), "equal": len(ids)}


async def edge_dead_host(disco: Path) -> dict:
    """Adds a ``EDGE_DEAD_HOST <port>`` line beside each replica's line
    of the disco files (the entry io.l5d.specificHost drops), after
    checking that a connect there is refused: the replicas listen on
    127.0.0.1 alone."""
    port = int((disco / "tele-00").read_text().split()[1])
    try:
        _, w = await asyncio.wait_for(
            asyncio.open_connection(EDGE_DEAD_HOST, port), 5)
    except ConnectionRefusedError:
        pass
    else:
        w.close()
        raise AssertionError(f"edge: {EDGE_DEAD_HOST}:{port} reaches a "
                             f"replica bound to 127.0.0.1")
    for f in sorted(disco.iterdir()):
        lines = f.read_text().splitlines()
        f.write_text("".join(f"{EDGE_DEAD_HOST} {ln.split()[1]}\n{ln}\n"
                             for ln in lines))
    return {"refused": True, "port": port}


def stormer_quotas(stats: dict) -> list:
    """The stormer's quota in each worker's tenant table (-1: none)."""
    from linkerd_tpu_torch.router.tenancy import tenant_hash

    th = str(tenant_hash(EDGE_STORMER))
    return [w["tenants"]["by_tenant"].get(th, {}).get("quota")
            for w in stats.get("workers", [stats])]


async def edge_engine_part(part: str, loads, flag, disco: Path, work: Path,
                           dev: str):
    """An engine router (``edge_config`` B or C) through the three
    windows: the stormer SICK, its quota pushed into the engine (B: 1 a
    worker) and its excess shed there (B: 503 + l5d-retryable; C:
    REFUSED_STREAM resets, as many as the engine's tenant_shed), cleared
    on recovery; no calm tenant SICK or shed; every engine row's tenant
    column the hash of its request's tenant; the per-tenant counters the
    engine's own; the board's keys; kernel and board against plain."""
    from collections import Counter

    from linkerd_tpu_torch.core.tasks import monitor
    from linkerd_tpu_torch.linker import load_linker
    from linkerd_tpu_torch.ops.scoring import fused_anomaly_scores
    from linkerd_tpu_torch.router.tenancy import tenant_feature, tenant_hash

    engine_cls = "FastPathEngine" if part == "B" else "H2FastPathEngine"
    kind = "http" if part == "B" else "h2"
    linker = load_linker(edge_config(part, disco, work), device=dev)
    router = linker.routers[0]
    ctl = getattr(router, "controller", None)
    if type(getattr(ctl, "engine", None)).__name__ != engine_cls:
        await linker.close()
        raise AssertionError(f"edge {part}: the router came up without the "
                             f"{engine_cls}")
    eng = ctl.engine
    await linker.start()
    port = router.server_ports[0]
    tele = linker.telemeters[0]
    _, board, adm = linker.tenant_views[0]
    names = edge_hashes()
    th = tenant_hash(EDGE_STORMER)
    tap = freeze_model(FastPathTap(tele), tele)
    task = monitor(asyncio.create_task(tele.run()),
                   what=f"telemeter-edge-{part}")
    sampler = EdgeSampler(adm, names)
    pushes = []
    push = eng.set_tenant_quota

    def pushing(h, limit):
        pushes.append((int(h), limit))
        return push(h, limit)

    eng.set_tenant_quota = pushing
    shed0 = eng.stats()["guard"]["tenant_shed"]
    out = {}

    def completed(*ws) -> int:
        """Requests answered, not shed: one engine row each."""
        return sum(int((~w["shed"] & (w["status"] != -1)).sum()) for w in ws)

    try:
        fused_anomaly_scores.launches = 0

        async def settle(*ws):
            await tap.settle(tele, task, completed(*ws), f"edge {part}")

        async def set_model():
            tap.model = edge_model(
                tele, batch_rows(tap),
                calm_logit=EDGE_CALM_LOGIT if part == "C" else None)
            if part == "C":
                if not await tele.refresh_native_weights():
                    raise AssertionError("edge C: the model was not "
                                         "published to the engine")

        def storm_end():
            return stormer_quotas(eng.stats())

        def cleared():
            return (EDGE_STORMER not in sampler.sick()
                    and [lim for h, lim in pushes if h == th][-1:] == [None])

        windows, quotas, t_storm, t_rec = await edge_windows(
            loads, kind, port, flag, settle, set_model, cleared, storm_end)
        await tap.settle(tele, task, completed(*windows.values()),
                         f"edge {part} recovery")
        launches = fused_anomaly_scores.launches
        await sampler.stop()
        ctl._export_stats()
        stats = eng.stats()
        out.update(edge_engine_checks(part, tele, tap, launches, dev))
        out["windows"] = edge_answer_checks(part, windows)
        out["sick"] = edge_sick_checks(part, sampler, t_storm, t_rec, adm,
                                       windows["recovery"]["ended"])
        want = [1] * EDGE_WORKERS if part == "B" else [EDGE_SUBLIMIT]
        out["stormer_quota_at_storm_end"] = quotas
        if quotas != want:
            raise AssertionError(f"edge {part}: {EDGE_STORMER}'s quota in "
                                 f"the engine at the end of the storm "
                                 f"{quotas}, want {want}")
        left = stormer_quotas(stats)
        if any(q != -1 for q in left):
            raise AssertionError(f"edge {part}: {EDGE_STORMER}'s quota "
                                 f"after the recovery {left}")
        out["quota_pushes"] = [(names.get(f"#{h:08x}", h), lim)
                               for h, lim in pushes]
        # the tenant column of every request row against what was sent
        by_name = Counter()
        for w in windows.values():
            done = ~w["shed"] & (w["status"] != -1)
            by_name.update(EDGE_TENANTS[i] for i in w["tenant"][done])
        raw = np.concatenate(tap.raw)
        req_rows = raw[raw[:, 9] < 0.5]
        got = Counter(req_rows[:, 8].tolist())
        want_rows = Counter({tenant_feature(tenant_hash(t)): n
                             for t, n in by_name.items()})
        if got != want_rows:
            raise AssertionError(f"edge {part}: engine rows by tenant "
                                 f"column {dict(got)} differ from the "
                                 f"requests answered by tenant")
        # the per-tenant counters against the engine's own snapshot
        flat = linker.metrics.flatten()
        by = stats["tenants"]["by_tenant"]
        off = {f"{h}/{k}": (flat.get(f"rt/{EDGE_LABEL}/fastpath/tenant/"
                                     f"{h}/{k}", 0), t[k])
               for h, t in by.items()
               for k in ("requests", "shed", "errors", "scored")
               if flat.get(f"rt/{EDGE_LABEL}/fastpath/tenant/{h}/{k}", 0)
               != t[k]}
        if off:
            raise AssertionError(f"edge {part}: rt/{EDGE_LABEL}/fastpath/"
                                 f"tenant counters differ from the engine: "
                                 f"{off}")
        shed = stats["guard"]["tenant_shed"] - shed0
        sent_shed = sum(int(w["shed"].sum()) for w in windows.values())
        calm_shed = {names[f"#{int(h):08x}"]: t["shed"]
                     for h, t in by.items() if int(h) != th and t["shed"]}
        if shed != sent_shed or by[str(th)]["shed"] != sent_shed \
                or calm_shed:
            raise AssertionError(
                f"edge {part}: the engine shed {shed} ({EDGE_STORMER}: "
                f"{by[str(th)]['shed']}; others {calm_shed}), the load saw "
                f"{sent_shed} sheds")
        snap_board = board.snapshot()
        missing = [t for h, t in names.items() if h not in snap_board]
        if missing:
            raise AssertionError(f"edge {part}: no board key for {missing}")
        if part == "C":
            ewma = {}
            for h, t in by.items():
                if t["scored"]:
                    v = snap_board[f"#{int(h):08x}"]["score_ewma"]
                    if v is None or not 0.0 <= v <= 1.0:
                        raise AssertionError(f"edge C: board score EWMA "
                                             f"{v} for a scored tenant")
                    ewma[names[f"#{int(h):08x}"]] = v
            if set(ewma) != set(EDGE_TENANTS):
                raise AssertionError(f"edge C: score EWMAs for "
                                     f"{sorted(ewma)}")
            out["score_ewma"] = ewma
            out["engine_scored"] = stats["native_scorer"]["scored"]
        out.update(engine_shed=shed, flat_transitions=flat.get(
            f"rt/{EDGE_LABEL}/server/tenants/tenant_transitions"))
        print(f"edge {part}: {EDGE_STORMER} SICK at "
              f"+{out['sick']['stormer_sick_after_s']:.2f} s into the "
              f"storm, cleared +{out['sick']['stormer_cleared_after_s']:.2f}"
              f" s into the recovery; quota at the storm's end {quotas}; "
              f"{shed} sheds in the engine; "
              f"rt/{EDGE_LABEL}/server/tenants/tenant_transitions "
              f"{out['flat_transitions']}")
        return out, launches
    finally:
        await sampler.stop()
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        await linker.close()


async def edge_phase(seed: int = 12, dev: str = "cuda",
                     parts=("A", "B", "C")):
    """Parts A and B on the linker phases' HTTP topology, with a dead
    entry beside each replica in the disco files, then part C on the h2
    topology. Returns the results and the kernel's launches."""
    res, launches = {"tenant_hash_native": edge_hash_check()}, 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        if {"A", "B"} & set(parts):
            async with linker_topology(seed, sizes=(0,), load=edge_load) \
                    as (loads, flag, _, disco):
                res["dead_host"] = await edge_dead_host(disco)
                if "A" in parts:
                    (work / "A").mkdir()
                    t = time.perf_counter()
                    res["part_a"], n = await edge_part_a(
                        loads, flag, disco, work / "A", dev)
                    res["part_a"]["part_s"] = time.perf_counter() - t
                    launches += n
                if "B" in parts:
                    t = time.perf_counter()
                    res["part_b"], n = await edge_engine_part(
                        "B", loads, flag, disco, work, dev)
                    res["part_b"]["part_s"] = time.perf_counter() - t
                    launches += n
        if "C" in parts:
            async with linker_topology(seed, sizes=(0,),
                                       backend=h2_backends,
                                       load=edge_load) \
                    as (loads, flag, _, disco):
                t = time.perf_counter()
                res["part_c"], n = await edge_engine_part(
                    "C", loads, flag, disco, work, dev)
                res["part_c"]["part_s"] = time.perf_counter() - t
                launches += n
    res["phase_s"] = time.perf_counter() - t0
    for part in ("a", "b", "c"):
        r = res.get(f"part_{part}")
        if r is None:
            continue
        print(f"edge {part.upper()} ({r['part_s']:.1f} s): " + "; ".join(
            f"{name} {w['requests_per_s']:.0f} requests/s over "
            f"{w['wall_s']:.2f} s, calm p50/p99 {w['calm_p50_ms']:.2f}/"
            f"{w['calm_p99_ms']:.2f} ms ({w['stormer_shed']} of "
            f"{w['stormer']} {EDGE_STORMER} shed)"
            for name, w in r["windows"].items()))
        if "router_ms" in r:
            print(f"edge {part.upper()}: the router's own ms (p50/p99): "
                  + ", ".join(f"{k} {v['p50']:.3f}/{v['p99']:.3f}"
                              for k, v in r["router_ms"].items()))
    print(f"edge: {launches} launches, {res['phase_s']:.1f} s")
    return res, launches


# The sidecar phase: the scorer sidecar on the port's own gRPC runtime
# (grpc/dispatch.py over protocol/h2), its replicas in processes of their
# own started as users start one (``python -m
# linkerd_tpu_torch.telemetry.sidecar``), announced into the linker
# topology's fs directory: one pair for A, B, D and E, one for C. A: the
# hop alone, held
# against the plain version and timed. B: the HTTP router with
# ``sidecarTier: primary`` on the announced pair, training over Fit. C:
# the reference's chaos drill (tools/validator.py) with real replicas:
# one killed, then the other, then one started again. D: the tiered
# scorer, its in-process primary made to fail for a window. E: a
# promotion pushed to every replica.
SIDECAR_ROWS = (1, 37, 1024, 4096)
SIDECAR_TIMED = (1, 37, 1024)
SIDECAR_CALLS = 200          # timed Score calls at each of SIDECAR_TIMED
SIDECAR_ROUNDS = 50          # rounds of IN_FLIGHT 1024-row calls
SIDECAR_SEED = 17            # part A's snapshot and rows
SIDECAR_SIZES = (4096, 8192)  # part B's warm-up and faulted window
SIDECAR_SEGMENT = 1024       # requests a traffic segment in C and D
SIDECAR_BOOT_S = 120.0       # a replica's start, to its SCORER_SIDECAR line
SIDECAR_TIMEOUT_MS = 500     # C's scoreTimeoutMs
SIDECAR_BACKOFF_MS = (200, 400)  # C's breaker probe backoffs
SIDECAR_SLACK_MS = 250       # a batch's linger and one call, past a probe
SIDECAR_BUDGET_MS = 1000     # C's totalTimeoutMs: every answer within it
SIDECAR_OBSERVE_S = 1.0      # C: traffic after each step
SIDECAR_WAIT_S = 20.0        # longest wait for a state to come
SIDECAR_SAMPLE_S = 0.01      # C and D sample the breakers this often
SIDECAR_NAMES = {"ABDE": "l5d-scorer", "C": "l5d-scorer-c"}


class Replica:
    """A scorer replica in a process of its own, started through the
    entry point and announced into ``announce_dir`` under ``name``; its
    errors go to a file under ``logs``."""

    def __init__(self, announce_dir: Path, name: str, logs: Path,
                 dev: str, port: int = 0):
        logs.mkdir(exist_ok=True)
        self.log_path = logs / f"{name}-{port}-{time.monotonic_ns()}.log"
        self.log = open(self.log_path, "w")
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        args = [sys.executable, "-m", "linkerd_tpu_torch.telemetry.sidecar",
                "--announce-dir", str(announce_dir), "--announce-name", name,
                "--warmup-rows", "1024", "--port", str(port)]
        if dev == "cpu":
            args += ["--device", "cpu"]
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(args, cwd=ROOT, env=env,
                                     stdout=subprocess.PIPE, stderr=self.log,
                                     text=True)
        self.addr = self.port = self.boot_ms = None
        self.done: dict = {}

    def tail(self) -> str:
        self.log.flush()
        return self.log_path.read_text()[-1500:]

    async def ready(self) -> "Replica":
        try:
            line = await asyncio.wait_for(
                asyncio.to_thread(self.proc.stdout.readline), SIDECAR_BOOT_S)
        except asyncio.TimeoutError:
            line = ""
        if not line.startswith("SCORER_SIDECAR "):
            raise AssertionError(f"sidecar: a replica did not start "
                                 f"({line!r}): {self.tail()}")
        self.addr = line.split()[1]
        self.port = int(self.addr.rsplit(":", 1)[1])
        self.boot_ms = (time.perf_counter() - self.t0) * 1e3
        return self

    async def kill(self) -> None:
        """SIGKILL; reaped off the loop (a CUDA process's end takes a
        while, and the router shares this loop)."""
        self.proc.kill()
        await asyncio.to_thread(self.proc.wait)
        self.log.close()

    def stop(self) -> dict:
        """SIGTERM; its rows and kernel launches, from its last line."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                out, _ = self.proc.communicate(timeout=CLI_STOP_S)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                out, _ = self.proc.communicate()
            for line in out.splitlines():
                if line.startswith("SCORER_SIDECAR_DONE "):
                    self.done = json.loads(line.split(" ", 1)[1])
        self.log.close()
        return self.done


async def start_replicas(disco: Path, logs: Path, dev: str, counts: dict):
    """``counts[part]`` replicas a part, all started at once; part ->
    its replicas, once each serves."""
    reps = {part: [Replica(disco, SIDECAR_NAMES[part], logs, dev)
                   for _ in range(n)] for part, n in counts.items()}
    await asyncio.gather(*(r.ready() for rs in reps.values() for r in rs))
    return reps


def sidecar_config(disco: Path, part: str, tier: str, **tele) -> str:
    """The linker phase's router and namer, its telemeter on the pool of
    ``part``'s announced replicas."""
    cfg = json.loads(linker_config(disco, True, "none", 8))
    cfg["telemetry"][0].update(
        sidecarAddress=f"/#/io.l5d.fs/{SIDECAR_NAMES[part]}",
        sidecarTier=tier, **tele)
    cfg["routers"][0]["service"] = {"totalTimeoutMs": SIDECAR_BUDGET_MS}
    return json.dumps(cfg)


async def sidecar_hop(reps, dev: str, service_rows_per_s):
    """A: a seeded snapshot restored into each replica; batches of
    SIDECAR_ROWS rows through the port's client, each reply against the
    plain version of the snapshot here; then the hop's Score times and
    rows/s at 1024 rows x IN_FLIGHT on the first replica."""
    from linkerd_tpu_torch.models.anomaly import AnomalyModelConfig
    from linkerd_tpu_torch.telemetry.sidecar import GrpcScorerClient

    rng = np.random.default_rng(SIDECAR_SEED)
    snap = make_snapshot(AnomalyModelConfig(recon_weight=0.7), SIDECAR_SEED)
    agree = Agreement("sidecar A: replies through the hop vs plain")
    clients = [GrpcScorerClient(r.addr) for r in reps]
    lat, out = {}, {}
    try:
        for c in clients:
            step = await c.restore(snap)
            if step != snap.step:
                raise AssertionError(f"sidecar A: {c.address} restored "
                                     f"step {step}, not {snap.step}")
            for n in SIDECAR_ROWS:
                x = make_inputs(rng, n, snap.mu, snap.var)
                agree.add(await c.score(x), plain_scores(snap, x, dev),
                          f"{n} rows from {c.address}")
        agree.close()
        c = clients[0]
        for n in SIDECAR_TIMED:
            x = make_inputs(rng, n, snap.mu, snap.var)
            await c.score(x)
            ms = []
            for _ in range(SIDECAR_CALLS):
                t0 = time.perf_counter()
                await c.score(x)
                ms.append((time.perf_counter() - t0) * 1e3)
            lat[n] = {"p50_ms": float(np.percentile(ms, 50)),
                      "p99_ms": float(np.percentile(ms, 99)),
                      "bytes": c.last_timing["bytes"]}
        xs = [make_inputs(rng, 1024, snap.mu, snap.var)
              for _ in range(IN_FLIGHT)]
        await asyncio.gather(*(c.score(x) for x in xs))
        t0 = time.perf_counter()
        for _ in range(SIDECAR_ROUNDS):
            await asyncio.gather(*(c.score(x) for x in xs))
        wall = time.perf_counter() - t0
    finally:
        for c in clients:
            await c.aclose()
    out = {"replies_vs_plain_max": agree.worst,
           "rows_past_row_tol": agree.off, "rows": agree.rows,
           "score_ms": lat,
           "rows_per_s": SIDECAR_ROUNDS * IN_FLIGHT * 1024 / wall,
           "service_rows_per_s": service_rows_per_s}
    print("sidecar A: Score through the hop, p50/p99 " + ", ".join(
        f"{n} rows {v['p50_ms']:.3f}/{v['p99_ms']:.3f} ms"
        for n, v in lat.items()) + f"; {out['rows_per_s']:.0f} rows/s at "
        f"1024 rows x{IN_FLIGHT} in flight (the service phase's handlers "
        f"alone: " + ("not measured in this run" if service_rows_per_s
                      is None else f"{service_rows_per_s:.0f} rows/s") + ")")
    return out


class FitTap:
    """Records the losses of the fits a scorer answers."""

    def __init__(self, scorer):
        self.losses, fit = [], scorer.fit

        async def fitting(x, labels, mask):
            loss = await fit(x, labels, mask)
            self.losses.append(float(loss))
            return loss

        scorer.fit = fitting


async def sidecar_router(part: str, text: str, dev: str):
    """A linker from ``text`` with its telemeter running, the tap and
    the fit tap on it, once its pool has found its two replicas."""
    from linkerd_tpu_torch.core.tasks import monitor
    from linkerd_tpu_torch.linker import load_linker

    linker = load_linker(text, device=dev)
    await linker.start()
    tele = linker.telemeters[0]
    task = monitor(asyncio.create_task(tele.run()), what="sidecar-telemeter")
    try:
        t0 = time.monotonic()
        while (tele._scorer_pool is None
               or len(tele._scorer_pool.addresses()) < 2):
            if task.done():
                task.result()
            if time.monotonic() - t0 > SIDECAR_WAIT_S:
                raise AssertionError(f"sidecar {part}: the pool found no "
                                     f"two replicas")
            await asyncio.sleep(0.02)
        tap = LinkerTap(tele)
        fits = FitTap(tele._scorer)
    except BaseException:
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        await linker.close()
        raise
    return linker, tele, task, tap, fits


async def sidecar_close(linker, task) -> None:
    task.cancel()
    await asyncio.gather(task, return_exceptions=True)
    await linker.close()


def tele_flat(tele) -> dict:
    """The telemeter's counters and gauges that the checks read."""
    flat = tele.metrics.flatten()
    return {k: flat[f"anomaly/{k}"] for k in (
        "requests_total", "scored_total", "batches", "score_failures",
        "dropped_batches", "degraded", "fleet_model_pushes")}


async def sidecar_part_b(loads, flag, plans, disco, dev: str):
    """B: the HTTP router with ``sidecarTier: primary`` on the announced
    pair: every request scored, both replicas called, finite fit losses,
    and the faulted destinations' rows scored above the calm ones
    (``fault_auc``) in the window."""
    from linkerd_tpu_torch.lifecycle.promote import auc

    linker, tele, task, tap, fits = await sidecar_router(
        "B", sidecar_config(disco, "ABDE", "primary"), dev)
    port = linker.routers[0].server_ports[0]
    try:
        flag.value = 0
        warm = await linker_traffic(loads, port, plans[0])
        await tap.settle(tele, task, "sidecar B warm-up")
        first = len(tap.batches)
        flag.value = 1
        window = await linker_traffic(loads, port, plans[1])
        await tap.settle(tele, task, "sidecar B window")
        flag.value = 0
        st = tele.model_state()
    finally:
        await sidecar_close(linker, task)
    out = {"warmup": linker_traffic_checks(warm, "sidecar B warm-up", False),
           "window": linker_traffic_checks(window, "sidecar B window", True)}
    got, sent = tele_flat(tele), len(warm["ms"]) + len(window["ms"])
    if not (got["scored_total"] == got["requests_total"] == sent) or \
            got["score_failures"] or got["dropped_batches"]:
        raise AssertionError(f"sidecar B: {sent} sent, {got}")
    calls = {a: r["calls"] for a, r in st["scorer_pool"]["replicas"].items()}
    if len(calls) != 2 or not all(calls.values()):
        raise AssertionError(f"sidecar B: replica calls {calls}")
    if not fits.losses or not np.isfinite(fits.losses).all():
        raise AssertionError(f"sidecar B: fit losses {fits.losses}")
    by_x = {id(x): s for x, s in tap.scored}
    faulted = set(tele_routes()[:TELE_FAULTED])
    labels, scores = [], []
    for b in tap.batches[first:]:
        labels += [float(fv.dst_path in faulted) for fv in b["fvs"]]
        scores.append(by_x[id(b["x"])])
    fault_auc = auc(labels, np.concatenate(scores).tolist())
    out.update(requests=sent, batches=got["batches"], replica_calls=calls,
               fits=len(fits.losses), fit_loss_last=fits.losses[-1],
               fault_auc=fault_auc, window_rows=len(labels),
               batch_sizes=batch_sizes(tap))
    print(f"sidecar B: {sent} requests, {got['batches']} batches, every row "
          f"scored through the hop; replica calls {calls}; "
          f"{len(fits.losses)} fits, last loss {fits.losses[-1]:.4f}; "
          f"fault_auc {fault_auc:.4f} over {len(labels)} window rows")
    if not fault_auc >= LINKER_AUC_MIN:
        raise AssertionError(f"sidecar B: fault_auc {fault_auc} < "
                             f"{LINKER_AUC_MIN}")
    return out


class Traffic:
    """Segments of SIDECAR_SEGMENT calm requests, one after another,
    until ``stop``; keeps every answer."""

    def __init__(self, loads, port: int, rng):
        self.loads, self.port, self.rng = loads, port, rng
        self.results, self._stop = [], asyncio.Event()
        self.task = asyncio.ensure_future(self._run())

    async def _run(self) -> None:
        while not self._stop.is_set():
            self.results.append(await linker_traffic(
                self.loads, self.port, linker_plans(self.rng,
                                                    SIDECAR_SEGMENT)))

    async def stop(self) -> dict:
        self._stop.set()
        await self.task
        return merge_segments(self.results)


class BreakerSampler:
    """Samples, every SIDECAR_SAMPLE_S, the monotonic instant, the
    board's degraded flag, the sidecar breaker's state and, when tiered,
    the primary's breaker state."""

    def __init__(self, tele):
        self.tele, self.rows = tele, []
        self.task = asyncio.ensure_future(self._run())

    async def _run(self) -> None:
        s = self.tele._scorer
        while True:
            tiers = getattr(s, "tier_state", None)
            self.rows.append((time.monotonic(), self.tele.board.degraded,
                              s.breaker.state,
                              tiers()["primary_breaker"] if tiers else None))
            await asyncio.sleep(SIDECAR_SAMPLE_S)

    async def until(self, pred, what: str, since: float) -> float:
        """ms from ``since`` to the first sample from then on that
        ``pred`` holds."""
        n = 0
        while time.monotonic() - since < SIDECAR_WAIT_S:
            for row in self.rows[n:]:
                if row[0] >= since and pred(row):
                    return (row[0] - since) * 1e3
            n = len(self.rows)
            await asyncio.sleep(SIDECAR_SAMPLE_S)
        raise AssertionError(f"sidecar: no {what} in {SIDECAR_WAIT_S} s")

    def between(self, t0: float, t1: float) -> list:
        return [r for r in self.rows if t0 <= r[0] <= t1]

    async def close(self) -> None:
        self.task.cancel()
        await asyncio.gather(self.task, return_exceptions=True)


async def sidecar_part_c(loads, disco, logs, reps, dev: str):
    """C: calm traffic through a ``sidecarTier: primary`` router on two
    replicas; one SIGKILLed (once it is reaped and a call's deadline and
    a probe have passed, the pool has moved to the survivor: no degraded
    sample), then the other (degraded and the breaker open within
    scoreTimeoutMs and a probe; the board neutral), then one started
    again on its port (degraded back to 0 within a probe interval of it
    serving). Every request answered 200 within the budget. Returns the
    results and the replica started again."""
    rng = np.random.default_rng(SIDECAR_SEED + 2)
    linker, tele, task, tap, fits = await sidecar_router("C", sidecar_config(
        disco, "C", "primary", trainEveryBatches=0,
        scoreTimeoutMs=SIDECAR_TIMEOUT_MS, breakerFailures=1,
        breakerMinBackoffMs=SIDECAR_BACKOFF_MS[0],
        breakerMaxBackoffMs=SIDECAR_BACKOFF_MS[1], scoreTtlSecs=2), dev)
    port = linker.routers[0].server_ports[0]
    sampler = BreakerSampler(tele)
    traffic = Traffic(loads, port, rng)
    again, out = None, {}
    try:
        await asyncio.sleep(SIDECAR_OBSERVE_S)
        pool = tele._scorer_pool
        before = {a: r["calls"] for a, r in pool.status()["replicas"].items()}
        t_kill1 = time.monotonic()
        await reps[0].kill()
        t_gone = time.monotonic()
        # until a call's deadline and a probe have passed after the
        # killed process is reaped, a call may still hang on its dying
        # sockets (the pool fails over on an error, not on a hang)
        settle = (SIDECAR_TIMEOUT_MS + SIDECAR_BACKOFF_MS[1]
                  + SIDECAR_SLACK_MS) / 1e3
        await asyncio.sleep(settle + SIDECAR_OBSERVE_S)
        dying = sampler.between(t_kill1, t_gone + settle)
        gone = sampler.between(t_gone + settle, time.monotonic())
        after = {a: r["calls"] for a, r in pool.status()["replicas"].items()}
        out.update(killed_reaped_ms=(t_gone - t_kill1) * 1e3,
                   dying_degraded_share=sum(r[1] for r in dying)
                   / max(len(dying), 1))
        if any(r[1] for r in gone):
            raise AssertionError(
                "sidecar C: degraded with one of two replicas gone: the "
                "pool did not move to the survivor")
        if not after[reps[1].addr] > before[reps[1].addr]:
            raise AssertionError(f"sidecar C: the survivor took no call "
                                 f"({before} -> {after})")
        t_kill2 = time.monotonic()
        await reps[1].kill()
        out["degraded_ms"] = await sampler.until(
            lambda r: r[1], "degraded flag", t_kill2)
        out["breaker_open_ms"] = await sampler.until(
            lambda r: r[2] == "open", "open breaker", t_kill2)
        bound = SIDECAR_TIMEOUT_MS + SIDECAR_BACKOFF_MS[1]
        for what in ("degraded_ms", "breaker_open_ms"):
            if out[what] > bound:
                raise AssertionError(f"sidecar C: {what} {out[what]:.0f} > "
                                     f"{bound} ms")
        await asyncio.sleep(SIDECAR_OBSERVE_S)
        board = tele.board
        neutral = (board.degraded and board.anomaly_level() == 0.0
                   and not any(board.effective_endpoint_scores().values()))
        if not neutral:
            raise AssertionError("sidecar C: the board does not read "
                                 "neutral with both replicas dead")
        again = Replica(disco, SIDECAR_NAMES["C"], logs, dev,
                        port=reps[1].port)
        await again.ready()
        t_ready = time.monotonic()
        out["recovered_ms"] = await sampler.until(
            lambda r: not r[1], "recovery", t_ready)
        out["restart_boot_ms"] = again.boot_ms
        bound = SIDECAR_BACKOFF_MS[1] + SIDECAR_SLACK_MS
        if out["recovered_ms"] > bound:
            raise AssertionError(f"sidecar C: degraded {out['recovered_ms']:.0f}"
                                 f" ms after a replica served again > "
                                 f"{bound} ms")
        await asyncio.sleep(SIDECAR_OBSERVE_S)
        res = await traffic.stop()
    except BaseException:
        traffic.task.cancel()
        raise
    finally:
        await sampler.close()
        st = tele.model_state()
        await sidecar_close(linker, task)
    out["traffic"] = linker_traffic_checks(res, "sidecar C", False)
    slow = int((res["ms"] > SIDECAR_BUDGET_MS).sum())
    if slow:
        raise AssertionError(f"sidecar C: {slow} requests over the "
                             f"{SIDECAR_BUDGET_MS} ms budget")
    out.update(max_ms=float(res["ms"].max()),
               replicas=st["scorer_pool"]["replicas"],
               score_failures=tele_flat(tele)["score_failures"])
    print(f"sidecar C: {out['traffic']['requests']} requests, all 200 within "
          f"{SIDECAR_BUDGET_MS} ms (max {out['max_ms']:.1f}); one replica "
          f"killed: reaped after {out['killed_reaped_ms']:.0f} ms, degraded "
          f"in {out['dying_degraded_share']:.2f} of the samples until a "
          f"deadline and a probe after that, none since; both: degraded "
          f"after "
          f"{out['degraded_ms']:.1f} ms, breaker open after "
          f"{out['breaker_open_ms']:.1f} ms, board neutral; one started "
          f"again ({out['restart_boot_ms']:.0f} ms to serve): degraded 0 "
          f"{out['recovered_ms']:.1f} ms after it served")
    return out, again


async def sidecar_part_de(loads, disco, work, reps, dev: str):
    """D: a tiered router (``sidecarTier: fallback``) on two replicas,
    with a lifecycle: calm, the in-process primary serves every batch and
    fit; then, its score and fit made to raise, the primary's breaker
    opens, the sidecar tier scores every row, and no fit reaches a
    replica; then a probe closes the breaker. E: a promotion restores
    the checkpoint on both replicas, which then score a probe batch as
    the in-process scorer does. Returns the results and the in-process
    kernel launches."""
    from linkerd_tpu_torch.ops.scoring import fused_anomaly_scores
    from linkerd_tpu_torch.telemetry.sidecar import GrpcScorerClient

    rng = np.random.default_rng(SIDECAR_SEED + 3)
    # the replicas' model config (the entry point's scorer) is the
    # reference's default, reconWeight 0.7: a checkpoint of another
    # config is refused by their Restore
    linker, tele, task, tap, fits = await sidecar_router("D", sidecar_config(
        disco, "ABDE", "fallback", reconWeight=0.7, lifecycle={
            "directory": str(work / "ckpt"), "checkpointEveryS": 0}), dev)
    port = linker.routers[0].server_ports[0]
    tiered = tele._scorer
    clients = [GrpcScorerClient(r.addr) for r in reps]
    sampler = BreakerSampler(tele)
    out = {}

    async def segment(what: str) -> dict:
        res = await linker_traffic(loads, port, linker_plans(
            rng, 2 * SIDECAR_SEGMENT))
        await tap.settle(tele, task, f"sidecar D {what}")
        return linker_traffic_checks(res, f"sidecar D {what}", False)

    async def steps() -> list:
        return [(await c.snapshot()).step for c in clients]

    try:
        fused_anomaly_scores.launches = 0
        out["calm"] = await segment("calm")
        ts, got = tiered.tier_state(), tele_flat(tele)
        launches = fused_anomaly_scores.launches
        if ts["fallback_calls"] or ts["primary_calls"] != \
                got["batches"] + len(fits.losses):
            raise AssertionError(f"sidecar D calm: {ts}, {got['batches']} "
                                 f"batches and {len(fits.losses)} fits")
        if launches != (0 if dev == "cpu" else got["batches"]):
            raise AssertionError(f"sidecar D calm: {launches} launches for "
                                 f"{got['batches']} batches")
        replica_steps = await steps()

        async def sick(*_):
            raise RuntimeError("the primary made to fail for a window")

        t_sick = time.monotonic()
        tiered.primary.score, tiered.primary.fit = sick, sick
        out["window"] = await segment("window")
        t_heal = time.monotonic()
        del tiered.primary.score, tiered.primary.fit
        ts2, got2 = tiered.tier_state(), tele_flat(tele)
        sick_rows = sampler.between(t_sick, t_heal)
        fallback_batches = ts2["fallback_calls"] - ts["fallback_calls"]
        if not any(r[3] == "open" for r in sick_rows):
            raise AssertionError("sidecar D: the primary's breaker never "
                                 "opened in the window")
        if not (got2["scored_total"] == got2["requests_total"]) or \
                got2["dropped_batches"] or got2["degraded"]:
            raise AssertionError(f"sidecar D window: {got2}")
        if fallback_batches != got2["batches"] - got["batches"]:
            raise AssertionError(
                f"sidecar D window: {fallback_batches} batches on the "
                f"sidecar tier of {got2['batches'] - got['batches']}")
        if await steps() != replica_steps:
            raise AssertionError("sidecar D: a fit reached a replica while "
                                 "the primary was down")
        traffic = Traffic(loads, port, rng)  # the probes ride on it
        try:
            out["closed_ms"] = await sampler.until(
                lambda r: r[3] == "closed", "closed primary breaker", t_heal)
            await asyncio.sleep(SIDECAR_OBSERVE_S)
        finally:
            res = await traffic.stop()
        await tap.settle(tele, task, "sidecar D after")
        out["after"] = linker_traffic_checks(res, "sidecar D after", False)
        ts3 = tiered.tier_state()
        if not ts3["primary_calls"] > ts2["primary_calls"]:
            raise AssertionError(f"sidecar D: the primary serves no more "
                                 f"after the probe: {ts3}")
        out.update(tiers_calm=ts, tiers_window=ts2, tiers_after=ts3,
                   fallback_batches=fallback_batches,
                   skipped_fits=got2["score_failures"]
                   - got["score_failures"], calm_launches=launches)
        # E: the fleet model push
        outcome = await tele.lifecycle_cycle()
        if outcome is None or outcome["action"] != "promoted":
            raise AssertionError(f"sidecar E: no promotion: {outcome}")
        t0 = time.monotonic()
        while tele._fleet_model_pushes.value < len(reps):
            if time.monotonic() - t0 > SIDECAR_WAIT_S:
                raise AssertionError(
                    f"sidecar E: {tele._fleet_model_pushes.value} of "
                    f"{len(reps)} replicas restored the promotion")
            await asyncio.sleep(0.01)
        out["push_ms"] = (time.monotonic() - t0) * 1e3
        _, promoted = tele.lifecycle.store.load(tele.lifecycle.serving_version)
        if await steps() != [promoted.step] * len(reps):
            raise AssertionError(f"sidecar E: replica steps "
                                 f"{await steps()}, promoted {promoted.step}")
        # the comparison's launch below is not the path's
        launches = fused_anomaly_scores.launches
        x = make_inputs(rng, 1024, promoted.mu, promoted.var)
        here = await tiered.primary.score(x)
        agree = Agreement("sidecar E: replicas vs the router's scorer")
        for c in clients:
            agree.add(await c.score(x), here, f"1024 rows from {c.address}")
        agree.close()
        out.update(fleet_model_pushes=tele._fleet_model_pushes.value,
                   promoted_step=promoted.step,
                   replicas_vs_router_max=agree.worst)
    finally:
        await sampler.close()
        for c in clients:
            await c.aclose()
        await sidecar_close(linker, task)
    print(f"sidecar D: calm {out['tiers_calm']}, {out['calm_launches']} "
          f"launches; primary down: {out['fallback_batches']} batches on the "
          f"sidecar tier, {out['skipped_fits']} fits skipped, replica steps "
          f"unchanged; breaker closed {out['closed_ms']:.0f} ms after it "
          f"healed. E: {out['fleet_model_pushes']} replicas restored step "
          f"{out['promoted_step']} in {out['push_ms']:.0f} ms, their scores "
          f"vs the router's max|diff| {out['replicas_vs_router_max']:.3e}")
    return out, launches


async def sidecar_phase(seed: int = 12, dev: str = "cuda",
                        service_rows_per_s=None):
    """Parts A-E on the linker topology (seed 12, SIDECAR_SIZES), four
    replicas started at once (a pair for A, B, D and E, a pair for C)
    and a fifth in C. Returns the results and the kernel's launches: the
    replicas' own (from their last line, where they were stopped, not
    killed) and this process's in D and E."""
    res, t0 = {}, time.perf_counter()
    reps = {}
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        logs = work / "logs"
        async with linker_topology(seed, sizes=SIDECAR_SIZES) as (
                loads, flag, plans, disco):
            try:
                reps = await start_replicas(disco, logs, dev,
                                            {"ABDE": 2, "C": 2})
                res["boot_ms"] = [r.boot_ms for rs in reps.values()
                                  for r in rs]
                res["part_a"] = await sidecar_hop(reps["ABDE"], dev,
                                                  service_rows_per_s)
                res["part_b"] = await sidecar_part_b(loads, flag, plans,
                                                     disco, dev)
                res["part_c"], again = await sidecar_part_c(
                    loads, disco, logs, reps["C"], dev)
                reps["C"].append(again)
                res["part_de"], here = await sidecar_part_de(
                    loads, disco, work, reps["ABDE"], dev)
                res["replicas_abde"] = [r.stop() for r in reps["ABDE"]]
                res["replica_c"] = again.stop()
            finally:
                for rs in reps.values():
                    for r in rs:
                        r.stop()
    replica = sum(d.get("kernel_launches", 0) for d in
                  res["replicas_abde"] + [res["replica_c"]])
    if dev != "cpu" and not (here and all(
            d.get("kernel_launches") for d in res["replicas_abde"])):
        raise AssertionError(f"sidecar: kernel launches here {here}, in the "
                             f"replicas {res['replicas_abde']}")
    res.update(launches_here=here, launches_replicas=replica,
               phase_s=time.perf_counter() - t0)
    print(f"sidecar: replicas served in {min(res['boot_ms']):.0f}-"
          f"{max(res['boot_ms']):.0f} ms; kernel launches here {here}, in the "
          f"stopped replicas {replica} ({res['replicas_abde']} A, B, D and "
          f"E, {res['replica_c']} C's restarted one; the two killed in C "
          f"report none); {res['phase_s']:.1f} s")
    return res, here + replica


# The discovery phase: the linkerd CLI (``linkerd_tpu_torch.__main__
# .main()`` in a spawned process, as ``python -m linkerd_tpu_torch``
# runs it, with ``CliTap`` installed) on the card, its io.l5d.jaxAnomaly
# telemeter at the reference's defaults, one http router naming its
# destinations by path: /c/<svc> through io.l5d.consul, /m/<app> through
# io.l5d.marathon, /s/<set> through io.l5d.serversets, /l/jobs through
# io.l5d.zkLeader and /k/api through io.l5d.curator. This process serves a
# scripted consul agent and a scripted Marathon
# (``linkerd_tpu_torch/testing/discovery.py``) and the port's
# FakeZkServer; the backends and the load clients are spawned processes;
# two downstream linkerds (``python -m linkerd_tpu_torch``) announce their
# servers into the serversets through the io.l5d.serversets announcer.
# Part A: consul and Marathon (a replica replaced in each, timed; one
# replica faulted). Part B: ZooKeeper (a downstream linkerd SIGKILLed, the
# leader changed, the curator instances). Part C: /config-check.json on
# the live CLI and on a second CLI started on a config with planted
# faults, and the traffic's p99 while checks run.
DISCO_CONSUL = 12          # consul services
DISCO_APPS = 4             # Marathon apps
DISCO_SETS = 4             # serversets, each announced by both downstreams
DISCO_REPLICAS = 3         # replicas a service, tasks an app, leader
                           # candidates, curator instances
DISCO_CALM = 2048          # part A's calm requests
DISCO_FAULTED = 3072       # ... with one consul replica faulted
DISCO_CHECK = 512          # part C: requests beside checks, and without
DISCO_CONNS = 16
DISCO_LOAD_PROCS = 2
DISCO_TTL_MS = 500         # the Marathon namer's ttlMs
DISCO_WAIT_S = 20.0        # longest wait for a change to show
DISCO_PROBE_S = 0.005      # a prober's pace
DISCO_KILL_WINDOW_S = 7.0  # part B: serverset traffic after the member went
DISCO_SETTLE_S = 0.5       # ... from the router's re-read to a clean window
DISCO_FAULTED_NAME = "c01/0"   # the replica faulted in part A
DISCO_ACCRUAL = 20         # the consecutive failures that remove it (the
                           # faulted rows that the board reads)
DISCO_LABEL = "disco"
DISCO_DTAB = ("/svc/c => /#/io.l5d.consul/dc1 ; "
              "/svc/m => /#/io.l5d.marathon ; "
              "/svc/s => /#/io.l5d.serversets/discovery ; "
              "/svc/l => /#/io.l5d.zkLeader/election ; "
              "/svc/k => /#/io.l5d.curator ;")
# a second CLI's config: a dtab-shadowed dentry (line 7), a port conflict
# that the sharded engine's SO_REUSEPORT listeners bind all the same
# (line 13) and a timeout-inversion (line 21); the CPU test holds these
# lines
DISCO_PLANTED = """\
routers:
- protocol: http
  label: planted
  fastPath: true
  workers: 2
  dtab: |
    /svc/web => /$/inet/127.0.0.1/9 ;
    /svc => /$/inet/127.0.0.1/9 ;
  servers:
  - ip: 0.0.0.0
    port: {port}
  - ip: 127.0.0.1
    port: {port}
- protocol: http
  label: inverted
  dtab: |
    /svc => /$/inet/127.0.0.1/9 ;
  service:
    totalTimeoutMs: 500
  client:
    requestAttemptTimeoutMs: 900
  servers:
  - port: {port2}
admin:
  port: {admin}
usage:
  enabled: false
"""
DISCO_PLANTED_FINDINGS = [("dtab-shadowed", 7), ("router-port-conflict", 13),
                          ("timeout-inversion", 21)]


def disco_dsts() -> list:
    """(request path, the answer's prefix) of each destination."""
    out = [(f"/c/svc{k:02d}", f"c{k:02d}/") for k in range(DISCO_CONSUL)]
    out += [(f"/m/app{k}", f"m{k}/") for k in range(DISCO_APPS)]
    out += [(f"/s/ss{k}", "ds") for k in range(DISCO_SETS)]
    return out + [("/l/jobs", "leader/"), ("/k/api", "api/")]


DISCO_DSTS = disco_dsts()


def disco_names() -> list:
    """Every backend's name, which it answers: the replicas, a spare
    replica for consul service 00 and one for Marathon app 0 (``/3``),
    the leader candidates, the curator instances, and each downstream
    linkerd's backend."""
    names = [f"c{k:02d}/{r}" for k in range(DISCO_CONSUL)
             for r in range(DISCO_REPLICAS)] + ["c00/3"]
    names += [f"m{k}/{r}" for k in range(DISCO_APPS)
              for r in range(DISCO_REPLICAS)] + ["m0/3"]
    names += [f"leader/{r}" for r in range(DISCO_REPLICAS)]
    names += [f"api/{r}" for r in range(DISCO_REPLICAS)]
    return names + ["ds0/0", "ds1/0"]


def disco_who(body: bytes, want: str) -> int:
    """Which replica of a destination answered ``body``: its replica digit
    (the downstream's index for a serverset), -1 for another body."""
    text = body.decode("latin-1")
    if not text.startswith(want) or len(text) <= len(want):
        return -1
    return int(text[len(want)]) if text[len(want)].isdigit() else -1


def disco_backends(conn, names, flag) -> None:
    """Child process: an HTTP server answering each of ``names`` with its
    name; the one at index ``flag.value`` fails every request after
    LINKER_FAULT_MS with a 503, so that DISCO_ACCRUAL consecutive
    failures remove it. Each message on ``conn`` is answered with every
    server's hits so far; ``None`` stops them."""
    from linkerd_tpu_torch.protocol.http.message import Response
    from linkerd_tpu_torch.protocol.http.server import serve
    from linkerd_tpu_torch.router.service import FnService

    hits = [0] * len(names)

    def backend(i: int, name: str):
        body = name.encode()

        async def handle(req):
            hits[i] += 1
            if flag.value == i:
                await asyncio.sleep(LINKER_FAULT_MS / 1e3)
                return Response(503, body=b"injected fault")
            return Response(200, body=body)

        return FnService(handle)

    async def main():
        servers = [await serve(backend(i, n)) for i, n in enumerate(names)]
        conn.send([s.bound_port for s in servers])
        loop = asyncio.get_running_loop()
        while await loop.run_in_executor(None, conn.recv) is not None:
            conn.send(list(hits))
        for s in servers:
            await s.close()

    asyncio.run(main())


def disco_load(conn) -> None:
    """Child process: on each ``(port, plans)`` from ``conn``, one
    keep-alive connection a plan, all at once, each GETting its
    destinations' paths in turn; sends back every request's destination,
    status, who answered (``disco_who``), ms, and completion instant,
    and the wall seconds. ``None`` ends it."""
    from linkerd_tpu_torch.protocol.http.client import HttpClient
    from linkerd_tpu_torch.protocol.http.message import Request

    async def connection(port, plan, out, off):
        client = HttpClient("127.0.0.1", port, max_connections=1)
        try:
            for i, d in enumerate(plan):
                path, want = DISCO_DSTS[d]
                t0 = time.perf_counter()
                try:
                    rsp = await client(Request(uri=path))
                except Exception:  # noqa: BLE001 — counted as status -1
                    status, body = -1, b""
                else:
                    status, body = rsp.status, rsp.body
                out["ms"][off + i] = (time.perf_counter() - t0) * 1e3
                out["t"][off + i] = time.monotonic()
                out["status"][off + i] = status
                out["who"][off + i] = disco_who(body, want)
        finally:
            await client.close()

    while True:
        msg = conn.recv()
        if msg is None:
            return
        port, plans = msg
        n = sum(len(p) for p in plans)
        out = {"dst": np.concatenate(plans).astype(np.int16),
               "status": np.zeros(n, np.int16), "who": np.zeros(n, np.int8),
               "ms": np.zeros(n), "t": np.zeros(n)}
        offs = np.cumsum([0] + [len(p) for p in plans])

        async def run():
            t0 = time.perf_counter()
            await asyncio.gather(*(connection(port, p, out, int(o))
                                   for p, o in zip(plans, offs)))
            return time.perf_counter() - t0

        out["wall"] = asyncio.run(run())
        conn.send(out)


async def disco_traffic(loads, port: int, plans) -> dict:
    """The load processes' share of ``plans`` at once; waits for every
    answer off the event loop (which serves the fakes)."""
    loop = asyncio.get_running_loop()
    for (conn, _), idx in zip(loads, np.array_split(
            np.arange(len(plans)), len(loads))):
        conn.send((port, [plans[i] for i in idx]))
    outs = await asyncio.gather(*(loop.run_in_executor(None, conn.recv)
                                  for conn, _ in loads))
    res = {k: np.concatenate([o[k] for o in outs])
           for k in ("dst", "status", "who", "ms", "t")}
    res["wall"] = max(o["wall"] for o in outs)
    return res


def disco_plans(rng, n: int) -> list:
    return np.array_split(rng.integers(len(DISCO_DSTS), size=n),
                          DISCO_CONNS)


def disco_traffic_checks(res: dict, what: str, faulted=None) -> dict:
    """Every request answered 200 by a replica of its destination (but
    those to destination ``faulted``, which may answer its replica's
    503s); requests/s and ms percentiles."""
    ok = (res["status"] == 200) & (res["who"] >= 0)
    wrong = ~ok & (res["dst"] != faulted)
    if wrong.any():
        i = int(np.flatnonzero(wrong)[0])
        raise AssertionError(
            f"discovery {what}: {int(wrong.sum())} requests misrouted or "
            f"failed, e.g. {DISCO_DSTS[res['dst'][i]][0]} -> status "
            f"{res['status'][i]}")
    ms = res["ms"]
    return {"requests": len(ms), "requests_per_s": len(ms) / res["wall"],
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99))}


def disco_answered(res: dict) -> dict:
    """destination path -> the sorted replicas that answered it 200."""
    out = {}
    for d, (path, _) in enumerate(DISCO_DSTS):
        sel = (res["dst"] == d) & (res["status"] == 200)
        out[path] = sorted({int(w) for w in res["who"][sel] if w >= 0})
    return out


def logged_zk():
    """The port's FakeZkServer, noting the instants each path's children
    are read (``reads``) and each node is deleted (``deleted``)."""
    from linkerd_tpu_torch.testing.zkserver import FakeZkServer
    from linkerd_tpu_torch.zk import client as zkc
    from linkerd_tpu_torch.zk import jute

    class LoggedZk(FakeZkServer):
        def __init__(self):
            super().__init__()
            self.reads, self.deleted = {}, {}

        def _notify(self, ev_type, path):
            if ev_type == zkc.EVENT_NODE_DELETED:
                self.deleted[path] = time.monotonic()
            super()._notify(ev_type, path)

        def _apply(self, sess, op, r):
            if op in (zkc.OP_GETCHILDREN, zkc.OP_GETCHILDREN2):
                path = jute.Reader(r.data, r.pos).ustring()
                self.reads.setdefault(path, []).append(time.monotonic())
            return super()._apply(sess, op, r)

    return LoggedZk()


async def disco_first_answer(port: int, path: str, want: bytes, t0: float,
                             what: str) -> float:
    """ms from ``t0`` (monotonic) to the first answer ``want`` to GETs of
    ``path`` sent every DISCO_PROBE_S; fails after DISCO_WAIT_S."""
    from linkerd_tpu_torch.protocol.http.client import HttpClient
    from linkerd_tpu_torch.protocol.http.message import Request

    client = HttpClient("127.0.0.1", port, max_connections=1)
    try:
        while True:
            rsp = await client(Request(uri=path))
            if rsp.body == want:
                return (time.monotonic() - t0) * 1e3
            if time.monotonic() - t0 > DISCO_WAIT_S:
                raise AssertionError(
                    f"discovery {what}: no answer from {want.decode()} "
                    f"{DISCO_WAIT_S} s after the change (last: "
                    f"{rsp.status} {rsp.body[:40]!r})")
            await asyncio.sleep(DISCO_PROBE_S)
    finally:
        await client.close()


async def disco_until(pred, what: str, timeout: float = DISCO_WAIT_S,
                      every: float = 0.005) -> float:
    """The monotonic instant ``pred()`` first holds, polled every
    ``every`` s; fails after ``timeout`` s."""
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"discovery: {what} after {timeout} s")
        await asyncio.sleep(every)
    return time.monotonic()


def disco_front_config(port: int, admin: int, consul: int, marathon: int,
                       zk: int) -> dict:
    zk_addrs = [{"host": "127.0.0.1", "port": zk}]
    return {
        "routers": [{
            "protocol": "http", "label": DISCO_LABEL,
            "identifier": {"kind": "io.l5d.path", "segments": 2},
            "dtab": DISCO_DTAB, "servers": [{"port": port}],
            "client": {"failureAccrual": {
                "kind": "io.l5d.consecutiveFailures",
                "failures": DISCO_ACCRUAL}}}],
        "namers": [
            {"kind": "io.l5d.consul", "host": "127.0.0.1", "port": consul},
            {"kind": "io.l5d.marathon", "host": "127.0.0.1",
             "port": marathon, "ttlMs": DISCO_TTL_MS},
            {"kind": "io.l5d.serversets", "zkAddrs": zk_addrs},
            {"kind": "io.l5d.zkLeader", "zkAddrs": zk_addrs},
            {"kind": "io.l5d.curator", "zkAddrs": zk_addrs,
             "basePath": "/services"}],
        "telemetry": [{"kind": "io.l5d.jaxAnomaly"}],
        "admin": {"port": admin}, "usage": {"enabled": False}}


def disco_downstream_config(i: int, ports, admin: int, backend: int,
                            zk: int) -> dict:
    """Downstream linkerd ``i``: one server a serverset, each announcing
    itself into ``/discovery/ss<k>``, all routed to its backend."""
    return {
        "routers": [{
            "protocol": "http", "label": f"ds{i}",
            "identifier": {"kind": "io.l5d.path", "segments": 2},
            "dtab": f"/svc => /$/inet/127.0.0.1/{backend} ;",
            "servers": [{"port": p,
                         "announce": [f"/#/io.l5d.serversets/ss{k}"]}
                        for k, p in enumerate(ports)]}],
        "announcers": [{"kind": "io.l5d.serversets", "pathPrefix":
                        "/discovery",
                        "zkAddrs": [{"host": "127.0.0.1", "port": zk}]}],
        "admin": {"port": admin}, "usage": {"enabled": False}}


def disco_cli(cfg: Path, log: Path, dev: str):
    """``python -m linkerd_tpu_torch <cfg>`` (``--device cpu`` only when
    ``dev`` is the CPU), with no DC/OS credential in its environment."""
    argv = [sys.executable, "-m", "linkerd_tpu_torch", str(cfg)]
    if dev == "cpu":
        argv[3:3] = ["--device", "cpu"]
    env = {k: v for k, v in os.environ.items()
           if k != "DCOS_SERVICE_ACCOUNT_CREDENTIAL"}
    with open(log, "w") as out:
        return subprocess.Popen(argv, cwd=ROOT, stdout=out,
                                stderr=subprocess.STDOUT,
                                env=dict(env, PYTHONPATH=str(ROOT)))


class BoardSampler:
    """Samples /anomaly.json every 0.1 s: (instant, the faulted
    destination's score, the median of the others')."""

    def __init__(self, admin: int, dst: str):
        self.admin, self.dst, self.samples = admin, dst, []
        self.last = None
        self.task = asyncio.get_running_loop().create_task(self.run())

    async def run(self):
        while True:
            scores = json.loads((await http_get(
                self.admin, "/anomaly.json"))[1])["scores"]
            self.last = scores
            if self.dst in scores:
                others = [v for k, v in scores.items() if k != self.dst]
                self.samples.append((time.monotonic(), scores[self.dst],
                                     float(np.median(others))))
            await asyncio.sleep(0.1)

    async def stop(self) -> list:
        self.task.cancel()
        (got,) = await asyncio.gather(self.task, return_exceptions=True)
        if not isinstance(got, asyncio.CancelledError):
            raise AssertionError(f"discovery: the board sampler ended: "
                                 f"{got!r}")
        return self.samples


async def disco_hits(backs) -> np.ndarray:
    loop = asyncio.get_running_loop()
    backs.send("hits")
    return np.asarray(await loop.run_in_executor(None, backs.recv))


async def disco_part_a(env: dict) -> dict:
    """Calm traffic through every namer; a consul replica replaced and a
    Marathon task replaced, each timed from the fake's write to the first
    answer from the new one; then one consul replica faulted. The board
    is sampled through the calm run and the fault: the faulted
    destination's margin over the others' median, before and during."""
    sampler = BoardSampler(env["admin"], "/svc/c/svc01")
    try:
        return await disco_part_a_sampled(env, sampler)
    finally:
        # a failed part leaves no sampler behind to fail at the loop's end
        sampler.task.cancel()
        await asyncio.gather(sampler.task, return_exceptions=True)


async def disco_part_a_sampled(env: dict, sampler) -> dict:
    consul, marathon, names, ports = (env[k] for k in (
        "consul", "marathon", "names", "ports"))
    port, rng, out = env["port"], env["rng"], {}
    calm = await disco_traffic(env["loads"], port,
                               disco_plans(rng, DISCO_CALM))
    out["calm"] = disco_traffic_checks(calm, "A calm")
    answered = disco_answered(calm)
    env["answered"] = answered
    short = {p: a for p, a in answered.items() if not a}
    if short:
        raise AssertionError(f"discovery A: destinations never answered: "
                             f"{sorted(short)}")
    # a consul deregister plus register: replica 2 of svc00 gives way to
    # the spare, in one write
    hp = lambda n: ("127.0.0.1", ports[names.index(n)])  # noqa: E731
    consul.set_service("svc00", [hp("c00/0"), hp("c00/1"), hp("c00/3")])
    out["consul_change_ms"] = await disco_first_answer(
        port, "/c/svc00", b"c00/3", consul.written["svc00"],
        "A consul change")
    marathon.set_app("/app0", [hp("m0/0"), hp("m0/1"), hp("m0/3")])
    out["marathon_change_ms"] = await disco_first_answer(
        port, "/m/app0", b"m0/3", marathon.written["/app0"],
        "A Marathon change")
    # the fault: replica 0 of svc01
    faulted = next(d for d, (p, _) in enumerate(DISCO_DSTS)
                   if p == "/c/svc01")
    fi = names.index(DISCO_FAULTED_NAME)
    before = await disco_hits(env["backs"])
    env["flag"].value = fi
    env["window_t"] = time.monotonic()
    try:
        faulty = await disco_traffic(env["loads"], port,
                                     disco_plans(rng, DISCO_FAULTED))
    finally:
        env["flag"].value = -1
    samples = await sampler.stop()
    if not samples:
        raise AssertionError(f"discovery A: no score for /svc/c/svc01 on "
                             f"the board: {sampler.last}")
    hits = await disco_hits(env["backs"]) - before
    out["faulted"] = disco_traffic_checks(faulty, "A faulted", faulted)
    mine = hits[[names.index(f"c01/{r}") for r in range(DISCO_REPLICAS)]]
    errors = int(((faulty["dst"] == faulted)
                  & (faulty["status"] != 200)).sum())
    pre = [s - m for t, s, m in samples if t < env["window_t"]]
    during = [s - m for t, s, m in samples if t >= env["window_t"]]
    out["fault"] = {"hits_by_replica": mine.tolist(), "errors": errors,
                    "margin_before": float(np.mean(pre)) if pre else None,
                    "margin_during": float(np.mean(during)) if during
                    else None,
                    "margin_before_max": max(pre) if pre else None,
                    "margin_during_max": max(during) if during else None,
                    "samples": [len(pre), len(during)]}
    # removed: after DISCO_ACCRUAL failures in a row it took no request
    # but a probe or two, while the others took more
    if not (DISCO_ACCRUAL <= mine[0] <= DISCO_ACCRUAL + 2
            and mine[0] < min(mine[1:]) and errors <= mine[0]):
        raise AssertionError(
            f"discovery A: failure accrual did not remove the faulted "
            f"replica: {out['fault']}")
    if not (pre and during and np.mean(during) > np.mean(pre)):
        raise AssertionError(
            f"discovery A: the faulted destination's score did not rise: "
            f"{out['fault']}")
    return out


async def disco_part_b(env: dict) -> dict:
    """A downstream linkerd SIGKILLed: ms until its members are gone (from
    the kill and from its reap), until the router re-read each serverset,
    and no failed request once it had; the leader changed, timed; the
    curator's instances all answered."""
    zk, port = env["zk"], env["port"]
    loop = asyncio.get_running_loop()
    out = {"serverset_answers": {p: a for p, a in env["answered"].items()
                                 if p.startswith("/s/")},
           "curator_answers": env["answered"]["/k/api"]}
    if any(a != [0, 1] for a in out["serverset_answers"].values()):
        raise AssertionError(f"discovery B: serversets not answered by both "
                             f"downstreams: {out['serverset_answers']}")
    if out["curator_answers"] != list(range(DISCO_REPLICAS)):
        raise AssertionError(f"discovery B: curator instances answered: "
                             f"{out['curator_answers']}")
    victim = env["downstreams"][1]
    members = env["members"][1]
    stop = asyncio.Event()
    seen = []

    async def prober():
        from linkerd_tpu_torch.protocol.http.client import HttpClient
        from linkerd_tpu_torch.protocol.http.message import Request

        client = HttpClient("127.0.0.1", port, max_connections=1)
        try:
            k = 0
            while not stop.is_set():
                path = f"/s/ss{k % DISCO_SETS}"
                try:
                    rsp = await client(Request(uri=path))
                    status, who = rsp.status, disco_who(rsp.body, "ds")
                except Exception:  # noqa: BLE001 — a failed request
                    status, who = -1, -1
                seen.append((time.monotonic(), status, who))
                k += 1
                await asyncio.sleep(DISCO_PROBE_S)
        finally:
            await client.close()

    probes = [loop.create_task(prober()) for _ in range(4)]
    try:
        await asyncio.sleep(0.5)
        t_kill = time.monotonic()
        victim.send_signal(signal.SIGKILL)
        # reaped off the loop: the instant wait() returned
        reaped = loop.run_in_executor(
            None, lambda: (victim.wait(), time.monotonic())[1])
        await disco_until(lambda: not any(m in zk.nodes for m in members),
                          "the killed members still in ZooKeeper")
        t_gone = max(zk.deleted[m] for m in members)
        t_reap = await reaped
        # the router's namer re-reads each set once its watch fires
        rereads = []
        for m in members:
            base = m.rsplit("/", 1)[0]

            def reread(base=base, m=m):
                return [t for t in zk.reads.get(base, [])
                        if t >= zk.deleted[m]]

            await disco_until(lambda: reread(), f"no re-read of {base}")
            rereads.append(min(reread()))
        t_reread = max(rereads)
        await asyncio.sleep(max(0.0, t_reread + DISCO_SETTLE_S
                                + DISCO_KILL_WINDOW_S - time.monotonic()))
    finally:
        stop.set()
        await asyncio.gather(*probes, return_exceptions=True)
    failed = [t for t, s, _ in seen if s != 200]
    late = [t for t in failed if t > t_reread + DISCO_SETTLE_S]
    out["kill"] = {
        "member_gone_from_kill_ms": (t_gone - t_kill) * 1e3,
        "member_gone_from_reap_ms": (t_gone - t_reap) * 1e3,
        "reap_from_kill_ms": (t_reap - t_kill) * 1e3,
        "router_reread_from_kill_ms": (t_reread - t_kill) * 1e3,
        "failed_after_kill": len(failed),
        "last_failure_from_kill_ms": (max(failed) - t_kill) * 1e3
        if failed else None,
        "probes": len(seen),
        "window_s": seen[-1][0] - t_reread if seen else 0.0}
    if late:
        raise AssertionError(
            f"discovery B: {len(late)} serverset requests failed more than "
            f"{DISCO_SETTLE_S} s after the router re-read the serversets "
            f"without the killed linkerd: {out['kill']}")
    if [w for t, s, w in seen if t > t_reread and s == 200 and w == 1]:
        raise AssertionError("discovery B: the killed linkerd answered")
    # the leader's node goes: the next candidate leads
    t0 = time.monotonic()
    zk.delete_node("/election/jobs/c_0000000000")
    out["leader_change_ms"] = await disco_first_answer(
        port, "/l/jobs", b"leader/1", t0, "B leader change")
    return out


async def disco_part_c(env: dict) -> dict:
    """/config-check.json on the live CLI (clean) and on the planted one
    (its rule ids at their lines); the p99 of traffic with and without
    checks running."""
    admin, port, rng = env["admin"], env["port"], env["rng"]
    status, body = await http_get(admin, "/config-check.json")
    live = json.loads(body)
    if status != 200 or live.get("clean") is not True:
        raise AssertionError(f"discovery C: the live config's check: "
                             f"{status} {live}")
    status, body = await http_get(env["planted_admin"], "/config-check.json")
    planted = json.loads(body)
    got = sorted((f["rule"], f["line"]) for f in planted.get("findings", []))
    if status != 200 or got != DISCO_PLANTED_FINDINGS:
        raise AssertionError(f"discovery C: the planted config's check "
                             f"gave {got}, not {DISCO_PLANTED_FINDINGS}")
    quiet = await disco_traffic(env["loads"], port,
                                disco_plans(rng, DISCO_CHECK))
    stop, checks = asyncio.Event(), []

    async def checking():
        while not stop.is_set():
            t0 = time.perf_counter()
            s, _ = await http_get(admin, "/config-check.json")
            checks.append(((time.perf_counter() - t0) * 1e3, s))

    task = asyncio.get_running_loop().create_task(checking())
    try:
        busy = await disco_traffic(env["loads"], port,
                                   disco_plans(rng, DISCO_CHECK))
    finally:
        stop.set()
        await task
    if not checks or any(s != 200 for _, s in checks):
        raise AssertionError(f"discovery C: checks beside traffic: {checks}")
    return {"live_clean": True, "planted": got,
            "without_checks": disco_traffic_checks(quiet, "C quiet"),
            "with_checks": disco_traffic_checks(busy, "C checked"),
            "checks": len(checks),
            "check_ms_p50": float(np.median([ms for ms, _ in checks]))}


async def disco_phase(dev: str = "cuda", parts=("A", "B", "C")):
    """The fakes here, the backends, load clients, downstream linkerds,
    the planted CLI and the CLI under test spawned at once; parts A-C;
    then the CLI's tap: one kernel launch a batch (and the warm-up's),
    kernel vs plain on every row, every row scored, every destination on
    the board. Returns the results and the CLI's kernel launches."""
    import multiprocessing

    from linkerd_tpu_torch.testing.discovery import FakeConsul, FakeMarathon

    mp = multiprocessing.get_context("spawn")
    t_phase = time.perf_counter()
    res, procs, clis = {}, [], {}
    work = Path(tempfile.mkdtemp(prefix="disco-"))
    flag = mp.RawValue("i", -1)
    consul = await FakeConsul().start()
    marathon = await FakeMarathon().start()
    zk = await logged_zk().start()
    names = disco_names()
    env = {"consul": consul, "marathon": marathon, "zk": zk, "flag": flag,
           "names": names, "rng": np.random.default_rng(18)}
    backs = child = None
    try:
        backs, theirs = mp.Pipe()
        p = mp.Process(target=disco_backends, args=(theirs, names, flag),
                       daemon=True)
        p.start()
        procs.append(p)
        loads = []
        for _ in range(DISCO_LOAD_PROCS):
            ours, theirs = mp.Pipe()
            p = mp.Process(target=disco_load, args=(theirs,), daemon=True)
            p.start()
            procs.append(p)
            loads.append((ours, p))
        loop = asyncio.get_running_loop()
        ports = await loop.run_in_executor(None, backs.recv)
        env.update(backs=backs, loads=loads, ports=ports)
        hp = lambda n: ("127.0.0.1", ports[names.index(n)])  # noqa: E731
        for k in range(DISCO_CONSUL):
            consul.set_service(f"svc{k:02d}", [
                hp(f"c{k:02d}/{r}") for r in range(DISCO_REPLICAS)])
        for k in range(DISCO_APPS):
            marathon.set_app(f"/app{k}", [hp(f"m{k}/{r}")
                                          for r in range(DISCO_REPLICAS)])
        for r in range(DISCO_REPLICAS):
            zk.set_node(f"/election/jobs/c_{r:010d}",
                        "{}:{}".format(*hp(f"leader/{r}")).encode())
            zk.set_node(f"/services/api/i-{r}", json.dumps({
                "name": "api", "id": f"i-{r}", "address": "127.0.0.1",
                "port": hp(f"api/{r}")[1], "sslPort": None}).encode())
        # the downstream linkerds, the planted CLI and the CLI under test
        admins = {}
        ds_ports = []
        for i in range(2):
            ds_ports.append([free_port() for _ in range(DISCO_SETS)])
            admins[f"ds{i}"] = free_port()
            (work / f"ds{i}.json").write_text(json.dumps(
                disco_downstream_config(i, ds_ports[i], admins[f"ds{i}"],
                                        hp(f"ds{i}/0")[1], zk.port)))
            clis[f"ds{i}"] = disco_cli(work / f"ds{i}.json",
                                       work / f"ds{i}.log", dev)
        admins["planted"] = free_port()
        (work / "planted.yml").write_text(DISCO_PLANTED.format(
            port=free_port(), port2=free_port(), admin=admins["planted"]))
        clis["planted"] = disco_cli(work / "planted.yml",
                                    work / "planted.log", dev)
        env["port"], env["admin"] = free_port(), free_port()
        (work / "linker.json").write_text(json.dumps(disco_front_config(
            env["port"], env["admin"], consul.port, marathon.port,
            zk.port)))
        child = mp.Process(target=cli_child, daemon=True, args=(
            str(work / "linker.json"), str(work / "tap.npz"), dev))
        saved = os.environ.pop("DCOS_SERVICE_ACCOUNT_CREDENTIAL", None)
        try:
            child.start()
        finally:
            if saved is not None:
                os.environ["DCOS_SERVICE_ACCOUNT_CREDENTIAL"] = saved
        boot = await asyncio.gather(
            wait_ping(env["admin"], child.is_alive, "discovery linkerd"),
            *(wait_ping(admins[k], lambda c=clis[k]: c.poll() is None,
                        f"discovery {k}") for k in clis))
        res["boot_ms"] = dict(zip(["linkerd", *clis], boot))
        env["planted_admin"] = admins["planted"]
        env["downstreams"] = [clis["ds0"], clis["ds1"]]
        # every server announced: one ephemeral member_ a downstream a set
        await disco_until(lambda: all(
            len(zk.children_of(f"/discovery/ss{k}")) == 2
            for k in range(DISCO_SETS)), "the downstreams' members")
        env["members"] = [[], []]
        for k in range(DISCO_SETS):
            for m in zk.children_of(f"/discovery/ss{k}"):
                node = zk.nodes[f"/discovery/ss{k}/{m}"]
                ep = json.loads(node.data)["serviceEndpoint"]["port"]
                if not m.startswith("member_") or not node.ephemeral_owner:
                    raise AssertionError(f"discovery: {m} is not an "
                                         f"ephemeral member_")
                env["members"][int(ep in ds_ports[1])].append(
                    f"/discovery/ss{k}/{m}")
        # a warm-up: the scorer is built and warmed off the router's loop
        # after the first /ping; the parts start once every destination
        # is on the board
        t0 = time.monotonic()
        warm = await disco_traffic(env["loads"], env["port"], disco_plans(
            env["rng"], 16 * len(DISCO_DSTS)))
        res["warm"] = disco_traffic_checks(warm, "warm-up")
        await wait_json(env["admin"], "/anomaly.json", lambda b: all(
            f"/svc{p}" in b["scores"] for p, _ in DISCO_DSTS),
            "every destination on the board", timeout=CLI_BOOT_S)
        res["board_after_ping_ms"] = (time.monotonic() - t0) * 1e3
        for name, part in (("A", disco_part_a), ("B", disco_part_b),
                           ("C", disco_part_c)):
            if name in parts:
                t0 = time.perf_counter()
                res[f"part_{name.lower()}"] = await part(env)
                res[f"part_{name.lower()}"]["s"] = time.perf_counter() - t0
        model = await wait_json(
            env["admin"], "/model.json", lambda m: m["requests_total"]
            == m["scored_total"] > 0, "every request scored")
        board = json.loads((await http_get(env["admin"],
                                           "/anomaly.json"))[1])["scores"]
        missing = [p for p, _ in DISCO_DSTS if f"/svc{p}" not in board]
        if missing:
            raise AssertionError(f"discovery: no board score for {missing}")
        res["scored"] = model["scored_total"]
        res["stops"] = {"linkerd": stop_process(child, "discovery linkerd")}
        for k in ("ds0", "planted"):
            res["stops"][k] = stop_process(clis[k], f"discovery {k}")
        tap = dict(np.load(work / "tap.npz"))
        checked = cli_tap_checks(tap, env.get("window_t", 0.0), dev)
        # the fault's rows carry no labels of their own here: no AUC
        for k in ("window_rows", "window_auc"):
            checked.pop(k)
        res.update(checked)
    finally:
        for proc in [child, *clis.values()]:
            if proc is None:
                continue
            alive = (proc.poll() is None if hasattr(proc, "poll")
                     else proc.is_alive())
            if alive:
                proc.kill()
                (proc.wait if hasattr(proc, "poll") else proc.join)()
        for conn in [backs] + [c for c, _ in env.get("loads", [])]:
            if conn is None:
                continue
            try:
                conn.send(None)
            except OSError:
                pass
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join()
        for fake in (consul, marathon, zk):
            try:
                await asyncio.wait_for(fake.close(), K8S_TEARDOWN_S)
            except asyncio.TimeoutError:
                print(f"discovery: {type(fake).__name__} did not close "
                      f"within {K8S_TEARDOWN_S} s")
        shutil.rmtree(work, ignore_errors=True)
    res["phase_s"] = time.perf_counter() - t_phase
    a, b, c = (res.get(f"part_{k}", {}) for k in "abc")
    print(f"discovery: {res['launches']} launches for {res['batches']} "
          f"batches; kernel vs plain max|diff| "
          f"{res['kernel_vs_plain_max']:.3e} ({res['rows_past_row_tol']} of "
          f"{res['rows']} rows past {ROW_TOL}); {res['scored']} rows scored")
    if a:
        print(f"discovery A: calm {a['calm']['requests_per_s']:.0f} "
              f"requests/s, p50 {a['calm']['p50_ms']:.3f} ms, p99 "
              f"{a['calm']['p99_ms']:.3f} ms; consul change "
              f"{a['consul_change_ms']:.1f} ms, Marathon change "
              f"{a['marathon_change_ms']:.1f} ms; fault {a['fault']}")
    if b:
        print(f"discovery B: kill {b['kill']}; leader change "
              f"{b['leader_change_ms']:.1f} ms")
    if c:
        print(f"discovery C: planted {c['planted']}; p99 without checks "
              f"{c['without_checks']['p99_ms']:.3f} ms, with "
              f"{c['with_checks']['p99_ms']:.3f} ms ({c['checks']} checks, "
              f"p50 {c['check_ms_p50']:.1f} ms)")
    print(f"discovery: boot {res['boot_ms']}; {res['phase_s']:.1f} s")
    return res, res["launches"]


# The witness of the kernel's sums (``--witness``): on a phase's window
# rows, an "exact" forward in float64 with the kernel's rounding points
# (the float64 sum of bf16 products rounded to float32 and then to bf16,
# the bf16 bias added in float32 and rounded again) says, layer by
# layer, how often each version's bf16 activation differs from the exact
# one given that version's own input to the layer. The kernel's
# activations come from a copy that also writes each layer's output
# after its scores (``DUMP``).
DUMP = ("    consumers_sync();  // this layer's output is whole; its input "
        "is free",
        "    consumers_sync();  // this layer's output is whole; its input "
        "is free\n"
        "    for (int i = tid; i < live * L.npad; i += WARPS * 32) {\n"
        "      const int r = i / L.npad, c = i - r * L.npad;\n"
        "      out[n + ((long)(li + 1) * n + row0 + r) * MAXW + c] =\n"
        "          __bfloat162float(s_act[L.out * ROWS * AST + r * AST + c]);\n"
        "    }")
DUMP_INPUT = ("  int g = 0;  // chunks consumed",
              "  for (int i = tid; i < live * kpad0; i += WARPS * 32) {\n"
              "    const int r = i / kpad0, c = i - r * kpad0;\n"
              "    out[n + (row0 + r) * (long)MAXW + c] =\n"
              "        __bfloat162float(s_act[r * AST + c]);\n"
              "  }\n"
              "  int g = 0;  // chunks consumed")
WITNESS_VARIANTS = {"dump": (DUMP, DUMP_INPUT)}
LAYER_ORDER = (("enc", 0), ("enc", 1), ("enc", 2), ("cls", 0), ("cls", 1),
               ("dec", 0), ("dec", 1), ("dec", 2))
LAYER_INPUT = (0, 1, 2, 3, 4, 3, 6, 7)  # slot each layer reads (0: x)
MAXW = 256


def bf16_of(a: np.ndarray) -> np.ndarray:
    """Round to bf16 (nearest even), straight from ``a``'s own type."""
    import torch

    return torch.from_numpy(np.ascontiguousarray(a)).to(
        torch.bfloat16).to(torch.float64).numpy()


def exact_layer(h: np.ndarray, layer, relu: bool) -> np.ndarray:
    """One layer from bf16 activations ``h``: the float64 sum of the bf16
    products rounded to float32 and then to bf16, plus the bf16 bias in
    float32, rounded again; then ReLU."""
    w = bf16_of(np.asarray(layer["w"], np.float32))
    b = bf16_of(np.asarray(layer["b"], np.float32)).astype(np.float32)
    h = h[:, :w.shape[0]].astype(np.float64)
    y = bf16_of(bf16_of((h @ w).astype(np.float32)).astype(np.float32) + b)
    return np.maximum(y, 0.0) if relu else y


def exact_scores(snap, x32: np.ndarray, acts=None):
    """Scores of the float32 z-scored rows ``x32`` by the exact chain,
    and its activations by slot (0: the bf16 input, 1..8: LAYER_ORDER);
    with ``acts`` (another version's activations by slot), each layer
    is taken from that version's own input to it instead."""
    p = snap.params
    chain = [bf16_of(x32)]
    for k, (g, i) in enumerate(LAYER_ORDER):
        src = chain if acts is None else acts
        relu = not ((g == "dec" and i == 2) or (g == "cls" and i == 1))
        chain.append(exact_layer(src[LAYER_INPUT[k]], p[g][i], relu))
    recon, logit = chain[8], chain[5][:, 0]
    err = np.mean((recon[:, :x32.shape[1]] - x32.astype(np.float64)) ** 2,
                  axis=1)
    w = float(snap.cfg.recon_weight)
    return w * np.tanh(err) + (1 - w) / (1 + np.exp(-logit)), chain


def plain_acts(snap, x: np.ndarray, dev: str = "cuda"):
    """The plain version's activations by slot on ``dev``, and its
    float32 z-scored input."""
    import torch

    from linkerd_tpu_torch.models.anomaly import normalize_features
    from linkerd_tpu_torch.models.convert import params_from_numpy

    params = params_from_numpy(snap.params, dev)
    x32 = normalize_features(torch.tensor(x, device=dev),
                             torch.tensor(snap.mu, device=dev),
                             torch.tensor(snap.var, device=dev))
    slots = [x32.to(torch.bfloat16)]
    for k, (g, i) in enumerate(LAYER_ORDER):
        layer = params[g][i]
        y = (slots[LAYER_INPUT[k]].double() @ layer["w"].to(
            torch.bfloat16).double()).float().to(torch.bfloat16)
        y = y + layer["b"].to(torch.bfloat16)
        relu = not ((g == "dec" and i == 2) or (g == "cls" and i == 1))
        slots.append(torch.relu(y) if relu else y)
    return [t.double().cpu().numpy() for t in slots], \
        x32.cpu().numpy()


def variant_fn(lib_path: Path):
    """``score_mlp_forward`` of a variant's library."""
    import ctypes

    fn = ctypes.CDLL(str(lib_path)).score_mlp_forward
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, i, i, p, p, p, p, i, i, f, f, p, p]
    fn.restype = ctypes.c_int
    return fn


def variant_scores(fn, kp, x, cfg, mu, var, dump: bool):
    """Scores (and with ``dump`` the activations by slot, [9, n, MAXW])
    of a variant's kernel; its launches are not counted."""
    import torch

    n = x.shape[0]
    out = torch.zeros(n + (9 * n * MAXW if dump else 0),
                      dtype=torch.float32, device="cuda")
    rc = fn(x.data_ptr(), n, cfg.in_dim, mu.data_ptr(), var.data_ptr(),
            kp.packed.data_ptr(), kp.table, len(kp.layers), kp.bias_len,
            cfg.recon_weight, 1.0 - cfg.recon_weight, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise AssertionError(f"variant launch failed: cudaError {rc}")
    torch.cuda.synchronize()
    out = out.cpu().numpy()
    return out[:n], (out[n:].reshape(9, n, MAXW) if dump else None)


def layer_counts(acts, snap, width_of) -> list:
    """Per layer: the activations of ``acts`` that differ from the exact
    layer taken on ``acts``' own input."""
    _, forced = exact_scores(snap, acts[0][:, :36], acts=acts)
    return [int((acts[k][:, :width_of(k)] != forced[k][:, :width_of(k)])
                .sum()) for k in range(1, 9)]


def witness(window: dict, libs: dict) -> dict:
    """The witness on one window (``WINDOWS`` entry): the kernel and the
    plain version against the exact forward, by score and layer by
    layer, over every row and over the rows where kernel and plain part
    by more than ROW_TOL."""
    import torch

    from linkerd_tpu_torch.models.anomaly import AnomalyModelConfig
    from linkerd_tpu_torch.models.convert import params_from_numpy
    from linkerd_tpu_torch.ops.scoring import pack_params

    x, snap = window["x"], window["snap"]
    cfg = AnomalyModelConfig(recon_weight=float(snap.cfg.recon_weight))
    kp = pack_params(params_from_numpy(snap.params, "cuda"), cfg)
    xd = torch.tensor(x, device="cuda")
    mu = torch.tensor(snap.mu, device="cuda")
    var = torch.tensor(snap.var, device="cuda")
    kernel, k_acts = variant_scores(libs["dump"], kp, xd, cfg, mu, var, True)
    p_acts, x32 = plain_acts(snap, x)
    plain = window["plain"]
    exact, _ = exact_scores(snap, x32)
    widths = [36] + [snap.params[g][i]["w"].shape[1] for g, i in LAYER_ORDER]
    out = {"rows": len(x),
           "dump_matches_kernel": float(np.abs(kernel - window["kernel"])
                                        .max())}
    wide = np.abs(window["kernel"] - plain) > ROW_TOL
    for name, sc, acts in (("kernel", kernel, k_acts),
                           ("plain", plain, p_acts)):
        acts = [np.asarray(a, np.float64) for a in acts]
        gap = np.abs(sc - exact)
        counts = layer_counts(acts, snap, lambda k: widths[k])
        sub = [a[wide] for a in acts]
        out[name] = {
            "vs_exact_max": float(gap.max()),
            "rows_past_row_tol": int((gap > ROW_TOL).sum()),
            "vs_plain_max": float(np.abs(sc - plain).max()),
            "input_differs_from_plain": int(
                (acts[0][:, :36] != p_acts[0]).sum()),
            "layer_mismatches": counts,
            "layer_mismatches_wide_rows": layer_counts(
                sub, snap, lambda k: widths[k]) if wide.any() else None}
    out["wide_rows"] = int(wide.sum())
    out["activations_per_row"] = int(sum(widths[1:]))
    print(f"witness, {len(x)} rows ({out['wide_rows']} where kernel and "
          f"plain part by more than {ROW_TOL}); per layer "
          f"{[f'{g}{i}' for g, i in LAYER_ORDER]}, bf16 activations off "
          f"the exact layer on the version's own input:")
    for name in ("kernel", "plain"):
        r = out[name]
        print(f"  {name}: {r['layer_mismatches']} (rows past {ROW_TOL}: "
              f"{r['layer_mismatches_wide_rows']}); score vs exact max "
              f"{r['vs_exact_max']:.3e}, {r['rows_past_row_tol']} rows past "
              f"{ROW_TOL}; vs plain max {r['vs_plain_max']:.3e}")
    return out


def build_variants(names) -> tuple:
    """Each named WITNESS_VARIANTS kernel built in a temporary copy, all
    at once; returns the temporary directory and the libraries."""
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    build = [sys.executable, "-c", "from linkerd_tpu_torch.ops import "
             "_build; print(_build.build('score_mlp'))"]
    procs = {}
    for name in names:
        d = copy_with(root, name, *WITNESS_VARIANTS[name][0])
        src = d / KERNEL_SOURCE
        text = src.read_text()
        for line, repl in WITNESS_VARIANTS[name][1:]:
            if text.count(line) != 1:
                raise AssertionError(f"{name}: line not found once: {line}")
            text = text.replace(line, repl)
        src.write_text(text)
        procs[name] = subprocess.Popen(build, cwd=d, stdout=subprocess.PIPE,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        outp, _ = proc.communicate(timeout=600)
        if proc.returncode:
            raise AssertionError(f"witness variant {name} did not build")
        libs[name] = variant_fn(Path(outp.strip().splitlines()[-1]))
    return tmp, libs


WITNESS_SEEDS = (12, 13, 14, 15)  # linker windows the witness reads


def run_witness() -> int:
    """``--witness``: for each of WITNESS_SEEDS the linker phase's part
    A, then the witness of the kernel's sums on its window."""
    from linkerd_tpu_torch.ops import _build

    _build.build("score_mlp")
    tmp, libs = build_variants(WITNESS_VARIANTS)
    try:
        out = {}
        for seed in WITNESS_SEEDS:
            asyncio.run(linker_phase(seed=seed, parts=("A",)))
            out[f"linker_seed_{seed}"] = witness(WINDOWS["linker"], libs)
    finally:
        tmp.cleanup()
    name, _, limit = card_line().partition(",")
    print(json.dumps({"witness": out, "card": name.strip(),
                      "power_limit": limit.strip()}))
    return 0


def engine_drift(rows: np.ndarray) -> np.ndarray:
    """Per-row latency drift as the engine's in-plane featurizer keeps
    it (``l5dscore::feat_drift_update`` in ``native/scorer.h``): one
    robust EWMA a route, updated per retired request in float32, in the
    order the engine retired them (the order it drains them)."""
    f = np.float32
    state, out = {}, np.zeros(len(rows), np.float32)
    for i, (rid, lat) in enumerate(zip(rows[:, 0].tolist(),
                                       rows[:, 1].astype(np.float32))):
        st = state.get(rid)
        if st is None:
            state[rid] = (lat, max(f(abs(lat) * f(0.1)), f(0.25)))
            continue
        ewma, dev = st
        drift = f(lat - ewma)
        lim = f(f(3.0) * max(dev, f(0.25)))
        inc = min(max(drift, -lim), lim)
        ad = min(abs(drift), lim)
        state[rid] = (f(ewma + f(f(0.05) * inc)),
                      f(dev + f(f(0.05) * f(ad - dev))))
        out[i] = drift
    return out


def engine_features(rows: np.ndarray, dst_of) -> np.ndarray:
    """The features the engine scored ``rows`` on (every row it retired,
    in order): ``NativeFeaturizer``'s encoding with the engine's per-row
    drift in column 32 in place of the featurizer's per-block one."""
    from linkerd_tpu_torch.telemetry.linerate import NativeFeaturizer

    x, _, _ = NativeFeaturizer(resolver=dst_of).encode_block(rows)
    drift = engine_drift(rows)
    x[:, 32] = np.sign(drift) * np.log1p(np.abs(drift))
    return x


# Broken kernels the checks must catch: (line in score_mlp.cu, its
# replacement). A dropped bias, a neighbouring column's bias, one bf16
# rounding of a layer instead of two, the error taken against the bf16
# copy of the input, the error averaged over the padded width.
KERNEL_SOURCE = "linkerd_tpu_torch/ops/csrc/score_mlp.cu"
MUTANTS = {
    "no_bias": ("const float b0 = __low2float(bb), b1 = __high2float(bb);",
                "const float b0 = 0.f, b1 = 0.f;"),
    "neighbour_bias": ("*reinterpret_cast<const __nv_bfloat162*>(bias + col);",
                       "*reinterpret_cast<const __nv_bfloat162*>("
                       "bias + (col + 2) % L.npad);"),
    "one_rounding": ("const float h = round_bf16(round_bf16(acc) + b);",
                     "const float h = round_bf16(acc + b);"),
    "error_vs_bf16_x": (
        "const float diff = __bfloat162float(recon[r * AST + d]) - v;",
        "const float diff = __bfloat162float(recon[r * AST + d]) - "
        "round_bf16(v);"),
    "error_over_padded_width": (
        "const float err = s / (float)in_dim;",
        "const float err = s / (float)t.l[t.n_layers - 1].npad;"),
}
ROWS_LINE = "constexpr int ROWS = {};         // rows per block"
# Where the kernel's time goes, for --sweep: the launch alone (every
# block returns at once), and the weight stream with the tile loads,
# epilogues and error but no products (no ldmatrix, no mma).
BREAKDOWN = {
    "launch_only": (
        "  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;",
        "  if (n > 0) return;\n"
        "  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;"),
    "no_products": ("    if (TILES > 0) {", "    if (false) {"),
}
CHECKS = ("kernel", "served")  # what --mutants runs on every mutant
LINKER_MUTANT = "one_rounding"  # ... and, on this one, the linker,
                                # fastpath and control phases
# --check and --mutant take these too (fastpath_d: the fastpath phase's
# part D alone)
PHASES = ("telemeter", "linker", "fastpath", "fastpath_d", "control",
          "cli", "h2", "h2fast", "mux", "k8s", "edge", "sidecar",
          "discovery")
# Broken copies of the port that the cli phase's checks must catch, one
# a family: (file, text found once, its replacement) edits. The tracer
# not installed; the router's request counter not incremented for a
# 5xx; /anomaly.json serving the board as it stood at startup; the TLS
# server's requests not counted.
STATS_APPLY = ("    async def apply(self, req: Request, service: Service) "
               "-> Response:\n"
               "        self._requests.incr()\n"
               "        t0 = time.monotonic()\n"
               "        try:\n"
               "            rsp = await service(req)\n"
               "        except BaseException:\n"
               "            self._failures.incr()\n")
CLI_MUTANTS = {
    "no_tracer": [(
        "linkerd_tpu_torch/linker.py",
        "        self.tracer = BroadcastTracer(tracers) if tracers else "
        "NullTracer()\n",
        "        self.tracer = NullTracer()\n")],
    "uncounted_request": [(
        "linkerd_tpu_torch/router/routing.py", STATS_APPLY,
        STATS_APPLY.replace(
            "        self._requests.incr()\n", "").replace(
            "            rsp = await service(req)\n",
            "            rsp = await service(req)\n"
            "            if rsp.status < 500:\n"
            "                self._requests.incr()\n"))],
    "stale_board": [(
        "linkerd_tpu_torch/telemetry/anomaly.py",
        "        async def anomaly_json(req: Request) -> Response:\n"
        "            return json_response({\n"
        "                \"scores\": self.board.scores.sample(),\n",
        "        stale = dict(self.board.scores.sample())\n\n"
        "        async def anomaly_json(req: Request) -> Response:\n"
        "            return json_response({\n"
        "                \"scores\": stale,\n")],
    "tls_uncounted": [(
        "linkerd_tpu_torch/linker.py",
        "            HttpServer(per_server_stack(s), s.ip, s.port,\n",
        "            HttpServer(per_server_stack(s) if s.tls is None else "
        "filters_to_service([f for f in server_filters if not "
        "isinstance(f, StatsFilter)], routing), s.ip, s.port,\n")],
}


# Broken copies of the sharded engine's fan-in that part D must catch:
# the merged stats keeping worker 0's snapshot alone, and the feature
# drain reading worker 0's rows alone.
FASTPATH_MUTANTS = {
    "merge_worker0": [(
        "linkerd_tpu_torch/native/__init__.py",
        "    if not snaps:\n        return {}\n    out: dict = "
        "{\"routes\": {}}\n",
        "    if not snaps:\n        return {}\n    snaps = snaps[:1]\n"
        "    out: dict = {\"routes\": {}}\n")],
    "drain_worker0": [(
        "linkerd_tpu_torch/native/__init__.py",
        "        for h in self._es:\n            if total >= len(out):\n",
        "        for h in self._es[:1]:\n            if total >= len(out):\n")],
}


# Broken copies of the port that the h2 phase must catch: every row keyed
# to the router's prefix instead of the call's destination; grpc-status
# left out of the trailers; the telemeter's recorder left off the h2
# router's server stack.
H2_MUTANTS = {
    "rows_wrong_dst": [(
        "linkerd_tpu_torch/telemetry/anomaly.py",
        '            dst_path = dst.path.show if dst is not None else '
        '"/unidentified"\n',
        '            dst_path = "/svc" if dst is not None else '
        '"/unidentified"\n')],
    "no_grpc_status": [(
        "linkerd_tpu_torch/grpc/status.py",
        '    def to_trailers(self) -> Trailers:\n'
        '        items: List[Tuple[str, str]] = [("grpc-status", '
        'str(self.code))]\n',
        '    def to_trailers(self) -> Trailers:\n'
        '        items: List[Tuple[str, str]] = []\n')],
    "no_h2_recorder": [(
        "linkerd_tpu_torch/linker.py",
        "        for t in self.telemeters:\n"
        "            if hasattr(t, \"recorder\"):\n"
        "                server_filters.append(t.recorder())\n"
        "        server_filters.append(H2ErrorResponder())\n",
        "        server_filters.append(H2ErrorResponder())\n")],
}


# Broken copies of the port that the h2fast phase must catch: the
# controller dropping the h2 engine's rows instead of feeding the
# telemeter's ring; the mesh interpreter keeping the first bound tree and
# ignoring every streamed update; the linker leaving the h2 engine's
# flood caps at their defaults.
H2FAST_MUTANTS = {
    "h2_rows_dropped": [(
        "linkerd_tpu_torch/router/fastpath.py",
        '        sinks = [t for t in self.telemeters\n'
        '                 if getattr(t, "native_ring", None) is not None]\n',
        '        sinks = [t for t in self.telemeters\n'
        '                 if getattr(t, "native_ring", None) is not None\n'
        '                 and self.engine._PREFIX != "fph2"]\n')],
    "mesh_frozen": [(
        "linkerd_tpu_torch/interpreter/mesh.py",
        "                    act.update(Ok(tree))\n",
        "                    if not isinstance(act.current, Ok):\n"
        "                        act.update(Ok(tree))\n")],
    "no_flood_guard": [(
        "linkerd_tpu_torch/linker.py",
        "                engine.set_flood_guard(\n",
        "                (lambda **kw: None)(\n")],
}
# Broken copies of the port that the mux phase must catch: the thrift
# server zeroing each reply's seqid; the mux router's bound layer sending
# the caller's logical dest instead of the bound residual; the thrift
# namerd interpreter keeping the first bound tree and ignoring every
# stamped update; the http router's recorder left off (config 3 then
# records no row).
MUX_MUTANTS = {
    "seqid_dropped": [(
        "linkerd_tpu_torch/protocol/thrift/server.py",
        "                if call.oneway or reply is None:\n"
        "                    return None\n",
        "                if call.oneway or reply is None:\n"
        "                    return None\n"
        "                from linkerd_tpu_torch.protocol.thrift.binary "
        "import header_len\n"
        "                h = header_len(reply)\n"
        "                reply = reply[:h - 4] + bytes(4) + reply[h:]\n")],
    "logical_dest": [(
        "linkerd_tpu_torch/linker.py",
        "                    td.tag, td.contexts, self._dest, [], "
        "td.payload,\n",
        "                    td.tag, td.contexts, td.dest, [], "
        "td.payload,\n")],
    "thrift_interp_frozen": [(
        "linkerd_tpu_torch/interpreter/namerd_thrift.py",
        "                    act.set_value(tree)\n",
        "                    if not isinstance(act.current, Ok):\n"
        "                        act.set_value(tree)\n")],
    "no_config3_recorder": [(
        "linkerd_tpu_torch/linker.py",
        "        for t in self.telemeters:\n"
        "            if hasattr(t, \"recorder\"):\n"
        "                server_filters.append(t.recorder())\n"
        "        # protocol-surgery filters",
        "        # protocol-surgery filters")],
}
# Broken copies of the port that the k8s phase must catch: the k8s namer
# dropping MODIFIED events (a restart never leaves the binding); the
# istio telemeter reporting nothing; the istio interpreter giving every
# branch of a route rule the same weight; the configMap interpreter
# never reading the ConfigMap after its first list.
K8S_MUTANTS = {
    "watch_ignored": [(
        "linkerd_tpu_torch/k8s/namer.py",
        '            if t in ("ADDED", "MODIFIED"):\n',
        '            if t == "ADDED":\n')],
    "no_mixer_report": [(
        "linkerd_tpu_torch/istio/telemeter.py",
        "            self.telemeter.enqueue_report(\n",
        "            (lambda **kw: None)(\n")],
    "istio_weights_ignored": [(
        "linkerd_tpu_torch/istio/interpreter.py",
        "        branches.append(Weighted(float(wd.weight), Leaf(dst_path)))\n",
        "        branches.append(Weighted(1.0, Leaf(dst_path)))\n")],
    "configmap_frozen": [(
        "linkerd_tpu_torch/interpreter/k8s_configmap.py",
        '        self._on_obj(evt.get("object") or {})\n',
        "        return\n")],
}
# Broken copies of the port that the edge phase must catch: the tag
# filter stamping no tenant hash (no sub-limit can apply); the engine
# binding's quota push doing nothing; the transforming namer handing back
# its inner tree; the file request logger writing nothing; the linker's
# close() withdrawing no announcement.
EDGE_MUTANTS = {
    "tenant_untagged": [(
        "linkerd_tpu_torch/router/tenancy.py",
        '            req.ctx["tenant_hash"] = tenant_hash(tenant)\n', "")],
    "quota_not_pushed": [(
        "linkerd_tpu_torch/native/__init__.py",
        '        fn = getattr(self._lib, self._PREFIX + "_set_tenant_quota")\n',
        "        return\n")],
    "transformer_dropped": [(
        "linkerd_tpu_torch/namer/transformers.py",
        "        for t in self._transformers:\n"
        "            act = act.map(t.transform_tree)\n", "")],
    "file_logger_silent": [(
        "linkerd_tpu_torch/protocol/http/loggers.py",
        "            self._emit(json.dumps({\n",
        "            (lambda line: None)(json.dumps({\n")],
    "announce_kept": [(
        "linkerd_tpu_torch/linker.py",
        "        for c in self._announcements:\n            c.close()\n",
        "        for c in self._announcements:\n            pass\n")],
}
# Broken copies of the port that the sidecar phase must catch: the
# client's Score reply losing its last row (A); the pool trying one
# replica a call, with no failover (C, one replica killed); the breaker
# never opening (C, both killed); the tiered scorer sending fits to the
# sidecar tier while its primary is down (D); a promotion pushed to no
# replica (E).
SIDECAR_MUTANTS = {
    "reply_row_dropped": [(
        "linkerd_tpu_torch/telemetry/sidecar.py",
        '        rsp = await self._bucketed("Score", len(x), payload)\n',
        '        rsp = (await self._bucketed("Score", len(x), payload))'
        '[:-4]\n')],
    "pool_no_failover": [(
        "linkerd_tpu_torch/fleet/scorer_pool.py",
        "        for _ in range(2):\n            addr = self._pick(",
        "        for _ in range(1):\n            addr = self._pick(")],
    "breaker_never_opens": [(
        "linkerd_tpu_torch/telemetry/resilience.py",
        "                and self._consecutive >= self.failures:\n",
        "                and self._consecutive >= self.failures + 10 ** 9:\n")],
    "fit_to_fallback": [(
        "linkerd_tpu_torch/telemetry/linerate.py",
        "        if not admitted:\n            raise ScorerUnavailable(\n"
        "                \"fit skipped: in-process primary breaker open \"\n",
        "        if not admitted:\n"
        "            return await self.fallback.fit(x, labels, mask)\n"
        "            raise ScorerUnavailable(\n"
        "                \"fit skipped: in-process primary breaker open \"\n")],
    "no_fleet_push": [(
        "linkerd_tpu_torch/telemetry/anomaly.py",
        "                self._maybe_push_fleet_model()\n", "")],
}
# Broken copies of the port that the discovery phase must catch: the
# consul namer keeping its first answer whatever the index says (A's
# consul change never shows); the serverset namer keeping members that
# were removed (B: the killed linkerd's addresses stay, and requests to
# them fail); the /config-check.json handler dropping dtab-shadowed
# findings (C: the planted CLI's rule ids).
DISCOVERY_MUTANTS = {
    "consul_first_answer": [(
        "linkerd_tpu_torch/consul/namer.py",
        "                self.addr.update(_entries_to_addr(entries, "
        "self._prefer))\n",
        "                if not self.seen.sample():\n"
        "                    self.addr.update(_entries_to_addr(\n"
        "                        entries, self._prefer))\n")],
    "serverset_keeps_removed": [(
        "linkerd_tpu_torch/namer/zk.py",
        "            addr = Bound(frozenset(addresses))\n",
        "            old = var.sample() if var is not None else None\n"
        "            addr = Bound(frozenset(addresses) | (\n"
        "                old.addresses if isinstance(old, Bound)\n"
        "                else frozenset()))\n")],
    "check_drops_shadowed": [(
        "linkerd_tpu_torch/admin/handlers.py",
        "        unsuppressed = [f for f in findings if not f.suppressed]\n",
        "        unsuppressed = [f for f in findings if not f.suppressed\n"
        "                        and f.rule != \"dtab-shadowed\"]\n")],
}
EDIT_MUTANTS = {**CLI_MUTANTS, **FASTPATH_MUTANTS, **H2_MUTANTS,
                **H2FAST_MUTANTS, **MUX_MUTANTS, **K8S_MUTANTS,
                **EDGE_MUTANTS, **SIDECAR_MUTANTS, **DISCOVERY_MUTANTS}


def run_check(which: str) -> int:
    """One agreement check alone (or the telemeter or linker phase), against the
    kernel this checkout builds: exits non-zero with an AssertionError
    if it disagrees."""
    from linkerd_tpu_torch.models.anomaly import AnomalyModelConfig

    cfg = AnomalyModelConfig(recon_weight=0.7)
    rng = np.random.default_rng(0)
    if which == "kernel":
        check_kernel(cfg, rng)
    elif which == "served":
        asyncio.run(drive_service(cfg, rng))
    elif which in ("linker", "fastpath", "fastpath_d", "control", "cli",
                   "h2", "h2fast", "mux", "k8s", "edge", "sidecar",
                   "discovery"):
        from linkerd_tpu_torch import native
        from linkerd_tpu_torch.native import _build as native_build
        from linkerd_tpu_torch.ops import _build

        _build.build("score_mlp")  # before the event loop serves
        if which.startswith("fastpath") or which in ("h2fast", "edge",
                                                      "discovery"):
            native.ensure_built()
            native_build.build("h2bench")
        phase = {"linker": linker_phase, "fastpath": fastpath_phase,
                 "fastpath_d": lambda: fastpath_phase(parts=("D",)),
                 "control": control_phase, "cli": cli_phase,
                 "h2": h2_phase, "h2fast": h2fast_phase,
                 "mux": mux_phase, "k8s": k8s_phase,
                 "edge": edge_phase, "sidecar": sidecar_phase,
                 "discovery": disco_phase}[which]
        res, _ = asyncio.run(phase())
        name, _, limit = card_line().partition(",")
        print(json.dumps({which: res, "card": name.strip(),
                          "power_limit": limit.strip()}))
    else:
        asyncio.run(telemeter_phase(cfg))
    return 0


def repeat_control_a(n: int, seed: int = 12) -> int:
    """The control phase's part A ``n`` times over one
    ``control_topology``: one line of weight margins a run, then their
    spread; non-zero if a run failed."""
    from linkerd_tpu_torch.ops import _build

    _build.build("score_mlp")  # before the event loop serves
    print(card_line())
    keys = ("weight_margin", "instant_weight_margin_min",
            "end_weight_margin", "steady_weight_samples", "calm_score_p50")

    async def runs():
        out = []
        async with control_topology(seed) as (loads, flag, plans, disco,
                                              namerd_port):
            for i in range(n):
                try:
                    res, _ = await control_part(
                        "A", control_config(namerd_port, False), loads,
                        flag, plans, disco, namerd_port, "cuda")
                except AssertionError as e:
                    out.append({"run": i, "failed": str(e)[:300]})
                else:
                    out.append({"run": i, **{k: res[k] for k in keys}})
                print(json.dumps(out[-1]), flush=True)
        return out

    out = asyncio.run(runs())
    ok = [r for r in out if "failed" not in r]
    print(json.dumps({"runs": n, "passed": len(ok), **{
        k: [min(r[k] for r in ok), max(r[k] for r in ok)] if ok else None
        for k in keys[:3]}, "instant_inverted": sum(
            r["instant_weight_margin_min"] <= 0 for r in ok),
        "end_inverted": sum(r["end_weight_margin"] <= 0 for r in ok)}))
    return 0 if len(ok) == n else 1


def repeat_control_b(n: int, seed: int = 12) -> int:
    """The control phase's part B ``n`` times over one
    ``control_topology``: a line a run with its events and each reactor
    step's highest level from the oscillation on (s from the fault), the
    gaps over 0.25 s between steps, and the full collections' ms; or its
    failure; then how many passed. Non-zero if a run failed."""
    from linkerd_tpu_torch.ops import _build

    _build.build("score_mlp")  # before the event loop serves
    print(card_line())

    async def runs():
        out = []
        async with control_topology(seed) as (loads, flag, plans, disco,
                                              namerd_port):
            for i in range(n):
                try:
                    res, _ = await control_part(
                        "B", control_config(namerd_port, True), loads,
                        flag, plans, disco, namerd_port, "cuda")
                except AssertionError as e:
                    out.append({"run": i, "failed": str(e)[:4000]})
                else:
                    osc = res["events_s"]["osc"]
                    trace = res["level_trace"]
                    out.append({
                        "run": i, "events_s": res["events_s"],
                        "levels": {k: res["levels"][k] for k in (
                            "recovery", "settle", "oscillation", "after")},
                        "from_oscillation": [
                            s for s in trace if s[0] >= osc],
                        "step_gaps": [
                            (a[0], round(b[0] - a[0], 3))
                            for a, b in zip(trace, trace[1:])
                            if b[0] - a[0] > 0.25],
                        "gc_full_ms": res["gc_full_ms"]})
                print(json.dumps(out[-1]), flush=True)
        return out

    out = asyncio.run(runs())
    ok = [r for r in out if "failed" not in r]
    print(json.dumps({"runs": n, "passed": len(ok)}))
    return 0 if len(ok) == n else 1


def copy_with(tmp: Path, name: str, line: str, replacement: str) -> Path:
    """A copy of this checkout under ``tmp/name`` whose kernel source
    has ``line`` (found exactly once) replaced."""
    return copy_with_edits(tmp, name, [(KERNEL_SOURCE, line, replacement)])


def copy_with_edits(tmp: Path, name: str, edits) -> Path:
    """A copy of this checkout under ``tmp/name`` with each ``(file,
    text, replacement)`` of ``edits`` made (``text`` found exactly once
    in ``file``)."""
    shutil.copytree(ROOT, tmp / name, ignore=shutil.ignore_patterns(
        "_build", "_tree", ".git", "__pycache__", "chiprun_out"))
    for rel, line, replacement in edits:
        src = tmp / name / rel
        text = src.read_text()
        if text.count(line) != 1:
            raise AssertionError(f"{name}: text not found once in {rel}: "
                                 f"{line}")
        src.write_text(text.replace(line, replacement))
    return tmp / name


def run_mutant(name: str, which: str, tmp: Path):
    """``--check which`` in the copy of this checkout at ``tmp/name``;
    returns (name, which, exit code, last line of its errors)."""
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py", "--check", which],
        cwd=tmp / name, capture_output=True, text=True, timeout=900)
    last = (proc.stderr.strip().splitlines() or [""])[-1]
    return name, which, proc.returncode, last


def caught(rc: int, last: str) -> bool:
    """A check catches a mutant by its own assertion: a build failure or
    a crash is not a catch."""
    return rc != 0 and last.startswith("AssertionError")


def check_mutant(name: str, which: str) -> int:
    """One mutant through one check (``--check`` names it), which must
    fail by its own assertion."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        if name in EDIT_MUTANTS:
            copy_with_edits(tmp, name, EDIT_MUTANTS[name])
        else:
            copy_with(tmp, name, *MUTANTS[name])
        _, _, rc, last = run_mutant(name, which, tmp)
    print(f"mutant {name}, {which} check: "
          f"{'caught' if caught(rc, last) else 'MISSED'}: {last}")
    if not caught(rc, last):
        raise AssertionError(f"the {which} check missed mutant {name}")
    return 0


def check_mutants() -> int:
    """Every check must fail on every mutant, and the linker, fastpath
    and control phases on LINKER_MUTANT, by its own assertion (a build
    failure or a crash is not a catch)."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for name, (line, broken) in MUTANTS.items():
            copy_with(tmp, name, line, broken)
        for name, edits in EDIT_MUTANTS.items():
            copy_with_edits(tmp, name, edits)
        # kernel checks in parallel (each builds its mutant), then the
        # served checks on the built libraries
        with ThreadPoolExecutor(len(MUTANTS)) as pool:
            results = list(pool.map(lambda n: run_mutant(n, "kernel", tmp),
                                    MUTANTS))
        results += [run_mutant(n, "served", tmp) for n in MUTANTS]
        results += [run_mutant(LINKER_MUTANT, phase, tmp)
                    for phase in ("linker", "fastpath", "control", "cli",
                                  "h2", "h2fast", "mux", "k8s", "edge",
                                  "sidecar", "discovery")]
        results += [run_mutant(name, "cli", tmp) for name in CLI_MUTANTS]
        results += [run_mutant(name, "fastpath_d", tmp)
                    for name in FASTPATH_MUTANTS]
        results += [run_mutant(name, "h2", tmp) for name in H2_MUTANTS]
        results += [run_mutant(name, "h2fast", tmp)
                    for name in H2FAST_MUTANTS]
        results += [run_mutant(name, "mux", tmp) for name in MUX_MUTANTS]
        results += [run_mutant(name, "k8s", tmp) for name in K8S_MUTANTS]
        results += [run_mutant(name, "edge", tmp) for name in EDGE_MUTANTS]
        results += [run_mutant(name, "sidecar", tmp)
                    for name in SIDECAR_MUTANTS]
        results += [run_mutant(name, "discovery", tmp)
                    for name in DISCOVERY_MUTANTS]
    missed = []
    for name, which, rc, last in results:
        print(f"mutant {name}, {which} check: "
              f"{'caught' if caught(rc, last) else 'MISSED'}: {last}")
        if not caught(rc, last):
            missed.append(f"{name}/{which}")
    if missed:
        raise AssertionError(f"checks missed mutants: {missed}")
    print(json.dumps({"mutants": len(MUTANTS), "checks": len(results),
                      "caught": len(results)}))
    return 0


def time_rows(cfg, rng, packed, params, mu, var, plain: bool):
    """Median device ms of the kernel (and, with ``plain``, of its plain
    version) at each of TIMED_ROWS, with the bound of that work."""
    import torch

    from linkerd_tpu_torch.ops.scoring import (
        fused_anomaly_scores, fused_anomaly_scores_plain,
    )

    by_rows = {}
    for n in TIMED_ROWS:
        x = torch.tensor(make_inputs(rng, n, mu.cpu().numpy(),
                                     var.cpu().numpy()), device="cuda")
        row = {"ms": device_ms(lambda: fused_anomaly_scores(packed, x, cfg,
                                                            mu, var))}
        if plain:
            row["plain_ms"] = device_ms(lambda: fused_anomaly_scores_plain(
                params, x, cfg, mu, var))
        row["bound_ms"], row["bound_by"] = bound_ms(packed.params, n,
                                                    cfg.in_dim)
        by_rows[n] = row
    return by_rows


def run_timing(check: bool) -> int:
    """The kernel timed at TIMED_ROWS, after the kernel check when
    ``check``; prints one JSON line."""
    import torch

    from linkerd_tpu_torch.models.anomaly import AnomalyModelConfig
    from linkerd_tpu_torch.models.convert import params_from_numpy
    from linkerd_tpu_torch.ops.scoring import pack_params

    cfg = AnomalyModelConfig(recon_weight=0.7)
    rng = np.random.default_rng(0)
    if check:
        worst, params, packed, mu, var = check_kernel(cfg, rng)
    else:
        worst = None
        params = params_from_numpy(random_params(0, cfg), "cuda")
        packed = pack_params(params, cfg)
        mu_h, var_h = make_stats(rng, cfg.in_dim)
        mu, var = torch.tensor(mu_h, device="cuda"), torch.tensor(
            var_h, device="cuda")
    print(json.dumps({"max_abs_err": worst, "by_rows": time_rows(
        cfg, rng, packed, params, mu, var, plain=False)}))
    return 0


def sweep() -> int:
    """The kernel's row tiles and breakdown variants, built in parallel
    in temporary copies, then timed one after another."""
    text = (ROOT / KERNEL_SOURCE).read_text()
    current = [t for t in TILES if ROWS_LINE.format(t) in text]
    if len(current) != 1:
        raise AssertionError("the kernel's ROWS line is not one of TILES")
    variants = {f"rows{t}": (ROWS_LINE.format(current[0]),
                             ROWS_LINE.format(t), True) for t in TILES}
    variants.update({k: (a, b, False) for k, (a, b) in BREAKDOWN.items()})
    build = [sys.executable, "-c", "from linkerd_tpu_torch.ops import "
             "_build; _build.build('score_mlp')"]
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        dirs = {k: copy_with(tmp, k, a, b) for k, (a, b, _) in
                variants.items()}
        procs = {k: subprocess.Popen(build, cwd=d) for k, d in dirs.items()}
        if any(p.wait(timeout=600) for p in procs.values()):
            raise AssertionError("a variant of the kernel did not build")
        for k, d in dirs.items():
            ptxas = next((d / "linkerd_tpu_torch/ops/_build").glob(
                "*.ptxas.txt")).read_text()
            mode = "--time" if variants[k][2] else "--time-only"
            proc = subprocess.run(
                [sys.executable, "chip_smoke.py", mode], cwd=d,
                capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"{k}: {proc.stderr[-2000:]}")
            results[k] = json.loads(proc.stdout.strip().splitlines()[-1])
            results[k]["ptxas"] = [ln.strip() for ln in ptxas.splitlines()
                                   if "registers" in ln or "spill" in ln]
            err = results[k]["max_abs_err"]
            print(f"{k}: " + ", ".join(
                f"n={n} {r['ms']:.4f} ms"
                for n, r in results[k]["by_rows"].items())
                + ("" if err is None else f"; max|diff| {err:.3e}"))
    print(json.dumps({"card": card_line(), "variants": results}))
    return 0


SASS_OPS = ("DMMA", "LDS", "UBLKCP", "LDGSTS", "SYNCS", "BAR.SYNC")
SASS_NEEDED = ("DMMA", "UBLKCP", "LDGSTS")  # tensor cores, staged copies


def sass_summary(lib: Path):
    """Counts of the kernel's tensor-core, shared-memory, copy and
    barrier instructions (cuobjdump -sass), with a line of each needed
    one; raises if one of SASS_NEEDED is missing. None where cuobjdump
    is not installed."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout.splitlines()
    counts = {op: sum(f" {op}" in ln for ln in sass) for op in SASS_OPS}
    missing = [op for op in SASS_NEEDED if not counts[op]]
    if missing:
        raise AssertionError(f"kernel SASS lacks {missing}: {counts}")
    excerpt = [next(ln.split("/*")[1].split("*/")[1].strip()
                    for ln in sass if f" {op}" in ln) for op in SASS_NEEDED]
    return {"counts": counts, "excerpt": excerpt}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "linkerd_tpu_torch" / "ops" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    # the plain reference runs its float32 products in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = sys.argv[1:]
    if args == ["--mutants"]:
        return check_mutants()
    if args == ["--sweep"]:
        return sweep()
    if args in (["--time"], ["--time-only"]):
        return run_timing(check=args == ["--time"])
    if args == ["--witness"]:
        return run_witness()
    if len(args) == 2 and args[0] == "--repeat-control-a" and \
            args[1].isdigit():
        return repeat_control_a(int(args[1]))
    if len(args) == 2 and args[0] == "--repeat-control-b" and \
            args[1].isdigit():
        return repeat_control_b(int(args[1]))
    if len(args) == 2 and args[0] == "--check" and \
            args[1] in CHECKS + PHASES:
        return run_check(args[1])
    if len(args) == 3 and args[0] == "--mutant" and \
            args[1] in (*MUTANTS, *EDIT_MUTANTS) and \
            args[2] in CHECKS + PHASES:
        return check_mutant(args[1], args[2])
    if args:
        print(f"chip_smoke: unknown arguments {args}", file=sys.stderr)
        return 2

    from linkerd_tpu_torch.models.anomaly import AnomalyModelConfig
    from linkerd_tpu_torch.native import _build as native_build
    from linkerd_tpu_torch.ops import _build
    from linkerd_tpu_torch.ops.scoring import fused_anomaly_scores

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    t_smoke, phase_s = time.perf_counter(), {}

    def run_phase(name: str, coro):
        t = time.perf_counter()
        try:
            return asyncio.run(coro)
        finally:
            phase_s[name] = time.perf_counter() - t
            print(f"{name} phase: {phase_s[name]:.1f} s", flush=True)

    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # g++ beside nvcc
        engine = [pool.submit(native_build.build, t)
                  for t in ("engine", "h2bench")]
        lib = _build.build("score_mlp")
        print(f"build score_mlp.cu: {time.perf_counter() - t0:.2f} s")
        for f in engine:
            f.result()
    print(f"build the native engine and h2bench: "
          f"{time.perf_counter() - t0:.2f} s")
    ptxas = lib.with_suffix(".ptxas.txt").read_text().strip()
    print(ptxas)
    spills = [ln for ln in ptxas.splitlines()
              if "spill" in ln and " 0 bytes spill stores, 0 bytes spill "
              "loads" not in ln]
    if spills:
        raise AssertionError(f"ptxas reports spills: {spills}")
    sass = sass_summary(lib)
    print("SASS: not measured (no cuobjdump)" if sass is None else
          f"SASS: {sass['counts']}\n  " + "\n  ".join(sass["excerpt"]))

    rng = np.random.default_rng(0)
    cfg = AnomalyModelConfig(recon_weight=0.7)
    max_err, params, packed, mu, var = check_kernel(cfg, rng)

    fused_anomaly_scores.launches = 0
    batches, served_err = asyncio.run(drive_service(cfg, rng))
    launches = fused_anomaly_scores.launches
    print(f"main path: {batches} batches, {launches} kernel launches, "
          f"served max|diff| vs plain {served_err:.3e}")
    if launches != batches:
        raise AssertionError(
            f"{batches} batches scored but the kernel launched {launches}")

    by_rows = time_rows(cfg, rng, packed, params, mu, var, plain=True)
    for n, r in by_rows.items():
        print(f"kernel n={n}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    h2d, d2h = copy_ms(1024, cfg.in_dim)
    print(f"copies of a 1024-row batch, each timed alone: h2d {h2d:.4f} "
          f"ms, d2h {d2h:.4f} ms")
    service = run_phase("service", time_service(cfg, rng))
    train, train_launches = run_phase("train", train_phase(cfg, rng))
    distill, distill_launches = run_phase("distill", distill_phase(cfg))
    telemeter, telemeter_launches = run_phase("telemeter",
                                              telemeter_phase(cfg))
    linker, linker_launches = run_phase("linker", linker_phase())
    fastpath, fastpath_launches = run_phase("fastpath", fastpath_phase())
    control, control_launches = run_phase("control", control_phase(
        linker_a=linker["part_a"]))
    cli, cli_launches = run_phase("cli", cli_phase(
        linker_a=linker["part_a"]))
    h2, h2_launches = run_phase("h2", h2_phase())
    h2fast, h2fast_launches = run_phase("h2fast", h2fast_phase())
    mux, mux_launches = run_phase("mux", mux_phase())
    k8s, k8s_launches = run_phase("k8s", k8s_phase())
    edge, edge_launches = run_phase("edge", edge_phase())
    sidecar, sidecar_launches = run_phase("sidecar", sidecar_phase(
        service_rows_per_s=service["rows_per_s"]))
    discovery, discovery_launches = run_phase("discovery", disco_phase())
    telemeter["recorder"] = recorder_us()
    print(f"recorder filter: {telemeter['recorder']['recorder_us']:.2f} us "
          f"a request, the downstream alone "
          f"{telemeter['recorder']['downstream_alone_us']:.2f} us")
    service["h2d_alone_ms"], service["d2h_alone_ms"] = h2d, d2h
    print(f"service: {service['rows_per_s']:.0f} rows/s at 1024-row "
          f"batches x{IN_FLIGHT} in flight, p50 "
          f"{service['batch_p50_ms']:.3f} ms, p99 "
          f"{service['batch_p99_ms']:.3f} ms")
    if service["device_busy_share"] is None:
        print("under the profiler: not measured (the trace holds no "
              "device event)")
    else:
        print(f"under the profiler: {service['traced_rows_per_s']:.0f} "
              f"rows/s, card busy {service['device_ms_per_batch']:.4f} ms "
              f"a batch, busy share {service['device_busy_share']:.3f}")

    main_rows = by_rows[1024]
    kernels = [{
        "name": "score_mlp",
        "route": "cuda",
        "source": "linkerd_tpu_torch/ops/csrc/score_mlp.cu",
        "replaces": "linkerd_tpu/ops/scoring.py:39",
        "launches": launches,
        "launches_by_phase": dict(serve=launches, **train_launches,
                                  distill=distill_launches,
                                  telemeter=telemeter_launches,
                                  linker=linker_launches,
                                  fastpath=fastpath_launches,
                                  control=control_launches,
                                  cli=cli_launches, h2=h2_launches,
                                  h2fast=h2fast_launches,
                                  mux=mux_launches, k8s=k8s_launches,
                                  edge=edge_launches,
                                  sidecar=sidecar_launches,
                                  discovery=discovery_launches),
        "max_abs_err": max_err,
        "ms": main_rows["ms"],
        "plain_ms": main_rows["plain_ms"],
        "bound_ms": main_rows["bound_ms"],
        "bound_by": main_rows["bound_by"],
        "library_ms": None,
        "rows": 1024,
        "by_rows": by_rows,
    }]
    name, _, limit = card.partition(",")
    smoke_s = time.perf_counter() - t_smoke
    print(f"smoke: {smoke_s:.1f} s after the card line; by phase "
          + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))
    print(json.dumps({"kernels": kernels, "card": name.strip(),
                      "power_limit": limit.strip(), "sass": sass,
                      "service": service, "smoke_s": smoke_s,
                      "phase_s": phase_s}))
    print(json.dumps({"train": train, "card": name.strip(),
                      "power_limit": limit.strip()}))
    print(json.dumps({"distill": distill, "card": name.strip(),
                      "power_limit": limit.strip()}))
    print(json.dumps({"telemeter": telemeter, "card": name.strip(),
                      "power_limit": limit.strip()}))
    print(json.dumps({"linker": linker, "card": name.strip(),
                      "power_limit": limit.strip()}))
    print(json.dumps({"fastpath": fastpath, "card": name.strip(),
                      "power_limit": limit.strip()}))
    print(json.dumps({"control": control, "card": name.strip(),
                      "power_limit": limit.strip()}))
    print(json.dumps({"cli": cli, "card": name.strip(),
                      "power_limit": limit.strip()}))
    print(json.dumps({"h2": h2, "card": name.strip(),
                      "power_limit": limit.strip()}))
    print(json.dumps({"h2fast": h2fast, "card": name.strip(),
                      "power_limit": limit.strip()}))
    print(json.dumps({"mux": mux, "card": name.strip(),
                      "power_limit": limit.strip()}, default=str))
    print(json.dumps({"k8s": k8s, "card": name.strip(),
                      "power_limit": limit.strip()}, default=str))
    print(json.dumps({"edge": edge, "card": name.strip(),
                      "power_limit": limit.strip()}, default=str))
    print(json.dumps({"sidecar": sidecar, "card": name.strip(),
                      "power_limit": limit.strip()}, default=str))
    print(json.dumps({"discovery": discovery, "card": name.strip(),
                      "power_limit": limit.strip()}, default=str))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
