#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # the smoke run
    python3 chip_smoke.py --mutants  # self-test of its agreement checks
    python3 chip_smoke.py --sweep    # the kernel's row tiles and breakdown
    python3 chip_smoke.py --check telemeter  # the telemeter phase alone
    python3 chip_smoke.py --check linker     # the linker phase alone
    python3 chip_smoke.py --mutant one_rounding telemeter  # one mutant, one check

Builds every CUDA kernel of the scoring path from the sources in this
checkout, holds each against its plain PyTorch version on the card,
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
times. Prints the card, a JSON line of kernel and
service numbers, one of the train phase's, one of the distill
phase's, one of the telemeter phase's, one of the linker phase's, and
as its last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero; with no CUDA device, or
outside the repository, it exits non-zero before printing any result.
Imports nothing of JAX.

``--mutants`` builds deliberately broken copies of the kernel in a
temporary copy of the port and runs the kernel and served checks
against each, and the linker phase against ``LINKER_MUTANT``, in a fresh
interpreter; it fails unless every check fails on its mutant.

``--sweep`` builds variants of the kernel in temporary copies and times
each at ``TIMED_ROWS``, one after another on this card: the row tiles
of ``TILES`` (rows a block owns), each checked against plain first, and
the ``BREAKDOWN`` variants, which skip part of the work and so compute
nothing checkable.
"""

from __future__ import annotations

import asyncio
import json
import shutil
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
# Kernel against plain: every score within TOL, and at most ROW_SHARE
# of the rows (pooled over a phase) off by more than ROW_TOL. The two
# round alike and differ only where another summation order tips a
# bf16 activation over a rounding boundary, which moves a few rows in a
# thousand; a kernel that misplaces a rounding point, a bias or the
# float32 input of the error moves nearly every row.
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
TILES = (16, 32, 64)       # rows a block owns, for --sweep


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
    by_id = {id(s): p for (_, s), p in zip(rec.scored, plain)}
    fresh = ScoreBoard(ttl_s=tele.cfg.scoreTtlSecs)
    for dsts, s, eps in rec.folds:
        fresh.update_batch(dsts, by_id[id(s)], endpoints=eps)
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


def linker_backends(conn, dsts, flag, seed: int) -> None:
    """Child process: one HTTP server a replica of each destination index
    in ``dsts``; each answers ``tele-DD/R`` padded to LINKER_BODY bytes.
    While ``flag`` is set, the first TELE_FAULTED destinations inject the
    reference test's faults (LINKER_FAULT_MS, then 503 at
    LINKER_ERROR_RATE), and every response carries the fault label."""
    import random

    from linkerd_tpu_torch.protocol.http.message import Response
    from linkerd_tpu_torch.protocol.http.server import serve
    from linkerd_tpu_torch.router.service import FnService

    rng = random.Random(seed)

    def backend(name: str, faulted: bool):
        body = name.encode().ljust(LINKER_BODY, b"x")

        async def handle(req):
            if faulted and flag.value:
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
        servers = [await serve(backend(f"tele-{d:02d}/{r}", d < TELE_FAULTED))
                   for d in dsts for r in range(LINKER_REPLICAS)]
        conn.send([s.bound_port for s in servers])
        await asyncio.get_running_loop().run_in_executor(None, conn.recv)
        for s in servers:
            await s.close()

    asyncio.run(main())


async def linker_connection(port: int, plan, out: dict, off: int) -> None:
    """One keep-alive connection sending ``plan``'s destinations in turn,
    each by its Host header; stores status, right replica and ms."""
    from linkerd_tpu_torch.protocol.http.client import HttpClient
    from linkerd_tpu_torch.protocol.http.message import Request

    client = HttpClient("127.0.0.1", port, max_connections=1)
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
            out["status"][off + i] = status
            out["right"][off + i] = body.startswith(f"tele-{d:02d}/".encode())
    finally:
        await client.close()


def linker_load(conn) -> None:
    """Child process: on each ``(port, plans)`` from ``conn``, one
    connection a plan, all at once; sends back every request's
    destination, status, whether a replica of its destination answered,
    its ms, and the wall seconds. ``None`` ends it."""
    while True:
        msg = conn.recv()
        if msg is None:
            return
        port, plans = msg
        n = sum(len(p) for p in plans)
        out = {"dst": np.concatenate(plans).astype(np.int16),
               "status": np.zeros(n, np.int16), "right": np.zeros(n, bool),
               "ms": np.zeros(n)}
        offs = np.cumsum([0] + [len(p) for p in plans])

        async def run():
            t0 = time.perf_counter()
            await asyncio.gather(*(linker_connection(port, p, out, int(o))
                                   for p, o in zip(plans, offs)))
            return time.perf_counter() - t0

        out["wall"] = asyncio.run(run())
        conn.send(out)


def linker_plans(rng, n: int):
    """``n`` requests over the destinations, uniform, split over the
    LINKER_CONNS connections."""
    return np.array_split(rng.integers(TELE_ROUTES, size=n), LINKER_CONNS)


async def linker_traffic(loads, port: int, plans) -> dict:
    """The load processes' share of ``plans`` at once; waits for every
    answer off the event loop, so the router keeps serving."""
    loop = asyncio.get_running_loop()
    shares = np.array_split(np.arange(len(plans)), len(loads))
    for (conn, _), idx in zip(loads, shares):
        conn.send((port, [plans[i] for i in idx]))
    outs = await asyncio.gather(*(loop.run_in_executor(None, conn.recv)
                                  for conn, _ in loads))
    res = {k: np.concatenate([o[k] for o in outs])
           for k in ("dst", "status", "right", "ms")}
    res["wall"] = max(o["wall"] for o in outs)
    return res


def linker_traffic_checks(res: dict, what: str, faults_on: bool) -> dict:
    """Every calm request answered 200 by a replica of its destination;
    returns requests/s and ms percentiles."""
    calm = res["dst"] >= (TELE_FAULTED if faults_on else 0)
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
    n = np.array([len(b["x"]) for b in tap.batches])
    return {"batches": len(n), "mean": float(n.mean()),
            **{f"p{q}": float(np.percentile(n, q)) for q in (10, 50, 90, 99)},
            "max": int(n.max())}


def linker_gap_report(got, plain, x, snap, labels, dev: str) -> dict:
    """How kernel and plain scores of the window's rows part: the largest
    gap, the rows past ROW_TOL and 1e-3, and the five widest gaps with
    each row's scores, label and largest z-score; beside it, a witness
    of the same model's plain version on the CPU against the card's
    (another summation order). Fails if more than ROW_SHARE of the rows
    are past ROW_TOL."""
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
    print(f"linker A: kernel vs plain max|diff| {out['kernel_vs_plain_max']:.3e}, "
          f"{out['rows_past_row_tol']} of {len(gap)} rows past {ROW_TOL}, "
          f"{out['rows_past_1e-3']} past 1e-3; the plain version on the CPU "
          f"vs the card's: max {out['cpu_plain_vs_card_plain_max']:.3e}, "
          f"{out['cpu_rows_past_row_tol']} rows past {ROW_TOL}; widest: "
          + "; ".join(f"{w['gap']:.3e} (kernel {w['kernel']:.6f}, plain "
                      f"{w['plain']:.6f}, CPU plain {w['cpu_plain']:.6f}, "
                      f"label {w['label']:.0f}, max|z| {w['max_abs_z']:.1f})"
                      for w in out["widest"]))
    if out["rows_past_row_tol"] > ROW_SHARE * len(gap):
        raise AssertionError(
            f"linker A: kernel vs plain: {out['rows_past_row_tol']} of "
            f"{len(gap)} rows past {ROW_TOL} > {ROW_SHARE:.0%}")
    return out


def linker_board_check(tele, tap, start: int, plain_by_id: dict) -> float:
    """The board against a fresh ScoreBoard folded in the same order: with
    the kernel's scores before fold ``start`` and the plain version's
    from it on. Returns the largest gap."""
    from linkerd_tpu_torch.telemetry.anomaly import ScoreBoard

    fresh = ScoreBoard(ttl_s=tele.cfg.scoreTtlSecs)
    for i, (dsts, s, eps) in enumerate(tap.folds):
        fresh.update_batch(dsts, s if i < start else plain_by_id[id(s)],
                           endpoints=eps)
    got, want = tele.board.scores.sample(), fresh.scores.sample()
    got_ep, want_ep = (tele.board.effective_endpoint_scores(),
                       fresh.effective_endpoint_scores())
    if sorted(got) != sorted(want) or sorted(got_ep) != sorted(want_ep):
        raise AssertionError("linker A: board keys differ from the fold")
    return max(max(abs(got[k] - want[k]) for k in got),
               max(abs(got_ep[k] - want_ep[k]) for k in got_ep))


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
        flat = tele.metrics.flatten()
        bad = {k: flat[f"anomaly/{k}"] for k in (
            "score_failures", "dropped_batches", "degraded")
            if flat[f"anomaly/{k}"]}
        recorded, scored = flat["anomaly/requests_total"], \
            flat["anomaly/scored_total"]
        drops = recorded - scored - len(tele.ring)
        sent = len(warm["ms"]) + len(window["ms"])
        print(f"linker {part}: {sent} requests, {recorded} recorded, "
              f"{scored} scored, ring drops {drops}")
        if bad or drops or scored != recorded or recorded != sent:
            raise AssertionError(
                f"linker {part}: {sent} sent, {recorded} recorded, {scored} "
                f"scored, {drops} dropped, {bad}")
        batches = flat["anomaly/batches"]
        expect = 0 if dev == "cpu" else batches
        if launches != expect or len(tap.scored) != batches:
            raise AssertionError(
                f"linker {part}: {launches} kernel launches, {batches} "
                f"batches, {len(tap.scored)} score calls")
        pub = np.asarray(tap.publish_ms)
        out.update(launches=launches, batches=batches,
                   batch_sizes=batch_sizes(tap),
                   score_and_publish_p50_ms=float(np.percentile(pub, 50)),
                   score_and_publish_p99_ms=float(np.percentile(pub, 99)))
        routes = tele_routes()
        board = {d: tele.board.score_of(d) for d in routes}
        faulted = routes[:TELE_FAULTED]
        out["board_levels"] = {
            "faulted_min": min(board[d] for d in faulted),
            "calm_max": max(board[d] for d in routes[TELE_FAULTED:])}
        if part == "A":
            xs = [x for x, _ in tap.scored[start:]]
            got = np.concatenate([s for _, s in tap.scored[start:]])
            plain = plain_scores(snap, np.concatenate(xs), dev)
            cuts = np.cumsum([len(x) for x in xs])[:-1]
            plain_by_id = {id(s): p for (_, s), p in zip(
                tap.scored[start:], np.split(plain, cuts))}
            gap = linker_board_check(tele, tap, start, plain_by_id)
            print(f"linker A: board vs plain fold {gap:.3e}")
            if gap > TOL:
                raise AssertionError(f"linker A: board off the plain fold "
                                     f"by {gap} > {TOL}")
            wb = tap.batches[first:]
            rows = linker_gap_report(
                got, plain, np.concatenate(xs), snap,
                np.concatenate([b["labels"] for b in wb]), dev)
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
            out.update(board_vs_plain_fold_max=gap, kernel_vs_plain=rows,
                       kernel_vs_plain_max=rows["kernel_vs_plain_max"],
                       window_rows=len(got), positives=int(labels.sum()),
                       auc=got_auc)
        if part == "B":
            ports = linker_endpoints(linker)
            removed = {f"{d}/{r}": accrual.removals.get(p, [])
                       for (d, r), p in ports.items()}
            bad_calm = {k: v for k, v in removed.items()
                        if v and k.rsplit("/", 1)[0] not in faulted}
            kept = [k for k, v in removed.items()
                    if not v and k.rsplit("/", 1)[0] in faulted]
            if bad_calm or kept:
                raise AssertionError(f"linker B: calm endpoints removed "
                                     f"{bad_calm}; faulted kept {kept}")
            out["failures_before_first_removal"] = {
                k: v[0] for k, v in removed.items() if v}
            out["removals"] = {k: len(v) for k, v in removed.items() if v}
        return out, launches
    finally:
        if accrual is not None:
            accrual.close()
        if task is not None:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
        await linker.close()


def linker_stages(linker) -> dict:
    """The router's own ms over the part (warm-up and window), from its
    metrics: the server's request latency and the stage timer's
    identification, binding, service and total, p50 and p99 each."""
    flat = linker.metrics.flatten()
    out = {}
    for name, key in (("server", "rt/tele/server/request_latency_ms"),
                      *((s, f"rt/tele/stage/{s}_ms") for s in (
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


async def linker_phase(seed: int = 12, dev: str = "cuda"):
    """Backends and load clients in child processes (spawn), then parts A
    (failure accrual none, training during the warm-up only), B
    (io.l5d.jaxAnomaly accrual at the reference's cadence) and C (no
    telemetry block: the router's own cost) on the same traffic. Returns
    the results and the kernel's launches on parts A and B."""
    import multiprocessing

    mp = multiprocessing.get_context("spawn")
    flag = mp.RawValue("b", 0)
    rng = np.random.default_rng(seed)
    plans = (linker_plans(rng, LINKER_WARMUP), linker_plans(rng, LINKER_WINDOW))
    loop = asyncio.get_running_loop()
    procs, backs, loads = [], [], []
    try:
        for i, dsts in enumerate(np.array_split(np.arange(TELE_ROUTES),
                                                LINKER_BACKEND_PROCS)):
            ours, theirs = mp.Pipe()
            p = mp.Process(target=linker_backends, daemon=True,
                           args=(theirs, dsts.tolist(), flag, seed + i))
            p.start()
            procs.append(p)
            backs.append((ours, dsts))
        for _ in range(LINKER_LOAD_PROCS):
            ours, theirs = mp.Pipe()
            p = mp.Process(target=linker_load, args=(theirs,), daemon=True)
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
            res = {}
            res["part_a"], la = await linker_part(
                "A", linker_config(disco, True, "none", 1), loads, flag,
                plans, dev)
            res["part_b"], lb = await linker_part(
                "B", linker_config(disco, True, "io.l5d.jaxAnomaly", 8),
                loads, flag, plans, dev)
            res["no_telemetry"], _ = await linker_part(
                "C", linker_config(disco, False, "none", 0), loads, flag,
                plans, dev)
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
LINKER_MUTANT = "one_rounding"  # ... and, on this one, the linker phase
PHASES = ("telemeter", "linker")  # phases --check and --mutant also take


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
    elif which == "linker":
        from linkerd_tpu_torch.ops import _build

        _build.build("score_mlp")  # before the event loop serves
        linker, _ = asyncio.run(linker_phase())
        name, _, limit = card_line().partition(",")
        print(json.dumps({"linker": linker, "card": name.strip(),
                          "power_limit": limit.strip()}))
    else:
        asyncio.run(telemeter_phase(cfg))
    return 0


def copy_with(tmp: Path, name: str, line: str, replacement: str) -> Path:
    """A copy of this checkout under ``tmp/name`` whose kernel source
    has ``line`` (found exactly once) replaced."""
    shutil.copytree(ROOT, tmp / name, ignore=shutil.ignore_patterns(
        "_build", "_tree", ".git", "__pycache__"))
    src = tmp / name / KERNEL_SOURCE
    text = src.read_text()
    if text.count(line) != 1:
        raise AssertionError(f"{name}: line not found once: {line}")
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
        copy_with(tmp, name, *MUTANTS[name])
        _, _, rc, last = run_mutant(name, which, tmp)
    print(f"mutant {name}, {which} check: "
          f"{'caught' if caught(rc, last) else 'MISSED'}: {last}")
    if not caught(rc, last):
        raise AssertionError(f"the {which} check missed mutant {name}")
    return 0


def check_mutants() -> int:
    """Every check must fail on every mutant, and the linker phase on
    LINKER_MUTANT, by its own assertion (a build failure or a crash is
    not a catch)."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for name, (line, broken) in MUTANTS.items():
            copy_with(tmp, name, line, broken)
        # kernel checks in parallel (each builds its mutant), then the
        # served checks on the built libraries
        with ThreadPoolExecutor(len(MUTANTS)) as pool:
            results = list(pool.map(lambda n: run_mutant(n, "kernel", tmp),
                                    MUTANTS))
        results += [run_mutant(n, "served", tmp) for n in MUTANTS]
        results.append(run_mutant(LINKER_MUTANT, "linker", tmp))
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


SASS_OPS = ("HMMA", "LDSM", "UBLKCP", "LDGSTS", "SYNCS", "BAR.SYNC")
SASS_NEEDED = ("HMMA", "UBLKCP", "LDGSTS")  # tensor cores, staged copies


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
    if len(args) == 2 and args[0] == "--check" and \
            args[1] in CHECKS + PHASES:
        return run_check(args[1])
    if len(args) == 3 and args[0] == "--mutant" and args[1] in MUTANTS \
            and args[2] in CHECKS + PHASES:
        return check_mutant(args[1], args[2])
    if args:
        print(f"chip_smoke: unknown arguments {args}", file=sys.stderr)
        return 2

    from linkerd_tpu_torch.models.anomaly import AnomalyModelConfig
    from linkerd_tpu_torch.ops import _build
    from linkerd_tpu_torch.ops.scoring import fused_anomaly_scores

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind}")

    t0 = time.perf_counter()
    lib = _build.build("score_mlp")
    print(f"build score_mlp.cu: {time.perf_counter() - t0:.2f} s")
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
    service = asyncio.run(time_service(cfg, rng))
    train, train_launches = asyncio.run(train_phase(cfg, rng))
    distill, distill_launches = asyncio.run(distill_phase(cfg))
    telemeter, telemeter_launches = asyncio.run(telemeter_phase(cfg))
    linker, linker_launches = asyncio.run(linker_phase())
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
                                  linker=linker_launches),
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
    print(json.dumps({"kernels": kernels, "card": name.strip(),
                      "power_limit": limit.strip(), "sass": sass,
                      "service": service}))
    print(json.dumps({"train": train, "card": name.strip(),
                      "power_limit": limit.strip()}))
    print(json.dumps({"distill": distill, "card": name.strip(),
                      "power_limit": limit.strip()}))
    print(json.dumps({"telemeter": telemeter, "card": name.strip(),
                      "power_limit": limit.strip()}))
    print(json.dumps({"linker": linker, "card": name.strip(),
                      "power_limit": limit.strip()}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
