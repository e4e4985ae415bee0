#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # the smoke run
    python3 chip_smoke.py --mutants  # self-test of its agreement checks

Builds every CUDA kernel of the scoring path from the sources in this
checkout, holds each against its plain PyTorch version on the card,
drives the scorer sidecar's request handlers (Restore, Score with
batches in flight, Snapshot) on the exact wire bytes, checks that every
batch went through the kernel, and times the kernel and the service.
Prints the card, a JSON line of kernel and service numbers, and as its
last line ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero; with no CUDA device, or outside the repository, it
exits non-zero before printing any result. Imports nothing of JAX.

``--mutants`` builds deliberately broken copies of the kernel in a
temporary copy of the port and runs the kernel and served checks
against each in a fresh interpreter; it fails unless every check fails
on every mutant.
"""

from __future__ import annotations

import asyncio
import json
import shutil
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
TIMED_ROWS = (1024, 4096)
TIMING_REPS = 60
SERVICE_ROUNDS = 100
TRACED_ROUNDS = 30      # the same load again, under the profiler
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3


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
    the bf16 dense peak for the operations."""
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


# Broken kernels the checks must catch: (line in score_mlp.cu, its
# replacement). A dropped bias, a neighbouring column's bias, one bf16
# rounding of a layer instead of two, the error taken against the bf16
# copy of the input.
KERNEL_SOURCE = "linkerd_tpu_torch/ops/csrc/score_mlp.cu"
MUTANTS = {
    "no_bias": ("const float bj = __bfloat162float(L.b[j]);",
                "const float bj = 0.f;"),
    "neighbour_bias": ("const float bj = __bfloat162float(L.b[j]);",
                       "const float bj = __bfloat162float("
                       "L.b[(j + 1) % L.out]);"),
    "one_rounding": ("round_bf16(round_bf16(acc[r]) + bj)",
                     "round_bf16(acc[r] + bj)"),
    "error_vs_bf16_x": ("s_x[r * MAXW + d] = v;",
                        "s_x[r * MAXW + d] = round_bf16(v);"),
}
CHECKS = ("kernel", "served")


def run_check(which: str) -> int:
    """One agreement check alone, against the kernel this checkout
    builds: exits non-zero with an AssertionError if it disagrees."""
    from linkerd_tpu_torch.models.anomaly import AnomalyModelConfig

    cfg = AnomalyModelConfig(recon_weight=0.7)
    rng = np.random.default_rng(0)
    if which == "kernel":
        check_kernel(cfg, rng)
    else:
        asyncio.run(drive_service(cfg, rng))
    return 0


def check_mutants() -> int:
    """Every check must fail on every mutant, by its own assertion (a
    build failure or a crash is not a catch)."""
    def one(name: str, which: str, tmp: Path):
        proc = subprocess.run(
            [sys.executable, "chip_smoke.py", "--check", which],
            cwd=tmp / name, capture_output=True, text=True, timeout=600)
        last = (proc.stderr.strip().splitlines() or [""])[-1]
        return name, which, proc.returncode, last

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for name, (line, broken) in MUTANTS.items():
            shutil.copytree(ROOT, tmp / name, ignore=shutil.ignore_patterns(
                "_build", "chiprun_out", ".git", "__pycache__"))
            src = tmp / name / KERNEL_SOURCE
            text = src.read_text()
            if text.count(line) != 1:
                raise AssertionError(f"mutant {name}: line not found once")
            src.write_text(text.replace(line, broken))
        # kernel checks in parallel (each builds its mutant), then the
        # served checks on the built libraries
        with ThreadPoolExecutor(len(MUTANTS)) as pool:
            results = list(pool.map(lambda n: one(n, "kernel", tmp), MUTANTS))
        results += [one(n, "served", tmp) for n in MUTANTS]
    missed = []
    for name, which, rc, last in results:
        caught = rc != 0 and last.startswith("AssertionError")
        print(f"mutant {name}, {which} check: "
              f"{'caught' if caught else 'MISSED'}: {last}")
        if not caught:
            missed.append(f"{name}/{which}")
    if missed:
        raise AssertionError(f"checks missed mutants: {missed}")
    print(json.dumps({"mutants": len(MUTANTS), "checks": len(results),
                      "caught": len(results)}))
    return 0


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
    if len(args) == 2 and args[0] == "--check" and args[1] in CHECKS:
        return run_check(args[1])
    if args:
        print(f"chip_smoke: unknown arguments {args}", file=sys.stderr)
        return 2

    from linkerd_tpu_torch.models.anomaly import AnomalyModelConfig
    from linkerd_tpu_torch.ops import _build
    from linkerd_tpu_torch.ops.scoring import (
        fused_anomaly_scores, fused_anomaly_scores_plain,
    )

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind}")

    t0 = time.perf_counter()
    lib = _build.build("score_mlp")
    print(f"build score_mlp.cu: {time.perf_counter() - t0:.2f} s")
    print(lib.with_suffix(".ptxas.txt").read_text().strip())

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

    by_rows = {}
    for n in TIMED_ROWS:
        x = torch.tensor(make_inputs(rng, n, mu.cpu().numpy(),
                                     var.cpu().numpy()), device="cuda")
        k_ms = device_ms(lambda: fused_anomaly_scores(packed, x, cfg,
                                                      mu, var))
        p_ms = device_ms(lambda: fused_anomaly_scores_plain(params, x, cfg,
                                                            mu, var))
        b_ms, b_by = bound_ms(packed.params, n, cfg.in_dim)
        by_rows[n] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                      "bound_by": b_by}
        print(f"kernel n={n}: {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
              f"bound {b_ms:.5f} ms ({b_by})")
    h2d, d2h = copy_ms(1024, cfg.in_dim)
    print(f"copies of a 1024-row batch, each timed alone: h2d {h2d:.4f} "
          f"ms, d2h {d2h:.4f} ms")
    service = asyncio.run(time_service(cfg, rng))
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
                      "power_limit": limit.strip(), "service": service}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
