"""The in-process ``io.l5d.jaxAnomaly`` telemeter on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` and skips elsewhere,
with its reason. The file imports nothing of JAX, so it runs on a
machine that has only the port's dependencies::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_telemeter_cuda.py

The tests run ``chip_smoke.py``'s telemeter phase, which raises on the
first check that fails, on seeds other than the script's. Part A: 64
full 1024-row batches through ``run()`` at the reference's defaults,
from the recorder filter and ring appends over 40 routes, 4 of them
faulted; every batch's kernel scores within the ``Agreement`` bounds
of the plain version, the board within 2e-3 of a fresh board folded
with the plain scores, one kernel launch a batch, every row scored
with no failure, drop or degraded flag, and the accrual policy
tightening on the faulted routes' mesh level. Part B: the reference's
cadence (a fit every 8 batches, a lifecycle with cycles run by hand, a
distill block, a span sink, a recording weight sink); launches equal
the batches plus two a gated cycle and two a retrain cycle, a
promotion's republished blob carries the CRC the manifest records, and
no hold-out batch reaches a fit.
"""

import asyncio
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from linkerd_tpu_torch.models.anomaly import AnomalyModelConfig  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, 600))


def cfg():
    return AnomalyModelConfig(recon_weight=0.7)


@pytest.mark.parametrize("seed", [20, 30])
def test_part_a_scores_every_batch_through_the_kernel(cuda, seed):
    snap = run(chip_smoke.tele_teacher(cfg(), seed, "cuda"))
    res = run(chip_smoke.telemeter_part_a(cfg(), snap, seed))
    assert res["launches"] == res["batches"]
    assert res["full_batches"] >= chip_smoke.TELE_BATCHES
    assert res["kernel_vs_plain_max"] <= chip_smoke.TOL
    assert res["board_vs_plain_fold_max"] <= chip_smoke.TOL
    assert res["failures_to_dead"] == {"mesh": 2, "calm_only": 5}


@pytest.mark.parametrize("seed", [20, 30])
def test_part_b_at_the_reference_cadence(cuda, seed):
    snap = run(chip_smoke.tele_teacher(cfg(), seed, "cuda"))
    res = run(chip_smoke.telemeter_part_b(cfg(), snap, seed + 1))
    assert res["launches"] == res["batches"] + 2 * res["gated_cycles"] \
        + 2 * res["retrain_cycles"]
    assert res["gated_cycles"] >= 1 and res["retrain_cycles"] >= 1
    assert res["fits"] == 8 and res["holdouts"] == 16
    assert res["cycles"][0]["action"] == "promoted"
    assert all(c["crc"] is not None for c in res["cycles"])
    assert res["timed_batches"] == 4
