"""Online training and the model lifecycle on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` and skips elsewhere,
with its reason. The file imports nothing of JAX, so it runs on a
machine that has only the port's dependencies::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_train_cuda.py

The first three tests run the phases (a)-(c) of ``chip_smoke.py``'s
train phase, which raise on the first check that fails, on seeds other
than the script's: each fit call on the card and on a CPU scorer
resynced to the card's state before it, the losses within 1e-3
relative and the fitted models within 3e-3 on every row; the fitted
model's served scores within the ``Agreement`` bounds of its plain
version; no batch scored under a torn (model, mu, var) while fits run,
and one launch a batch; a poisoned fit rolled back to the promoted
scores bit for bit, with two launches a gated cycle.
"""

import asyncio
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from linkerd_tpu_torch.lifecycle import promote  # noqa: E402
from linkerd_tpu_torch.models.anomaly import AnomalyModelConfig  # noqa: E402
from linkerd_tpu_torch.ops import scoring  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, 300))


def cfg():
    return AnomalyModelConfig(recon_weight=0.7)


@pytest.mark.parametrize("seed", [10, 11, 12])
def test_fit_on_card_matches_fit_on_cpu(cuda, seed):
    res = run(chip_smoke.train_parity(cfg(), seed))
    assert res["loss_rel_max"] <= chip_smoke.FIT_LOSS_REL
    assert res["card_vs_cpu_model_max"] <= chip_smoke.MODEL_TOL
    assert res["served_vs_plain_max"] <= chip_smoke.TOL
    assert res["launches"] == 1 and res["step"] == 7 + 4 * 3
    assert len(res["card_vs_cpu_model_by_call"]) == chip_smoke.FIT_CALLS


def test_score_during_fit_sees_only_published_tuples(cuda):
    res = run(chip_smoke.score_during_fit(cfg(), np.random.default_rng(11)))
    assert res["launches"] == res["batches"] > 0
    assert res["tuples_published"] == 1 + 2 * chip_smoke.DURING_FITS


def test_rollback_restores_scores_bit_for_bit(cuda):
    res = run(chip_smoke.lifecycle_phase(cfg(), np.random.default_rng(12)))
    assert res["actions"] == ["promoted", "promoted", "rolled_back"]
    assert res["launches_per_gated_cycle"] == [2, 2]


def test_evaluate_snapshot_launches_the_kernel(cuda):
    snap = chip_smoke.make_snapshot(cfg(), seed=6)
    x, labels, mask = chip_smoke.labeled_rows(
        np.random.default_rng(13), 4096, snap.mu, snap.var)
    scoring.fused_anomaly_scores.launches = 0
    card = promote.evaluate_snapshot(snap, x, labels, mask)
    assert scoring.fused_anomaly_scores.launches == 1
    cpu = promote.evaluate_snapshot(snap, x, labels, mask, device="cpu")
    assert (card.n_rows, card.n_labeled) == (cpu.n_rows, cpu.n_labeled)
    assert abs(card.loss - cpu.loss) <= 1e-3 * abs(cpu.loss)
    assert abs(card.auc - cpu.auc) <= 0.01
