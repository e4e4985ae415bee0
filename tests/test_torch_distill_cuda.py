"""Distillation of per-route specialist heads on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` and skips elsewhere,
with its reason. The file imports nothing of JAX, so it runs on a
machine that has only the port's dependencies::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_distill_cuda.py

The first tests run ``chip_smoke.py``'s distill phase, which raises on
the first check that fails, on seeds other than the script's: 34
drifted routes at ``DistillConfig()`` defaults fill the bank with 32
heads, each retrain cycle launching the kernel exactly twice, every
head's kernel scores within the ``Agreement`` bounds of its plain
version, a NaN-poisoned candidate rejected with nothing published, the
last route skipped with the bank full, fenced generations and lineage
checked publish by publish (checks (a), (b), (d), (e)); and a 4-step
``distill_head`` on the card within 3e-3 of the same call on the CPU
on every row of the route, both heads read through the plain forward in
float32 (check (c); ``chip_smoke.distill_parity`` says why).

Run as a script, it prints check (c)'s CPU witness, with no card::

    PYTHONPATH=. python tests/test_torch_distill_cuda.py
"""

import asyncio
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from linkerd_tpu_torch.distill import DistillConfig  # noqa: E402
from linkerd_tpu_torch.distill import pipeline  # noqa: E402
from linkerd_tpu_torch.models.anomaly import AnomalyModelConfig  # noqa: E402
from linkerd_tpu_torch.telemetry.anomaly import InProcessScorer  # noqa: E402

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


@pytest.mark.parametrize("seed", [10, 11])
def test_retrain_cycles_fill_the_bank(cuda, seed):
    res = run(chip_smoke.distill_scenario(cfg(), seed))
    n = DistillConfig().maxHeads
    assert res["cycles"] == n + 1 and res["promoted"] == n
    assert res["launches_per_cycle"] == [2] * (n + 1)
    assert res["heads_vs_plain_max"] <= chip_smoke.TOL
    assert res["generation"] == res["publishes"] == n + 1
    assert res["bank_heads"] == n


@pytest.mark.parametrize("seed", [10, 11, 12])
def test_distill_head_on_card_matches_cpu(cuda, seed):
    res = run(chip_smoke.distill_parity(cfg(), seed))
    assert res["card_vs_cpu"] <= chip_smoke.MODEL_TOL


def test_distill_head_steps_on_a_stream_of_its_own(cuda, monkeypatch):
    """Neither the default stream nor a scorer's dispatch ring."""
    seen = []
    real = pipeline.train_steps

    def recording(*args, **kwargs):
        seen.append(torch.cuda.current_stream())
        return real(*args, **kwargs)

    monkeypatch.setattr(pipeline, "train_steps", recording)
    scorer = InProcessScorer()
    try:
        snap = scorer.snapshot()
        x, labels, mask = chip_smoke.labeled_rows(
            np.random.default_rng(13), 256, np.zeros(36, np.float32),
            np.ones(36, np.float32))
        head = pipeline.distill_head(snap, x, labels, mask, 2, 1e-3)
        ring = scorer._dispatcher.stream
    finally:
        scorer.close()
    assert len(seen) == 1
    assert seen[0] != torch.cuda.default_stream() and seen[0] != ring
    assert np.isfinite(head.params["enc"][0]["w"]).all()
    assert DistillConfig().mk(None).device.type == "cuda"


if __name__ == "__main__":
    # check (c)'s CPU witness, which needs no card:
    #   PYTHONPATH=. python tests/test_torch_distill_cuda.py
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.distill_witness(cfg())
