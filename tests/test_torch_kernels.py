"""Tests of the port's CUDA kernel and the dispatch ring on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` and skips elsewhere,
with its reason. The file imports nothing of JAX, so it runs on a
machine that has only the port's dependencies::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels.py

The kernel is held against its plain PyTorch version on the same
inputs: every score within 2e-3 (a tenth of the reference's own bound
for its fused kernel, ``linkerd_tpu/ops/scoring.py::fused_available``)
and at most one row in a hundred (at least one) off by more than 1e-5.
The two round alike and differ only where another summation order tips
a bfloat16 activation over a rounding boundary; a kernel that misplaces
a rounding point, a bias or the float32 input of the error moves nearly
every row. The models have nonzero biases and inputs whose z-scores are
about standard normal, so every part of the forward shows in the score.
"""

import asyncio

import numpy as np
import pytest
import torch

from linkerd_tpu_torch.lifecycle.store import encode_snapshot
from linkerd_tpu_torch.models.anomaly import AnomalyModelConfig, init_params
from linkerd_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from linkerd_tpu_torch.ops import scoring
from linkerd_tpu_torch.telemetry.anomaly import InProcessScorer
from linkerd_tpu_torch.telemetry.sidecar import ScorerService, encode_matrix

TOL = 2e-3
ROW_TOL = 1e-5

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


def random_params(seed, c):
    """He-normal weights, biases drawn around zero, and the decoder's
    output scaled so the reconstruction error keeps tanh's slope."""
    rng = np.random.default_rng(seed)
    p = params_to_numpy(init_params(seed, c, "cpu"))
    for group in p.values():
        for layer in group:
            layer["b"] = (rng.standard_normal(layer["b"].shape)
                          * 0.1).astype(np.float32)
    p["dec"][-1]["w"] *= np.float32(0.3)
    return p


def assert_agrees(got, ref):
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    diff = np.abs(got - ref)
    assert diff.max() <= TOL
    assert (diff > ROW_TOL).sum() <= max(1, len(diff) // 100)


@pytest.mark.parametrize("n", [1, 7, 8, 9, 37, 256, 1000, 1024, 4096])
@pytest.mark.parametrize("folded", [False, True])
def test_kernel_matches_plain(cuda, n, folded):
    c = cfg()
    params = params_from_numpy(random_params(0, c), cuda)
    rng = np.random.default_rng(n)
    z = rng.standard_normal((n, c.in_dim))
    mu = var = None
    if folded:
        mu_h = rng.standard_normal(c.in_dim) * 0.5
        var_h = rng.uniform(0.05, 4.0, c.in_dim)
        z = mu_h + np.sqrt(var_h) * z
        mu = torch.tensor(mu_h, dtype=torch.float32, device=cuda)
        var = torch.tensor(var_h, dtype=torch.float32, device=cuda)
    x = torch.tensor(z, dtype=torch.float32, device=cuda)
    before = scoring.fused_anomaly_scores.launches
    got = scoring.fused_anomaly_scores(params, x, c, mu, var)
    ref = scoring.fused_anomaly_scores_plain(params, x, c, mu, var)
    torch.cuda.synchronize()
    assert scoring.fused_anomaly_scores.launches == before + 1
    assert_agrees(got, ref)


def test_packed_params_launch_alike(cuda):
    """A model packed once scores as the same model packed per call."""
    c = cfg()
    params = params_from_numpy(random_params(3, c), cuda)
    packed = scoring.pack_params(params, c)
    x = torch.randn(300, c.in_dim, device=cuda)
    assert torch.equal(scoring.fused_anomaly_scores(packed, x, c),
                       scoring.fused_anomaly_scores(params, x, c))


def test_ragged_tail_leaves_rest_untouched(cuda):
    """Rows past n are neither read as live nor written: scoring the
    first 9 rows of a larger tensor equals scoring a 9-row copy."""
    c = cfg()
    params = params_from_numpy(random_params(1, c), cuda)
    x = torch.randn(64, c.in_dim, device=cuda)
    a = scoring.fused_anomaly_scores(params, x[:9], c)
    b = scoring.fused_anomaly_scores(params, x[:9].clone(), c)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_zero_rows_launch_nothing(cuda):
    c = cfg()
    params = init_params(0, c, cuda)
    before = scoring.fused_anomaly_scores.launches
    out = scoring.fused_anomaly_scores(
        params, torch.zeros(0, c.in_dim, device=cuda), c)
    assert out.shape == (0,)
    assert scoring.fused_anomaly_scores.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    c = cfg()
    params = init_params(0, c, cuda)
    x = torch.zeros(8, c.in_dim, device=cuda)
    with pytest.raises(ValueError):
        scoring.fused_anomaly_scores(params, x.double(), c)
    with pytest.raises(ValueError):
        scoring.fused_anomaly_scores(params, x.t().contiguous().t(), c)
    with pytest.raises(ValueError):
        scoring.fused_anomaly_scores(params, x[:, :20].contiguous(), c)
    with pytest.raises(ValueError):
        scoring.fused_anomaly_scores(params, x, c, mu=torch.zeros(
            c.in_dim, device=cuda))
    with pytest.raises(ValueError):
        scoring.fused_anomaly_scores(
            params, x, AnomalyModelConfig(compute_dtype=torch.float32))
    cpu_params = init_params(0, c, "cpu")
    with pytest.raises(ValueError):
        scoring.fused_anomaly_scores(cpu_params, x, c)


def test_service_in_flight_and_hot_swap(cuda):
    """Batches in flight through the ring each score against one whole
    model, even when a restore swaps the model under them."""
    c = cfg()
    scorer = InProcessScorer(device=cuda)
    svc = ScorerService(scorer)
    snaps = []
    for seed in (1, 2):
        s = scorer.snapshot()
        s.params = random_params(seed, c)
        snaps.append(s)
    x = np.random.default_rng(0).standard_normal((1024, c.in_dim)).astype(
        np.float32)
    payload = encode_matrix(x)

    async def go():
        try:
            refs = []
            for s in snaps:
                await svc.handle_restore(encode_snapshot(s))
                refs.append(np.frombuffer(await svc.handle_score(payload),
                                          np.float32))
            assert np.abs(refs[0] - refs[1]).max() > 1e-3
            before = scoring.fused_anomaly_scores.launches
            tasks = [asyncio.ensure_future(svc.handle_score(payload))
                     for _ in range(8)]
            await svc.handle_restore(encode_snapshot(snaps[0]))
            tasks += [asyncio.ensure_future(svc.handle_score(payload))
                      for _ in range(8)]
            outs = [np.frombuffer(r, np.float32)
                    for r in await asyncio.gather(*tasks)]
            assert scoring.fused_anomaly_scores.launches == before + 16
            for o in outs:
                assert any(np.array_equal(o, r) for r in refs)
        finally:
            scorer.close()

    run(go())
