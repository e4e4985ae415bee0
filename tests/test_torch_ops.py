"""The port's fused scoring wrapper (linkerd_tpu_torch/ops/scoring.py) on
the CPU against the JAX package's Pallas kernel in interpret mode.

On a CPU tensor the wrapper runs its plain PyTorch version; the CUDA
kernel itself is held against that plain version on the card by
``tests/test_torch_kernels.py`` and ``chip_smoke.py``.

The cases are those of ``tests/test_ops.py``: one 256-row tile, a
multi-tile grid whose second tile is anomalous, and a ragged batch,
plus the z-score fold. The weights are the JAX ``init_params`` with
biases drawn nonzero from the seed. float32 compute (as
``tests/test_ops.py`` compares) is held to ``atol=1e-5``; bfloat16
compute to 1e-5 on all but 1% of rows and 1e-3 on every row, since the
Pallas dot and torch's float32 GEMM sum in other orders and now and
then an activation rounds to the neighbouring bf16 value (see
``tests/test_torch_models.py``).

The Pallas kernel is compiled with XLA's ``xla_allow_excess_precision``
off, so that it keeps the rounding points its source writes (the layer
sum rounded to bf16, then the bias added and rounded again), which the
CUDA kernel and the plain version follow. Left on, XLA fuses the bias
add into the product and rounds once, and with nonzero biases most rows
then move by a few 1e-4 (``test_excess_precision_rounds_the_bias_once``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linkerd_tpu.models import anomaly as jax_model
from linkerd_tpu.ops import scoring as jax_scoring
from linkerd_tpu_torch.models import anomaly as torch_model
from linkerd_tpu_torch.models.convert import params_from_numpy
from linkerd_tpu_torch.ops import scoring

ATOL = 1e-5
BF16_SCORE_ATOL = 1e-3
BF16_ROW_SHARE = 0.01
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def setup(request):
    jdt, tdt = DTYPES[request.param]
    jcfg = jax_model.AnomalyModelConfig(compute_dtype=jdt, recon_weight=0.7)
    tcfg = torch_model.AnomalyModelConfig(compute_dtype=tdt, recon_weight=0.7)
    p = jax.tree_util.tree_map(
        np.asarray, jax_model.init_params(jax.random.key(0), jcfg))
    rng = np.random.default_rng(1)
    for group in p.values():
        for layer in group:
            layer["b"] = (rng.standard_normal(layer["b"].shape)
                          * 0.1).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = params_from_numpy(p, "cpu")
    x = rng.standard_normal((512, jcfg.in_dim)).astype(np.float32)
    check = assert_close if request.param == "float32" else \
        assert_bf16_close
    return jcfg, tcfg, jp, tp, x, check


def assert_close(got, ref):
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def assert_bf16_close(got, ref):
    diff = np.abs(np.asarray(got) - np.asarray(ref))
    assert diff.max() <= BF16_SCORE_ATOL
    assert (diff > ATOL).mean() <= BF16_ROW_SHARE


def jax_fused(jp, x, jcfg, excess_precision=False):
    fn = jax.jit(lambda p, x: jax_scoring.fused_anomaly_scores(
        p, x, jcfg, block_rows=256, interpret=True))
    compiled = fn.lower(jp, x).compile(compiler_options={
        "xla_allow_excess_precision": excess_precision})
    return np.asarray(compiled(jp, x))


class TestFusedAgainstPallas:
    def test_one_tile(self, setup):
        jcfg, tcfg, jp, tp, x, check = setup
        ref = jax_fused(jp, x[:256], jcfg)
        got = scoring.fused_anomaly_scores(tp, torch.tensor(x[:256]), tcfg)
        check(got.numpy(), ref)

    def test_grid_tiling_covers_all_rows(self, setup):
        jcfg, tcfg, jp, tp, x, check = setup
        x = x.copy()
        x[256:] += 10.0  # tile 1 anomalous
        ref = jax_fused(jp, x, jcfg)
        got = scoring.fused_anomaly_scores(tp, torch.tensor(x), tcfg)
        check(got.numpy(), ref)
        assert got[256:].mean() > got[:256].mean()

    def test_ragged_batch(self, setup):
        jcfg, tcfg, jp, tp, x, check = setup
        ref = jax_fused(jp, x[:300], jcfg)
        got = scoring.fused_anomaly_scores(tp, torch.tensor(x[:300]), tcfg)
        assert tuple(got.shape) == (300,)
        check(got.numpy(), ref)

    def test_folded_zscore(self, setup):
        jcfg, tcfg, jp, tp, x, check = setup
        rng = np.random.default_rng(2)
        mu = rng.standard_normal(jcfg.in_dim).astype(np.float32)
        var = rng.uniform(0.05, 9.0, jcfg.in_dim).astype(np.float32)
        raw = (mu + np.sqrt(var) * x).astype(np.float32)
        ref = jax_fused(jp, jax_model.normalize_features(raw, mu, var), jcfg)
        got = scoring.fused_anomaly_scores(
            tp, torch.tensor(raw), tcfg, torch.tensor(mu), torch.tensor(var))
        check(got.numpy(), ref)

    def test_excess_precision_rounds_the_bias_once(self, setup):
        """With XLA's excess precision on, the compiled Pallas kernel
        adds the bias to the unrounded sum: in bf16 compute most rows
        then leave the 1e-5 band (the gap the docstring describes);
        in float32 compute there is no rounding to skip."""
        jcfg, tcfg, jp, tp, x, check = setup
        ref = jax_fused(jp, x[:300], jcfg, excess_precision=True)
        got = scoring.fused_anomaly_scores(tp, torch.tensor(x[:300]), tcfg)
        if tcfg.compute_dtype == torch.float32:
            check(got.numpy(), ref)
        else:
            diff = np.abs(got.numpy() - ref)
            assert diff.max() <= BF16_SCORE_ATOL
            assert (diff > ATOL).mean() > 0.5


class TestWrapperOnCpu:
    def test_cpu_runs_plain_and_launches_nothing(self, setup):
        _, tcfg, _, tp, x, _ = setup
        before = scoring.fused_anomaly_scores.launches
        xt = torch.tensor(x[:37])
        got = scoring.fused_anomaly_scores(tp, xt, tcfg)
        ref = scoring.fused_anomaly_scores_plain(tp, xt, tcfg)
        assert torch.equal(got, ref)
        assert scoring.fused_anomaly_scores.launches == before

    def test_best_scorer_takes_mu_var(self, setup):
        _, tcfg, _, tp, x, _ = setup
        step = scoring.best_scorer(tcfg)
        xt = torch.tensor(x[:64])
        mu, var = torch.zeros(36), torch.ones(36)
        assert torch.equal(
            step(tp, xt, mu, var),
            scoring.fused_anomaly_scores_plain(tp, xt, tcfg, mu, var))
        assert torch.equal(step(tp, xt),
                           scoring.fused_anomaly_scores_plain(tp, xt, tcfg))

    def test_zero_rows(self, setup):
        _, tcfg, _, tp, _, _ = setup
        got = scoring.fused_anomaly_scores(tp, torch.zeros(0, 36), tcfg)
        assert tuple(got.shape) == (0,)

    def test_other_devices_raise(self, setup):
        _, tcfg, _, tp, _, _ = setup
        with pytest.raises(ValueError, match="unsupported device"):
            scoring.fused_anomaly_scores(
                tp, torch.zeros(4, 36, device="meta"), tcfg)


class TestPackParams:
    """``pack_params`` owns the checks of a model against what the
    kernel takes; they run on any device, so they are held here."""

    @staticmethod
    def model():
        cfg = torch_model.AnomalyModelConfig(enc_dims=(64, 32), bottleneck=16,
                                             cls_hidden=32, recon_weight=0.7)
        return cfg, torch_model.init_params(0, cfg, "cpu")

    def test_packed_model_scores_like_the_tree(self):
        cfg, params = self.model()
        packed = scoring.pack_params(params, cfg)
        assert packed.counts == (3, 3, 2)
        assert packed.params["enc"][0]["w"].dtype == torch.bfloat16
        assert list(packed.dims)[:4] == [36, 64, 64, 32]
        x = torch.tensor(np.random.default_rng(0).standard_normal(
            (37, 36)), dtype=torch.float32)
        assert torch.equal(scoring.fused_anomaly_scores(packed, x, cfg),
                           scoring.fused_anomaly_scores_plain(params, x, cfg))

    @pytest.mark.parametrize("fault, match", [
        ("no_cls", "no cls layers"),
        ("broken_chain", r"dec\[1\] takes 40 inputs"),
        ("wrong_recon_width", "dec ends in 35 outputs, want 36"),
        ("bias_shape", r"enc\[0\]: want w \[in, out\] and b \[out\]"),
        ("too_wide", "exceeds the kernel's 256"),
        ("too_many_layers", "17 layers exceed the kernel's 16"),
    ])
    def test_faults_are_named(self, fault, match):
        cfg, params = self.model()

        def dense(d_in, d_out):
            return {"w": torch.zeros(d_in, d_out), "b": torch.zeros(d_out)}

        if fault == "no_cls":
            params["cls"] = []
        elif fault == "broken_chain":
            params["dec"][1] = dense(40, 64)
        elif fault == "wrong_recon_width":
            params["dec"][2] = dense(64, 35)
        elif fault == "bias_shape":
            params["enc"][0]["b"] = torch.zeros(63)
        elif fault == "too_wide":
            params["enc"][0] = dense(36, 300)
        else:
            params["cls"] = [dense(16, 16) for _ in range(10)] + [dense(16, 1)]
        with pytest.raises(ValueError, match=match):
            scoring.pack_params(params, cfg)
