"""The port's plain model (linkerd_tpu_torch/models) against the JAX
package's, on the same weights and inputs, on the CPU.

Weights come from the JAX ``init_params`` and cross as numpy through
``models.convert``; inputs come from ``np.random.default_rng``.

The biases are drawn nonzero from the seed (the JAX ``init_params``
makes them zero), and the inputs are drawn from the stream that
``mu``/``var`` describe, so their z-scores are about standard normal
and the reconstruction error keeps tanh's slope: every rounding point
shows in the scores.

Tolerances. In float32 compute the two differ only by float32 rounding
in another summation order: ``atol=1e-5``. In bfloat16 compute the
XLA CPU dot and torch's float32 GEMM also sum in different orders, and
now and then a bf16 activation rounds to the neighbouring bf16 value
(a few rows in a thousand). So bf16 outputs are held to one bf16 step
of the tensor's scale (2**-7 of its largest magnitude) on at most 1% of
elements, and bf16 scores to 1e-5 on all but 1% of rows and to 1e-3 on
every row. Computing in float32 instead moves nearly every row by more
(``test_f32_compute_fails_the_bf16_bound``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linkerd_tpu.models import anomaly as jax_model
from linkerd_tpu_torch import resolve_device
from linkerd_tpu_torch.models import anomaly as torch_model
from linkerd_tpu_torch.models.convert import params_from_numpy, params_to_numpy

F32_ATOL = 1e-5
BF16_SCORE_ATOL = 1e-3
BF16_ROW_SHARE = 0.01  # rows allowed past F32_ATOL in bf16 compute

SMALL = dict(enc_dims=(64, 32), bottleneck=16, cls_hidden=32)
CONFIGS = {"small": SMALL, "default": {}}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def configs(size, dtype, recon_weight=0.7):
    jdt, tdt = DTYPES[dtype]
    kw = CONFIGS[size]
    return (jax_model.AnomalyModelConfig(compute_dtype=jdt,
                                         recon_weight=recon_weight, **kw),
            torch_model.AnomalyModelConfig(compute_dtype=tdt,
                                           recon_weight=recon_weight, **kw))


def carried_params(jcfg, seed=0):
    """JAX ``init_params`` with biases drawn from the seed, as JAX
    arrays and as the port's tensors."""
    p = jax.tree_util.tree_map(
        np.asarray, jax_model.init_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed)
    for group in p.values():
        for layer in group:
            layer["b"] = (rng.standard_normal(layer["b"].shape)
                          * 0.1).astype(np.float32)
    return jax.tree_util.tree_map(jnp.asarray, p), params_from_numpy(p, "cpu")


def inputs(seed, n=256, d=36):
    """Raw rows drawn from the stream ``mu``/``var`` describe."""
    rng = np.random.default_rng(seed)
    mu = (rng.standard_normal(d) * 0.5).astype(np.float32)
    var = rng.uniform(0.05, 4.0, d).astype(np.float32)
    x = (mu + np.sqrt(var) * rng.standard_normal((n, d))).astype(np.float32)
    return x, mu, var


def assert_bf16_close(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    diff = np.abs(got - ref)
    assert diff.max() <= 2.0 ** -7 * np.abs(ref).max()
    assert (diff > 0).mean() <= 0.01


def assert_bf16_scores_close(got, ref):
    diff = np.abs(np.asarray(got) - np.asarray(ref))
    assert diff.max() <= BF16_SCORE_ATOL
    assert (diff > F32_ATOL).mean() <= BF16_ROW_SHARE


class TestNormalize:
    def test_matches_jax(self):
        x, mu, var = inputs(1, n=512)
        ref = np.asarray(jax_model.normalize_features(x, mu, var))
        got = torch_model.normalize_features(
            torch.tensor(x), torch.tensor(mu), torch.tensor(var))
        np.testing.assert_allclose(got.numpy(), ref, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("size", ["small", "default"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
class TestForward:
    def test_apply_model(self, size, dtype):
        jcfg, tcfg = configs(size, dtype)
        jp, tp = carried_params(jcfg, seed=2)
        x, _, _ = inputs(3)
        ref = jax_model.apply_model(jp, x, jcfg)
        got = torch_model.apply_model(tp, torch.tensor(x), tcfg)
        assert [tuple(t.shape) for t in got] == [r.shape for r in ref]
        for g, r in zip(got, ref):
            assert g.dtype == torch.float32
            if dtype == "float32":
                np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                           atol=F32_ATOL, rtol=0)
            else:
                assert_bf16_close(g.numpy(), r)

    def test_anomaly_scores(self, size, dtype):
        jcfg, tcfg = configs(size, dtype)
        jp, tp = carried_params(jcfg, seed=4)
        x, mu, var = inputs(5)
        xn = np.asarray(jax_model.normalize_features(x, mu, var))
        ref = np.asarray(jax_model.anomaly_scores(jp, xn, jcfg))
        got = torch_model.anomaly_scores(tp, torch.tensor(xn), tcfg).numpy()
        assert got.shape == (len(x),)
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, atol=F32_ATOL, rtol=0)
        else:
            assert_bf16_scores_close(got, ref)
        assert ((got >= 0) & (got <= 1)).all()


def permuted_hidden(tp, seed):
    """The same model with the first layer's outputs (and so the second
    layer's products) in another order."""
    perm = torch.tensor(np.random.default_rng(seed).permutation(
        tp["enc"][0]["w"].shape[1]))
    tq = {g: [dict(layer) for layer in tp[g]] for g in tp}
    tq["enc"][0] = {"w": tp["enc"][0]["w"][:, perm],
                    "b": tp["enc"][0]["b"][perm]}
    tq["enc"][1] = {"w": tp["enc"][1]["w"][perm], "b": tp["enc"][1]["b"]}
    return tq


@pytest.mark.parametrize("size", ["small", "default"])
def test_exact_sums_ignore_the_summation_order(size):
    """With ``exact_sums`` a layer's sum is the correctly rounded float32
    sum of its products, whatever their order (as the CUDA kernel takes
    it on its float64 tensor cores): the second layer's products taken
    in another order change no bit of a float32-compute bottleneck,
    where float32 sums move many; and in bf16 the exact scores stay
    within the bf16 bounds of the reference's float32 sums."""
    _, t32 = configs(size, "float32")
    jcfg, tcfg = configs(size, "bfloat16")
    jp, tp = carried_params(jcfg, seed=6)
    tq = permuted_hidden(tp, seed=8)
    x, mu, var = inputs(7, n=512)
    xn = np.asarray(jax_model.normalize_features(x, mu, var))
    xt = torch.tensor(xn)
    moved = {}
    for exact in (False, True):
        _, z, _ = torch_model.apply_model(tp, xt, t32, exact_sums=exact)
        _, zq, _ = torch_model.apply_model(tq, xt, t32, exact_sums=exact)
        moved[exact] = int((z != zq).sum())
    assert moved[True] == 0 and moved[False] > 0, moved
    ref = np.asarray(jax_model.anomaly_scores(jp, xn, jcfg))
    got = torch_model.anomaly_scores(tp, xt, tcfg, exact_sums=True).numpy()
    assert_bf16_scores_close(got, ref)


@pytest.mark.parametrize("size", ["small", "default"])
def test_f32_compute_fails_the_bf16_bound(size):
    """The bf16 bound sees the compute dtype: the port computing in
    float32 on the same weights does not pass it against JAX in bf16."""
    jcfg, _ = configs(size, "bfloat16")
    _, t32 = configs(size, "float32")
    jp, tp = carried_params(jcfg, seed=4)
    x, mu, var = inputs(5)
    xn = np.asarray(jax_model.normalize_features(x, mu, var))
    ref = np.asarray(jax_model.anomaly_scores(jp, xn, jcfg))
    got = torch_model.anomaly_scores(tp, torch.tensor(xn), t32).numpy()
    with pytest.raises(AssertionError):
        assert_bf16_scores_close(got, ref)


class TestParams:
    def test_init_layout_matches_reference(self):
        jcfg, tcfg = configs("default", "bfloat16")
        jp = jax_model.init_params(jax.random.key(0), jcfg)
        tp = torch_model.init_params(0, tcfg, "cpu")
        for group in ("enc", "dec", "cls"):
            assert len(tp[group]) == len(jp[group])
            for tl, jl in zip(tp[group], jp[group]):
                assert tuple(tl["w"].shape) == jl["w"].shape  # [in, out]
                assert tuple(tl["b"].shape) == jl["b"].shape
                assert tl["w"].dtype == torch.float32
                assert not tl["b"].any()
        # He-normal scale, as the reference draws it
        w = tp["enc"][1]["w"]
        assert abs(float(w.std()) - (2.0 / w.shape[0]) ** 0.5) < 0.01

    def test_init_is_seeded(self):
        cfg = torch_model.AnomalyModelConfig(**SMALL)
        a = params_to_numpy(torch_model.init_params(7, cfg, "cpu"))
        b = params_to_numpy(torch_model.init_params(7, cfg, "cpu"))
        c = params_to_numpy(torch_model.init_params(8, cfg, "cpu"))
        assert (a["enc"][0]["w"] == b["enc"][0]["w"]).all()
        assert not (a["enc"][0]["w"] == c["enc"][0]["w"]).all()

    def test_numpy_round_trip_is_exact(self):
        jcfg, _ = configs("default", "float32")
        jp = jax.tree_util.tree_map(
            np.asarray, jax_model.init_params(jax.random.key(3), jcfg))
        back = params_to_numpy(params_from_numpy(jp, "cpu"))
        for group in ("enc", "dec", "cls"):
            for bl, jl in zip(back[group], jp[group]):
                assert (bl["w"] == jl["w"]).all() and (bl["b"] == jl["b"]).all()

    def test_bf16_carry_rounds_like_jax(self):
        jcfg, _ = configs("small", "float32")
        jp = jax_model.init_params(jax.random.key(5), jcfg)
        w = jp["enc"][0]["w"]
        got = params_from_numpy({"w": np.asarray(w)}, "cpu",
                                dtype=torch.bfloat16)["w"]
        ref = np.asarray(w.astype(jnp.bfloat16).astype(jnp.float32))
        assert (got.float().numpy() == ref).all()

    def test_dtype_names_round_trip(self):
        for name in ("bfloat16", "float32"):
            dt = torch_model.dtype_from_name(name)
            assert torch_model.dtype_name(dt) == name
        with pytest.raises(ValueError):
            torch_model.dtype_from_name("float8")


class TestDevice:
    def test_cpu_only_by_name(self):
        assert resolve_device("cpu") == torch.device("cpu")
        with pytest.raises(ValueError):
            resolve_device("meta")

    def test_default_raises_without_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()
        with pytest.raises(RuntimeError):
            torch_model.init_params(0)
