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

from pathlib import Path

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


class TestPackedLayout:
    """The layout ``pack_params`` hands the CUDA kernel: one bf16
    buffer of biases and zero-padded weights, and a table of where each
    layer sits and which activation buffers it reads and writes. The
    kernel runs only on the card; the layout is built on any device,
    so it is held here."""

    MODELS = {
        "default": dict(),
        "narrow": dict(enc_dims=(64, 32), bottleneck=16, cls_hidden=32),
        # a width in every group that is a multiple of neither 16 nor 8
        "odd": dict(enc_dims=(100, 50), bottleneck=20, cls_hidden=30),
        "one_enc_layer": dict(enc_dims=(), bottleneck=20, cls_hidden=30),
    }

    @classmethod
    def packed(cls, name, seed=0):
        cfg = torch_model.AnomalyModelConfig(recon_weight=0.7,
                                             **cls.MODELS[name])
        params = torch_model.init_params(seed, cfg, "cpu")
        rng = np.random.default_rng(seed)
        for group in params.values():
            for layer in group:
                layer["b"] = torch.tensor(
                    rng.standard_normal(tuple(layer["b"].shape)) * 0.1,
                    dtype=torch.float32)
        return cfg, params, scoring.pack_params(params, cfg)

    def test_kernel_constants_are_mirrored(self):
        src = (Path(scoring.__file__).parent / "csrc" /
               "score_mlp.cu").read_text()
        for name, value in (("MAXW", scoring.MAX_WIDTH),
                            ("MAX_LAYERS", scoring.MAX_LAYERS),
                            ("ROWS", scoring.ROWS_PER_BLOCK)):
            assert f"constexpr int {name} = {value};" in src
        assert "enum { RELU = %d, LOGIT = %d };" % (
            scoring.RELU, scoring.LOGIT) in src

    @pytest.mark.parametrize("name", list(MODELS))
    def test_buffer_reads_back(self, name):
        """Through its table, the buffer holds the cast weights and
        biases in the live region and zeros everywhere else, and the
        regions tile it with no gap or overlap."""
        _, _, kp = self.packed(name)
        buf = kp.packed.float()
        assert kp.packed.dtype == torch.bfloat16
        live = torch.zeros(buf.numel(), dtype=torch.bool)
        covered = torch.zeros(buf.numel(), dtype=torch.int32)
        for pl in kp.layers:
            layer = kp.params[pl.group][pl.index]
            w = buf[pl.w_off:pl.w_off + pl.kpad * pl.wstride].view(
                pl.kpad, pl.wstride)
            assert torch.equal(w[:pl.k, :pl.n], layer["w"].float())
            assert torch.equal(buf[pl.b_off:pl.b_off + pl.n],
                               layer["b"].float())
            covered[pl.w_off:pl.w_off + pl.kpad * pl.wstride] += 1
            covered[pl.b_off:pl.b_off + pl.npad] += 1
            live[pl.b_off:pl.b_off + pl.n] = True
            live[pl.w_off:pl.w_off + pl.kpad * pl.wstride].view(
                pl.kpad, pl.wstride)[:pl.k, :pl.n] = True
        assert torch.equal(covered, torch.ones_like(covered))
        assert not buf[~live].any()
        assert kp.bias_len == sum(pl.npad for pl in kp.layers)
        assert list(kp.table) == [v for pl in kp.layers for v in pl.row()]

    @pytest.mark.parametrize("width", [1, 8, 16, 20, 30, 36, 100, 255, 256])
    def test_tile_shapes_take_every_width(self, width):
        """Every width up to 256 pads to the mma shape (K to 16, N to
        8), by less than one tile, into a row stride of an odd number
        of 16-byte units, at offsets that keep 16-byte alignment."""
        cfg = torch_model.AnomalyModelConfig(
            in_dim=max(width, 2), enc_dims=(width,), bottleneck=width,
            cls_hidden=width)
        kp = scoring.pack_params(torch_model.init_params(0, cfg, "cpu"), cfg)
        for pl in kp.layers:
            assert pl.kpad % 16 == 0 and pl.k <= pl.kpad < pl.k + 16
            assert pl.npad % 8 == 0 and pl.n <= pl.npad < pl.n + 8
            assert pl.kpad <= scoring.MAX_WIDTH
            assert pl.npad <= pl.wstride <= pl.npad + 8
            assert (pl.wstride // 8) % 2 == 1
            assert pl.w_off % 8 == 0 and pl.b_off % 8 == 0

    @pytest.mark.parametrize("name", list(MODELS))
    def test_execution_order_and_buffers(self, name):
        """Encoder, classifier, decoder; each layer reads the buffer
        the layer before it wrote; z stays put while the classifier and
        the decoder run; the logit comes from the classifier's last."""
        _, _, kp = self.packed(name)
        groups = [pl.group for pl in kp.layers]
        counts = dict(zip(("enc", "dec", "cls"), kp.counts))
        assert groups == (["enc"] * counts["enc"] + ["cls"] * counts["cls"]
                          + ["dec"] * counts["dec"])
        enc = [pl for pl in kp.layers if pl.group == "enc"]
        z = enc[-1].out_buf
        assert enc[0].in_buf == 0
        for chain in (enc, *[[pl for pl in kp.layers if pl.group == g]
                             for g in ("cls", "dec")]):
            for before, after in zip(chain, chain[1:]):
                assert after.in_buf == before.out_buf != after.out_buf
            if chain[0].group != "enc":
                assert chain[0].in_buf == z
                assert all(pl.out_buf != z for pl in chain)
        flags = [pl.flags for pl in kp.layers]
        last = {g: max(i for i, pl in enumerate(kp.layers) if pl.group == g)
                for g in counts}
        for i, f in enumerate(flags):
            relu = not (i == last["cls"] or i == last["dec"])
            assert bool(f & scoring.RELU) == relu
            assert bool(f & scoring.LOGIT) == (i == last["cls"])

    @staticmethod
    def run_table(kp, x):
        """The kernel's plan in plain PyTorch: layers in table order on
        three activation buffers that start as NaN (shared memory is
        not cleared), each layer reading its padded K from its input
        buffer and zeroing its output up to the next 16 columns."""
        n, in_dim = x.shape
        act = torch.full((3, n, scoring.MAX_WIDTH + 8), float("nan"))
        act[0, :, :kp.layers[0].kpad] = 0.0
        act[0, :, :in_dim] = x.to(torch.bfloat16).float()
        buf = kp.packed.float()
        bf16 = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
        logit = None
        for pl in kp.layers:
            w = buf[pl.w_off:pl.w_off + pl.kpad * pl.wstride].view(
                pl.kpad, pl.wstride)[:, :pl.npad]
            b = buf[pl.b_off:pl.b_off + pl.npad]
            h = bf16(bf16(act[pl.in_buf, :, :pl.kpad] @ w) + b)
            if pl.flags & scoring.RELU:
                h = torch.relu(h)
            act[pl.out_buf, :, :-(-pl.npad // 16) * 16] = 0.0
            act[pl.out_buf, :, :pl.npad] = h
            if pl.flags & scoring.LOGIT:
                logit = h[:, 0]
        recon = act[kp.layers[-1].out_buf, :, :in_dim]
        err = torch.mean(torch.square(recon - x), dim=-1)
        return err, logit

    @pytest.mark.parametrize("name", list(MODELS))
    def test_table_forward_matches_plain(self, name):
        """Run through its table, the padded buffer scores as the
        unpadded model does, at the bf16 bound of this file."""
        cfg, params, kp = self.packed(name, seed=3)
        x = torch.tensor(np.random.default_rng(4).standard_normal(
            (97, cfg.in_dim)), dtype=torch.float32)
        err, logit = self.run_table(kp, x)
        got = (cfg.recon_weight * torch.tanh(err)
               + (1 - cfg.recon_weight) * torch.sigmoid(logit))
        assert torch.isfinite(got).all()
        assert_bf16_close(got.numpy(), scoring.fused_anomaly_scores_plain(
            params, x, cfg).numpy())
