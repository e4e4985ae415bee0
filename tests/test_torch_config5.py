"""BASELINE config 5 (istio mixer reporting over a 50-service,
three-tier replay through two routers, a latency-only cascade from
svc-45 and 15% 503s from svc-47) in both packages, on the CPU: the
port's ``linkerd_tpu_torch.testing.config5.bench`` against the
reference's ``benchmarks.config5_istio.bench``.

The two runs see the same rows, arranged as in
``tests/test_torch_config4.py``: a scripted clock a package, moved by
1-2 ms (seeded) in every backend's GET and by the FaultInjectors'
latency; scorers restored from one snapshot, the JAX train step
compiled with ``xla_allow_excess_precision`` off, the reference's scorer
resynced to the port's state after each fit; the reference's
``drain_once`` draining the ring empty, as the port's schedule does. The
replay's zipf draws (``random.Random(7)``) and both injectors' draws
are the same in both.

Run at 160 front requests (520 with the windows, 1,560 through the two
routers) where the benchmark's default is 500: each package's run then
takes about a third of the file's minute on one worker.

Bounds: the rows of every score call bit-equal; the port's scores of
them within the bf16 bounds in force (1e-3 on every row, 1e-5 on all
but 1%) against the JAX package's fused scorer (Pallas, interpreted)
under the model the port scored with; ``fault_auc_subtle_istio`` and
``fault_auc_latency_only`` within 0.01 (ROADMAP Queue 1 item 5); the
routers' request counts, the labeled rows and the mixer's reports
equal, a report for every request either router served.
"""

import pytest

import benchmarks.config5_istio as ref_bench
from linkerd_tpu_torch.testing import config5 as port_bench
from tests.test_torch_config4 import rows_and_fits_alike, scripted_runs

N_REQUESTS = 160          # the benchmark's default: 500
AUC_TOL = 0.01            # ROADMAP Queue 1 item 5


@pytest.fixture(scope="module")
def runs():
    with pytest.MonkeyPatch.context() as monkeypatch:
        return scripted_runs(monkeypatch, port_bench, ref_bench, N_REQUESTS)


def test_config_text_is_the_benchmarks():
    assert port_bench.CONFIG == ref_bench.CONFIG
    assert (port_bench.N_FRONT, port_bench.N_MID, port_bench.N_DB) == (
        ref_bench.N_FRONT, ref_bench.N_MID, ref_bench.N_DB)


def test_config5_alike(runs):
    got, want = runs.got, runs.want
    print(f"fault_auc_subtle_istio port {got['fault_auc_subtle_istio']} "
          f"reference {want['fault_auc_subtle_istio']}; "
          f"fault_auc_latency_only {got['fault_auc_latency_only']} / "
          f"{want['fault_auc_latency_only']}")
    for k in ("fault_auc_subtle_istio", "fault_auc_latency_only"):
        assert abs(got[k] - want[k]) <= AUC_TOL, k
    # 160 replayed, then 4 windows of 20 + 10 rounds of three front
    # requests; each front request makes two more at the back router
    keys = ("front_requests", "back_requests", "mixer_reports",
            "labeled_n", "anomalous_n")
    assert [got[k] for k in keys] == [want[k] for k in keys]
    assert (got["front_requests"], got["back_requests"]) == (520, 1040)
    assert got["mixer_reports"] == 1560
    # every front 502 is a svc-47 503, in an errors window
    assert got["front_502"] == got["injected_503"] > 0


def test_config5_rows_and_fits_alike(runs):
    # 7 drains of phase A and the epochs (480 rows each), 2 score-only
    # drains (1,080 rows in batches of 1,024), the AUC's
    rows_and_fits_alike(runs, 10, 7)
