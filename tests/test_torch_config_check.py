"""The port's semantic config check (``linkerd_tpu_torch/check``) and its
``/config-check.json`` against l5dcheck's (``tools/analysis/semantic``)
and the JAX package's handler, on the CPU.

- Every fixture under ``tests/configs/`` and ``examples/``: the same
  ``(rule, line, message, suppressed)`` list from both.
- One planted config for each rule in ``SEMANTIC_RULES``: the same list,
  and the planted rule among it.
- ``/config-check.json``: a reference linker and a port linker (on
  ``device="cpu"``) loaded from one text serve the same body.
- The listed differences, asserted as such: where the port still
  refuses a kind by name, the port reports a ``config-kind`` finding
  where the reference reports its own rule or nothing: naming ROADMAP
  Queue 1 item 14 for ``control.fleet`` and ``regionFailover``, and
  reading namerd's remote dtab stores (item 15) as unknown kinds. Every
  other finding is the same.
"""

import asyncio
import glob
import json
import os

import pytest

from tools.analysis.semantic import check_text as ref_check_text
from tools.analysis.semantic.engine import SEMANTIC_RULES
from linkerd_tpu_torch.check import check_text as port_check_text
from linkerd_tpu_torch.check.engine import SEMANTIC_RULES as PORT_RULES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# fixture -> the port's one extra finding: (rule, line, ROADMAP item)
FIXTURE_DIFFERENCES = {
    "tests/configs/linker-fleet.yml": ("config-kind", 16, "item 14"),
    "tests/configs/linker-regions.yml": ("config-kind", 18, "item 14"),
}
FIXTURES = sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(REPO, "tests/configs/*.yml"))
    + glob.glob(os.path.join(REPO, "examples/*.yml")))


def rows(findings):
    return [(f.rule, f.line, f.message, f.suppressed) for f in findings]


def both(text, base_dir=None):
    return (rows(ref_check_text(text, "<cfg>", base_dir=base_dir)),
            rows(port_check_text(text, "<cfg>", base_dir=base_dir)))


def test_rule_lists_equal():
    assert PORT_RULES == SEMANTIC_RULES


@pytest.mark.parametrize("rel", FIXTURES)
def test_fixture_findings_equal(rel):
    with open(os.path.join(REPO, rel)) as fh:
        text = fh.read()
    ref, port = both(text, base_dir=os.path.dirname(
        os.path.join(REPO, rel)))
    if rel not in FIXTURE_DIFFERENCES:
        assert port == ref
        return
    rule, line, item = FIXTURE_DIFFERENCES[rel]
    extra = [r for r in port if r not in ref]
    assert [r for r in port if r in ref] == ref
    ((got_rule, got_line, msg, suppressed),) = extra
    assert (got_rule, got_line, suppressed) == (rule, line, False)
    assert f"ROADMAP Queue 1 {item}" in msg


NAMERS = "namers:\n- kind: io.l5d.fs\n  rootDir: disco\n"


def linker(dtab="/svc => /#/io.l5d.fs ;", extra="",
           servers="  servers: [{port: 0}]"):
    body = "\n".join(f"    {ln}" for ln in dtab.splitlines())
    return (f"routers:\n- protocol: http\n  dtab: |\n{body}\n{servers}\n"
            f"{extra}{NAMERS}")


ANOMALY = "telemetry:\n- kind: io.l5d.jaxAnomaly\n"
CONTROL = (ANOMALY + "  control:\n    namespace: default\n"
           "    namerdAddress: 127.0.0.1:4180\n    failover:\n")

PLANTED = {
    "config-parse": "routers: [\n",
    "config-kind": linker(extra="telemetry:\n- kind: io.l5d.nosuch\n"),
    "dtab-syntax": linker("/svc /#/io.l5d.fs ;"),
    "dtab-cycle": linker("/a => /b ;\n/b => /a ;\n/svc => /#/io.l5d.fs ;"),
    "dtab-unbound": linker("/svc => /#/io.l5d.zookeeper ;"),
    "dtab-neg-only": linker("/orphan => /nowhere/bound ;\n"
                            "/svc => /#/io.l5d.fs ;"),
    "dtab-shadowed": linker("/svc/web => /#/io.l5d.fs/web-v1 ;\n"
                            "/svc => /#/io.l5d.fs ;"),
    "dtab-dead-branch": linker(
        "/svc => 0.0 * /#/io.l5d.fs/a & 1.0 * /#/io.l5d.fs/b ;"),
    "router-port-conflict": (
        "routers:\n- protocol: http\n  label: a\n"
        "  dtab: /svc => /#/io.l5d.fs ;\n  servers: [{port: 4140}]\n"
        "- protocol: http\n  label: b\n"
        "  dtab: /svc => /#/io.l5d.fs ;\n  servers: [{port: 4140}]\n"
        + NAMERS),
    "router-dst-uncovered": linker("/other => /#/io.l5d.fs ;"),
    "timeout-inversion": linker(extra=(
        "  service:\n    totalTimeoutMs: 500\n"
        "  client:\n    requestAttemptTimeoutMs: 900\n")),
    "retry-starved": linker(extra=(
        "  service:\n    retries:\n      maxRetries: 0\n")),
    "admission-deadline": linker(extra=(
        "  admissionControl:\n    maxConcurrency: 0\n")),
    "tls-missing-cert": linker(extra=(
        "  client:\n    tls:\n      commonName: svc.example.com\n"
        "      trustCerts: [no-such-ca.pem]\n")),
    "tenant-config": linker(extra="  tenantIdentifier: {kind: cookie}\n"),
    "fastpath-workers": linker(extra="  workers: 2\n"),
    "scorer-config": linker(extra=ANOMALY + "  maxBatch: 100\n"
                            "  ringCapacity: 10\n"),
    "scorer-width": linker(extra=ANOMALY + "  lifecycle:\n"
                           "    directory: ckpt\n"),
    "override-unsafe": linker(extra=CONTROL + "      /svc/web: /svc/web\n"),
    "fleet-config": linker(extra=CONTROL + "      /svc/web: /svc/web-b\n"
                           "    fleet:\n      quorum: 5\n"
                           "      expectInstances: 3\n")
    + "admin: {port: 9990}\n",
    "distill-config": linker(extra=ANOMALY + "  distill:\n"
                             "    maxHeads: 500\n"),
    "stream-config": linker(extra=(
        "  fastPath: true\n  streamScoring: {enter: 0.3, exit: 0.5}\n")),
}
# planted rule -> the port's config-kind line and ROADMAP item, where the
# port refuses the block the rule reads by name
PLANTED_DIFFERENCES = {"fleet-config": "item 14"}


def test_every_rule_is_planted():
    assert set(PLANTED) == set(SEMANTIC_RULES)


def width_store(tmp_path):
    """A promoted checkpoint at in_dim 7 under ``tmp_path/ckpt``, written
    by the reference's store (which both packages' stores read)."""
    import numpy as np

    from linkerd_tpu.lifecycle import CheckpointStore, ModelSnapshot
    from linkerd_tpu.models.anomaly import AnomalyModelConfig

    snap = ModelSnapshot(
        params={"w": np.zeros((7, 2), np.float32)}, opt_leaves=[],
        mu=np.zeros(7, np.float32), var=np.ones(7, np.float32),
        norm_initialized=True, step=1, cfg=AnomalyModelConfig(in_dim=7))
    CheckpointStore(str(tmp_path / "ckpt")).save(snap, status="promoted")


@pytest.mark.parametrize("rule", sorted(PLANTED))
def test_planted_findings_equal(rule, tmp_path, monkeypatch):
    # the workers rule reads the host's cores
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    if rule == "scorer-width":
        width_store(tmp_path)
    ref, port = both(PLANTED[rule], base_dir=str(tmp_path))
    assert rule in {r for r, _, _, _ in ref}, ref
    if rule not in PLANTED_DIFFERENCES:
        assert port == ref
        return
    # the port refuses the block by name: a config-kind finding naming
    # the item, and none of the rule's own
    assert not [r for r in port if r[0] == rule]
    assert [r for r in ref if r[0] != rule] == [
        r for r in port if r[0] != "config-kind"]
    (kind,) = [r for r in port if r[0] == "config-kind"]
    assert f"ROADMAP Queue 1 {PLANTED_DIFFERENCES[rule]}" in kind[2]


@pytest.mark.parametrize("kind", ["io.l5d.zk", "io.l5d.etcd",
                                  "io.l5d.consul", "io.l5d.k8s"])
def test_refused_dtab_stores_are_the_listed_difference(kind):
    """namerd's remote stores (ROADMAP Queue 1 item 15) are not in the
    port's registry: its analyzer reads them as unknown kinds."""
    text = (f"storage:\n  kind: {kind}\n"
            "interfaces:\n- kind: io.l5d.httpController\n  port: 4180\n")
    ref, port = both(text)
    assert not [r for r in ref if r[0] in ("config-kind", "config-parse")]
    (row,) = [r for r in port if r[0] in ("config-kind", "config-parse")]
    assert row[:2] == ("config-kind", 2)
    assert row[2].startswith(f"storage: unknown dtabStore kind {kind!r}")
    assert [r for r in port if r is not row] == ref


LIVE = linker(
    "/svc/web => /#/io.l5d.fs/web-v1 ;\n/svc => /#/io.l5d.fs ;\n"
    "/orphan => /nowhere/bound ;  # l5d: ignore[dtab-neg-only] — planted",
    extra=("  service:\n    totalTimeoutMs: 500\n"
           "  client:\n    requestAttemptTimeoutMs: 900\n"),
    servers="  servers: [{port: 0}]") + "usage: {enabled: false}\n"


def test_config_check_json_bodies_equal(tmp_path):
    from linkerd_tpu.admin.handlers import (
        mk_config_check_handler as ref_handler,
    )
    from linkerd_tpu.linker import load_linker as ref_load
    from linkerd_tpu.protocol.http.message import Request as RefRequest
    from linkerd_tpu_torch.admin.handlers import (
        linkerd_admin_handlers, mk_config_check_handler as port_handler,
    )
    from linkerd_tpu_torch.linker import load_linker as port_load
    from linkerd_tpu_torch.protocol.http.message import Request

    (tmp_path / "disco").mkdir()
    text = LIVE.replace("rootDir: disco", f"rootDir: {tmp_path / 'disco'}")

    async def go():
        ref = ref_load(text)
        port = port_load(text, device="cpu")
        try:
            a = await ref_handler(ref)(RefRequest(uri="/config-check.json"))
            b = await port_handler(port)(Request(uri="/config-check.json"))
            routes = [r for r, _ in linkerd_admin_handlers(port)]
            return a, b, routes
        finally:
            for lk in (ref, port):
                for _, n in lk.namers:
                    n.close()

    a, b, routes = asyncio.run(asyncio.wait_for(go(), 60))
    assert (a.status, b.status) == (200, 200)
    assert json.loads(a.body) == json.loads(b.body)
    body = json.loads(b.body)
    assert body["clean"] is False
    assert sorted(f["rule"] for f in body["findings"]) == [
        "dtab-shadowed", "timeout-inversion"]
    assert [f["rule"] for f in body["suppressed"]] == ["dtab-neg-only"]
    assert "/config-check.json" in routes


def test_card_phase_planted_config_lines():
    """The planted config the card's discovery phase starts a second CLI
    on: both checks give its rule ids at the lines the phase holds."""
    import chip_smoke

    text = chip_smoke.DISCO_PLANTED.format(port=4140, port2=4141, admin=9990)
    ref, port = both(text)
    assert port == ref
    assert sorted((r, line) for r, line, _, s in port if not s) == \
        chip_smoke.DISCO_PLANTED_FINDINGS
    # the live CLI's own config is clean
    live = json.dumps(chip_smoke.disco_front_config(4140, 9990, 8500, 8080,
                                                    2181))
    assert both(live) == ([], [])
