"""The port stands alone: nothing under ``linkerd_tpu_torch/``, and not
``chip_smoke.py``, imports JAX, optax, ml_dtypes, the JAX package, the
repo's ``tools`` (which imports the JAX package) or grpcio (which the
card's machine lacks: the scorer sidecar runs on the port's own gRPC
runtime).

Checked twice: statically, over every import statement in the source;
and by importing every port module in a fresh interpreter in which
those names cannot be imported, then scoring a batch on the CPU, and
serving calls through the sidecar, its client, the replica pool and a
tiered telemeter.
"""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "linkerd_tpu_torch"
# ``tools`` (the repo's analyzers) imports linkerd_tpu, so the port must
# not reach it either
BLOCKED = ("jax", "jaxlib", "optax", "ml_dtypes", "linkerd_tpu", "tools",
           "grpc")
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def port_modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PKG.rglob("*.py"))


def test_sources_found():
    assert len(SOURCES) >= 12
    mods = port_modules()
    for mod in ("linkerd_tpu_torch.telemetry.sidecar",
                "linkerd_tpu_torch.zk.client", "linkerd_tpu_torch.zk.jute",
                "linkerd_tpu_torch.consul.client",
                "linkerd_tpu_torch.consul.namer",
                "linkerd_tpu_torch.namer.zk",
                "linkerd_tpu_torch.namer.marathon",
                "linkerd_tpu_torch.testing.zkserver",
                "linkerd_tpu_torch.check.engine",
                "linkerd_tpu_torch.check.router_check",
                "linkerd_tpu_torch.check.telemetry_check",
                "linkerd_tpu_torch.fleet.doc"):
        assert mod in mods, mod


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_reference(path):
    # exact top-level names: linkerd_tpu_torch must not match linkerd_tpu
    bad = sorted(set(top_level_imports(path)) & set(BLOCKED))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def blocked_prelude() -> str:
    """A script's first lines: the names of BLOCKED cannot be imported."""
    return textwrap.dedent(f"""
        import importlib, importlib.abc, sys
        BLOCKED = {BLOCKED!r}

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("blocked: " + name)
                return None

        for name in list(sys.modules):
            if name.split(".")[0] in BLOCKED:
                del sys.modules[name]
        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {str(ROOT)!r})
    """)


def run_blocked(body: str) -> None:
    script = blocked_prelude() + textwrap.dedent(body) + textwrap.dedent("""
        leaked = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
        assert not leaked, leaked
        print("OK")
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_imports_and_scores_with_reference_blocked():
    run_blocked(f"""
        for mod in {port_modules()!r}:
            importlib.import_module(mod)
        import chip_smoke

        import asyncio
        import numpy as np
        from linkerd_tpu_torch.telemetry.anomaly import InProcessScorer

        async def go():
            s = InProcessScorer(device="cpu")
            try:
                x = np.random.default_rng(0).standard_normal((8, 36))
                out = await s.score(x.astype(np.float32))
            finally:
                s.close()
            assert out.shape == (8,) and np.isfinite(out).all()

        asyncio.run(go())
    """)


def test_config_check_and_zk_run_with_reference_blocked():
    """With the JAX package and tools unimportable: the port's config
    check runs on a linker config naming the five discovery kinds and a
    jaxAnomaly telemeter, and a serverset namer binds a member on the
    port's fake ZooKeeper."""
    run_blocked('''
        import asyncio
        import json
        from linkerd_tpu_torch.check import check_data
        from linkerd_tpu_torch.core import Path
        from linkerd_tpu_torch.namer.zk import (
            ServersetNamer, close_shared_zk, shared_zk,
        )
        from linkerd_tpu_torch.testing.zkserver import FakeZkServer

        zk_addrs = [{"host": "127.0.0.1", "port": 1}]
        cfg = {
            "namers": [
                {"kind": "io.l5d.consul", "host": "127.0.0.1", "port": 1},
                {"kind": "io.l5d.marathon", "host": "127.0.0.1", "port": 1},
                {"kind": "io.l5d.serversets", "zkAddrs": zk_addrs},
                {"kind": "io.l5d.zkLeader", "zkAddrs": zk_addrs},
                {"kind": "io.l5d.curator", "zkAddrs": zk_addrs},
            ],
            "telemetry": [{"kind": "io.l5d.jaxAnomaly"}],
            "routers": [{
                "protocol": "http",
                "dtab": "/svc/web => /#/io.l5d.consul/dc1/web ; "
                        "/svc => /#/io.l5d.marathon ;",
                "servers": [{"port": 4140}, {"port": 4140}],
            }],
        }
        rules = sorted({f.rule for f in check_data(cfg)})
        assert rules == ["dtab-shadowed", "router-port-conflict"], rules

        async def go():
            zk = await FakeZkServer().start()
            member = {"serviceEndpoint": {"host": "10.0.0.1", "port": 80},
                      "status": "ALIVE"}
            zk.set_node("/d/web/member_0000000000",
                        json.dumps(member).encode())
            namer = ServersetNamer(shared_zk(zk.hosts).start(),
                                   Path.of("#", "io.l5d.serversets"))
            try:
                act = namer.lookup(Path.read("/d/web"))
                for _ in range(500):
                    if act.current.__class__.__name__ == "Ok":
                        break
                    await asyncio.sleep(0.01)
                leaf = act.current.value
                addrs = leaf.value.addr.sample().addresses
                assert [(a.host, a.port) for a in addrs] == [("10.0.0.1", 80)]
            finally:
                namer.close()
                await close_shared_zk()
                await zk.close()

        asyncio.run(go())
    ''')


def test_sidecar_hop_serves_with_grpc_blocked():
    """With grpc (and the JAX package) unimportable: a sidecar on the
    CPU answers the port's client and a replica pool, and a tiered
    telemeter whose in-process scorer fails scores its batch on the
    sidecar tier."""
    run_blocked("""
        import asyncio
        import numpy as np
        from linkerd_tpu_torch.fleet import ScorerReplicaPool
        from linkerd_tpu_torch.telemetry.anomaly import (
            InProcessScorer, JaxAnomalyConfig, JaxAnomalyTelemeter,
        )
        from linkerd_tpu_torch.telemetry.metrics import MetricsTree
        from linkerd_tpu_torch.telemetry.sidecar import (
            GrpcScorerClient, ScorerSidecar,
        )
        from linkerd_tpu_torch.models.features import FeatureVector

        async def go():
            side = await ScorerSidecar(
                scorer=InProcessScorer(device="cpu")).start()
            addr = f"127.0.0.1:{side.port}"
            x = np.random.default_rng(0).standard_normal(
                (8, 36)).astype(np.float32)
            client, pool = GrpcScorerClient(addr), ScorerReplicaPool([addr])
            tele = JaxAnomalyTelemeter(JaxAnomalyConfig(
                sidecarAddress=addr, trainEveryBatches=0, nativeTier="off"),
                MetricsTree(), device="cpu")
            try:
                a, b = await client.score(x), await pool.score(x)
                assert a.shape == (8,) and (a == b).all()
                tiered = tele._ensure_scorer()

                async def sick(x):
                    raise RuntimeError("primary down")

                tiered.primary.score = sick
                for i in range(4):
                    tele.ring.append((FeatureVector(
                        dst_path="/svc/a", latency_ms=1.0 + i), None))
                assert await tele.drain_once() == 4
                st = tele.model_state()["tiers"]
                assert st["fallback_calls"] == 1, st
                assert side.service.rows_scored == 8 + 8 + 4
            finally:
                tele.close()
                pool.close()
                await client.aclose()
                await side.close()

        asyncio.run(go())
    """)
