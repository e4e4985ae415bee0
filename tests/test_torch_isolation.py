"""The port stands alone: nothing under ``linkerd_tpu_torch/``, and not
``chip_smoke.py``, imports JAX, optax, ml_dtypes, the JAX package or the
repo's ``tools`` (which imports the JAX package).

Checked twice: statically, over every import statement in the source;
and by importing every port module in a fresh interpreter in which
those names cannot be imported, then scoring a batch on the CPU.
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
BLOCKED = ("jax", "jaxlib", "optax", "ml_dtypes", "linkerd_tpu", "tools")
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
    assert "linkerd_tpu_torch.telemetry.sidecar" in port_modules()


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_reference(path):
    # exact top-level names: linkerd_tpu_torch must not match linkerd_tpu
    bad = sorted(set(top_level_imports(path)) & set(BLOCKED))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_imports_and_scores_with_reference_blocked():
    script = textwrap.dedent(f"""
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
        leaked = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
        assert not leaked, leaked
        print("OK")
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")
