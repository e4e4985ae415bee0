"""The port's copies of the JAX package's device-free modules stay
copies: parsed, with ``linkerd_tpu_torch`` rewritten to ``linkerd_tpu``
in import statements and the module docstring dropped, each is
AST-equal to its original. Modules that differ on purpose are listed
with the reason, and are held to that list: a module listed as
differing must differ, and where the difference is confined to a few
top-level names, exactly those names differ."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT, REF = ROOT / "linkerd_tpu_torch", ROOT / "linkerd_tpu"

# Copies that must be AST-equal to the original (relative paths, the
# same under both packages).
COPIES = (
    # PRs 1-6
    "core/__init__.py", "core/path.py", "core/var.py", "core/tasks.py",
    "config/__init__.py", "config/registry.py",
    "router/__init__.py", "router/service.py",
    "telemetry/metrics.py", "telemetry/telemeter.py",
    "protocol/__init__.py", "protocol/http/__init__.py",
    "protocol/http/message.py", "models/features.py",
    "distill/bank.py", "distill/monitor.py",
    "lifecycle/drift.py", "lifecycle/export.py",
    # this slice: naming, config, namers, router, HTTP/1.1
    "core/dtab.py", "core/nametree.py", "core/addr.py",
    "core/activity.py", "core/pathmatcher.py", "config/types.py",
    "namer/__init__.py", "namer/core.py", "namer/fs.py",
    "router/stages.py", "router/admission.py", "router/balancer.py",
    "router/binding.py", "router/routing.py", "router/classifiers.py",
    "router/deadline.py", "router/retries.py",
    "router/failure_accrual.py", "protocol/tls.py",
    "protocol/http/server.py", "protocol/http/client.py",
    "protocol/http/identifiers.py", "protocol/http/filters.py",
)

# Modules that differ on purpose: reason, and the top-level names that
# differ (None: the module is a partial counterpart, not a copy with a
# few changed definitions).
DIFFERENT = {
    "protocol/http/codec.py": (
        "the reference's native C head parser is not bound: the port "
        "keeps the pure-Python parser only (ROADMAP Queue 1 item 4)",
        {"_native", "_parse_head_bytes", "read_request"}),
    "config/parser.py": (
        "PyYAML is imported on the first non-JSON config, not at load, "
        "so a host without it still takes JSON configs",
        {"yaml", "_StrictLoader", "_strict_mapping", "_STRICT_LOADER",
         "_strict_loader", "parse_config"}),
    "router/tracing.py": (
        "partial: only TraceId, which the telemeter's scorer spans use; "
        "the trace filters wait for the tracer telemeters (ROADMAP "
        "Queue 1 item 8)", None),
    "linker.py": (
        "the protocol: http subset, with a device for the telemeters and "
        "by-name refusals of what is not ported", None),
    "telemetry/anomaly.py": (
        "the telemeter ported to PyTorch: the scorer, training "
        "and kernel are the port's own", None),
    "announcer.py": (
        "a counterpart of FsAnnouncer alone, not a copy of the module",
        None),
}


class _Rename(ast.NodeTransformer):
    def visit_ImportFrom(self, node):
        if node.module and node.module.split(".")[0] == "linkerd_tpu_torch":
            node.module = "linkerd_tpu" + node.module[len("linkerd_tpu_torch"):]
        return node

    def visit_Import(self, node):
        for alias in node.names:
            if alias.name.split(".")[0] == "linkerd_tpu_torch":
                alias.name = "linkerd_tpu" + alias.name[len("linkerd_tpu_torch"):]
        return node


def normalized(path: Path) -> ast.Module:
    tree = ast.parse(path.read_text(), filename=str(path))
    body = tree.body
    if body and isinstance(body[0], ast.Expr) and \
            isinstance(body[0].value, ast.Constant) and \
            isinstance(body[0].value.value, str):
        tree.body = body[1:]
    return _Rename().visit(tree)


def top_level(tree: ast.Module) -> dict:
    """Top-level definitions by name: functions, classes, assignments
    and imports (a name bound twice keeps both)."""
    out: dict = {}

    def bind(name, node):
        out.setdefault(name, []).append(ast.dump(node))

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            bind(node.name, node)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        bind(n.id, node)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                bind((a.asname or a.name).split(".")[0], node)
        elif isinstance(node, ast.Try):
            for inner in ast.walk(node):
                if isinstance(inner, (ast.Import, ast.ImportFrom)):
                    for a in inner.names:
                        bind(a.asname or a.name.split(".")[0], node)
                elif isinstance(inner, ast.Assign):
                    for t in inner.targets:
                        if isinstance(t, ast.Name):
                            bind(t.id, node)
        else:
            # a statement such as ``Cls.method(...)``: under the first
            # name it reads
            first = next((n.id for n in ast.walk(node)
                          if isinstance(n, ast.Name)), type(node).__name__)
            bind(first, node)
    return out


def test_lists_are_disjoint_and_complete():
    assert not set(COPIES) & set(DIFFERENT)
    for rel in COPIES + tuple(DIFFERENT):
        assert (PORT / rel).is_file(), rel
        assert (REF / rel).is_file(), rel


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_ast_equal(rel):
    port, ref = normalized(PORT / rel), normalized(REF / rel)
    assert ast.dump(port) == ast.dump(ref), (
        f"linkerd_tpu_torch/{rel} is no longer a copy of linkerd_tpu/{rel}")


@pytest.mark.parametrize("rel", sorted(DIFFERENT))
def test_difference_is_the_listed_one(rel):
    reason, names = DIFFERENT[rel]
    assert reason
    port, ref = normalized(PORT / rel), normalized(REF / rel)
    assert ast.dump(port) != ast.dump(ref), (
        f"{rel} is listed as differing but is a copy: move it to COPIES")
    if names is None:
        return
    a, b = top_level(port), top_level(ref)
    differing = {n for n in set(a) | set(b) if a.get(n) != b.get(n)}
    assert differing == names
