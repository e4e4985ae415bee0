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
    # the control loop slice: delegation, namerd, its HTTP interpreter
    # and the actuators
    "namer/delegate.py", "namerd/__init__.py", "namerd/store.py",
    "namerd/core.py", "namerd/http_api.py", "interpreter/namerd_http.py",
    "control/__init__.py", "control/state.py", "control/balancer.py",
    "control/admission.py",
    # the CLI slice: tracing, the exporter and usage telemeters, the
    # admin server and namerd's admin pages
    "router/tracing.py", "telemetry/exporters.py", "telemetry/usage.py",
    "admin/__init__.py", "admin/server.py", "admin/dashboard.py",
    "namerd/admin_pages.py",
    # the native engine's options: the stream tracker and sentinel
    # (observer.py, the h2 frame observer, comes whole with the package)
    "streams/__init__.py", "streams/tracker.py", "streams/sentinel.py",
    "streams/observer.py",
    # the h2 router and the gRPC runtime
    "protocol/h2/__init__.py", "protocol/h2/frames.py",
    "protocol/h2/stream.py", "protocol/h2/messages.py",
    "protocol/h2/connection.py", "protocol/h2/client.py",
    "protocol/h2/server.py", "protocol/h2/identifiers.py",
    "protocol/h2/classifiers.py", "router/h2_layer.py",
    "grpc/__init__.py", "grpc/proto.py", "grpc/codec.py",
    "grpc/status.py", "grpc/stream.py", "grpc/dispatch.py",
    "grpc/var_event.py",
    # the mesh gRPC API between linkerd and namerd
    "mesh/__init__.py", "mesh/api.py", "mesh/messages.py",
    "mesh/converters.py", "namerd/mesh_iface.py", "interpreter/mesh.py",
    "interpreter/__init__.py",
    # the thrift, mux and thriftmux routers, namerd's thrift interface
    # and its io.l5d.namerd interpreter, and the fault harness
    "protocol/thrift/__init__.py", "protocol/thrift/binary.py",
    "protocol/thrift/codec.py", "protocol/thrift/ttwitter.py",
    "protocol/thrift/server.py", "protocol/thrift/client.py",
    "protocol/mux/__init__.py", "protocol/mux/codec.py",
    "protocol/mux/server.py", "protocol/mux/client.py",
    "namerd/thrift_idl.py", "namerd/thrift_iface.py",
    "interpreter/namerd_thrift.py", "testing/__init__.py",
    # the k8s and istio families, the fs and configMap interpreters and
    # the kinds they register
    "protocol/http/simple_client.py", "k8s/__init__.py", "k8s/client.py",
    "k8s/namer.py", "k8s/ingress.py", "interpreter/k8s_configmap.py",
    "interpreter/fs.py", "interpreter/configs.py", "istio/__init__.py",
    "istio/mixer_pb.py", "istio/mixer.py", "istio/telemeter.py",
    "istio/pilot.py", "istio/namer.py", "istio/interpreter.py",
    "istio/identifier.py",
)

# Modules that differ on purpose: reason, and the top-level names that
# differ (None: the module is a partial counterpart, not a copy with a
# few changed definitions).
DIFFERENT = {
    "protocol/http/codec.py": (
        "the reference's native C head parser is not bound: the port "
        "keeps the pure-Python parser only (ROADMAP Queue 1 item 4)",
        {"_native", "read_request"}),
    "protocol/h2/hpack.py": (
        "the reference's native Huffman coder is not bound: the port "
        "codes Huffman strings with the reference's own table and "
        "pure-Python path only",
        {"_native", "huffman_decode", "huffman_encode"}),
    "config/parser.py": (
        "PyYAML is imported on the first non-JSON config, not at load, "
        "so a host without it still takes JSON configs; a by-name "
        "refusal (ConfigRefused) passes through the Optional branch of "
        "_convert with its message; refusal and instantiate_ported "
        "refuse the reference's kinds the port has not ported by name, "
        "for the linker and namerd",
        {"yaml", "_StrictLoader", "_strict_mapping", "_STRICT_LOADER",
         "_strict_loader", "parse_config", "ConfigRefused", "_convert",
         "refusal", "instantiate_ported", "ConfigError", "kinds",
         "lookup"}),
    "admin/handlers.py": (
        "no /config-check.json: the reference's runs l5dcheck from "
        "tools/, which imports the JAX package (ROADMAP Queue 1 item 16)",
        {"mk_config_check_handler", "linkerd_admin_handlers"}),
    "__main__.py": (
        "--device: the telemeters run on the CUDA device unless "
        "--device cpu is given, and with no CUDA device the CLI exits "
        "non-zero instead of serving; its logger and usage line name "
        "the port",
        {"USAGE", "amain", "parse_args", "main", "log", "List", "Optional",
         "Tuple"}),
    "namerd/config.py": (
        "the in-memory and fs stores, the HTTP control interface, the "
        "mesh interface and the thrift interface; namerd/stores.py's "
        "kinds are refused by name (ROADMAP Queue 1 item 15)",
        None),
    "namerd/__main__.py": (
        "runs the port's namerd/config.py, which refuses the remote "
        "stores by name; its logger and usage line name the port",
        {"log", "main"}),
    "linker.py": (
        "the five router protocols, with a device for the telemeters and "
        "by-name refusals of what is not ported (tenants, loggers, "
        "announcers, the other namers and transformers); "
        "_mk_thrift_router and _mk_mux_router are the reference's",
        None),
    "testing/faults.py": (
        "auc is the port's NaN-safe one (lifecycle/promote.py): the "
        "reference's tie scan never ends on a NaN score",
        {"auc"}),
    "telemetry/anomaly.py": (
        "the telemeter ported to PyTorch: the scorer, training "
        "and kernel are the port's own", None),
    "announcer.py": (
        "a counterpart of FsAnnouncer alone, not a copy of the module",
        None),
    "native/__init__.py": (
        "the loader builds the port's own library from native/ and has no "
        "pure-Python fallback (a failed build raises); FastPathEngine and "
        "H2FastPathEngine drive the two engines with sharded workers, "
        "native TLS, the connection guard and the stream sentinel, "
        "without tenants (ROADMAP Queue 1 item 10); no head parser, "
        "Huffman or test-blob bindings; the scorer calls and stream_accum "
        "raise instead of returning None",
        {"FastPathEngine", "MAX_HEADERS", "ScoreSlab",
         "_QUANT_CODES", "_SO_PATH", "_SPANS", "_build",
         "_declare_engine", "_declare_fastpath", "_declare_h2_fastpath",
         "_declare_scorer", "_lock", "_tried", "available", "ensure_built",
         "huffman_decode", "huffman_encode", "json", "lib", "np",
         "parse_http1_head", "score_blob_info", "score_eval",
         "score_eval_raw", "score_eval_route", "score_feature_dim",
         "score_test_bank", "score_test_blob", "score_test_delta",
         "stream_accum", "subprocess", "sys", "tenant_hash_native",
         "threading"}),
    "control/reactor.py": (
        "verify_override runs the port's own copy of l5dcheck's "
        "check_override (control/verify.py): the reference's is in "
        "tools/, which imports linkerd_tpu",
        {"verify_override"}),
    "control/loop.py": (
        "single-instance mode: ControlConfig keeps every key and "
        "default but refuses fleet and regionFailover by name "
        "(ROADMAP Queue 1 item 14), so FleetConfig is not imported",
        {"ControlConfig", "FleetConfig", "ConfigRefused",
         "REFUSED_KEYS"}),
    "router/fastpath.py": (
        "the controller of both engines: no tenant board and "
        "admission (ROADMAP Queue 1 item 10; the guard counters are "
        "exported by _export_guard, the guard half of _export_tenants), "
        "and no per-row FeatureVector feed (every port telemeter has a "
        "native ring)",
        {"FastPathController"}),
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


# The port's copy of what the reactor's verify_override reaches in
# l5dcheck (tools/analysis/semantic/dtab_check.py): these definitions,
# and these methods of DtabAnalysis, are AST-equal to the original's.
VERIFY = ("control/verify.py", "tools/analysis/semantic/dtab_check.py")
VERIFY_NAMES = ("PROBE_SEG", "ProbeNamer", "probe_interpreter",
                "probe_path_for", "terminals", "prefix_subsumes",
                "dst_leaf_paths", "_dentry_anchor_map", "check_override")
VERIFY_METHODS = ("__init__", "delegate", "dentry_outcomes")


def _methods(tree: ast.Module, cls: str) -> dict:
    node = next(n for n in tree.body
                if isinstance(n, ast.ClassDef) and n.name == cls)
    return {m.name: ast.dump(m) for m in node.body
            if isinstance(m, ast.FunctionDef)}


@pytest.mark.parametrize("name", VERIFY_NAMES + tuple(
    f"DtabAnalysis.{m}" for m in VERIFY_METHODS))
def test_verify_is_a_copy_of_dtab_check(name):
    port = normalized(PORT / VERIFY[0])
    ref = normalized(ROOT / VERIFY[1])
    if name.startswith("DtabAnalysis."):
        m = name.split(".", 1)[1]
        assert _methods(port, "DtabAnalysis")[m] == \
            _methods(ref, "DtabAnalysis")[m]
        return
    a, b = top_level(port), top_level(ref)
    assert a[name] == b[name], f"control/verify.py: {name} differs"


def test_verify_defines_only_the_copied_parts():
    """Beside the copied definitions, control/verify.py defines only the
    stand-ins for l5dcheck's Finding and ConfigSource."""
    tree = normalized(PORT / VERIFY[0])
    defined = {n.name for n in tree.body
               if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    defined |= {t.id for n in tree.body if isinstance(n, ast.Assign)
                for t in n.targets if isinstance(t, ast.Name)}
    assert defined == set(VERIFY_NAMES) | {
        "DtabAnalysis", "Finding", "ConfigSource"}
    assert set(_methods(tree, "DtabAnalysis")) == set(VERIFY_METHODS)
