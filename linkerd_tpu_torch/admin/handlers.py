"""Linkerd admin handlers: delegator, bound names, log levels, config
check: the counterpart of ``linkerd_tpu/admin/handlers.py``.

Ref: linkerd/admin/.../LinkerdAdmin.scala:71-109 (composition),
admin/.../names/DelegateApiHandler.scala:331 (delegate JSON API),
admin/.../BoundNamesHandler, admin/.../LoggingHandler.scala:95.

``/config-check.json`` runs the port's own copy of l5dcheck's semantic
check (``linkerd_tpu_torch/check``) where the reference's reaches the
repo's ``tools/analysis/semantic``.
"""

from __future__ import annotations

import json
import logging
from typing import TYPE_CHECKING, Any, List, Tuple
from urllib.parse import parse_qsl, urlsplit

from linkerd_tpu_torch.admin.server import json_response
from linkerd_tpu_torch.core import Dtab, Path
from linkerd_tpu_torch.namer.core import ConfiguredDtabNamer
from linkerd_tpu_torch.namer.delegate import Delegator, delegate_json
from linkerd_tpu_torch.protocol.http.message import Request, Response

if TYPE_CHECKING:  # pragma: no cover
    from linkerd_tpu_torch.linker import Linker


def _query(req: Request) -> dict:
    return dict(parse_qsl(urlsplit(req.uri).query))


def mk_delegator_handler(linker: "Linker"):
    """``/delegator.json?router=<label>&path=/svc/x[&dtab=...]`` —
    step-by-step delegation explanation (DelegateApiHandler)."""

    async def handler(req: Request) -> Response:
        q = _query(req)
        label = q.get("router") or (
            linker.routers[0].label if linker.routers else None)
        router = next((r for r in linker.routers if r.label == label), None)
        if router is None:
            return json_response(
                {"error": f"no router {label!r}"}, status=404)
        if not isinstance(router.interpreter, ConfiguredDtabNamer):
            return json_response(
                {"error": "delegation is only explainable for in-process "
                          "interpreters; query namerd for remote ones"},
                status=501)
        path_s = q.get("path")
        if not path_s:
            return json_response({"error": "missing ?path="}, status=400)
        try:
            path = Path.read(path_s)
            extra = Dtab.read(q["dtab"]) if q.get("dtab") else Dtab.empty()
        except ValueError as e:
            return json_response({"error": str(e)}, status=400)
        base = Dtab.read(router.spec.dtab) if router.spec.dtab else Dtab.empty()
        tree = Delegator(router.interpreter).delegate(base + extra, path)
        return json_response(delegate_json(tree))

    return handler


def mk_bound_names_handler(linker: "Linker"):
    """``/bound-names.json`` — per-router live binding-cache contents
    (BoundNamesHandler + PathRegistry)."""

    async def handler(req: Request) -> Response:
        out = {}
        for r in linker.routers:
            out[r.label] = {
                "paths": sorted(
                    k.path.show for k in r.binding.paths._entries),
                "clients": sorted(
                    k.show for k in r.binding.clients._entries),
            }
        return json_response(out)

    return handler


async def logging_handler(req: Request) -> Response:
    """``/logging.json`` — GET lists logger levels; POST/PUT
    ``?logger=<name>&level=DEBUG`` sets one at runtime
    (LoggingHandler.scala:95)."""
    q = _query(req)
    if req.method in ("POST", "PUT"):
        name = q.get("logger", "")
        level = (q.get("level") or "").upper()
        if level not in ("DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL"):
            return json_response({"error": f"bad level {level!r}"},
                                 status=400)
        logging.getLogger(name or None).setLevel(level)
        return json_response({"logger": name or "root", "level": level})
    loggers = {"root": logging.getLevelName(logging.getLogger().level)}
    for name in sorted(logging.root.manager.loggerDict):
        lg = logging.root.manager.loggerDict[name]
        if isinstance(lg, logging.Logger) and lg.level != logging.NOTSET:
            loggers[name] = logging.getLevelName(lg.level)
    return json_response(loggers)


def mk_anomaly_handler(linker: "Linker"):
    """``/anomaly.json`` — live per-dst anomaly scores from the
    io.l5d.jaxAnomaly telemeter's score board (empty when the telemeter
    isn't configured)."""
    async def handler(req: Request) -> Response:
        board = linker._anomaly_board()
        return json_response({"scores": dict(board.scores.sample())})

    return handler


def mk_model_handler(linker: "Linker"):
    """``/model.json`` — anomaly-model lifecycle state (version, step,
    last promotion/rollback, drift gauges, checkpoint inventory) from the
    io.l5d.jaxAnomaly telemeter; ``{"lifecycle_enabled": false}`` when no
    lifecycle block is configured."""
    async def handler(req: Request) -> Response:
        tele = linker._anomaly_telemeter()
        if tele is None:
            return json_response({"lifecycle_enabled": False,
                                  "telemeter": None})
        return json_response(tele.model_state())

    return handler


def mk_tenants_handler(linker: "Linker"):
    """``/tenants.json`` — per-router tenant-isolation state: each
    tenant's aggregates and anomaly level (TenantBoard), the quota
    governor's verdicts (sick set, transitions, hysteresis snapshot),
    and — for fastPath routers — the native engine's own per-tenant
    stats and connection-guard counters, read live so the admin view
    and ``rt/*/fastpath/tenant/*`` can be cross-checked."""

    async def handler(req: Request) -> Response:
        out = {}
        views = {label: (board, adm)
                 for label, board, adm in linker.tenant_views}
        for r in linker.routers:
            view = views.get(r.label)
            if view is None:
                continue
            board, adm = view
            entry: dict = {
                "tenants": board.snapshot(),
                "evicted": board.evicted,
            }
            if adm is not None:
                quotas = adm.status()
                quotas.pop("tenants", None)  # already above
                entry["quotas"] = quotas
            ctl = getattr(r, "controller", None)
            if ctl is not None:
                snap = ctl.engine.stats()
                entry["engine"] = {
                    "tenants": snap.get("tenants"),
                    "guard": snap.get("guard"),
                }
            out[r.label] = entry
        return json_response(out)

    return handler


def mk_streams_handler(linker: "Linker"):
    """``/streams.json`` — per-router stream-sentinel state: the
    Python-plane sentinel table (h2 routers with ``streamScoring``) and
    the native engine's in-plane stream table + tunnel counters
    (fastPath routers), read live."""

    async def handler(req: Request) -> Response:
        out = {}
        sentinels = dict(linker.stream_sentinels)
        for r in linker.routers:
            entry: dict = {}
            ctl = getattr(r, "controller", None)
            if ctl is not None:
                entry = ctl.streams_snapshot()
            sent = sentinels.get(r.label)
            if sent is not None and "sentinel" not in entry:
                entry["sentinel"] = sent.snapshot()
                entry["enabled"] = True
            if entry:
                out[r.label] = entry
        return json_response(out)

    return handler


def mk_config_check_handler(linker: "Linker"):
    """``/config-check.json`` — l5dcheck semantic verification of the
    live linker's parsed config (the same rules as ``python -m
    tools.analysis check``, run against what this process actually
    loaded). Findings are returned, never enforced: the linker is
    already serving this config."""
    async def handler(req: Request) -> Response:
        import asyncio

        def run():
            from linkerd_tpu_torch.check import check_data, check_text
            if linker.config_text is not None:
                return check_text(linker.config_text, "<live-config>")
            return check_data(linker.config_dict, "<live-config>")

        try:
            # symbolic delegation over a big dtab is CPU work; keep the
            # event loop serving while it runs
            findings = await asyncio.to_thread(run)
        except Exception as e:  # noqa: BLE001 — analyzer bug != outage
            return json_response({"error": repr(e)}, status=500)
        unsuppressed = [f for f in findings if not f.suppressed]
        return json_response({
            "clean": not unsuppressed,
            "findings": [f.to_dict() for f in unsuppressed],
            "suppressed": [f.to_dict() for f in findings if f.suppressed],
        })

    return handler


def mk_identifier_handler(linker: "Linker"):
    """``/identifier.json`` — run each http router's identifier against a
    synthetic request and show the resulting logical name (ref:
    linkerd/admin/.../HttpIdentifierHandler.scala:48). Query params:
    ``method``, ``host``, ``path``, plus optional ``router`` filter."""
    async def handler(req: Request) -> Response:
        q = _query(req)
        if q.get("router") and not any(
                r.label == q["router"] for r in linker.routers):
            return json_response(
                {"error": f"no router {q['router']!r}"}, status=404)
        synthetic = Request(method=q.get("method", "GET"),
                            uri=q.get("path", "/"))
        if q.get("host"):
            synthetic.headers.set("Host", q["host"])
        out = {}
        for r in linker.routers:
            identifier = getattr(r, "identifier", None)  # fastPath: absent
            if identifier is None:
                continue
            if q.get("router") and r.label != q["router"]:
                continue
            try:
                dst = identifier(synthetic)
                if hasattr(dst, "__await__"):
                    dst = await dst
                if isinstance(dst, Response):
                    # identifiers may answer directly (istio redirects)
                    out[r.label] = {"response": dst.status}
                else:
                    out[r.label] = {"path": dst.path.show,
                                    "baseDtab": dst.base_dtab.show,
                                    "localDtab": dst.local_dtab.show}
            except Exception as e:  # noqa: BLE001 — per-router result
                out[r.label] = {"error": str(e)}
        return json_response(out)

    return handler


# one capture of each kind at a time: cProfile refuses a second
# concurrent enable() and tracemalloc.stop() under an active window
# would break the other request's snapshot
_profile_active = False
_heap_active = False


async def pprof_profile_handler(req: Request) -> Response:
    """``/admin/pprof/profile?seconds=N`` — cProfile the live event-loop
    thread for N seconds (default 3, max 60) and return the pstats text
    sorted by cumulative time.

    Ref: twitter-server's /admin/pprof/profile (inherited by the
    reference via project/Deps.scala:10). The native engines run on
    their own pthreads and are outside this profile — attach ``perf
    record -t <tid>`` for those.
    """
    import asyncio
    import cProfile
    import io
    import pstats

    global _profile_active
    import math

    q = _query(req)
    try:
        seconds = float(q.get("seconds", 3.0))
    except ValueError:
        return json_response({"error": "bad seconds"}, status=400)
    if not math.isfinite(seconds):  # nan survives min/max clamping
        return json_response({"error": "bad seconds"}, status=400)
    seconds = min(max(seconds, 0.1), 60.0)
    if _profile_active:
        return json_response({"error": "a profile capture is already "
                                       "running"}, status=409)
    _profile_active = True
    prof = cProfile.Profile()
    try:
        prof.enable()
        try:
            await asyncio.sleep(seconds)
        finally:
            prof.disable()
    finally:
        _profile_active = False
    buf = io.StringIO()
    stats = pstats.Stats(prof, stream=buf)
    stats.sort_stats("cumulative").print_stats(80)
    rsp = Response(status=200, body=buf.getvalue().encode())
    rsp.headers.set("Content-Type", "text/plain; charset=utf-8")
    return rsp


async def pprof_heap_handler(req: Request) -> Response:
    """``/admin/pprof/heap?seconds=N`` — tracemalloc snapshot of
    allocations made during an N-second window (default 3, max 60),
    top allocation sites by size."""
    import asyncio
    import io
    import tracemalloc

    global _heap_active
    import math

    q = _query(req)
    try:
        seconds = float(q.get("seconds", 3.0))
    except ValueError:
        return json_response({"error": "bad seconds"}, status=400)
    if not math.isfinite(seconds):  # nan survives min/max clamping
        return json_response({"error": "bad seconds"}, status=400)
    seconds = min(max(seconds, 0.1), 60.0)
    if _heap_active:
        return json_response({"error": "a heap capture is already "
                                       "running"}, status=409)
    _heap_active = True
    try:
        was_tracing = tracemalloc.is_tracing()
        if not was_tracing:
            tracemalloc.start()
        try:
            await asyncio.sleep(seconds)
            snap = tracemalloc.take_snapshot()
        finally:
            if not was_tracing:
                tracemalloc.stop()
    finally:
        _heap_active = False
    buf = io.StringIO()
    for stat in snap.statistics("lineno")[:60]:
        buf.write(f"{stat}\n")
    rsp = Response(status=200, body=buf.getvalue().encode())
    rsp.headers.set("Content-Type", "text/plain; charset=utf-8")
    return rsp


async def mk_identifier_server(linker: "Linker", port: int,
                               host: str = "127.0.0.1"):
    """Standalone identification debug server (ref: HttpIdentifierHandler
    wired by Main.initAdmin when ``admin.httpIdentifierPort`` is set):
    every request to the port runs the routers' identifiers against the
    query-described synthetic request."""
    from linkerd_tpu_torch.protocol.http.server import HttpServer
    from linkerd_tpu_torch.router.service import FnService

    handler = mk_identifier_handler(linker)
    server = HttpServer(FnService(handler), host=host, port=port)
    await server.start()
    return server


def linkerd_admin_handlers(linker: "Linker") -> List[Tuple[str, Any]]:
    """The standard linkerd admin surface (LinkerdAdmin.apply)."""
    from linkerd_tpu_torch.admin.dashboard import dashboard_handler
    return [
        ("/", dashboard_handler),
        ("/delegator.json", mk_delegator_handler(linker)),
        ("/bound-names.json", mk_bound_names_handler(linker)),
        ("/anomaly.json", mk_anomaly_handler(linker)),
        ("/model.json", mk_model_handler(linker)),
        ("/tenants.json", mk_tenants_handler(linker)),
        ("/streams.json", mk_streams_handler(linker)),
        ("/config-check.json", mk_config_check_handler(linker)),
        ("/identifier.json", mk_identifier_handler(linker)),
        ("/logging.json", logging_handler),
        ("/admin/pprof/profile", pprof_profile_handler),
        ("/admin/pprof/heap", pprof_heap_handler),
    ]
