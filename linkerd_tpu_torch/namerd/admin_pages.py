"""namerd admin dtab pages: ``/dtabs`` index + ``/dtabs/<ns>`` detail: a copy of
``linkerd_tpu/namerd/admin_pages.py``.

Ref: namerd/admin/.../DtabListHandler.scala + DtabHandler.scala (the
reference renders a dashboard list of namespaces and a per-namespace
delegation view). Here: a minimal HTML index with namespace links and a
detail page showing the parsed dentries (prefix => dst per row), the
store version, and the raw dtab text. ``?format=json`` (or an
``Accept: application/json`` header) returns the same data as JSON for
tooling — closing the "control plane you can see into" half of ROADMAP
item 5.
"""

from __future__ import annotations

import html
import json
from typing import TYPE_CHECKING
from urllib.parse import parse_qsl, unquote, urlsplit

from linkerd_tpu_torch.protocol.http.message import Request, Response

if TYPE_CHECKING:  # pragma: no cover
    from linkerd_tpu_torch.namerd.core import Namerd

_PAGE = """<!doctype html>
<html><head><title>{title}</title><style>
body {{ font-family: monospace; margin: 2em; }}
table {{ border-collapse: collapse; }}
td, th {{ border: 1px solid #999; padding: 4px 10px; text-align: left; }}
th {{ background: #eee; }}
.muted {{ color: #666; }}
</style></head><body>
<h1>{title}</h1>
{body}
</body></html>"""


def _html_rsp(title: str, body: str, status: int = 200) -> Response:
    rsp = Response(status=status,
                   body=_PAGE.format(title=title, body=body).encode())
    rsp.headers.set("Content-Type", "text/html; charset=utf-8")
    return rsp


def _wants_json(req: Request) -> bool:
    q = dict(parse_qsl(urlsplit(req.uri).query))
    if q.get("format") == "json":
        return True
    accept = req.headers.get("Accept") or ""
    return "application/json" in accept


def _json_rsp(data, status: int = 200) -> Response:
    rsp = Response(status=status,
                   body=(json.dumps(data, indent=2) + "\n").encode())
    rsp.headers.set("Content-Type", "application/json")
    return rsp


def mk_dtab_index_handler(namerd: "Namerd"):
    """``/dtabs`` — namespace index with dentry counts and links."""

    async def handler(req: Request) -> Response:
        namespaces = sorted(namerd.store.list().sample())
        entries = []
        for ns in namespaces:
            vd = await namerd.store.observe(ns).to_future()
            entries.append({
                "namespace": ns,
                "dentries": len(vd.dtab) if vd is not None else 0,
                "version": vd.version.hex() if vd is not None else None,
            })
        if _wants_json(req):
            return _json_rsp(entries)
        if not entries:
            body = '<p class="muted">no dtab namespaces</p>'
        else:
            rows = "".join(
                f'<tr><td><a href="/dtabs/{html.escape(e["namespace"])}">'
                f'{html.escape(e["namespace"])}</a></td>'
                f'<td>{e["dentries"]}</td>'
                f'<td class="muted">{e["version"]}</td></tr>'
                for e in entries)
            body = ("<table><tr><th>namespace</th><th>dentries</th>"
                    f"<th>version</th></tr>{rows}</table>")
        return _html_rsp("namerd dtabs", body)

    return handler


def mk_dtab_detail_handler(namerd: "Namerd"):
    """``/dtabs/<ns>`` — parsed dentries + version + raw dtab."""

    async def handler(req: Request) -> Response:
        path = urlsplit(req.uri).path
        ns = unquote(path[len("/dtabs/"):]).strip("/")
        if not ns:
            return _html_rsp("namerd dtabs", "<p>missing namespace</p>",
                             status=404)
        vd = await namerd.store.observe(ns).to_future()
        if vd is None:
            if _wants_json(req):
                return _json_rsp(
                    {"error": f"no namespace {ns!r}"}, status=404)
            return _html_rsp(
                f"dtab {ns}",
                f"<p>no dtab namespace <b>{html.escape(ns)}</b></p>",
                status=404)
        dentries = [{"prefix": d.prefix.show, "dst": d.dst.show}
                    for d in vd.dtab]
        if _wants_json(req):
            return _json_rsp({"namespace": ns,
                              "version": vd.version.hex(),
                              "dentries": dentries,
                              "dtab": vd.dtab.show})
        rows = "".join(
            f"<tr><td>{html.escape(d['prefix'])}</td>"
            f"<td>{html.escape(d['dst'])}</td></tr>"
            for d in dentries)
        body = (
            f'<p><a href="/dtabs">&larr; all namespaces</a></p>'
            f'<p>version <span class="muted">{vd.version.hex()}</span>,'
            f' {len(dentries)} dentries</p>'
            f"<table><tr><th>prefix</th><th>dst</th></tr>{rows}</table>"
            f"<h2>raw</h2><pre>{html.escape(vd.dtab.show)}</pre>")
        return _html_rsp(f"dtab {ns}", body)

    return handler


def namerd_admin_handlers(namerd: "Namerd"):
    """(exact, prefix) handler lists for the namerd admin server."""
    exact = [("/dtabs", mk_dtab_index_handler(namerd))]
    prefix = [("/dtabs/", mk_dtab_detail_handler(namerd))]
    return exact, prefix
