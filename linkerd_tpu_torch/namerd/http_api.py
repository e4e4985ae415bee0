"""namerd's HTTP control API (kind ``io.l5d.httpController``): a copy of
``linkerd_tpu/namerd/http_api.py``.

Ref: namerd/iface/control-http/.../HttpControlService.scala:118 — routes
``/api/1/dtabs[/ns]`` (CRUD with version ETags, ref DtabHandler.scala:171),
``/api/1/bind/<ns>``, ``/api/1/addr/<ns>``, ``/api/1/resolve/<ns>``; every
GET supports ``?watch=true`` newline-delimited-JSON chunked streaming.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Any, AsyncIterator, Callable, Dict, Optional
from urllib.parse import parse_qsl, unquote, urlsplit

from linkerd_tpu_torch.core import Activity, Dtab, Path, Var
from linkerd_tpu_torch.core.activity import Failed, Ok, Pending
from linkerd_tpu_torch.core.addr import (
    AddrFailed, AddrPending, Bound, BoundName,
)
from linkerd_tpu_torch.core.dtab import Dentry, Prefix
from linkerd_tpu_torch.core.nametree import (
    Alt, Empty, Fail, Leaf, NameTree, Neg, Union, parse as parse_tree,
)
from linkerd_tpu_torch.namerd.core import Namerd
from linkerd_tpu_torch.namerd.store import (
    DtabNamespaceAlreadyExists, DtabNamespaceDoesNotExist,
    DtabVersionMismatch, VersionedDtab,
)
from linkerd_tpu_torch.protocol.http.message import Headers, Request, Response
from linkerd_tpu_torch.router.service import Service

DTAB_CT = "application/dtab"
JSON_CT = "application/json"


# ---- JSON shapes -----------------------------------------------------------

def dtab_json(dtab: Dtab) -> Any:
    return [{"prefix": d.prefix.show, "dst": d.dst.show} for d in dtab]


def dtab_from_body(body: bytes, content_type: str) -> Dtab:
    text = body.decode("utf-8")
    if JSON_CT in content_type:
        data = json.loads(text)
        dentries = [
            Dentry(Prefix.read(d["prefix"]), parse_tree(d["dst"]))
            for d in data
        ]
        return Dtab(dentries)
    return Dtab.read(text)


def tree_json(tree: NameTree) -> Any:
    if isinstance(tree, Leaf):
        v = tree.value
        if isinstance(v, BoundName):
            return {"type": "leaf", "id": v.id_.show,
                    "residual": v.residual.show}
        return {"type": "leaf", "path": str(v)}
    if isinstance(tree, Alt):
        return {"type": "alt", "trees": [tree_json(t) for t in tree.trees]}
    if isinstance(tree, Union):
        return {"type": "union", "trees": [
            {"weight": w.weight, "tree": tree_json(w.tree)}
            for w in tree.weighted]}
    if isinstance(tree, Fail):
        return {"type": "fail"}
    if isinstance(tree, Empty):
        return {"type": "empty"}
    return {"type": "neg"}


def addr_json(addr) -> Any:
    if isinstance(addr, Bound):
        return {"type": "bound", "addrs": [
            {"ip": a.host, "port": a.port, "meta": dict(a.meta)}
            for a in sorted(addr.addresses,
                            key=lambda a: (a.host, a.port))]}
    if isinstance(addr, AddrFailed):
        return {"type": "failed", "cause": addr.why}
    if isinstance(addr, AddrPending):
        return {"type": "pending"}
    return {"type": "neg"}


def _json_rsp(data: Any, status: int = 200,
              etag: Optional[str] = None) -> Response:
    headers = Headers([("Content-Type", JSON_CT)])
    if etag:
        headers.set("ETag", etag)
    return Response(status=status, headers=headers,
                    body=(json.dumps(data) + "\n").encode())


def _err(status: int, msg: str) -> Response:
    return Response(status=status, body=(msg + "\n").encode())


async def _watch_states(act: Activity, to_json: Callable[[Any], Any]
                        ) -> AsyncIterator[bytes]:
    """NDJSON stream of an Activity's non-pending states, deduped."""
    last = None
    async for st in act.changes():
        if isinstance(st, Pending):
            continue
        if isinstance(st, Failed):
            data = {"error": str(st.exc)}
        else:
            data = to_json(st.value)
        line = (json.dumps(data) + "\n").encode()
        if line != last:
            last = line
            yield line


async def _watch_var(var: Var, to_json: Callable[[Any], Any]
                     ) -> AsyncIterator[bytes]:
    last = None
    async for v in var.changes():
        line = (json.dumps(to_json(v)) + "\n").encode()
        if line != last:
            last = line
            yield line


class HttpControlService(Service[Request, Response]):
    """The control API as a plain HTTP service (mount standalone or on
    the admin server). Per-endpoint request/latency/failure stats land
    under ``namerd/http/<endpoint>/*`` in the namerd MetricsTree."""

    def __init__(self, namerd: Namerd):
        self._namerd = namerd
        self._metrics = namerd.metrics.scope("namerd", "http")
        # live watch streams (chunked NDJSON responses still open)
        self._watches = 0
        self._metrics.gauge("watches", fn=lambda: float(self._watches))

    def _observe(self, endpoint: str, t0: float, status: int) -> None:
        node = self._metrics.scope(endpoint)
        node.counter("requests").incr()
        node.stat("latency_ms").add((time.monotonic() - t0) * 1e3)
        node.counter("status", f"{status // 100}XX").incr()
        if status >= 500:
            node.counter("failures").incr()

    def _track_watch(self, gen: AsyncIterator[bytes]) -> AsyncIterator[bytes]:
        async def tracked():
            self._watches += 1
            try:
                async for line in gen:
                    yield line
            finally:
                self._watches -= 1
        return tracked()

    async def __call__(self, req: Request) -> Response:
        parts = urlsplit(req.uri)
        segs = [unquote(s) for s in parts.path.split("/") if s]
        q = dict(parse_qsl(parts.query))
        watch = q.get("watch", "").lower() == "true"
        # bounded metric cardinality: only the fixed route set may name
        # a scope — an unmatched path (scanner sweep) must not mint a
        # permanent tree node per unique segment
        endpoint = (segs[2] if len(segs) >= 3 and segs[2] in (
            "dtabs", "bind", "addr", "resolve", "delegate") else "unknown")
        t0 = time.monotonic()
        try:
            rsp: Optional[Response] = None
            if segs[:3] == ["api", "1", "dtabs"]:
                rsp = await self._dtabs(req, segs[3:], q, watch)
            elif segs[:3] == ["api", "1", "bind"] and len(segs) == 4:
                rsp = await self._bind(segs[3], q, watch)
            elif segs[:3] == ["api", "1", "addr"] and len(segs) == 4:
                rsp = await self._addr(segs[3], q, watch)
            elif segs[:3] == ["api", "1", "resolve"] and len(segs) == 4:
                rsp = await self._resolve(segs[3], q, watch)
            elif segs[:3] == ["api", "1", "delegate"] and len(segs) == 4:
                rsp = await self._delegate(segs[3], q)
        except DtabNamespaceDoesNotExist as e:
            rsp = _err(404, str(e))
        except DtabNamespaceAlreadyExists as e:
            rsp = _err(409, str(e))
        except DtabVersionMismatch as e:
            rsp = _err(412, str(e))
        except (ValueError, KeyError) as e:
            rsp = _err(400, f"bad request: {e}")
        except BaseException:
            self._observe(endpoint, t0, 500)
            raise
        if rsp is None:
            rsp = _err(404, f"no such endpoint {parts.path}")
        if rsp.body_stream is not None:
            rsp.body_stream = self._track_watch(rsp.body_stream)
        self._observe(endpoint, t0, rsp.status)
        return rsp

    # ---- /api/1/dtabs ------------------------------------------------------

    async def _dtabs(self, req: Request, rest, q, watch: bool) -> Response:
        store = self._namerd.store
        if not rest:
            if req.method != "GET":
                return _err(405, "method not allowed")
            if watch:
                return Response(
                    status=200, headers=Headers([("Content-Type", JSON_CT)]),
                    body_stream=_watch_var(
                        store.list(), lambda nss: sorted(nss)))
            return _json_rsp(sorted(store.list().sample()))
        if len(rest) != 1:
            return _err(404, "expected /api/1/dtabs[/<ns>]")
        ns = rest[0]
        if req.method == "GET":
            act = store.observe(ns)
            if watch:
                return Response(
                    status=200, headers=Headers([("Content-Type", JSON_CT)]),
                    body_stream=_watch_states(
                        act, lambda vd: dtab_json(vd.dtab)
                        if vd is not None else None))
            vd = await act.to_future()
            if vd is None:
                return _err(404, f"dtab namespace {ns!r} does not exist")
            return _json_rsp(dtab_json(vd.dtab), etag=vd.version.hex())
        ct = req.headers.get("content-type") or DTAB_CT
        if req.method == "POST":
            await store.create(ns, dtab_from_body(req.body, ct))
            return Response(status=204)
        if req.method == "PUT":
            dtab = dtab_from_body(req.body, ct)
            if_match = req.headers.get("if-match")
            if if_match:
                await store.update(ns, dtab, bytes.fromhex(if_match))
            else:
                await store.put(ns, dtab)
            return Response(status=204)
        if req.method == "DELETE":
            await store.delete(ns)
            return Response(status=204)
        return _err(405, "method not allowed")

    # ---- /api/1/bind, /addr, /resolve --------------------------------------

    def _bind_act(self, ns: str, q: Dict[str, str]) -> Activity:
        path = Path.read(q["path"])
        extra = Dtab.read(q["dtab"]) if q.get("dtab") else Dtab.empty()
        return self._namerd.interpreter(ns).bind(extra, path)

    async def _bind(self, ns: str, q, watch: bool) -> Response:
        act = self._bind_act(ns, q)
        if watch:
            async def gen():
                try:
                    async for line in _watch_states(act, tree_json):
                        yield line
                finally:
                    act.close()
            return Response(
                status=200, headers=Headers([("Content-Type", JSON_CT)]),
                body_stream=gen())
        try:
            tree = await act.to_future()
            return _json_rsp(tree_json(tree))
        finally:
            act.close()

    def _first_leaf(self, tree: NameTree) -> Optional[BoundName]:
        if isinstance(tree, Leaf):
            return tree.value
        for sub in getattr(tree, "trees", ()):
            found = self._first_leaf(sub)
            if found is not None:
                return found
        for w in getattr(tree, "weighted", ()):
            found = self._first_leaf(w.tree)
            if found is not None:
                return found
        return None

    async def _addr(self, ns: str, q, watch: bool) -> Response:
        act = self._bind_act(ns, q)
        try:
            tree = await act.to_future()
        except Exception:
            act.close()
            raise
        leaf = self._first_leaf(tree)
        if leaf is None:
            act.close()
            return _json_rsp({"type": "neg"})
        if watch:
            async def gen():
                try:
                    async for line in _watch_var(leaf.addr, addr_json):
                        yield line
                finally:
                    act.close()
            return Response(
                status=200, headers=Headers([("Content-Type", JSON_CT)]),
                body_stream=gen())
        try:
            addr = leaf.addr.sample()
            if isinstance(addr, AddrPending):
                async for a in leaf.addr.changes():
                    if not isinstance(a, AddrPending):
                        addr = a
                        break
            return _json_rsp(addr_json(addr))
        finally:
            act.close()

    async def _resolve(self, ns: str, q, watch: bool) -> Response:
        # bind + addr of the tree's first live leaf (ResolveHandler)
        return await self._addr(ns, q, watch)

    async def _delegate(self, ns: str, q) -> Response:
        """Step-by-step delegation explanation
        (ref: HttpControlService /api/1/delegate + DelegateApiHandler)."""
        from linkerd_tpu_torch.namer.core import ConfiguredDtabNamer
        from linkerd_tpu_torch.namer.delegate import Delegator, delegate_json
        path = Path.read(q["path"])
        extra = Dtab.read(q["dtab"]) if q.get("dtab") else Dtab.empty()
        interp = self._namerd.interpreter(ns)
        if not isinstance(interp, ConfiguredDtabNamer):
            return _err(501, "delegation unsupported for this interpreter")
        return _json_rsp(delegate_json(
            Delegator(interp).delegate(extra, path)))
