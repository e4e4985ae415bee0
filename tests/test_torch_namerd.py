"""The port's namerd (``linkerd_tpu_torch/namerd/``), its HTTP control API,
the ``io.l5d.namerd.http`` interpreter and the reactor's store clients,
against the JAX package's on the same inputs, on the CPU.

- ``InMemoryDtabStore`` / ``FsDtabStore``: the same operations give the
  same versions, states and errors.
- ``Delegator``: the same delegation explanations (``delegate_json``).
- ``HttpControlService``: the same requests give the same status,
  ETag and body in both packages (GET, PUT with If-Match and a stale
  one, POST of an existing namespace, DELETE, 404s, bind, addr,
  delegate), and the same ``?watch=true`` NDJSON lines.
- Across packages, over sockets: the port's ``NamerdHttpStoreClient``
  (and ``cas_modify``) against the reference's namerd, the reference's
  client against the port's namerd.
- The port's ``NamerdHttpInterpreter`` rebinds on a namespace write
  served by either package's namerd.

Every await is bounded.
"""

import asyncio
import json
import time

import pytest

from linkerd_tpu import core as ref_core
from linkerd_tpu.control import reactor as ref_reactor
from linkerd_tpu.namer.delegate import Delegator as RefDelegator
from linkerd_tpu.namer.delegate import delegate_json as ref_delegate_json
from linkerd_tpu.namer.fs import FsNamer as RefFsNamer
from linkerd_tpu.namerd import store as ref_store
from linkerd_tpu.namerd.core import Namerd as RefNamerd
from linkerd_tpu.namerd.http_api import HttpControlService as RefControl
from linkerd_tpu.protocol.http import message as ref_message
from linkerd_tpu.protocol.http.server import serve as ref_serve
from linkerd_tpu_torch import core as port_core
from linkerd_tpu_torch.control import reactor as port_reactor
from linkerd_tpu_torch.interpreter.namerd_http import NamerdHttpInterpreter
from linkerd_tpu_torch.namer.delegate import Delegator as PortDelegator
from linkerd_tpu_torch.namer.delegate import (
    delegate_json as port_delegate_json,
)
from linkerd_tpu_torch.namer.fs import FsNamer as PortFsNamer
from linkerd_tpu_torch.namerd import store as port_store
from linkerd_tpu_torch.namerd.core import Namerd as PortNamerd
from linkerd_tpu_torch.namerd.http_api import HttpControlService as PortControl
from linkerd_tpu_torch.protocol.http import message as port_message
from linkerd_tpu_torch.protocol.http.server import serve as port_serve

REF = dict(core=ref_core, store=ref_store, Namerd=RefNamerd,
           Control=RefControl, message=ref_message, FsNamer=RefFsNamer,
           serve=ref_serve, reactor=ref_reactor, Delegator=RefDelegator,
           delegate_json=ref_delegate_json)
PORT = dict(core=port_core, store=port_store, Namerd=PortNamerd,
            Control=PortControl, message=port_message, FsNamer=PortFsNamer,
            serve=port_serve, reactor=port_reactor, Delegator=PortDelegator,
            delegate_json=port_delegate_json)

BASE = "/svc => /#/io.l5d.fs ;"


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def disco_dir(tmp_path):
    d = tmp_path / "disco"
    d.mkdir(exist_ok=True)
    (d / "web").write_text("127.0.0.1 9001\n127.0.0.1 9002\n")
    (d / "web-b").write_text("127.0.0.1 9003\n")
    return d


# -- stores ---------------------------------------------------------------------

async def store_ops(pkg, store):
    D = pkg["core"].Dtab.read
    out = [sorted(store.list().sample())]
    vd = await asyncio.wait_for(store.observe("default").to_future(), 5)
    out.append((vd.dtab.show, vd.version.hex()))
    for op, args in (
            ("create", ("ns2", D("/a => /b ;"))),
            ("create", ("ns2", D("/a => /c ;"))),
            ("update", ("ns2", D("/a => /d ;"), b"\0" * 8)),
            ("update", ("nope", D("/a => /d ;"), b"\0" * 8)),
            ("put", ("ns3", D("/x => /y ;"))),
            ("delete", ("ns3",)),
            ("delete", ("ns3",))):
        try:
            await getattr(store, op)(*args)
            out.append((op, "ok"))
        except Exception as e:  # noqa: BLE001 — the error is compared
            out.append((op, type(e).__name__, str(e)))
    vd = await asyncio.wait_for(store.observe("ns2").to_future(), 5)
    await store.update("ns2", D("/a => /e ;"), vd.version)
    for ns in ("default", "ns2", "ns3"):
        vd = await asyncio.wait_for(store.observe(ns).to_future(), 5)
        out.append(None if vd is None else (vd.dtab.show, vd.version.hex()))
    out.append(sorted(store.list().sample()))
    return out


@pytest.mark.parametrize("kind", ["InMemoryDtabStore", "FsDtabStore"])
def test_store_operations_match(kind, tmp_path):
    def mk(pkg, name):
        if kind == "FsDtabStore":
            d = tmp_path / name
            d.mkdir()
            (d / "default.dtab").write_text(BASE)
            return pkg["store"].FsDtabStore(str(d))
        return pkg["store"].InMemoryDtabStore(
            {"default": pkg["core"].Dtab.read(BASE)})

    async def go():
        return (await store_ops(REF, mk(REF, "ref")),
                await store_ops(PORT, mk(PORT, "port")))

    ref, port = run(go())
    assert port == ref
    if kind == "FsDtabStore":
        assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
            sorted(p.name for p in (tmp_path / "ref").iterdir()) == \
            ["default.dtab", "ns2.dtab"]


# -- delegation -------------------------------------------------------------------

DELEGATIONS = {
    "fs leaf": (BASE, "/svc/web"),
    "alt": (BASE + " /svc/web => /#/io.l5d.fs/nope | /#/io.l5d.fs/web-b ;",
            "/svc/web"),
    "union": (BASE + " /svc/web => 1 * /#/io.l5d.fs/web & 3 * /svc/web-b ;",
              "/svc/web"),
    "neg": ("/svc/x => /#/io.l5d.fs ;", "/svc/web"),
    "cycle": ("/svc/web => /svc/web ;", "/svc/web"),
    "utility": ("/svc => /$/inet/127.0.0.1 ;", "/svc/8080"),
}


@pytest.mark.parametrize("case", sorted(DELEGATIONS))
def test_delegation_matches(case, tmp_path):
    dtab, path = DELEGATIONS[case]
    d = disco_dir(tmp_path)

    def explain(pkg):
        from importlib import import_module
        core = pkg["core"]
        namer_core = import_module(
            pkg["store"].__name__.split(".")[0] + ".namer.core")
        interp = namer_core.ConfiguredDtabNamer(
            [(core.Path.read("/io.l5d.fs"), pkg["FsNamer"](str(d)))],
            dtab=core.Activity.value(core.Dtab.read(dtab)))
        return pkg["delegate_json"](pkg["Delegator"](interp).delegate(
            core.Dtab.empty(), core.Path.read(path)))

    assert explain(PORT) == explain(REF)


# -- the HTTP control API, in process ---------------------------------------------

def mk_namerd(pkg, tmp_path):
    return pkg["Namerd"](
        pkg["store"].InMemoryDtabStore(
            {"default": pkg["core"].Dtab.read(BASE)}),
        namers=[(pkg["core"].Path.read("/io.l5d.fs"),
                 pkg["FsNamer"](str(disco_dir(tmp_path))))])


def request(pkg, method, uri, body=b"", **headers):
    req = pkg["message"].Request(method=method, uri=uri, body=body)
    for k, v in headers.items():
        req.headers.set(k.replace("_", "-"), v)
    return req


async def api_session(pkg, tmp_path):
    """One scripted session against a fresh namerd: every response's
    status, ETag and body."""
    namerd = mk_namerd(pkg, tmp_path)
    svc = pkg["Control"](namerd)
    out = []

    async def call(method, uri, body=b"", **headers):
        rsp = await asyncio.wait_for(
            svc(request(pkg, method, uri, body, **headers)), 5)
        out.append((method, uri, rsp.status, rsp.headers.get("etag"),
                    rsp.body))
        return rsp

    await call("GET", "/api/1/dtabs")
    rsp = await call("GET", "/api/1/dtabs/default")
    etag = rsp.headers.get("etag")
    await call("GET", "/api/1/dtabs/nope")
    await call("PUT", "/api/1/dtabs/default",
               b"/svc => /#/io.l5d.fs ; /svc/web => /svc/web-b ;",
               content_type="application/dtab", if_match="00" * 8)
    await call("PUT", "/api/1/dtabs/default",
               b"/svc => /#/io.l5d.fs ; /svc/web => /svc/web-b ;",
               content_type="application/dtab", if_match=etag)
    await call("GET", "/api/1/dtabs/default")
    await call("POST", "/api/1/dtabs/default", b"/a => /b ;")
    await call("POST", "/api/1/dtabs/other",
               json.dumps([{"prefix": "/a", "dst": "/b | /c"}]).encode(),
               content_type="application/json")
    await call("GET", "/api/1/dtabs/other")
    await call("DELETE", "/api/1/dtabs/other")
    await call("DELETE", "/api/1/dtabs/other")
    await call("PATCH", "/api/1/dtabs/default")
    await call("GET", "/api/1/dtabs/default/extra")
    await call("GET", "/api/1/bind/default?path=/svc/web")
    await call("GET", "/api/1/bind/default?path=/svc/web&dtab="
               "/svc/web%3D%3E/svc/web-b")
    await call("GET", "/api/1/addr/default?path=/svc/web-b")
    await call("GET", "/api/1/addr/default?path=/svc/none")
    await call("GET", "/api/1/resolve/default?path=/svc/web")
    await call("GET", "/api/1/delegate/default?path=/svc/web")
    await call("GET", "/api/1/bind/default")
    await call("GET", "/nope")
    flat = {k: v for k, v in namerd.metrics.flatten().items()
            if k.endswith(("/requests", "/failures")) or "status" in k}
    await namerd.close()
    return out, flat


def test_control_api_answers_match(tmp_path):
    async def go():
        return (await api_session(REF, tmp_path / "r"),
                await api_session(PORT, tmp_path / "p"))

    (tmp_path / "r").mkdir()
    (tmp_path / "p").mkdir()
    ref, port = run(go())
    assert port == ref
    statuses = [s for _, _, s, _, _ in ref[0]]
    assert statuses[:12] == [200, 200, 404, 412, 204, 200, 409, 204, 200,
                             204, 404, 405]


async def next_line(it, timeout=5.0) -> bytes:
    return await asyncio.wait_for(it.__anext__(), timeout)


async def watch_session(pkg, tmp_path):
    """The watch streams of dtabs/<ns>, the namespace list, bind and
    addr: their first lines, and the lines each write pushes."""
    namerd = mk_namerd(pkg, tmp_path)
    svc = pkg["Control"](namerd)
    D = pkg["core"].Dtab.read
    streams = {}
    for name, uri in (("dtab", "/api/1/dtabs/default?watch=true"),
                      ("list", "/api/1/dtabs?watch=true"),
                      ("bind", "/api/1/bind/default?path=/svc/web"
                               "&watch=true"),
                      ("addr", "/api/1/addr/default?path=/svc/web"
                               "&watch=true"),
                      ("missing", "/api/1/dtabs/later?watch=true")):
        rsp = await asyncio.wait_for(svc(request(pkg, "GET", uri)), 5)
        assert rsp.status == 200 and rsp.body_stream is not None
        streams[name] = rsp.body_stream.__aiter__()
    out = {name: [await next_line(it)] for name, it in streams.items()}
    watches = namerd.metrics.flatten()["namerd/http/watches"]
    vd = await asyncio.wait_for(namerd.store.observe("default").to_future(),
                                5)
    await namerd.store.update(
        "default", D(BASE + " /svc/web => /#/io.l5d.fs/web-b ;"), vd.version)
    out["dtab"].append(await next_line(streams["dtab"]))
    out["bind"].append(await next_line(streams["bind"]))
    await namerd.store.create("later", D("/a => /b ;"))
    out["list"].append(await next_line(streams["list"]))
    out["missing"].append(await next_line(streams["missing"]))
    for it in streams.values():
        await it.aclose()
    out["watches"] = [watches, namerd.metrics.flatten()["namerd/http/watches"]]
    await namerd.close()
    return out


def test_watch_streams_match(tmp_path):
    async def go():
        return (await watch_session(REF, tmp_path / "r"),
                await watch_session(PORT, tmp_path / "p"))

    (tmp_path / "r").mkdir()
    (tmp_path / "p").mkdir()
    ref, port = run(go())
    assert port == ref
    assert json.loads(ref["dtab"][1])[-1] == {
        "prefix": "/svc/web", "dst": "/#/io.l5d.fs/web-b"}
    assert json.loads(ref["missing"][0]) is None
    assert ref["watches"] == [5.0, 0.0]


# -- over sockets, across packages ------------------------------------------------

async def client_session(client_pkg, server_pkg, tmp_path):
    """``client_pkg``'s NamerdHttpStoreClient against ``server_pkg``'s
    namerd served over HTTP: fetch, cas (good and stale), create (new
    and existing), cas_modify and one watch update."""
    namerd = mk_namerd(server_pkg, tmp_path)
    server = await server_pkg["serve"](server_pkg["Control"](namerd))
    reactor = client_pkg["reactor"]
    D = client_pkg["core"].Dtab.read
    client = reactor.NamerdHttpStoreClient(f"127.0.0.1:{server.bound_port}")
    out = []
    try:
        vd = await asyncio.wait_for(client.fetch("default"), 5)
        out.append((vd.dtab.show, vd.version.hex()))
        out.append(await asyncio.wait_for(client.fetch("nope"), 5))
        await asyncio.wait_for(client.cas(
            "default", D(BASE + " /svc/web => /svc/web-b ;"), vd.version), 5)
        for coro in (client.cas("default", D(BASE), vd.version),
                     client.cas("nope", D(BASE), vd.version),
                     client.create("default", D(BASE))):
            try:
                await asyncio.wait_for(coro, 5)
                out.append("ok")
            except Exception as e:  # noqa: BLE001 — compared
                out.append((type(e).__name__, str(e)))
        await asyncio.wait_for(client.create("ns2", D("/a => /b ;")), 5)
        conflicts = []
        wrote = await asyncio.wait_for(reactor.cas_modify(
            client, "ns3", lambda d: d + D("/c => /d ;"),
            create_if_missing=D("/a => /b ;"),
            on_conflict=lambda: conflicts.append(1)), 5)
        out.append((wrote.show, len(conflicts)))
        wrote = await asyncio.wait_for(reactor.cas_modify(
            client, "ns3", lambda d: d + D("/e => /f ;")), 5)
        out.append(wrote.show)
        watch = client.watch("default").__aiter__()
        out.append((await next_line(watch)).show)
        vd = await asyncio.wait_for(
            namerd.store.observe("default").to_future(), 5)
        await namerd.store.update("default", vd.dtab, vd.version)
        await namerd.store.put(
            "default", server_pkg["core"].Dtab.read("/svc => /x ;"))
        out.append((await next_line(watch)).show)
        await watch.aclose()
        for ns in ("default", "ns2", "ns3"):
            vd = await asyncio.wait_for(
                namerd.store.observe(ns).to_future(), 5)
            out.append((ns, vd.dtab.show, vd.version.hex()))
    finally:
        await client.aclose()
        await server.close()
        await namerd.close()
    return out


@pytest.mark.parametrize("pair", ["port client, ref namerd",
                                  "ref client, port namerd"])
def test_store_client_across_packages(pair, tmp_path):
    """Each package's client against the other package's namerd gives
    what the reference's client gives against the reference's."""
    c, s = (PORT, REF) if pair.startswith("port") else (REF, PORT)

    async def go():
        (tmp_path / "a").mkdir()
        (tmp_path / "b").mkdir()
        return (await client_session(REF, REF, tmp_path / "a"),
                await client_session(c, s, tmp_path / "b"))

    ref, got = run(go())
    assert got == ref
    assert ref[1] is None
    assert [r[0] for r in ref[2:5]] == [
        "DtabVersionMismatch", "DtabNamespaceDoesNotExist",
        "DtabNamespaceAlreadyExists"]


async def eventually(pred, what: str, timeout: float = 10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        await asyncio.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def first_leaf(state):
    """The first bound leaf of an Activity state's tree (an override
    binds as an Alt whose first branch is the override's)."""
    tree = getattr(state, "value", None)
    while tree is not None and hasattr(tree, "trees"):
        tree = tree.trees[0] if tree.trees else None
    return getattr(tree, "value", None)


@pytest.mark.parametrize("server", ["port", "ref"])
def test_interpreter_rebinds_on_a_namespace_write(server, tmp_path):
    """The port's io.l5d.namerd.http interpreter over either package's
    namerd: a bind resolves to the fs namer's addresses, and moves when
    the namespace is rewritten."""
    pkg = PORT if server == "port" else REF
    Dp = port_core.Dtab

    async def go():
        namerd = mk_namerd(pkg, tmp_path)
        srv = await pkg["serve"](pkg["Control"](namerd))
        interp = NamerdHttpInterpreter("127.0.0.1", srv.bound_port,
                                       namespace="default")
        try:
            act = interp.bind(Dp.empty(), port_core.Path.read("/svc/web"))
            tree = await asyncio.wait_for(act.to_future(), 5)
            leaf = tree.value
            assert leaf.id_.show == "/#/io.l5d.fs/web"
            await eventually(lambda: hasattr(leaf.addr.sample(),
                                             "addresses"), "addr")
            ports = sorted(a.port for a in leaf.addr.sample().addresses)
            vd = await asyncio.wait_for(
                namerd.store.observe("default").to_future(), 5)
            await namerd.store.update("default", pkg["core"].Dtab.read(
                BASE + " /svc/web => /svc/web-b ;"), vd.version)
            await eventually(
                lambda: first_leaf(act.current) is not None
                and first_leaf(act.current).id_.show
                == "/#/io.l5d.fs/web-b", "rebind")
            moved = first_leaf(act.current)
            await eventually(lambda: hasattr(moved.addr.sample(),
                                             "addresses"), "addr b")
            return ports, sorted(a.port
                                 for a in moved.addr.sample().addresses)
        finally:
            await interp.aclose()
            await srv.close()
            await namerd.close()

    assert run(go()) == ([9001, 9002], [9003])
