"""The port's mesh gRPC API between linkerd and namerd against the JAX
package's, on the CPU: ``mesh/`` (messages, services, converters),
namerd's ``io.l5d.mesh`` interface (``namerd/mesh_iface.py``) and the
``io.l5d.mesh`` interpreter (``interpreter/mesh.py``).

- Every ``mesh/messages`` type, filled from a numpy seed, encodes to the
  same bytes in both packages, and each package decodes the other's
  bytes back to them.
- The converters take seeded dtabs, name trees, bound trees and
  addresses to equal bytes and back to equal values.
- ``MeshIface`` answers ``Get``/``Stream`` ``BoundTree``, ``Replicas`` and
  ``Dtab`` with equal bytes, before and after a dtab write and an
  address change, and NOT_FOUND alike.
- ``MeshClientInterpreter`` binds alike against either package's
  namerd, follows a write, and after the namerd's server is closed and
  started again on its port reconnects with backoff and follows the next
  write. Both packages see the same reconnect errors on the way (a reset
  stream goes through the shared ``GrpcStatus.from_reset``
  ``AttributeError``, ROADMAP Queue 3).
- A linker with ``interpreter: {kind: io.l5d.mesh}`` binds a Python h2
  router and an h2 ``fastPath: true`` router through namerd and follows
  a dtab write, as the reference's linker does.
- namerd's config takes ``namerdIface: io.l5d.mesh`` beside
  ``io.l5d.httpController``, in process and through ``python -m
  linkerd_tpu_torch.namerd``.

Answers and bytes are compared exactly (no tolerance: nothing here is
a float computed differently). Every await is bounded.
"""

import asyncio
import importlib
import json
import logging
import os
import socket
import subprocess
import sys
import time
import types
import urllib.request
from pathlib import Path as FsPath

import numpy as np
import pytest

ROOT = FsPath(__file__).resolve().parent.parent
WAIT_S = 10
SEEDS = (0, 1, 2, 3)


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def bounded(aw, timeout=WAIT_S):
    return asyncio.wait_for(aw, timeout)


async def until(cond, what: str, timeout=WAIT_S):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.01)


def package(name: str) -> types.SimpleNamespace:
    """The modules of one package (``linkerd_tpu`` or
    ``linkerd_tpu_torch``) this file drives."""
    mod = lambda rel: importlib.import_module(f"{name}.{rel}")  # noqa: E731
    return types.SimpleNamespace(
        name=name, core=mod("core"), addr=mod("core.addr"),
        nametree=mod("core.nametree"), var=mod("core.var"),
        messages=mod("mesh.messages"), mesh=mod("mesh"),
        conv=mod("mesh.converters"), grpc=mod("grpc"),
        status=mod("grpc.status"), iface=mod("namerd.mesh_iface"),
        namerd=mod("namerd"), fs=mod("namer.fs"),
        interp=mod("interpreter.mesh"), h2client=mod("protocol.h2.client"),
        h2server=mod("protocol.h2.server"), linker=mod("linker"),
        namerd_config=mod("namerd.config"), config=mod("config"))


PKGS = {"ref": package("linkerd_tpu"), "port": package("linkerd_tpu_torch")}


# -- messages ----------------------------------------------------------------


def message_types(pkg) -> list:
    base = pkg.grpc.ProtoMessage
    return sorted(n for n, c in vars(pkg.messages).items()
                  if isinstance(c, type) and issubclass(c, base)
                  and c is not base)


def describe(cls, rng, depth: int = 0) -> dict:
    """A random value for each field of ``cls`` (about half present), as
    plain data: a nested message is ``(class name, its description)``."""
    out = {}
    for name, f in cls.FIELDS.items():
        if rng.random() < 0.5:
            continue
        if f.kind == "message" and depth >= 3:
            continue
        n = int(rng.integers(0, 4)) if f.repeated else 1
        vals = [scalar(f, rng, depth) for _ in range(n)]
        out[name] = vals if f.repeated else vals[0]
    return out


def scalar(f, rng, depth: int):
    k = f.kind
    if k == "message":
        return (f.message.__name__, describe(f.message, rng, depth + 1))
    if k == "bytes":
        return rng.integers(0, 256, int(rng.integers(0, 9)),
                            dtype=np.uint8).tobytes()
    if k == "string":
        return "".join(rng.choice(list("abcxyz-/.:é"),
                                  int(rng.integers(0, 9))))
    if k == "double":
        return float(rng.normal() * 10 ** int(rng.integers(-3, 4)))
    if k == "enum":
        return int(rng.integers(0, 2))
    if k == "int32":
        return int(rng.integers(-2 ** 31, 2 ** 31))
    raise AssertionError(f"field kind {k!r} has no generator here")


def build(pkg, cls_name: str, desc: dict):
    cls = getattr(pkg.messages, cls_name)

    def val(v):
        if isinstance(v, tuple):
            return build(pkg, *v)
        return v

    return cls(**{k: [val(x) for x in v] if isinstance(v, list) else val(v)
                  for k, v in desc.items()})


def test_message_types_are_the_same():
    assert message_types(PKGS["port"]) == message_types(PKGS["ref"])
    assert len(message_types(PKGS["port"])) >= 25


@pytest.mark.parametrize("name", message_types(PKGS["port"]))
def test_every_message_type_encodes_alike(name):
    ref, port = PKGS["ref"], PKGS["port"]
    for seed in range(12):
        desc = describe(getattr(port.messages, name),
                        np.random.default_rng(seed))
        got = build(port, name, desc).encode()
        want = build(ref, name, desc).encode()
        assert got == want, (name, seed)
        assert getattr(ref.messages, name).decode(got).encode() == want
        assert getattr(port.messages, name).decode(want).encode() == got


# -- converters --------------------------------------------------------------

SEGS = ("svc", "web", "api", "#", "io.l5d.fs", "$", "inet", "127.0.0.1",
        "8080", "x-1", "é")


def rand_path(rng, lo: int = 1) -> str:
    return "/" + "/".join(rng.choice(SEGS, int(rng.integers(lo, 5))))


def rand_tree(rng, depth: int = 0) -> str:
    """NameTree text: alternatives of unions of weighted simple trees."""
    def simple():
        r = rng.random()
        if depth < 2 and r < 0.15:
            return f"({rand_tree(rng, depth + 1)})"
        if r < 0.25:
            return str(rng.choice(["~", "$", "!"]))
        return rand_path(rng)

    def union():
        parts = []
        for _ in range(int(rng.integers(1, 4))):
            w = f"{rng.integers(1, 100) / 10} * " if rng.random() < 0.5 \
                else ""
            parts.append(w + simple())
        return " & ".join(parts)

    return " | ".join(union() for _ in range(int(rng.integers(1, 3))))


def rand_dtab(rng) -> str:
    out = []
    for _ in range(int(rng.integers(0, 5))):
        prefix = "/" + "/".join(
            "*" if rng.random() < 0.2 else str(rng.choice(SEGS))
            for _ in range(int(rng.integers(1, 4))))
        out.append(f"{prefix} => {rand_tree(rng)} ;")
    return " ".join(out)


def rand_addr(pkg, rng):
    a = pkg.addr
    r = rng.random()
    if r < 0.15:
        return a.AddrFailed("why-" + str(rng.integers(100)))
    if r < 0.25:
        return a.ADDR_NEG
    if r < 0.35:
        return a.ADDR_PENDING
    addrs = []
    for _ in range(int(rng.integers(0, 4))):
        kind = rng.integers(3)
        host = (".".join(str(x) for x in rng.integers(0, 256, 4))
                if kind == 0 else
                f"fe80::{int(rng.integers(1, 65535)):x}" if kind == 1 else
                f"host-{int(rng.integers(100))}.example")
        meta = {"nodeName": f"n{int(rng.integers(9))}"} \
            if rng.random() < 0.5 else {}
        addrs.append(a.Address.mk(host, int(rng.integers(1, 65536)), **meta))
    return a.Bound(frozenset(addrs))


def addr_key(addr):
    if type(addr).__name__ == "Bound":
        return ("Bound", sorted((x.host, x.port, tuple(sorted(
            dict(x.meta).items()))) for x in addr.addresses))
    return (type(addr).__name__, getattr(addr, "why", None))


def bound_tree(pkg, text: str):
    """The path tree ``text`` with every leaf a BoundName of that id and a
    one-segment residual."""
    return pkg.nametree.parse(text).map(lambda p: pkg.addr.BoundName(
        p, pkg.var.Var(pkg.addr.ADDR_PENDING), pkg.core.Path.read("/rest")))


def converted(pkg, seed: int) -> list:
    """Each converter's bytes and round-trip on the seed's inputs."""
    rng = np.random.default_rng(seed)
    c, core = pkg.conv, pkg.core
    out = []
    for _ in range(8):
        dtab = core.Dtab.read(rand_dtab(rng))
        enc = c.dtab_to_proto(dtab).encode()
        back = c.dtab_from_proto(pkg.messages.MDtab.decode(enc))
        out.append(("dtab", enc, back.show, back.show == dtab.show))
        text = rand_tree(rng)
        tree = pkg.nametree.parse(text)
        enc = c.pathtree_to_proto(tree).encode()
        back = c.pathtree_from_proto(pkg.messages.MPathNameTree.decode(enc))
        out.append(("pathtree", enc, back.show, back.show == tree.show))
        bt = bound_tree(pkg, text)
        enc = c.boundtree_to_proto(bt).encode()
        back = c.boundtree_from_proto(
            pkg.messages.MBoundNameTree.decode(enc),
            lambda i, r: pkg.addr.BoundName(
                i, pkg.var.Var(pkg.addr.ADDR_PENDING), r))
        out.append(("boundtree", enc, back.show, back == bt))
        path = core.Path.read(rand_path(rng, lo=0))
        enc = c.path_to_proto(path).encode()
        out.append(("path", enc, c.path_from_proto(
            pkg.messages.MPath.decode(enc)).show))
        addr = rand_addr(pkg, rng)
        enc = c.addr_to_replicas(addr).encode()
        back = c.addr_from_replicas(pkg.messages.MReplicas.decode(enc))
        out.append(("addr", enc, addr_key(back), addr_key(addr)))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_converters_round_trip_alike(seed):
    got, want = converted(PKGS["port"], seed), converted(PKGS["ref"], seed)
    assert got == want
    for row in got:
        if row[0] in ("dtab", "pathtree", "boundtree"):
            assert row[3], row  # the round trip keeps the value
        if row[0] == "addr" and row[3][0] == "Bound" and all(
                ":" in h or h.replace(".", "").isdigit()
                for h, _, _ in row[3][1]):
            assert row[2] == row[3], row  # literal hosts come back


# -- namerd's mesh interface -------------------------------------------------

BASE_DTAB = "/svc => /#/io.l5d.fs ;"


def mk_namerd(pkg, disco):
    return pkg.namerd.Namerd(
        pkg.namerd.InMemoryDtabStore(
            {"default": pkg.core.Dtab.read(BASE_DTAB)}),
        [(pkg.core.Path.read("/io.l5d.fs"),
          pkg.fs.FsNamer(str(disco), 0.05))])


async def write_dtab(pkg, namerd, text: str) -> None:
    vd = await bounded(namerd.store.observe("default").to_future())
    await namerd.store.update("default", pkg.core.Dtab.read(text), vd.version)


def p2p(pkg, text: str):
    return pkg.conv.path_to_proto(pkg.core.Path.read(text))


async def iface_session(pkg, disco) -> list:
    """Every mesh call against a namerd of ``pkg``, by that package's
    client: the encoded answers, before and after a write and an address
    change."""
    (disco / "web").write_text("127.0.0.1 8080\n127.0.0.1 8081\n")
    (disco / "web-b").write_text("127.0.0.1 9090\n")
    m, mesh = pkg.messages, pkg.mesh
    namerd = mk_namerd(pkg, disco)
    server = await bounded(pkg.h2server.H2Server(
        pkg.iface.MeshIface(namerd).dispatcher).start())
    h2 = pkg.h2client.H2Client("127.0.0.1", server.bound_port)
    client = pkg.grpc.ClientDispatcher(h2)
    bind = m.MBindReq(root=p2p(pkg, "/default"), name=p2p(pkg, "/svc/web"),
                      dtab=pkg.conv.dtab_to_proto(
                          pkg.core.Dtab.read("/x => /y ;")))
    reps = m.MReplicasReq(id=p2p(pkg, "/#/io.l5d.fs/web"))
    dreq = m.MDtabReq(root=p2p(pkg, "/default"))
    out = []
    try:
        out.append(("get bound", (await bounded(client.unary(
            mesh.INTERPRETER_SVC, "GetBoundTree", bind))).encode()))
        out.append(("get replicas", (await bounded(client.unary(
            mesh.RESOLVER_SVC, "GetReplicas", reps))).encode()))
        out.append(("get dtab", (await bounded(client.unary(
            mesh.DELEGATOR_SVC, "GetDtab", dreq))).encode()))
        try:
            await bounded(client.unary(mesh.DELEGATOR_SVC, "GetDtab",
                                       m.MDtabReq(root=p2p(pkg, "/nope"))))
        except pkg.grpc.GrpcError as e:
            out.append(("missing namespace", e.status.code))
        streams = [await bounded(client.server_stream(svc, name, req))
                   for svc, name, req in (
                       (mesh.INTERPRETER_SVC, "StreamBoundTree", bind),
                       (mesh.RESOLVER_SVC, "StreamReplicas", reps),
                       (mesh.DELEGATOR_SVC, "StreamDtab", dreq))]
        out.append(("first", [(await bounded(s.recv())).encode()
                              for s in streams]))
        await write_dtab(pkg, namerd, BASE_DTAB + " /svc/web => /svc/web-b ;")
        (disco / "web").write_text("127.0.0.1 7070\n")
        out.append(("bound after the write",
                    (await bounded(streams[0].recv())).encode()))
        out.append(("replicas after the edit",
                    (await bounded(streams[1].recv())).encode()))
        out.append(("dtab after the write",
                    (await bounded(streams[2].recv())).encode()))
    finally:
        await bounded(h2.close())
        await bounded(server.close())
        await bounded(namerd.close())
    return out


def test_mesh_iface_answers_alike(tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want = run(iface_session(PKGS["ref"], tmp_path / "ref"))
    got = run(iface_session(PKGS["port"], tmp_path / "port"))
    assert got == want
    m, conv = PKGS["port"].messages, PKGS["port"].conv
    leaf = m.MBoundTreeRsp.decode(got[0][1]).tree.leaf
    assert conv.path_from_proto(leaf.id).show == "/#/io.l5d.fs/web"
    # the override first, the namespace's own dentry as its fallback
    after = m.MBoundTreeRsp.decode(got[5][1]).tree.alt.trees
    assert [conv.path_from_proto(s.leaf.id).show for s in after] == [
        "/#/io.l5d.fs/web-b", "/#/io.l5d.fs/web"]
    assert got[3] == ("missing namespace", PKGS["port"].status.NOT_FOUND)
    rep = m.MReplicas.decode(got[6][1])
    assert [e.port for e in rep.bound.endpoints] == [7070]


# -- the io.l5d.mesh interpreter -------------------------------------------


class Errors(logging.Handler):
    """The exception types the interpreters' reconnect loops log."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.seen = []

    def emit(self, record):
        if record.args and isinstance(record.args[-1], BaseException):
            self.seen.append(type(record.args[-1]).__name__)


async def interp_session(ipkg, npkg, disco) -> list:
    """``ipkg``'s MeshClientInterpreter against ``npkg``'s namerd: the
    bound id and its replicas, after a write, and after the server is
    closed and started again on its port and another write. Returns
    what it saw and the reconnect errors logged."""
    (disco / "web").write_text("127.0.0.1 8080\n127.0.0.1 8081\n")
    (disco / "web-b").write_text("127.0.0.1 9090\n")
    (disco / "web-c").write_text("127.0.0.1 9191\n")
    namerd = mk_namerd(npkg, disco)

    async def serve(port=0):
        return await bounded(npkg.h2server.H2Server(
            npkg.iface.MeshIface(namerd).dispatcher, port=port).start())

    server = await serve()
    port = server.bound_port
    interp = ipkg.interp.MeshClientInterpreter(
        "127.0.0.1", port, root="default", backoff_base=0.05,
        backoff_max=0.2)
    errors = Errors()
    logger = logging.getLogger(f"{ipkg.name}.interpreter.mesh")
    logger.addHandler(errors)
    level, logger.level = logger.level, logging.DEBUG
    act = interp.bind(ipkg.core.Dtab.empty(), ipkg.core.Path.read("/svc/web"))
    out = []

    def leaf():
        """The bound tree's first leaf: an override binds as an Alt of
        it and the namespace's own dentry."""
        tree = getattr(act.current, "value", None)
        while tree is not None and hasattr(tree, "trees"):
            tree = tree.trees[0]
        return getattr(tree, "value", None)

    async def seen(dst: str, ports):
        def ok():
            bn = leaf()
            if bn is None or bn.id_.show != dst:
                return False
            a = bn.addr.sample()
            return type(a).__name__ == "Bound" and \
                sorted(x.port for x in a.addresses) == ports
        await until(ok, f"{dst} at {ports}")
        out.append((dst, ports))

    try:
        await seen("/#/io.l5d.fs/web", [8080, 8081])
        await write_dtab(npkg, namerd, BASE_DTAB + " /svc/web => /svc/web-b ;")
        await seen("/#/io.l5d.fs/web-b", [9090])
        await bounded(server.close())
        await asyncio.sleep(0.3)  # the watches fail and back off
        server = await serve(port)
        await write_dtab(npkg, namerd, BASE_DTAB + " /svc/web => /svc/web-c ;")
        await seen("/#/io.l5d.fs/web-c", [9191])
    finally:
        logger.removeHandler(errors)
        logger.level = level
        await bounded(interp.aclose())
        await bounded(server.close())
        await bounded(namerd.close())
    return out, sorted(set(errors.seen))


@pytest.mark.parametrize("namerd_pkg", ["ref", "port"])
def test_interpreter_binds_follows_and_reconnects_alike(namerd_pkg,
                                                        tmp_path):
    outs = {}
    for ipkg in ("ref", "port"):
        (tmp_path / ipkg).mkdir()
        outs[ipkg] = run(interp_session(PKGS[ipkg], PKGS[namerd_pkg],
                                        tmp_path / ipkg))
    assert outs["port"] == outs["ref"]
    seen, errors = outs["port"]
    assert seen == [("/#/io.l5d.fs/web", [8080, 8081]),
                    ("/#/io.l5d.fs/web-b", [9090]),
                    ("/#/io.l5d.fs/web-c", [9191])]
    # the reset stream goes through the shared from_reset AttributeError
    assert "AttributeError" in errors, errors


# -- a linker bound through the mesh API ------------------------------------


class Echo:
    """The test's gRPC service, built in each package."""

    def __init__(self, pkg):
        g = pkg.grpc

        class Msg(g.ProtoMessage):
            FIELDS = {"text": g.Field(1, "string")}

        self.msg = Msg
        self.svc = g.ServiceDef("mesh.Echo", [g.Rpc("Echo", Msg, Msg)])

    def dispatcher(self, pkg, name: str):
        disp = pkg.grpc.ServerDispatcher()

        async def echo(req):
            return self.msg(text=f"{name}:{req.text}")

        disp.register_all(self.svc, {"Echo": echo})
        return disp


def linker_text(mesh_port: int, disco, fast: bool) -> str:
    router = {"protocol": "h2", "label": "h2fp" if fast else "h2",
              "servers": [{"port": 0}],
              "interpreter": {"kind": "io.l5d.mesh",
                              "dst": f"/$/inet/127.0.0.1/{mesh_port}",
                              "root": "/default"}}
    if fast:
        router["fastPath"] = True
    return json.dumps({"routers": [router], "namers": [
        {"kind": "io.l5d.fs", "rootDir": str(disco)}]})


async def linker_session(pkg, disco, fast: bool) -> list:
    """A linker of ``pkg`` whose h2 router (Python or fastPath) binds
    through ``pkg``'s namerd over the mesh API: who answers ``web``
    before and after a write that moves it to ``web-b``, and the
    router's type."""
    echo = Echo(pkg)
    a = await bounded(pkg.h2server.H2Server(
        echo.dispatcher(pkg, "A")).start())
    b = await bounded(pkg.h2server.H2Server(
        echo.dispatcher(pkg, "B")).start())
    (disco / "web").write_text(f"127.0.0.1 {a.bound_port}\n")
    (disco / "web-b").write_text(f"127.0.0.1 {b.bound_port}\n")
    namerd = mk_namerd(pkg, disco)
    mesh = await bounded(pkg.h2server.H2Server(
        pkg.iface.MeshIface(namerd).dispatcher).start())
    text = linker_text(mesh.bound_port, disco, fast)
    linker = (pkg.linker.load_linker(text, device="cpu")
              if pkg.name == "linkerd_tpu_torch"
              else pkg.linker.load_linker(text))
    await bounded(linker.start())
    h2 = pkg.h2client.H2Client("127.0.0.1",
                               linker.routers[0].server_ports[0])
    stub = pkg.grpc.ClientDispatcher(h2, authority="web")
    out = []

    async def call():
        return (await bounded(stub.unary(echo.svc, "Echo",
                                         echo.msg(text="hi")))).text

    try:
        out.append(await call())
        await write_dtab(pkg, namerd, BASE_DTAB + " /svc/web => /svc/web-b ;")
        for _ in range(300):
            got = await call()
            if got == "B:hi":
                break
            await asyncio.sleep(0.02)
        out.append(got)
        out.append(type(linker.routers[0]).__name__)
    finally:
        await bounded(h2.close())
        await bounded(linker.close())
        await bounded(mesh.close())
        await bounded(namerd.close())
        await bounded(a.close())
        await bounded(b.close())
    return out


@pytest.fixture(scope="module")
def engines():
    """Both engine libraries, built before any event loop runs."""
    from linkerd_tpu import native as ref_native
    from linkerd_tpu_torch import native

    native.ensure_built()
    if not ref_native.ensure_built():
        pytest.fail("the reference's native library did not build")


@pytest.mark.parametrize("fast", [False, True], ids=["python", "fastpath"])
def test_linker_binds_h2_routers_through_mesh_alike(fast, engines,
                                                    tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want = run(linker_session(PKGS["ref"], tmp_path / "ref", fast))
    got = run(linker_session(PKGS["port"], tmp_path / "port", fast))
    assert got == want
    assert got[:2] == ["A:hi", "B:hi"]
    assert got[2] == ("_FastPathRouter" if fast else "Router")


def test_mesh_interpreter_config_alike():
    """``interpreter: {kind: io.l5d.mesh}`` builds the same client in both
    packages, and a bad ``dst`` fails with the same words."""
    out = {}
    for name, pkg in PKGS.items():
        cfg = pkg.config.instantiate("interpreter", {
            "kind": "io.l5d.mesh", "dst": "/$/inet/10.1.2.3/4321",
            "root": "/ns1"}, "interpreter")
        interp = cfg.mk([])
        try:
            pkg.config.instantiate("interpreter", {
                "kind": "io.l5d.mesh", "dst": "/#/io.l5d.fs/x"},
                "interpreter").mk([])
        except pkg.config.ConfigError as e:
            err = str(e)
        out[name] = (type(interp).__name__, interp.host, interp.port,
                     interp.root.show, err)
    assert out["port"] == out["ref"] == (
        "MeshClientInterpreter", "10.1.2.3", 4321, "/ns1", out["ref"][4])
    assert "/$/inet/<host>/<port>" in out["port"][4]


# -- namerd's config and CLI ----------------------------------------------


def namerd_text(disco, mesh: int = 0, http: int = 0, admin=None) -> str:
    cfg = {"storage": {"kind": "io.l5d.inMemory",
                       "namespaces": {"default": BASE_DTAB}},
           "interfaces": [{"kind": "io.l5d.mesh", "port": mesh},
                          {"kind": "io.l5d.httpController", "port": http}],
           "namers": [{"kind": "io.l5d.fs", "rootDir": str(disco)}]}
    if admin is not None:
        cfg["admin"] = {"port": admin}
    return json.dumps(cfg)


async def get_dtab(pkg, port: int) -> bytes:
    h2 = pkg.h2client.H2Client("127.0.0.1", port)
    try:
        rsp = await bounded(pkg.grpc.ClientDispatcher(h2).unary(
            pkg.mesh.DELEGATOR_SVC, "GetDtab",
            pkg.messages.MDtabReq(root=p2p(pkg, "/default"))))
        return rsp.encode()
    finally:
        await bounded(h2.close())


async def namerd_process_session(pkg, disco) -> list:
    proc = pkg.namerd_config.NamerdProcess(
        pkg.namerd_config.parse_namerd_spec(namerd_text(disco)))
    await bounded(proc.start())
    try:
        mesh_port, http_port = proc.bound_ports
        types_ = [type(s).__name__ for s in proc.servers]
        body = await asyncio.to_thread(lambda: urllib.request.urlopen(
            f"http://127.0.0.1:{http_port}/api/1/dtabs/default",
            timeout=WAIT_S).read())
        return [types_, await get_dtab(pkg, mesh_port), json.loads(body)]
    finally:
        await bounded(proc.close())


def test_namerd_config_serves_mesh_beside_http_alike(tmp_path):
    got = run(namerd_process_session(PKGS["port"], tmp_path))
    want = run(namerd_process_session(PKGS["ref"], tmp_path))
    assert got == want
    assert got[0] == ["H2Server", "HttpServer"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_namerd_cli_serves_mesh(tmp_path):
    """``python -m linkerd_tpu_torch.namerd`` with the mesh and HTTP
    interfaces: the mesh answers GetDtab as the in-process namerd does,
    the HTTP API answers, and SIGTERM stops it."""
    mesh, http, admin = free_port(), free_port(), free_port()
    cfg = tmp_path / "namerd.json"
    cfg.write_text(namerd_text(tmp_path, mesh, http, admin))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "linkerd_tpu_torch.namerd", str(cfg)],
        cwd=tmp_path, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    try:
        t0 = time.monotonic()
        while True:
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{admin}/ping",
                                       timeout=1).read()
                break
            except OSError:
                if proc.poll() is not None or time.monotonic() - t0 > 60:
                    raise AssertionError("namerd did not answer /ping")
                time.sleep(0.1)
        port = PKGS["port"]
        got = run(get_dtab(port, mesh))
        want = run(namerd_process_session(port, tmp_path))[1]
        assert got == want
        body = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{http}/api/1/dtabs/default",
            timeout=WAIT_S).read())
        assert body
    finally:
        proc.terminate()
        _, err = proc.communicate(timeout=30)
    assert proc.returncode == 0, err[-3000:]
