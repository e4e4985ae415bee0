"""namerd's thrift interface and the ``io.l5d.namerd`` interpreter: the
port's against the JAX package's, on the CPU.

- Every IDL struct of ``namerd/thrift_idl.py``, filled from a numpy
  seed (unions with one field set), encodes to the same bytes in both
  packages and decodes back to the same values; so do a call and its
  reply (``encode_call``/``decode_call_reply``).
- Each package's ``ThriftNamerIface`` over its own namerd (the same
  store, the same fs namer directory; the stamper's instance prefix made
  the same) answers the same calls with the same bytes: dtab, bind, addr
  and delegate, an unbound name, stamps included, and the parked long
  polls answered by a dtab write and by an address change.
- Each package's ``ThriftNamerInterpreter`` against either package's
  namerd: a bind, a dtab write that moves it, and a namerd restart on the
  same port followed by another write, observed through the long poll
  and its backoff.
"""

import asyncio
import importlib
import os
import struct
import zlib

import numpy as np
import pytest

PKGS = {"ref": "linkerd_tpu", "port": "linkerd_tpu_torch"}
TIMEOUT_S = 60
WAIT_S = 20.0   # longest wait for an interpreter to see a change


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, TIMEOUT_S))


def mod(pkg: str, name: str):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


IDL_CLASSES = sorted(
    name for name, v in vars(mod("ref", "namerd.thrift_idl")).items()
    if isinstance(v, type) and hasattr(v, "FIELDS") and name != "TStruct"
    and v.__module__.endswith("thrift_idl"))


def random_value(pkg: str, t, rng, depth: int = 0):
    idl = mod(pkg, "namerd.thrift_idl")
    if isinstance(t, tuple):
        kind = t[0]
        if kind == "struct":
            return random_struct(pkg, getattr(idl, t[1].__name__), rng,
                                 depth + 1)
        n = int(rng.integers(0, 3 if depth < 3 else 1))
        if kind in ("list", "set"):
            items = [random_value(pkg, t[1], rng, depth + 1)
                     for _ in range(n)]
            return items
        return {random_value(pkg, t[1], rng, depth + 1):
                random_value(pkg, t[2], rng, depth + 1) for _ in range(n)}
    if t == "bool":
        return bool(rng.random() < 0.5)
    if t in ("byte", "i16", "i32", "i64"):
        bits = {"byte": 7, "i16": 15, "i32": 31, "i64": 62}[t]
        return int(rng.integers(-2**bits, 2**bits))
    if t == "double":
        return float(rng.standard_normal())
    if t == "string":
        return "".join(rng.choice(list("abc/=> ;#xyz"),
                                  size=int(rng.integers(0, 12))))
    return bytes(rng.integers(0, 256, int(rng.integers(0, 12)),
                              dtype=np.uint8))


def random_struct(pkg: str, cls, rng, depth: int = 0):
    fields = list(cls.FIELDS.items())
    if cls.UNION:
        chosen = [fields[int(rng.integers(len(fields)))]] if fields else []
    else:
        chosen = [f for f in fields if depth < 3 and rng.random() < 0.8]
    return cls(**{name: random_value(pkg, t, rng, depth)
                  for name, (_, t) in chosen})


@pytest.mark.parametrize("name", IDL_CLASSES)
def test_idl_struct_byte_for_byte(name):
    out = {}
    for pkg in PKGS:
        binary = mod(pkg, "protocol.thrift.binary")
        cls = getattr(mod(pkg, "namerd.thrift_idl"), name)
        rng = np.random.default_rng(zlib.crc32(name.encode()))
        wires = []
        for _ in range(6):
            wire = binary.encode_struct(random_struct(pkg, cls, rng))
            back = binary.decode_struct(cls, wire)
            wires.append((wire, binary.encode_struct(back)))
        out[pkg] = wires
    assert out["port"] == out["ref"]
    assert all(w == again for w, again in out["port"])


def test_call_and_reply_byte_for_byte():
    out = {}
    for pkg in PKGS:
        idl = mod(pkg, "namerd.thrift_idl")
        nt = mod(pkg, "interpreter.namerd_thrift")
        binary = mod(pkg, "protocol.thrift.binary")
        req = idl.BindReq(dtab="/a => /b;", name=idl.NameRef(
            stamp=b"\x01\x02", name=[b"svc", b"web"], ns="default"),
            clientId=[b"l5d"])
        call = nt._encode_call("bind", 7, req)
        reply = struct.pack(">II", 0x80010002, 4) + b"bind" + \
            struct.pack(">i", 7)
        bound = idl.TBound(stamp=b"s", ns="default", tree=idl.BoundTree(
            root=idl.BoundNode(neg=idl.TVoid()), nodes={}))
        w = binary.Writer()
        w.write(struct.pack(">bh", 12, 0))
        binary.write_struct(w, bound)
        w.write(b"\x00")
        got = nt._decode_reply(reply + w.bytes(), idl.TBound,
                               idl.BindFailure)
        out[pkg] = (call, binary.encode_struct(got))
    assert out["port"] == out["ref"]


# -- the interface, answer for answer ----------------------------------------

async def namerd_world(pkg: str, disco, dtab: str, port: int = 0):
    """``pkg``'s namerd over an in-memory store holding ``dtab`` in
    ``default`` and an fs namer on ``disco``, with its thrift interface
    started on ``port``."""
    core = mod(pkg, "core")
    namer = mod(pkg, "namer.fs").FsNamer(str(disco))
    store = mod(pkg, "namerd").InMemoryDtabStore()
    namerd = mod(pkg, "namerd").Namerd(
        store, [(core.Path.read("/io.l5d.fs"), namer)])
    await store.create("default", core.Dtab.read(dtab))
    iface = await mod(pkg, "namerd.thrift_iface").ThriftNamerIface(
        namerd, port=port).start()
    return namer, store, namerd, iface


def raw_call(method: str, seqid: int, req) -> bytes:
    """The call's bytes, by the reference's encoder (what every linkerd
    sends)."""
    return mod("ref", "interpreter.namerd_thrift")._encode_call(
        method, seqid, req)


async def iface_session(pkg: str, tmp) -> list:
    """A fixed sequence of calls to ``pkg``'s interface; every reply's
    bytes."""
    idl = mod("ref", "namerd.thrift_idl")
    rcodec = mod("ref", "protocol.thrift.codec")
    disco = tmp / pkg / "disco"
    disco.mkdir(parents=True)
    (disco / "web").write_text("127.0.0.1 7001\n127.0.0.1 7002\n")
    (disco / "web2").write_text("127.0.0.1 7101\n")
    namer, store, namerd, iface = await namerd_world(
        pkg, disco, "/svc => /#/io.l5d.fs ;")
    namer.refresh()
    client = mod("ref", "protocol.thrift.client").ThriftClient(
        "127.0.0.1", iface.bound_port)
    Dtab = mod(pkg, "core").Dtab
    replies, seq = [], [0]

    async def call(method, req):
        seq[0] += 1
        rsp = await client(rcodec.ThriftCall(
            payload=raw_call(method, seq[0], req), name=method,
            seqid=seq[0], type=rcodec.CALL))
        replies.append(rsp)
        return rsp

    def stamp_of(rsp, cls):
        nt = mod("ref", "interpreter.namerd_thrift")
        return nt._decode_reply(rsp, cls, Exception).stamp

    def name(path, stamp=b""):
        return idl.NameRef(stamp=stamp, name=[s.encode() for s in
                                              path.strip("/").split("/")],
                           ns="default")

    try:
        d1 = await call("dtab", idl.DtabReq(stamp=b"", ns="default",
                                            clientId=[b"t"]))
        b1 = await call("bind", idl.BindReq(dtab="", name=name("/svc/web"),
                                            clientId=[b"t"]))
        a1 = await call("addr", idl.AddrReq(
            name=name("/#/io.l5d.fs/web"), clientId=[b"t"]))
        await call("bind", idl.BindReq(dtab="", name=name("/svc/ghost"),
                                       clientId=[b"t"]))
        await call("bind", idl.BindReq(
            dtab="/svc/web => /#/io.l5d.fs/web2 ;", name=name("/svc/web"),
            clientId=[b"t"]))
        await call("delegate", idl.DelegateReq(
            dtab="", delegation=idl.Delegation(
                ns="default", tree=idl.TDelegateTree(root=idl.DelegateNode(
                    path=[b"svc", b"web"], dentry=""))), clientId=[b"t"]))
        await call("nosuch", idl.DtabReq(ns="default"))
        # parked long polls, answered by a write and an address change
        polls = [asyncio.ensure_future(call(m, r)) for m, r in (
            ("dtab", idl.DtabReq(stamp=stamp_of(d1, idl.DtabRef),
                                 ns="default", clientId=[b"t"])),
            ("bind", idl.BindReq(dtab="", name=name(
                "/svc/web", stamp_of(b1, idl.TBound)), clientId=[b"t"])),
        )]
        await asyncio.sleep(0.2)
        assert not any(p.done() for p in polls)
        vd = await store.observe("default").to_future()
        await store.update("default", Dtab.read(
            "/svc => /#/io.l5d.fs ; /svc/web => /#/io.l5d.fs/web2 ;"),
            vd.version)
        await asyncio.wait_for(asyncio.gather(*polls), 10)
        addr_poll = asyncio.ensure_future(call("addr", idl.AddrReq(
            name=name("/#/io.l5d.fs/web", stamp_of(a1, idl.TAddr)),
            clientId=[b"t"])))
        await asyncio.sleep(0.2)
        assert not addr_poll.done()
        (disco / "web").write_text("127.0.0.1 7003\n")
        namer.refresh()
        await asyncio.wait_for(addr_poll, 10)
    finally:
        await client.close()
        await iface.close()
        await namerd.close()
        namer.close()
    return replies


def test_iface_answers_as_the_reference(tmp_path, monkeypatch):
    # the stamper's instance prefix is random: the same in both here
    monkeypatch.setattr(os, "urandom", lambda n: b"\x5a" * n)
    ref = run(iface_session("ref", tmp_path))
    port = run(iface_session("port", tmp_path))
    assert len(port) == len(ref) == 10
    for i, (a, b) in enumerate(zip(ref, port)):
        assert b == a, f"reply {i} differs"
    rcodec = mod("ref", "protocol.thrift.codec")
    types = [rcodec.parse_message_header(r)[2] for r in port]
    assert types.count(rcodec.EXCEPTION) == 1  # the unknown method


# -- each interpreter against either namerd ----------------------------------

async def wait_leaf(act, pkg: str, suffix: str, what: str) -> None:
    Ok = mod(pkg, "core.activity").Ok
    Leaf = mod(pkg, "core.nametree").Leaf
    t0 = asyncio.get_running_loop().time()
    while asyncio.get_running_loop().time() - t0 < WAIT_S:
        st = act.current
        if isinstance(st, Ok):
            tree = st.value.simplified
            if isinstance(tree, Leaf) and tree.value.id_.show.endswith(
                    suffix):
                return
        await asyncio.sleep(0.02)
    raise AssertionError(f"{what}: no bind to {suffix} after {WAIT_S} s "
                         f"({act.current})")


async def interp_session(interp_pkg: str, namerd_pkg: str, tmp) -> list:
    disco = tmp / f"{interp_pkg}-{namerd_pkg}"
    disco.mkdir(parents=True)
    for n, p in (("web", 7001), ("web2", 7101), ("web3", 7201)):
        (disco / n).write_text(f"127.0.0.1 {p}\n")
    namer, store, namerd, iface = await namerd_world(
        namerd_pkg, disco, "/svc => /#/io.l5d.fs ;")
    port = iface.bound_port
    core = mod(interp_pkg, "core")
    interp = mod(interp_pkg, "interpreter.namerd_thrift") \
        .ThriftNamerInterpreter("127.0.0.1", port, namespace="default")
    seen = []
    try:
        act = interp.bind(core.Dtab.empty(), core.Path.read("/svc/web"))
        await wait_leaf(act, interp_pkg, "/web", "bind")
        seen.append(act.current.value.simplified.value.id_.show)
        leaf = act.current.value.simplified.value
        Bound = mod(interp_pkg, "core.addr").Bound
        t0 = asyncio.get_running_loop().time()
        while not isinstance(leaf.addr.sample(), Bound):
            assert asyncio.get_running_loop().time() - t0 < WAIT_S
            await asyncio.sleep(0.02)
        seen.append(sorted((a.host, a.port)
                           for a in leaf.addr.sample().addresses))
        Dtab = mod(namerd_pkg, "core").Dtab
        vd = await store.observe("default").to_future()
        await store.update("default", Dtab.read(
            "/svc/web => /#/io.l5d.fs/web2 ;"), vd.version)
        await wait_leaf(act, interp_pkg, "/web2", "write")
        seen.append(act.current.value.simplified.value.id_.show)
        # restart: a new namerd on the same port, whose store moves the
        # name again; the interpreter's long poll reconnects after its
        # backoff and sees it
        await iface.close()
        await namerd.close()
        namer.close()
        namer, store, namerd, iface = await namerd_world(
            namerd_pkg, disco, "/svc/web => /#/io.l5d.fs/web3 ;",
            port=port)
        await wait_leaf(act, interp_pkg, "/web3", "restart")
        seen.append(act.current.value.simplified.value.id_.show)
    finally:
        interp.close()
        await iface.close()
        await namerd.close()
        namer.close()
    return seen


@pytest.mark.parametrize("pair", ["port-port", "port-ref", "ref-port"])
def test_interpreter_through_write_and_restart(pair, tmp_path):
    """``<interpreter package>-<namerd package>``: the same bindings, in
    order, as the reference's interpreter against its own namerd."""
    want = run(interp_session("ref", "ref", tmp_path / "want"))
    got = run(interp_session(*pair.split("-"), tmp_path / "got"))
    assert got == want
    assert [s.rsplit("/", 1)[1] for s in (got[0], got[2], got[3])] == [
        "web", "web2", "web3"]
    assert got[1] == [("127.0.0.1", 7001)]


# -- a reference-shared fault, held alike (ROADMAP Queue 3) ------------------

async def two_fs_namers(pkg: str, tmp) -> list:
    """Two io.l5d.fs namers under /a.fs and /b.fs, each with a file ``x``
    of its own address, behind ``pkg``'s namerd and thrift interface: the
    id and the addresses each of /a/x and /b/x binds to, read through
    ``pkg``'s interpreter."""
    core = mod(pkg, "core")
    FsNamer = mod(pkg, "namer.fs").FsNamer
    dirs = {}
    for k, port in (("a", 1111), ("b", 2222)):
        dirs[k] = tmp / pkg / f"{k}.fs"
        dirs[k].mkdir(parents=True)
        (dirs[k] / "x").write_text(f"127.0.0.1 {port}\n")
    store = mod(pkg, "namerd").InMemoryDtabStore()
    namerd = mod(pkg, "namerd").Namerd(store, [
        (core.Path.read(f"/{k}.fs"), FsNamer(str(d)))
        for k, d in dirs.items()])
    await store.create("default", core.Dtab.read(
        "/a => /#/a.fs ; /b => /#/b.fs ;"))
    iface = await mod(pkg, "namerd.thrift_iface").ThriftNamerIface(
        namerd).start()
    interp = mod(pkg, "interpreter.namerd_thrift").ThriftNamerInterpreter(
        "127.0.0.1", iface.bound_port)
    Bound = mod(pkg, "core.addr").Bound
    out = []
    try:
        for name in ("/a/x", "/b/x"):
            act = interp.bind(core.Dtab.empty(), core.Path.read(name))
            for _ in range(200):
                if isinstance(act.current, mod(pkg, "core.activity").Ok):
                    break
                await asyncio.sleep(0.02)
            leaf = act.sample().simplified.value
            for _ in range(200):
                if isinstance(leaf.addr.sample(), Bound):
                    break
                await asyncio.sleep(0.02)
            out.append((leaf.id_.show, sorted(
                a.port for a in leaf.addr.sample().addresses)))
    finally:
        interp.close()
        await iface.close()
        await namerd.close()
    return out


def test_fs_namer_ids_ignore_their_prefix_alike(tmp_path):
    """An io.l5d.fs namer names its ids /#/io.l5d.fs/<file> whatever its
    configured prefix (``namer/fs.py``), so through namerd two fs namers'
    files of one name share an id and resolve to one namer's addresses.
    A reference-shared fault (ROADMAP Queue 3): the port keeps it, as
    the reference does."""
    want = run(two_fs_namers("ref", tmp_path))
    got = run(two_fs_namers("port", tmp_path))
    assert got == want
    assert [i for i, _ in got] == ["/#/io.l5d.fs/x"] * 2
    assert got[0][1] == got[1][1]
