"""The port's mux stack against the JAX package's, on the CPU.

Both sides take the same inputs, made from a numpy seed: Tdispatch
messages (contexts, dest, dtab, payload), Rdispatch replies of each
status, Rerr and their frames through a stream. Bytes and decoded
values must be equal, exactly. Then each package's client against the
other's server, and both packages' mux and thriftmux routers on the same
calls: the Tdispatch ``dest`` and its dtab override, the bound residual
that reaches the downstream as its ``dest`` (never the logical one),
``thriftMethodInDst`` on thriftmux, answers, Rerr and metric counters.
"""

import asyncio
import importlib
import struct

import numpy as np
import pytest

from linkerd_tpu.linker import load_linker as ref_load_linker
from linkerd_tpu_torch.linker import load_linker as port_load_linker

PKGS = {"ref": "linkerd_tpu", "port": "linkerd_tpu_torch"}
SEEDS = (0, 1, 2, 3)
TIMEOUT_S = 30


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, TIMEOUT_S))


def mod(pkg: str, name: str):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


def load(pkg: str, text: str):
    if pkg == "ref":
        return ref_load_linker(text)
    return port_load_linker(text, device="cpu")


def thrift_msg(name: str, seqid: int, mtype: int) -> bytes:
    nb = name.encode()
    return (struct.pack(">I", (0x80010000 | mtype) & 0xFFFFFFFF)
            + struct.pack(">I", len(nb)) + nb + struct.pack(">i", seqid)
            + b"\x00")


def blob(rng, hi: int = 40) -> bytes:
    return bytes(rng.integers(0, 256, int(rng.integers(0, hi)),
                              dtype=np.uint8))


def seg(rng) -> str:
    return "".join(rng.choice(list("abcdefgxyz0123-_"),
                              size=int(rng.integers(1, 9))))


@pytest.mark.parametrize("seed", SEEDS)
def test_dispatch_frames_byte_for_byte(seed):
    """Tdispatch, Rdispatch (ok, error, nack) and Rerr: the encoders'
    bytes, the decoders' values and the frames read back through a
    stream, alike."""
    out = {}
    for pkg in PKGS:
        c = mod(pkg, "protocol.mux.codec")
        rng = np.random.default_rng(seed)
        frames, decoded = [], []
        for i in range(10):
            tag = int(rng.integers(1, 1 << 23))
            ctxs = [(blob(rng, 12), blob(rng, 12))
                    for _ in range(int(rng.integers(0, 3)))]
            dest = "/" + "/".join(seg(rng) for _ in range(
                int(rng.integers(0, 4))))
            dtab = [("/svc/" + seg(rng), "/#/io.l5d.fs/" + seg(rng))
                    for _ in range(int(rng.integers(0, 3)))]
            payload = blob(rng)
            frames.append(c.encode_tdispatch(tag, ctxs, dest, dtab, payload))
            td = c.decode_tdispatch(c.MuxMessage(*frames[-1]))
            decoded.append((td.tag, td.contexts, td.dest, td.dtab,
                            td.payload))
            status = int(rng.integers(0, 3))
            frames.append(c.encode_rdispatch(tag, payload, status))
            decoded.append(c.decode_rdispatch(c.MuxMessage(*frames[-1])))
            frames.append(c.encode_rerr(tag, f"why {i}"))

        class W:
            data = b""

            def write(self, b):
                W.data += b

        w = W()
        for f in frames:
            c.write_mux_frame(w, *f)

        async def read_back(data):
            reader = asyncio.StreamReader()
            reader.feed_data(data)
            reader.feed_eof()
            got = []
            while (m := await c.read_mux_frame(reader)) is not None:
                got.append((m.type, m.tag, m.body, m.fragment))
            return got

        out[pkg] = (frames, decoded, W.data, run(read_back(W.data)))
    assert out["port"] == out["ref"]
    assert len(out["port"][3]) == 30


def test_truncated_and_fragmented_frames_alike():
    outs = {}
    for pkg in PKGS:
        c = mod(pkg, "protocol.mux.codec")
        res = []
        for body in (b"\x00", b"\x00\x01\x00\x05ab", b""):
            try:
                res.append(c.decode_tdispatch(c.MuxMessage(2, 1, body)))
            except c.MuxCodecError as e:
                res.append(("error", type(e).__name__))
            try:
                res.append(c.decode_rdispatch(c.MuxMessage(254, 1, body)))
            except c.MuxCodecError as e:
                res.append(("error", type(e).__name__))

        async def frag():
            reader = asyncio.StreamReader()
            reader.feed_data(struct.pack(">I", 5) + b"\x02\x80\x00\x01x")
            reader.feed_eof()
            m = await c.read_mux_frame(reader)
            return (m.tag, m.fragment)

        res.append(run(frag()))
        outs[pkg] = [r if isinstance(r, tuple) else
                     (r.tag, r.dest, r.payload) for r in res]
    assert outs["port"] == outs["ref"]


async def client_server(client_pkg: str, server_pkg: str):
    """Concurrent calls answered out of order, a handler error (Rerr)
    and a ping, from ``client_pkg``'s MuxClient to ``server_pkg``'s
    MuxServer."""
    seen = []

    async def handler(td):
        seen.append((td.dest, td.dtab, td.contexts))
        if td.payload == b"boom":
            raise RuntimeError("kapow")
        await asyncio.sleep(int(td.payload) / 200)
        return b"r" + td.payload

    server = await mod(server_pkg, "protocol.mux.server").MuxServer(
        mod(server_pkg, "router.service").FnService(handler)).start()
    Tdispatch = mod(client_pkg, "protocol.mux.codec").Tdispatch
    client = mod(client_pkg, "protocol.mux.client").MuxClient(
        "127.0.0.1", server.bound_port)
    try:
        got = await asyncio.gather(*(
            client(Tdispatch(0, [(b"k", b"v")], f"/svc/{n}",
                             [("/a", "/b")], str(n).encode()))
            for n in (3, 1, 2)))
        try:
            await client(Tdispatch(0, [], "/x", [], b"boom"))
            got.append("no error")
        except Exception as e:  # noqa: BLE001 — the Rerr, by type
            got.append((type(e).__name__, "kapow" in str(e)))
        await client.ping()
    finally:
        await client.close()
        await server.close()
    return got, sorted(seen)


@pytest.mark.parametrize("pair", ["port-ref", "ref-port"])
def test_client_against_the_other_server(pair):
    client_pkg, server_pkg = pair.split("-")
    want = run(client_server("ref", "ref"))
    got = run(client_server(client_pkg, server_pkg))
    assert got == want
    assert got[0][:3] == [b"r3", b"r1", b"r2"]
    assert got[0][3] == ("MuxApplicationError", True)


# -- both packages' mux and thriftmux routers -------------------------------

ROUTER = """
routers:
- protocol: {protocol}
  label: mr
  dtab: |
    /svc => /#/io.l5d.fs ;
    /svc/deep => /#/io.l5d.fs/web ;
  servers: [{{port: 0}}]
{extra}
namers:
- kind: io.l5d.fs
  rootDir: {disco}
"""

# (dest, dtab override, thrift method) a call
MUX_CALLS = [
    ("/web", [], "get"),
    ("/web/extra/path", [], "get"),
    ("/deep/a/b", [], "put"),              # bound residual /a/b
    ("/web", [("/svc/web", "/#/io.l5d.fs/alt")], "get"),  # override
    ("/ghost", [], "get"),                 # unbound: Rerr
    ("relative", [], "get"),               # no leading slash: /svc/mux
    ("/alt/x", [], "del"),
]
TMX_CALLS = [("", [], "get"), ("", [], "put"), ("", [], "nope"),
             ("", [("/svc/get", "/#/io.l5d.fs/alt")], "get")]


async def mux_scenario(pkg: str, tmp, protocol: str, method_in_dst: bool):
    """``MUX_CALLS`` (mux) or ``TMX_CALLS`` (thriftmux) through ``pkg``'s
    router to ``pkg``'s backends, each tagging its answer with its name
    and the dest it was sent: the answers, what each backend saw, and
    the router's counters."""
    disco = tmp / pkg / protocol / str(method_in_dst) / "disco"
    disco.mkdir(parents=True)
    codec = mod(pkg, "protocol.thrift.codec")
    FnService = mod(pkg, "router.service").FnService
    MuxServer = mod(pkg, "protocol.mux.server").MuxServer
    seen, servers = [], []
    for name in ("web", "alt", "mux", "thriftmux", "get", "put"):
        async def handler(td, name=name):
            seen.append((name, td.dest, td.dtab))
            mname, seqid, _ = codec.parse_message_header(td.payload)
            return thrift_msg(f"{name}:{mname}:{td.dest}", seqid,
                              codec.REPLY)

        s = await MuxServer(FnService(handler)).start()
        servers.append(s)
        (disco / name).write_text(f"127.0.0.1 {s.bound_port}\n")
    extra = "  thriftMethodInDst: true\n" if method_in_dst else ""
    linker = load(pkg, ROUTER.format(protocol=protocol, disco=disco,
                                     extra=extra))
    await linker.start()
    Tdispatch = mod(pkg, "protocol.mux.codec").Tdispatch
    client = mod(pkg, "protocol.mux.client").MuxClient(
        "127.0.0.1", linker.routers[0].server_ports[0])
    out = []
    try:
        calls = MUX_CALLS if protocol == "mux" else TMX_CALLS
        for i, (dest, dtab, method) in enumerate(calls):
            try:
                rsp = await client(Tdispatch(0, [], dest, dtab,
                                             thrift_msg(method, i, 1)))
                out.append(codec.parse_message_header(rsp)[:2])
            except Exception as e:  # noqa: BLE001 — the Rerr, by type
                out.append(type(e).__name__)
        flat = linker.metrics.flatten()
    finally:
        await client.close()
        await linker.close()
        for s in servers:
            await s.close()
    return out, seen, {k: v for k, v in flat.items()
                       if k.startswith("rt/") and isinstance(v, int)}


@pytest.mark.parametrize("case", ["mux", "thriftmux",
                                  "thriftmux-methodInDst"])
def test_mux_router_alike(case, tmp_path):
    protocol, _, mid = case.partition("-")
    ref = run(mux_scenario("ref", tmp_path, protocol, bool(mid)))
    port = run(mux_scenario("port", tmp_path, protocol, bool(mid)))
    assert port == ref
    answers, seen, flat = port
    assert flat["rt/mr/server/requests"] == len(answers)
    if protocol == "mux":
        assert answers[0] == ("web:get:/", 0)
        # the bound residual rides as the downstream dest, never the
        # logical one, and the consumed dtab is not re-sent
        assert answers[1] == ("web:get:/extra/path", 1)
        assert answers[2] == ("web:put:/a/b", 2)
        assert answers[3] == ("alt:get:/", 3)
        assert answers[4] == "MuxApplicationError"
        assert answers[5] == ("mux:get:/", 5)
        assert all(dtab == [] for _, _, dtab in seen)
    elif mid:
        # thriftmux passes the caller's dest through (no residual)
        assert answers[:3] == [("get:get:", 0), ("put:put:", 1),
                               "MuxApplicationError"]
        assert answers[3] == ("alt:get:", 3)
    else:
        assert [a[0].split(":")[0] for a in answers[:3]] == [
            "thriftmux"] * 3


def mux_text(extra: str, protocol: str) -> str:
    return (f"routers:\n- protocol: {protocol}\n  label: mr\n"
            f"  servers: [{{port: 0}}]\n{extra}")


CONFIG_ERRORS = {
    "server tls": "  servers:\n  - port: 0\n    tls: {certPath: c, "
                  "keyPath: k}\n",
    "server maxConcurrentRequests": "  servers:\n  - port: 0\n"
                                    "    maxConcurrentRequests: 4\n",
    "server clearContext": "  servers:\n  - port: 0\n    clearContext: true\n",
    "admissionControl": "  admissionControl: {maxConcurrency: 4}\n",
    "tenants": "  tenants: {}\n",
    "connectionGuard": "  connectionGuard: {}\n",
    "streamScoring": "  streamScoring: {}\n",
}


@pytest.mark.parametrize("protocol", ["mux", "thriftmux"])
@pytest.mark.parametrize("case", sorted(CONFIG_ERRORS))
def test_config_errors_word_for_word(case, protocol):
    from linkerd_tpu.config import ConfigError as RefConfigError
    from linkerd_tpu_torch.config import ConfigError

    text = mux_text(CONFIG_ERRORS[case], protocol).replace(
        "  servers: [{port: 0}]\n  servers:", "  servers:")
    msgs = []
    for pkg in PKGS:
        with pytest.raises((ConfigError, RefConfigError)) as e:
            load(pkg, text)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert "not supported by the port yet" not in msgs[1]


@pytest.mark.parametrize("protocol", ["thrift", "mux"])
def test_status_namer_refused_at_bind_alike(protocol, tmp_path):
    """A dtab to /$/io.buoyant.http.status fails the call, with the
    reference's words, in either package (the refusal is raised when the
    name binds, so the caller gets an exception reply or an Rerr)."""
    outs = []
    for pkg in PKGS:
        text = (f"routers:\n- protocol: {protocol}\n  dtab: |\n"
                f"    /svc => /$/io.buoyant.http.status/500 ;\n"
                f"  servers: [{{port: 0}}]\n")

        async def go():
            linker = load(pkg, text)
            await linker.start()
            port = linker.routers[0].server_ports[0]
            try:
                if protocol == "mux":
                    Tdispatch = mod(pkg, "protocol.mux.codec").Tdispatch
                    c = mod(pkg, "protocol.mux.client").MuxClient(
                        "127.0.0.1", port)
                    try:
                        await c(Tdispatch(0, [], "/x", [],
                                          thrift_msg("m", 1, 1)))
                        return "answered"
                    except Exception as e:  # noqa: BLE001
                        return str(e)
                    finally:
                        await c.close()
                codec = mod(pkg, "protocol.thrift.codec")
                c = mod(pkg, "protocol.thrift.client").ThriftClient(
                    "127.0.0.1", port)
                try:
                    rsp = await c(codec.ThriftCall(thrift_msg("m", 1, 1),
                                                   "m", 1, 1))
                    return codec.parse_message_header(rsp), rsp[-120:]
                finally:
                    await c.close()
            finally:
                await linker.close()

        outs.append(run(go()))
    assert outs[0] == outs[1]
    assert "only available to http/h2 routers" in str(outs[1])
