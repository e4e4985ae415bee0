"""The port's HTTP/2 stack (``linkerd_tpu_torch/protocol/h2``) against
the JAX package's, on the CPU.

- Frames: every packer, on arguments drawn from a numpy seed, gives the
  same bytes in both packages, and the parsers read them alike.
- HPACK: seeded header lists through both encoders (literal and
  Huffman-coded strings, with and without a dynamic table) give the same
  bytes, and each package's decoder reads both packages' blocks to the
  same headers. Huffman strings: the reference codes them natively where
  its library is built and the port in Python; both give the same bytes
  and the same errors on malformed input.
- Loopback, both ways: a port ``H2Client`` against a reference
  ``H2Server`` and a reference ``H2Client`` against a port ``H2Server``,
  with a unary exchange, bodies larger than the connection window
  streamed each way, and trailers; and the h2c upgrade of a raw
  HTTP/1.1 client, answered alike by both servers.
"""

import asyncio
import base64

import numpy as np
import pytest

from linkerd_tpu.protocol.h2 import frames as ref_frames
from linkerd_tpu.protocol.h2 import hpack as ref_hpack
from linkerd_tpu.protocol.h2 import client as ref_client
from linkerd_tpu.protocol.h2 import messages as ref_messages
from linkerd_tpu.protocol.h2 import server as ref_server
from linkerd_tpu.protocol.h2 import stream as ref_stream
from linkerd_tpu.router import service as ref_service
from linkerd_tpu_torch.protocol.h2 import client, frames, hpack, messages
from linkerd_tpu_torch.protocol.h2 import server, stream
from linkerd_tpu_torch.router import service

PKGS = {
    "ref": dict(frames=ref_frames, hpack=ref_hpack, client=ref_client,
                messages=ref_messages, server=ref_server,
                stream=ref_stream, service=ref_service),
    "port": dict(frames=frames, hpack=hpack, client=client,
                 messages=messages, server=server, stream=stream,
                 service=service),
}
CONN_WINDOW = 4 << 20   # the stack's connection window (connection.py)
BIG = CONN_WINDOW + (1 << 20) + 12345


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


# -- frames -----------------------------------------------------------------

def frame_calls(seed: int):
    """(name, args) of every packer, on arguments drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    sid = int(rng.integers(1, 1 << 31))
    blob = rng.bytes(int(rng.integers(0, 300)))
    settings = [(int(rng.integers(1, 7)), int(rng.integers(0, 1 << 31)))
                for _ in range(int(rng.integers(0, 6)))]
    return [
        ("pack_frame", (int(rng.integers(0, 10)), int(rng.integers(0, 256)),
                        sid, blob)),
        ("pack_settings", (settings,)),
        ("pack_settings", ([], True)),
        ("pack_window_update", (sid, int(rng.integers(1, 1 << 31)))),
        ("pack_rst", (sid, int(rng.integers(0, 14)))),
        ("pack_goaway", (sid, int(rng.integers(0, 14)), blob[:40])),
        ("pack_ping", (rng.bytes(8), bool(rng.integers(2)))),
    ]


@pytest.mark.parametrize("seed", range(4))
def test_frames_pack_and_parse_alike(seed):
    for name, args in frame_calls(seed):
        want = getattr(ref_frames, name)(*args)
        got = getattr(frames, name)(*args)
        assert got == want, name
        assert tuple(frames.unpack_header(got[:9])) == \
            tuple(ref_frames.unpack_header(want[:9]))
    settings = frame_calls(seed)[1][1][0]
    payload = ref_frames.pack_settings(settings)[9:]
    assert frames.unpack_settings(payload) == \
        ref_frames.unpack_settings(payload)
    rng = np.random.default_rng(seed)
    pad = int(rng.integers(0, 20))
    padded = bytes([pad]) + rng.bytes(30) + bytes(pad)
    assert frames.strip_padding(frames.FLAG_PADDED, padded) == \
        ref_frames.strip_padding(ref_frames.FLAG_PADDED, padded)


# -- HPACK ------------------------------------------------------------------

NAMES = (":method", ":path", ":authority", ":scheme", ":status",
         "content-type", "te", "grpc-status", "grpc-message", "l5d-dst-service",
         "x-custom-trace", "cookie", "user-agent")


def header_lists(seed: int, n: int = 6):
    """``n`` header lists from ``seed``: names from NAMES and random ones,
    values of printable and arbitrary Latin-1 text, repeats that hit the
    dynamic table."""
    rng = np.random.default_rng(seed)
    lists, seen = [], []
    for _ in range(n):
        hs = []
        for _ in range(int(rng.integers(1, 12))):
            if seen and rng.random() < 0.3:
                hs.append(seen[int(rng.integers(len(seen)))])
                continue
            name = (NAMES[int(rng.integers(len(NAMES)))] if rng.random() < 0.7
                    else "x-" + "".join(chr(c) for c in rng.integers(
                        97, 123, size=int(rng.integers(1, 12)))))
            lo = 32 if rng.random() < 0.8 else 0
            value = "".join(chr(c) for c in rng.integers(
                lo, 256 if lo == 0 else 127, size=int(rng.integers(0, 60))))
            hs.append((name, value))
            seen.append((name, value))
        lists.append(hs)
    return lists


@pytest.mark.parametrize("huffman", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_hpack_blocks_alike(seed, huffman):
    """The same header lists through each package's encoder give the same
    blocks; each package's decoder reads the blocks to the lists."""
    lists = header_lists(seed)
    encs = {"ref": ref_hpack.Encoder(huffman=huffman),
            "port": hpack.Encoder(huffman=huffman)}
    decs = {"ref": ref_hpack.Decoder(), "port": hpack.Decoder()}
    table = 256 if seed == 2 else None
    if table:
        for e in encs.values():
            e.set_max_table_size(table)
    for hs in lists:
        block = encs["ref"].encode(hs)
        assert encs["port"].encode(hs) == block
        for d in decs.values():
            assert d.decode(block) == hs


@pytest.mark.parametrize("seed", range(4))
def test_huffman_strings_alike(seed):
    """Huffman coding of seeded byte strings: the reference (native where
    its library is built) and the port (Python) give the same codes and
    decode them back; a string-literal with the Huffman flag decodes the
    same through both decoders."""
    rng = np.random.default_rng(seed)
    for n in (0, 1, 7, 64, 1000):
        data = rng.bytes(n) if seed % 2 else bytes(
            rng.integers(32, 127, size=n).astype(np.uint8))
        code = ref_hpack.huffman_encode(data)
        assert hpack.huffman_encode(data) == code
        assert hpack.huffman_decode(code) == data
        assert ref_hpack.huffman_decode(code) == data
    # one literal header, never indexed, with a Huffman-coded value
    value = bytes(rng.integers(32, 127, size=40).astype(np.uint8))
    code = ref_hpack.huffman_encode(value)
    block = (b"\x10" + ref_hpack.encode_int(len(b"x-h"), 7) + b"x-h"
             + ref_hpack.encode_int(len(code), 7, 0x80) + code)
    assert hpack.Decoder().decode(block) == \
        ref_hpack.Decoder().decode(block) == [("x-h", value.decode())]


@pytest.mark.parametrize("bad", [
    b"\xff\xff\xff\xff",          # the EOS symbol
    b"\x00",                       # padding not all ones
    b"\x1f\xff",                   # padding of 8 bits or more
    b"\xff",                       # a whole byte of padding
])
def test_malformed_huffman_raises_alike(bad):
    errs = []
    for mod in (ref_hpack, hpack):
        with pytest.raises(mod.HpackError) as e:
            mod.huffman_decode(bad)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_port_hpack_codes_in_python():
    """The port binds no native Huffman coder: its module holds none."""
    assert not hasattr(hpack, "_native")


# -- loopback across packages -----------------------------------------------

def echo_service(pkg: str):
    """An h2 service (of ``pkg``) answering each request with its method,
    path, authority, body length and the body's last bytes, and trailers
    that carry the length."""
    m, svc = PKGS[pkg]["messages"], PKGS[pkg]["service"]

    async def handle(req):
        body, trailers = await req.stream.read_all(max_bytes=1 << 27)
        head = f"{req.method} {req.path} {req.authority} {len(body)} ".encode()
        got_trailers = "" if trailers is None else ",".join(
            f"{k}={v}" for k, v in trailers.headers)
        rsp = m.H2Response(status=200, body=head + body[-16:],
                           trailers=[("x-len", str(len(body))),
                                     ("x-req-trailers", got_trailers)])
        rsp.headers.set("x-served-by", pkg)
        return rsp

    return svc.FnService(handle)


def big_body(seed: int, n: int = BIG) -> bytes:
    return np.random.default_rng(seed).bytes(n)


async def exchange(client_pkg: str, server_pkg: str):
    """Over one connection: a unary GET, a POST of a body larger than the
    connection window (streamed as frames with request trailers), and a
    request answered with a body larger than the window. Returns what the
    client read."""
    srv = await PKGS[server_pkg]["server"].serve_h2(echo_service(server_pkg))
    c = PKGS[client_pkg]
    cli = c["client"].H2Client("127.0.0.1", srv.bound_port)
    out = []
    try:
        rsp = await cli(c["messages"].H2Request(
            method="GET", path="/unary", authority="svc.local"))
        body, tr = await rsp.stream.read_all()
        out.append((rsp.status, rsp.headers.get("x-served-by"), body,
                    tr.headers if tr else None))
        big = big_body(1)
        st = c["stream"].H2Stream()
        for i in range(0, len(big), 100_000):
            st.offer(c["stream"].DataFrame(big[i:i + 100_000]))
        st.offer(c["stream"].Trailers([("x-sent", str(len(big)))]))
        rsp = await cli(c["messages"].H2Request(
            method="POST", path="/up", authority="svc.local", stream=st))
        body, tr = await rsp.stream.read_all()
        out.append((rsp.status, body, tr.headers if tr else None))
        return out
    finally:
        await cli.close()
        await srv.close()


@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("port", "ref"), ("ref", "port")])
def test_loopback_across_packages(client_pkg, server_pkg):
    """A client of one package against a server of the other answers as
    the reference's own pair does."""
    got = run(exchange(client_pkg, server_pkg))
    want = run(exchange("ref", "ref"))
    assert [g[2:] if i == 0 else g for i, g in enumerate(got)] == \
        [w[2:] if i == 0 else w for i, w in enumerate(want)]
    assert got[0][:2] == (200, server_pkg)
    assert got[1][1].endswith(big_body(1)[-16:])
    assert dict(got[1][2])["x-len"] == str(BIG)


async def download(client_pkg: str, server_pkg: str) -> bytes:
    """A response body larger than the connection window, from a server of
    ``server_pkg`` to a client of ``client_pkg``."""
    s = PKGS[server_pkg]
    big = big_body(2)

    async def handle(req):
        await req.stream.read_all()
        st = s["stream"].H2Stream()

        async def pump():
            for i in range(0, len(big), 65_536):
                st.offer(s["stream"].DataFrame(big[i:i + 65_536]))
                await asyncio.sleep(0)
            st.offer(s["stream"].Trailers([("x-done", "1")]))

        asyncio.ensure_future(pump())
        return s["messages"].H2Response(status=200, stream=st)

    srv = await s["server"].serve_h2(s["service"].FnService(handle))
    c = PKGS[client_pkg]
    cli = c["client"].H2Client("127.0.0.1", srv.bound_port)
    try:
        rsp = await cli(c["messages"].H2Request(path="/down",
                                                authority="svc"))
        body, tr = await rsp.stream.read_all(max_bytes=1 << 27)
        assert tr is not None and ("x-done", "1") in tr.headers
        return body
    finally:
        await cli.close()
        await srv.close()


@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("port", "ref"), ("ref", "port")])
def test_download_larger_than_the_window(client_pkg, server_pkg):
    assert run(download(client_pkg, server_pkg)) == big_body(2)


async def upgrade_exchange(port: int, body: bytes = b"", host="up.test",
                           path="/up", headers=()):
    """A raw HTTP/1.1 client upgrading to h2c (RFC 7540 §3.2): the
    status line, then the h2 response to stream 1 (status, body,
    trailers)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        settings = base64.urlsafe_b64encode(
            ref_frames.pack_settings([(4, 1 << 20)])[9:]).decode()
        method = "POST" if body else "GET"
        writer.write(
            (f"{method} {path} HTTP/1.1\r\nHost: {host}\r\n"
             f"Connection: Upgrade, HTTP2-Settings\r\nUpgrade: h2c\r\n"
             f"HTTP2-Settings: {settings}\r\n"
             + "".join(f"{k}: {v}\r\n" for k, v in headers)
             + f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
        await writer.drain()
        line = await reader.readline()
        while (await reader.readline()) not in (b"\r\n", b""):
            pass
        writer.write(ref_frames.CONNECTION_PREFACE
                     + ref_frames.pack_settings([]))
        await writer.drain()
        dec, status, data, trailers = ref_hpack.Decoder(), None, b"", None
        while True:
            fh = ref_frames.unpack_header(await reader.readexactly(9))
            payload = (await reader.readexactly(fh.length)
                       if fh.length else b"")
            if fh.type == ref_frames.SETTINGS and \
                    not fh.flags & ref_frames.FLAG_ACK:
                writer.write(ref_frames.pack_settings([], ack=True))
                await writer.drain()
            elif fh.type == ref_frames.HEADERS and fh.stream_id == 1:
                hdrs = dec.decode(ref_frames.strip_padding(fh.flags,
                                                           payload))
                if status is None:
                    status = dict(hdrs)[":status"]
                else:
                    trailers = hdrs
            elif fh.type == ref_frames.DATA and fh.stream_id == 1:
                data += ref_frames.strip_padding(fh.flags, payload)
            if fh.stream_id == 1 and fh.flags & ref_frames.FLAG_END_STREAM:
                return line, status, data, trailers
    finally:
        writer.close()


async def h2c_upgrade(server_pkg: str, body: bytes = b""):
    """``upgrade_exchange`` against an echo server of ``server_pkg``."""
    srv = await PKGS[server_pkg]["server"].serve_h2(echo_service(server_pkg))
    try:
        return await upgrade_exchange(srv.bound_port, body)
    finally:
        await srv.close()


@pytest.mark.parametrize("body", [b"", b"PAYLOAD" * 100])
def test_h2c_upgrade_answered_alike(body):
    """101, then the upgraded request served as stream 1: the port's
    server answers as the reference's (the upgrade head goes through the
    HTTP/1.1 codec's ``_parse_head_bytes`` in both)."""
    got = run(h2c_upgrade("port", body))
    want = run(h2c_upgrade("ref", body))
    assert got[0].startswith(b"HTTP/1.1 101")
    assert got == want
    method = "POST" if body else "GET"
    assert got[2].startswith(f"{method} /up up.test {len(body)} ".encode())


def test_non_upgrade_h1_answered_alike():
    """An HTTP/1.1 request that does not upgrade gets 426 from both
    servers; a malformed head gets 400 from both."""
    async def one(pkg, head):
        srv = await PKGS[pkg]["server"].serve_h2(echo_service(pkg))
        r, w = await asyncio.open_connection("127.0.0.1", srv.bound_port)
        try:
            w.write(head)
            await w.drain()
            return await r.read()
        finally:
            w.close()
            await srv.close()

    for head in (b"GET / HTTP/1.1\r\nHost: x\r\n\r\n",
                 b"GET / HTTP/1.1\r\nBad Header\r\n\r\n"):
        got = run(one("port", head))
        assert got == run(one("ref", head))
        assert got.split(b"\r\n", 1)[0] in (
            b"HTTP/1.1 426 Upgrade Required", b"HTTP/1.1 400 Bad Request")
