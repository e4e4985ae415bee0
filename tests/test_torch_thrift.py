"""The port's thrift stack against the JAX package's, on the CPU.

Both sides take the same inputs, made from a numpy seed: message
headers (strict, legacy and compact), TApplicationException replies,
TStruct values (the TTwitter request header with trace ids, client id,
dest and dtab delegations), and streams of unframed messages cut into
chunks. Bytes and parsed values must be equal, exactly. Then each
package's client against the other's server (framed or buffered, binary
or compact, with or without the TTwitter upgrade), and both packages'
thrift routers on the same calls: answers, retries, metric counters,
and the refusals of what a thrift router does not take, word for word.
"""

import asyncio
import importlib
import struct

import numpy as np
import pytest

from linkerd_tpu.config import ConfigError as RefConfigError
from linkerd_tpu.linker import load_linker as ref_load_linker
from linkerd_tpu_torch.config import ConfigError
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


# -- messages from a seed ---------------------------------------------------

def names(rng, n: int):
    alphabet = list("abcdefghijklmnopqrstuvwxyz_ABCDEFG0123456789") + [
        "é", "ü", "λ"]
    return ["".join(rng.choice(alphabet, size=int(rng.integers(1, 24))))
            for _ in range(n)]


def strict(name: str, seqid: int, mtype: int, body: bytes = b"\x00"):
    nb = name.encode()
    return (struct.pack(">I", (0x80010000 | mtype) & 0xFFFFFFFF)
            + struct.pack(">I", len(nb)) + nb + struct.pack(">i", seqid)
            + body)


def legacy(name: str, seqid: int, mtype: int, body: bytes = b"\x00"):
    nb = name.encode()
    return (struct.pack(">i", len(nb)) + nb + bytes([mtype])
            + struct.pack(">i", seqid) + body)


def compact(name: str, seqid: int, mtype: int):
    def varint(v: int) -> bytes:
        out = b""
        while v >= 0x80:
            out += bytes([v & 0x7F | 0x80])
            v >>= 7
        return out + bytes([v])
    nb = name.encode()
    return (bytes([0x82, (mtype << 5) | 1]) + varint(seqid)
            + varint(len(nb)) + nb + b"\x00")


def random_struct(rng, depth: int = 0) -> bytes:
    """A TBinaryProtocol struct of random fields, nested up to 3 deep."""
    out = b""
    for fid in range(int(rng.integers(0, 6))):
        kind = int(rng.integers(0, 6 if depth < 3 else 4))
        if kind == 0:
            out += struct.pack(">bhi", 8, fid, int(rng.integers(-2**31, 2**31)))
        elif kind == 1:
            s = bytes(rng.integers(0, 256, int(rng.integers(0, 40)),
                                   dtype=np.uint8))
            out += struct.pack(">bhI", 11, fid, len(s)) + s
        elif kind == 2:
            out += struct.pack(">bhd", 4, fid, float(rng.standard_normal()))
        elif kind == 3:
            out += struct.pack(">bhq", 10, fid, int(rng.integers(-2**62, 2**62)))
        elif kind == 4:
            out += struct.pack(">bh", 12, fid) + random_struct(rng, depth + 1)
        else:
            n = int(rng.integers(0, 5))
            out += struct.pack(">bhbI", 15, fid, 8, n) + b"".join(
                struct.pack(">i", int(rng.integers(-9, 9))) for _ in range(n))
    return out + b"\x00"


@pytest.mark.parametrize("seed", SEEDS)
def test_headers_and_exceptions_byte_for_byte(seed):
    rng = np.random.default_rng(seed)
    rc, pc = mod("ref", "protocol.thrift.codec"), \
        mod("port", "protocol.thrift.codec")
    for name in names(rng, 20):
        seqid = int(rng.integers(-2**31, 2**31))
        mtype = int(rng.integers(1, 5))
        msg = str(rng.integers(1 << 30)) * int(rng.integers(0, 4))
        # a compact seqid is a varint read as unsigned (never negative)
        for proto, sq in (("binary", seqid), ("compact", seqid & 0x7FFFFFFF)):
            assert pc.encode_exception_for(proto, name, sq, msg) == \
                rc.encode_exception_for(proto, name, sq, msg)
        for payload in (strict(name, seqid, mtype),
                        legacy(name, seqid, mtype)):
            assert pc.parse_message_header(payload) == \
                rc.parse_message_header(payload) == (name, seqid, mtype)
        cseq = seqid & 0x7FFFFFFF
        assert pc.parse_header(compact(name, cseq, mtype), "compact") == \
            rc.parse_header(compact(name, cseq, mtype), "compact") == \
            (name, cseq, mtype)
    for bad in (b"", b"\x80\x02\x00\x01", b"\x81\x00", b"\x82\x3f\x00\x00"):
        for proto in ("binary", "compact"):
            errs = []
            for c in (rc, pc):
                try:
                    c.parse_header(bad, proto)
                    errs.append(None)
                except Exception as e:  # noqa: BLE001 — compared by type
                    errs.append(type(e).__name__)
            assert errs[0] == errs[1]


@pytest.mark.parametrize("seed", SEEDS)
def test_message_length_and_unframed_reader_alike(seed):
    """The buffered transport's boundary scan on random messages: every
    prefix's length (or None) alike, and a stream cut into random chunks
    read back message by message alike; EOF mid-message raises in both."""
    rng = np.random.default_rng(seed)
    msgs = [(strict if i % 3 else legacy)(
        nm, int(rng.integers(1 << 20)), 1, random_struct(rng))
        for i, nm in enumerate(names(rng, 12))]
    rc, pc = mod("ref", "protocol.thrift.codec"), \
        mod("port", "protocol.thrift.codec")
    for m in msgs:
        for cut in sorted(set(rng.integers(0, len(m) + 1, 8).tolist())):
            assert pc.message_length(m[:cut]) == rc.message_length(m[:cut])
        assert pc.message_length(m + b"tail") == len(m)
    stream = b"".join(msgs)
    cuts = np.sort(rng.integers(0, len(stream), 16))
    chunks = np.split(np.frombuffer(stream, np.uint8), cuts)

    async def read_all(c, data_chunks, truncate=0):
        reader = asyncio.StreamReader()
        for ch in data_chunks:
            reader.feed_data(bytes(ch))
        if truncate:
            reader.feed_data(msgs[0][:truncate])
        reader.feed_eof()
        ur, out = c.UnframedReader(reader), []
        try:
            while (m := await ur.read_message()) is not None:
                out.append(m)
        except c.ThriftCodecError as e:
            out.append(("error", str(e)))
        return out

    for trunc in (0, 7):
        got = [run(read_all(c, chunks, trunc)) for c in (rc, pc)]
        assert got[0] == got[1]
        assert got[1][:len(msgs)] == msgs
        assert len(got[1]) == len(msgs) + (1 if trunc else 0)


@pytest.mark.parametrize("seed", SEEDS)
def test_ttwitter_headers_byte_for_byte(seed):
    built = {}
    for pkg in PKGS:
        ttw = mod(pkg, "protocol.thrift.ttwitter")
        TraceId = mod(pkg, "router.tracing").TraceId
        Dtab = mod(pkg, "core").Dtab
        r = np.random.default_rng(seed)
        out = []
        for _ in range(8):
            trace = None if r.random() < 0.2 else TraceId(
                trace_id=int(r.integers(1, 2**62)),
                span_id=int(r.integers(1, 2**62)),
                parent_id=int(r.integers(0, 2**62)) * int(r.random() < 0.5),
                sampled=bool(r.random() < 0.5))
            dtab = Dtab.read(";".join(
                f"/svc/{a} => /#/io.l5d.fs/{b}"
                for a, b in zip(names(r, 3), names(r, 3))))
            header = ttw.mk_request_header(
                trace=trace, dest=str(r.choice(["", "/svc/x"])),
                dtab=dtab if r.random() < 0.7 else None,
                client_id=str(r.choice(["", "web"])))
            payload = strict(names(r, 1)[0], int(r.integers(1 << 20)), 1)
            wire = ttw.prepend_struct(header, payload)
            peeled, rest = ttw.peel_struct(ttw.TRequestHeader, wire)
            tr = ttw.header_trace(peeled)
            out.append((wire, rest == payload,
                        None if tr is None else (tr.trace_id, tr.span_id,
                                                 tr.parent_id, tr.sampled),
                        ttw.header_dtab(peeled).show,
                        ttw.encode_upgrade_request(int(r.integers(9))),
                        ttw.encode_upgrade_reply(int(r.integers(9)))))
        built[pkg] = out
    assert built["port"] == built["ref"]
    assert all(ok for _, ok, *_ in built["port"])


def test_framed_io_alike():
    payloads = [b"", b"x", bytes(range(256)) * 3]
    for pkg in PKGS:
        c = mod(pkg, "protocol.thrift.codec")

        class W:
            def __init__(self):
                self.out = b""

            def write(self, b):
                self.out += b

        w = W()
        for p in payloads:
            c.write_framed(w, p)

        async def read_back(data):
            reader = asyncio.StreamReader()
            reader.feed_data(data)
            reader.feed_eof()
            return [await c.read_framed(reader) for _ in range(4)]

        assert run(read_back(w.out)) == payloads + [None]
        assert w.out == b"".join(struct.pack(">I", len(p)) + p
                                 for p in payloads)


# -- each package's client against either server ----------------------------

MODES = {
    "framed-binary-ttwitter": dict(framed=True, protocol="binary", tt=True),
    "framed-binary-plain": dict(framed=True, protocol="binary", tt=False),
    "framed-compact": dict(framed=True, protocol="compact", tt=True),
    "buffered-binary": dict(framed=False, protocol="binary", tt=True),
}


async def client_server(client_pkg: str, server_pkg: str, mode: dict):
    """Three calls (one raising in the handler) and one oneway from
    ``client_pkg``'s ThriftClient to ``server_pkg``'s ThriftServer; what
    the handler saw and what came back."""
    seen = []
    scodec = mod(server_pkg, "protocol.thrift.codec")
    proto = mode["protocol"]

    async def handler(call):
        tr = call.ctx.get("trace")
        seen.append((call.name, call.seqid, call.type,
                     None if tr is None else tr.trace_id,
                     call.ctx.get("dtab").show if call.ctx.get("dtab")
                     else None, call.ctx.get("dest"),
                     call.ctx.get("clientId")))
        if call.name == "boom":
            raise ValueError("boom")
        if proto == "compact":
            return compact(call.name, call.seqid, scodec.REPLY)
        return strict(call.name, call.seqid, scodec.REPLY)

    server = await mod(server_pkg, "protocol.thrift.server").ThriftServer(
        mod(server_pkg, "router.service").FnService(handler),
        ttwitter=mode["tt"], framed=mode["framed"],
        protocol=proto).start()
    ccodec = mod(client_pkg, "protocol.thrift.codec")
    client = mod(client_pkg, "protocol.thrift.client").ThriftClient(
        "127.0.0.1", server.bound_port, attempt_ttwitter=mode["tt"],
        dest="/svc/echo", client_id="cli", framed=mode["framed"],
        protocol=proto)
    TraceId = mod(client_pkg, "router.tracing").TraceId
    Dtab = mod(client_pkg, "core").Dtab
    replies = []
    try:
        for i, name in enumerate(("getUser", "boom", "ping", "fire")):
            mtype = ccodec.ONEWAY if name == "fire" else ccodec.CALL
            payload = (compact(name, 10 + i, mtype) if proto == "compact"
                       else strict(name, 10 + i, mtype))
            call = ccodec.ThriftCall(payload, name, 10 + i, mtype)
            call.ctx["trace"] = TraceId(trace_id=0xABC0 + i, span_id=7,
                                        parent_id=0, sampled=True)
            call.ctx["dtab"] = Dtab.read("/svc/a => /#/io.l5d.fs/b")
            rsp = await client(call)
            replies.append(None if rsp is None else
                           ccodec.parse_header(rsp, proto))
        for _ in range(200):
            if len(seen) == 4:
                break
            await asyncio.sleep(0.01)
    finally:
        await client.close()
        await server.close()
    return replies, seen


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("pair", ["port-ref", "ref-port"])
def test_client_against_the_other_server(pair, mode):
    """Answers and what the server saw are those of the reference's own
    client and server."""
    client_pkg, server_pkg = pair.split("-")
    want = run(client_server("ref", "ref", MODES[mode]))
    got = run(client_server(client_pkg, server_pkg, MODES[mode]))
    assert got == want
    replies, seen = got
    assert [r[:2] for r in replies[:3]] == [
        ("getUser", 10), ("boom", 11), ("ping", 12)]
    assert replies[1][2] == 3 and replies[3] is None  # EXCEPTION, oneway
    upgraded = MODES[mode]["tt"] and MODES[mode]["framed"] and \
        MODES[mode]["protocol"] == "binary"
    assert (seen[0][3] == 0xABC0) == upgraded


# -- both packages' thrift routers ------------------------------------------

ROUTER = """
routers:
- protocol: thrift
  label: tr
  dtab: |
    /svc => /#/io.l5d.fs ;
  servers: [{{port: 0}}]
{extra}
namers:
- kind: io.l5d.fs
  rootDir: {disco}
"""


async def thrift_backends(pkg: str, n: int, proto: str, framed: bool,
                          exceptions: bool = False):
    """``n`` ThriftServers of ``pkg``; each answers a REPLY tagged with
    its index, or with ``exceptions`` an EXCEPTION."""
    codec = mod(pkg, "protocol.thrift.codec")
    FnService = mod(pkg, "router.service").FnService
    servers = []
    for i in range(n):
        async def handler(call, i=i):
            if exceptions:
                return codec.encode_exception_for(proto, call.name,
                                                  call.seqid, f"bad {i}")
            if proto == "compact":
                return compact(call.name, call.seqid, codec.REPLY)
            tag = f"B{i}".encode()
            return strict(call.name, call.seqid, codec.REPLY,
                          b"\x0b" + struct.pack(">hI", 0, len(tag)) + tag
                          + b"\x00")

        servers.append(await mod(pkg, "protocol.thrift.server").ThriftServer(
            FnService(handler), framed=framed, protocol=proto).start())
    return servers


def counters(flat: dict) -> dict:
    """The router's counters: every int-valued key under rt/ but the
    endpoint gauges (the fs namer's replicas are listed, not counted)."""
    return {k: v for k, v in flat.items() if k.startswith("rt/")
            and isinstance(v, int) and not k.endswith("/endpoints")}


async def router_scenario(pkg: str, tmp, scenario: str):
    """One scenario through ``pkg``'s thrift router to ``pkg``'s
    backends: the parsed answers and the router's counters."""
    disco = tmp / pkg / "disco"
    disco.mkdir(parents=True)
    proto = "compact" if scenario == "compact" else "binary"
    framed = scenario != "buffered"
    extra, calls = "", [("getUser", i) for i in range(6)]
    servers = await thrift_backends(pkg, 2, proto, framed,
                                    exceptions=scenario == "exceptions")
    hostports = [f"127.0.0.1 {s.bound_port}" for s in servers]
    # one replica: the balancer's picks are random
    (disco / "thrift").write_text(hostports[0] + "\n")
    if scenario == "method_in_dst":
        extra = "  thriftMethodInDst: true\n"
        (disco / "getUser").write_text(hostports[0] + "\n")
        (disco / "putUser").write_text(hostports[1] + "\n")
        calls = [("getUser", 1), ("putUser", 2), ("noSuchMethod", 3),
                 ("getUser", 4)]
    elif scenario == "retries":
        # one replica's port refuses connections: each pick of it is a
        # retryable failure, retried on the live one
        s = await thrift_backends(pkg, 1, proto, framed)
        dead = s[0].bound_port
        await s[0].close()
        (disco / "thrift").write_text(
            f"{hostports[0]}\n127.0.0.1 {dead}\n")
        extra = ("  service:\n    retries:\n      budget: "
                 "{minRetriesPerSec: 100, percentCanRetry: 1.0}\n")
        calls = [("getUser", i) for i in range(12)]
    elif scenario in ("compact", "buffered"):
        extra = (f"  thriftProtocol: {proto}\n"
                 f"  thriftFramed: {'true' if framed else 'false'}\n")
    elif scenario == "no_ttwitter":
        extra = "  attemptTTwitterUpgrade: false\n"
    linker = load(pkg, ROUTER.format(disco=disco, extra=extra))
    await linker.start()
    codec = mod(pkg, "protocol.thrift.codec")
    client = mod(pkg, "protocol.thrift.client").ThriftClient(
        "127.0.0.1", linker.routers[0].server_ports[0], framed=framed,
        protocol=proto, attempt_ttwitter=True)
    out = []
    try:
        for name, seqid in calls:
            payload = (compact(name, seqid, 1) if proto == "compact"
                       else strict(name, seqid, 1))
            rsp = await client(codec.ThriftCall(payload, name, seqid, 1))
            parsed = codec.parse_header(rsp, proto)
            out.append((*parsed, rsp[-3:] if parsed[2] == 2 else
                        b"exception"))
        flat = linker.metrics.flatten()
    finally:
        await client.close()
        await linker.close()
        for s in servers:
            await s.close()
    return out, counters(flat)


SCENARIOS = ("static", "method_in_dst", "retries", "exceptions", "compact",
             "buffered", "no_ttwitter")


class SeededRandom:
    """A balancer module's ``random``: every balancer draws from the same
    seeded sequence, so the two packages' balancers pick alike (the
    retries scenario's dead replica is picked as often in both)."""

    @staticmethod
    def Random():
        import random
        return random.Random(16)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_thrift_router_alike(scenario, tmp_path, monkeypatch):
    for pkg in PKGS:
        monkeypatch.setattr(mod(pkg, "router.balancer"), "random",
                            SeededRandom)
    ref = run(router_scenario("ref", tmp_path, scenario))
    port = run(router_scenario("port", tmp_path, scenario))
    assert port == ref
    answers, flat = port
    sent = len(answers)
    assert flat["rt/tr/server/requests"] == sent
    if scenario == "retries":
        assert all(a[2] == 2 for a in answers)
        assert flat["rt/tr/service/svc.thrift/retries/total"] > 0
    elif scenario == "exceptions":
        assert all(a[2] == 3 for a in answers)
        assert flat["rt/tr/server/failures"] == sent
    elif scenario == "method_in_dst":
        assert [a[2] for a in answers] == [2, 2, 3, 2]
        assert [a[3] for a in answers[:2]] == [b"B0\x00", b"B1\x00"]
    else:
        assert all(a[2] == 2 for a in answers)
        assert flat["rt/tr/server/success"] == sent


# -- config: refusals word for word, and what loads -------------------------

def thrift_text(extra: str = "", protocol: str = "thrift") -> str:
    return (f"routers:\n- protocol: {protocol}\n  label: tr\n"
            f"  servers: [{{port: 0}}]\n{extra}")


CONFIG_ERRORS = {
    "server tls": "  servers:\n  - port: 0\n    tls: {certPath: c, "
                  "keyPath: k}\n",
    "server maxConcurrentRequests": "  servers:\n  - port: 0\n"
                                    "    maxConcurrentRequests: 4\n",
    "server clearContext": "  servers:\n  - port: 0\n    clearContext: true\n",
    "admissionControl": "  admissionControl: {maxConcurrency: 4}\n",
    "tenants": "  tenants: {}\n",
    "tenantIdentifier": "  tenantIdentifier: {kind: header}\n",
    "connectionGuard": "  connectionGuard: {}\n",
    "streamScoring": "  streamScoring: {}\n",
    "thriftProtocol": "  thriftProtocol: json\n",
    "thriftFramed": "  thriftProtocol: compact\n  thriftFramed: false\n",
    "compressionLevel": "  servers:\n  - port: 0\n    compressionLevel: 5\n",
}


def outcome(pkg: str, text: str) -> str:
    try:
        linker = load(pkg, text)
    except (ConfigError, RefConfigError) as e:
        return str(e)
    run(linker.close())
    return "loads"


@pytest.mark.parametrize("case", sorted(CONFIG_ERRORS))
def test_config_errors_word_for_word(case):
    text = thrift_text(CONFIG_ERRORS[case]).replace(
        "  servers: [{port: 0}]\n  servers:", "  servers:")
    want = outcome("ref", text)
    assert want != "loads"
    got = outcome("port", text)
    assert got == want
    assert "not supported by the port yet" not in got


LOADS = {
    "fastPath": "  fastPath: true\n",
    "fastPath workers": "  fastPath: true\n  workers: 2\n",
    "loggers": "  loggers: [{kind: io.l5d.http.file, path: x}]\n",
    "server timeoutMs": "  servers:\n  - port: 0\n    timeoutMs: 50\n",
    "static service": (
        "  service:\n    kind: io.l5d.static\n    configs:\n"
        "    - prefix: /svc\n      totalTimeoutMs: 100\n"),
    "interpreter io.l5d.namerd": (
        "  interpreter: {kind: io.l5d.namerd, dst: /$/inet/127.0.0.1/4100}"
        "\n"),
}


@pytest.mark.parametrize("protocol", ["thrift", "mux", "thriftmux"])
@pytest.mark.parametrize("case", sorted(LOADS))
def test_configs_load_alike(case, protocol):
    """Configs the reference takes on a thrift, mux or thriftmux router
    load in the port too (``fastPath`` and ``loggers`` are not read by
    these routers, in either package), with the same router label."""
    text = thrift_text(LOADS[case], protocol).replace(
        "  servers: [{port: 0}]\n  servers:", "  servers:")
    assert outcome("ref", text) == outcome("port", text) == "loads"
