"""TTwitter thrift upgrade: trace + dtab context over plain thrift.

Ref: linkerd/protocol/thrift/.../TTwitterClientFilter.scala and
TTwitterServerFilter.scala (both forked from finagle-thrift) and
ThriftInitializer.scala:103 ``attemptTTwitterUpgrade``. Protocol: the
client sends a CALL named ``__can__finagle__trace__v3__`` carrying
ConnectionOptions; an upgraded server replies with UpgradeReply. After
upgrade every request is prefixed with a RequestHeader struct (trace
ids, sampled, client id, dest, dtab delegations) and every reply with a
ResponseHeader struct.

A copy of ``linkerd_tpu/protocol/thrift/ttwitter.py``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from linkerd_tpu_torch.core import Dtab
from linkerd_tpu_torch.protocol.thrift.binary import (
    Reader, TStruct, Writer, encode_struct, read_struct, write_struct,
)
from linkerd_tpu_torch.protocol.thrift.codec import (
    CALL, REPLY, VERSION_1,
)
from linkerd_tpu_torch.router.tracing import TraceId

CAN_TRACE_METHOD = "__can__finagle__trace__v3__"

_MASK64 = (1 << 64) - 1


class TClientId(TStruct):  # finagle tracing.thrift ClientId
    FIELDS = {"name": (1, "string")}


class TRequestContext(TStruct):
    FIELDS = {"key": (1, "binary"), "value": (2, "binary")}


class TDelegation(TStruct):
    FIELDS = {"src": (1, "string"), "dst": (2, "string")}


class TRequestHeader(TStruct):
    FIELDS = {
        "trace_id": (1, "i64"),
        "span_id": (2, "i64"),
        "parent_span_id": (3, "i64"),
        "sampled": (5, "bool"),
        "client_id": (6, ("struct", TClientId)),
        "flags": (7, "i64"),
        "contexts": (8, ("list", ("struct", TRequestContext))),
        "dest": (9, "string"),
        "delegations": (10, ("list", ("struct", TDelegation))),
    }


class TResponseHeader(TStruct):
    FIELDS: dict = {}


class TConnectionOptions(TStruct):
    FIELDS: dict = {}


class TUpgradeReply(TStruct):
    FIELDS: dict = {}


def _message(name: str, mtype: int, seqid: int, body: bytes) -> bytes:
    import struct
    nb = name.encode("utf-8")
    return (struct.pack(">I", (VERSION_1 | mtype) & 0xFFFFFFFF)
            + struct.pack(">I", len(nb)) + nb
            + struct.pack(">i", seqid) + body)


def encode_upgrade_request(seqid: int = 0) -> bytes:
    return _message(CAN_TRACE_METHOD, CALL, seqid,
                    encode_struct(TConnectionOptions()))


def encode_upgrade_reply(seqid: int) -> bytes:
    return _message(CAN_TRACE_METHOD, REPLY, seqid,
                    encode_struct(TUpgradeReply()))


def mk_request_header(trace: Optional[TraceId] = None,
                      dest: str = "",
                      dtab: Optional[Dtab] = None,
                      client_id: str = "") -> TRequestHeader:
    h = TRequestHeader()
    if trace is not None:
        h.trace_id = trace.trace_id & _MASK64
        h.span_id = trace.span_id & _MASK64
        if trace.parent_id:
            h.parent_span_id = trace.parent_id & _MASK64
        h.sampled = trace.sampled
    else:
        h.trace_id = 0
        h.span_id = 0
    if dest:
        h.dest = dest
    if client_id:
        h.client_id = TClientId(name=client_id)
    if dtab:
        h.delegations = [
            TDelegation(src=d.prefix.show, dst=d.dst.show) for d in dtab]
    return h


def header_trace(h: TRequestHeader) -> Optional[TraceId]:
    if not h.trace_id and not h.span_id:
        return None
    return TraceId(trace_id=h.trace_id or 0, span_id=h.span_id or 0,
                   parent_id=h.parent_span_id or 0,
                   sampled=bool(h.sampled) if h.sampled is not None else True)


def header_dtab(h: TRequestHeader) -> Dtab:
    if not h.delegations:
        return Dtab.empty()
    try:
        return Dtab.read(";".join(
            f"{d.src} => {d.dst}" for d in h.delegations))
    except ValueError:
        return Dtab.empty()


def prepend_struct(s: TStruct, payload: bytes) -> bytes:
    return encode_struct(s) + payload


def peel_struct(cls: type, payload: bytes) -> Tuple[TStruct, bytes]:
    r = Reader(payload)
    obj = read_struct(r, cls)
    return obj, payload[r.pos:]
