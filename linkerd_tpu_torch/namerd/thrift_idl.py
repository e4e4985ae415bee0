"""namerd's thrift interface IDL, transcribed into the TStruct DSL.

Wire-compatible with the reference's scrooge-generated types from
/root/reference/namerd/iface/interpreter-thrift-idl/src/main/thrift/namer.thrift
(struct/field ids match line-for-line; Path = list<binary>, Stamp =
opaque binary, Dtab = string).

Service methods (namer.thrift:197-202):
  Bound      bind(1: BindReq)     throws (1: BindFailure)
  Addr       addr(1: AddrReq)     throws (1: AddrFailure)
  Delegation delegate(1: DelegateReq) throws (1: DelegationFailure)
  DtabRef    dtab(1: DtabReq)     throws (1: DtabFailure)

A copy of ``linkerd_tpu/namerd/thrift_idl.py``.
"""

from __future__ import annotations

from linkerd_tpu_torch.protocol.thrift.binary import TStruct

PATH_T = ("list", "binary")  # typedef list<binary> Path


class TVoid(TStruct):
    FIELDS = {}


class NameRef(TStruct):  # namer.thrift:13-17
    FIELDS = {
        "stamp": (1, "binary"),
        "name": (2, PATH_T),
        "ns": (3, "string"),
    }


class BindReq(TStruct):  # :27-31
    FIELDS = {
        "dtab": (1, "string"),
        "name": (2, ("struct", NameRef)),
        "clientId": (3, PATH_T),
    }


class TBoundName(TStruct):  # :33-36
    FIELDS = {
        "id": (1, PATH_T),
        "residual": (2, PATH_T),
    }


class WeightedNodeId(TStruct):  # :40-43
    FIELDS = {
        "weight": (1, "double"),
        "id": (2, "i32"),
    }


class BoundNode(TStruct):  # union, :45-52
    UNION = True
    FIELDS = {
        "neg": (1, ("struct", TVoid)),
        "empty": (2, ("struct", TVoid)),
        "fail": (3, ("struct", TVoid)),
        "leaf": (4, ("struct", TBoundName)),
        "alt": (5, ("list", "i32")),
        "weighted": (6, ("list", ("struct", WeightedNodeId))),
    }


class BoundTree(TStruct):  # :54-57
    FIELDS = {
        "root": (1, ("struct", BoundNode)),
        "nodes": (2, ("map", "i32", ("struct", BoundNode))),
    }


class TBound(TStruct):  # :59-63
    FIELDS = {
        "stamp": (1, "binary"),
        "tree": (2, ("struct", BoundTree)),
        "ns": (3, "string"),
    }


class BindFailure(TStruct):  # exception, :65-70
    FIELDS = {
        "reason": (1, "string"),
        "retryInSeconds": (2, "i32"),
        "name": (3, ("struct", NameRef)),
        "ns": (4, "string"),
    }


class AddrReq(TStruct):  # :78-81
    FIELDS = {
        "name": (1, ("struct", NameRef)),
        "clientId": (2, PATH_T),
    }


class AddrMeta(TStruct):  # :83-93
    FIELDS = {
        "authority": (1, "string"),
        "nodeName": (2, "string"),
        "endpoint_addr_weight": (3, "double"),
    }


class TransportAddress(TStruct):  # :95-99
    FIELDS = {
        "ip": (1, "binary"),
        "port": (2, "i32"),
        "meta": (3, ("struct", AddrMeta)),
    }


class BoundAddr(TStruct):  # :101-104
    FIELDS = {
        "addresses": (1, ("set", ("struct", TransportAddress))),
        "meta": (2, ("struct", AddrMeta)),
    }


class AddrVal(TStruct):  # union, :106-109
    UNION = True
    FIELDS = {
        "bound": (1, ("struct", BoundAddr)),
        "neg": (2, ("struct", TVoid)),
    }


class TAddr(TStruct):  # :111-114
    FIELDS = {
        "stamp": (1, "binary"),
        "value": (2, ("struct", AddrVal)),
    }


class AddrFailure(TStruct):  # exception, :116-120
    FIELDS = {
        "reason": (1, "string"),
        "retryInSeconds": (2, "i32"),
        "name": (3, ("struct", NameRef)),
    }


class Transformation(TStruct):  # :128-131
    FIELDS = {
        "value": (1, ("struct", TBoundName)),
        "tree": (2, "i32"),
    }


class DelegateContents(TStruct):  # union, :133-144
    UNION = True
    FIELDS = {
        "excpetion": (1, "string"),  # sic — field name from the IDL
        "empty": (2, ("struct", TVoid)),
        "fail": (3, ("struct", TVoid)),
        "neg": (4, ("struct", TVoid)),
        "delegate": (5, "i32"),
        "boundLeaf": (6, ("struct", TBoundName)),
        "pathLeaf": (7, PATH_T),
        "alt": (8, ("list", "i32")),
        "weighted": (9, ("list", ("struct", WeightedNodeId))),
        "transformation": (10, ("struct", Transformation)),
    }


class DelegateNode(TStruct):  # :146-150
    FIELDS = {
        "path": (1, PATH_T),
        "dentry": (2, "string"),
        "contents": (3, ("struct", DelegateContents)),
    }


class TDelegateTree(TStruct):  # :152-155
    FIELDS = {
        "root": (1, ("struct", DelegateNode)),
        "nodes": (2, ("map", "i32", ("struct", DelegateNode))),
    }


class Delegation(TStruct):  # :157-161
    FIELDS = {
        "stamp": (1, "binary"),
        "tree": (2, ("struct", TDelegateTree)),
        "ns": (3, "string"),
    }


class DelegateReq(TStruct):  # :163-167
    FIELDS = {
        "dtab": (1, "string"),
        "delegation": (2, ("struct", Delegation)),
        "clientId": (3, PATH_T),
    }


class DelegationFailure(TStruct):  # exception, :169-171
    FIELDS = {"reason": (1, "string")}


class DtabReq(TStruct):  # :177-181
    FIELDS = {
        "stamp": (1, "binary"),
        "ns": (2, "string"),
        "clientId": (3, PATH_T),
    }


class DtabRef(TStruct):  # :183-186
    FIELDS = {
        "stamp": (1, "binary"),
        "dtab": (2, "string"),
    }


class DtabFailure(TStruct):  # exception, :188-190
    FIELDS = {"reason": (1, "string")}
