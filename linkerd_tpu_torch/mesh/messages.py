"""Mesh API proto messages (field numbers match the reference schema): a
copy of ``linkerd_tpu/mesh/messages.py``.

Ref: mesh/core/src/main/protobuf/path.proto (Path, PathNameTree, Dtab,
VersionedDtab live in dtab.proto there), interpreter.proto (BindReq,
BoundTreeRsp, BoundNameTree), resolver.proto (ReplicasReq, Endpoint,
Replicas), delegator.proto (DtabReq, DtabRsp). oneof members are modeled
as optional fields — presence (is not None) selects the arm, which is
wire-identical for proto3 message-typed oneofs.
"""

from __future__ import annotations

from linkerd_tpu_torch.grpc.proto import Enum, Field, ProtoMessage


class MPath(ProtoMessage):
    FIELDS = {"elems": Field(1, "bytes", repeated=True)}


class MEmpty(ProtoMessage):
    FIELDS = {}


# ---- PathNameTree (dtab.proto PathNameTree) --------------------------------

class MPathLeaf(ProtoMessage):
    FIELDS = {"id": Field(1, "message", message=MPath)}


class MPathNameTree(ProtoMessage):
    pass  # populated below (self-referential)


class MPathWeighted(ProtoMessage):
    pass


class MPathAlt(ProtoMessage):
    pass


class MPathUnion(ProtoMessage):
    pass


MPathAlt.FIELDS = {
    "trees": Field(1, "message", message=MPathNameTree, repeated=True)}
MPathWeighted.FIELDS = {
    "weight": Field(1, "double"),
    "tree": Field(2, "message", message=MPathNameTree)}
MPathUnion.FIELDS = {
    "trees": Field(1, "message", message=MPathWeighted, repeated=True)}
MPathNameTree.FIELDS = {
    "neg": Field(1, "message", message=MEmpty),
    "fail": Field(2, "message", message=MEmpty),
    "empty": Field(3, "message", message=MEmpty),
    "alt": Field(4, "message", message=MPathAlt),
    "union": Field(5, "message", message=MPathUnion),
    "leaf": Field(6, "message", message=MPathLeaf),
}


# ---- Dtab (dtab.proto) -----------------------------------------------------

class MPrefixElem(ProtoMessage):
    FIELDS = {
        "label": Field(1, "bytes"),
        "wildcard": Field(2, "message", message=MEmpty),
    }


class MPrefix(ProtoMessage):
    FIELDS = {"elems": Field(1, "message", message=MPrefixElem, repeated=True)}


class MDentry(ProtoMessage):
    FIELDS = {
        "prefix": Field(1, "message", message=MPrefix),
        "dst": Field(2, "message", message=MPathNameTree),
    }


class MDtab(ProtoMessage):
    FIELDS = {"dentries": Field(1, "message", message=MDentry, repeated=True)}


class MDtabVersion(ProtoMessage):
    FIELDS = {"id": Field(1, "bytes")}


class MVersionedDtab(ProtoMessage):
    FIELDS = {
        "version": Field(1, "message", message=MDtabVersion),
        "dtab": Field(2, "message", message=MDtab),
    }


# ---- Interpreter (interpreter.proto) ---------------------------------------

class MBindReq(ProtoMessage):
    FIELDS = {
        "root": Field(1, "message", message=MPath),
        "name": Field(2, "message", message=MPath),
        "dtab": Field(3, "message", message=MDtab),
    }


class MBoundLeaf(ProtoMessage):
    FIELDS = {
        "id": Field(1, "message", message=MPath),
        "residual": Field(2, "message", message=MPath),
    }


class MBoundNameTree(ProtoMessage):
    pass


class MBoundWeighted(ProtoMessage):
    pass


class MBoundAlt(ProtoMessage):
    pass


class MBoundUnion(ProtoMessage):
    pass


MBoundAlt.FIELDS = {
    "trees": Field(1, "message", message=MBoundNameTree, repeated=True)}
MBoundWeighted.FIELDS = {
    "weight": Field(1, "double"),
    "tree": Field(2, "message", message=MBoundNameTree)}
MBoundUnion.FIELDS = {
    "trees": Field(1, "message", message=MBoundWeighted, repeated=True)}
MBoundNameTree.FIELDS = {
    "neg": Field(1, "message", message=MEmpty),
    "fail": Field(2, "message", message=MEmpty),
    "empty": Field(3, "message", message=MEmpty),
    "alt": Field(4, "message", message=MBoundAlt),
    "union": Field(5, "message", message=MBoundUnion),
    "leaf": Field(6, "message", message=MBoundLeaf),
}


class MBoundTreeRsp(ProtoMessage):
    FIELDS = {"tree": Field(1, "message", message=MBoundNameTree)}


# ---- Resolver (resolver.proto) ---------------------------------------------

class AddressFamily(Enum):
    INET4 = 0
    INET6 = 1


class MEndpointMeta(ProtoMessage):
    FIELDS = {"nodeName": Field(1, "string")}


class MEndpoint(ProtoMessage):
    FIELDS = {
        "inet_af": Field(1, "enum"),
        "address": Field(2, "bytes"),
        "port": Field(3, "int32"),
        "meta": Field(4, "message", message=MEndpointMeta),
    }


class MReplicasReq(ProtoMessage):
    FIELDS = {"id": Field(1, "message", message=MPath)}


class MReplicasFailed(ProtoMessage):
    FIELDS = {"message": Field(1, "string")}


class MReplicasBound(ProtoMessage):
    FIELDS = {"endpoints": Field(1, "message", message=MEndpoint,
                                 repeated=True)}


class MReplicas(ProtoMessage):
    FIELDS = {
        "pending": Field(1, "message", message=MEmpty),
        "neg": Field(2, "message", message=MEmpty),
        "failed": Field(3, "message", message=MReplicasFailed),
        "bound": Field(4, "message", message=MReplicasBound),
    }


# ---- Delegator (delegator.proto) -------------------------------------------

class MDtabReq(ProtoMessage):
    FIELDS = {"root": Field(1, "message", message=MPath)}


class MDtabRsp(ProtoMessage):
    FIELDS = {"dtab": Field(1, "message", message=MVersionedDtab)}
