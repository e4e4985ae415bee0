"""Mesh gRPC service definitions, a copy of ``linkerd_tpu/mesh/api.py`` (ref: the three services in
mesh/core/src/main/protobuf/: Interpreter, Resolver, Delegator)."""

from linkerd_tpu_torch.grpc import Rpc, ServiceDef
from linkerd_tpu_torch.mesh import messages as m

INTERPRETER_SVC = ServiceDef("io.linkerd.mesh.Interpreter", [
    Rpc("GetBoundTree", m.MBindReq, m.MBoundTreeRsp),
    Rpc("StreamBoundTree", m.MBindReq, m.MBoundTreeRsp,
        server_streaming=True),
])

RESOLVER_SVC = ServiceDef("io.linkerd.mesh.Resolver", [
    Rpc("GetReplicas", m.MReplicasReq, m.MReplicas),
    Rpc("StreamReplicas", m.MReplicasReq, m.MReplicas,
        server_streaming=True),
])

DELEGATOR_SVC = ServiceDef("io.linkerd.mesh.Delegator", [
    Rpc("GetDtab", m.MDtabReq, m.MDtabRsp),
    Rpc("StreamDtab", m.MDtabReq, m.MDtabRsp, server_streaming=True),
])
