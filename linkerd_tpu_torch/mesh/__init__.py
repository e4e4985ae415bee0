"""The linkerd<->namerd mesh API: a copy of ``linkerd_tpu/mesh/``.

Wire-compatible with the reference's proto3 schema
(ref: mesh/core/src/main/protobuf/{interpreter,resolver,delegator,dtab,path}.proto):
``Interpreter.{Get,Stream}BoundTree``, ``Resolver.{Get,Stream}Replicas``,
``Delegator.{Get,Stream}Dtab`` / ``{Get,Stream}DelegateTree`` under package
``io.linkerd.mesh``, served over our gRPC runtime.
"""

from linkerd_tpu_torch.mesh.messages import (
    MBoundNameTree, MBindReq, MBoundTreeRsp, MDtab, MDtabReq, MDtabRsp,
    MEndpoint, MPath, MPathNameTree, MReplicas, MReplicasReq, MVersionedDtab,
)
from linkerd_tpu_torch.mesh.api import DELEGATOR_SVC, INTERPRETER_SVC, RESOLVER_SVC
from linkerd_tpu_torch.mesh import converters

__all__ = [
    "MBoundNameTree", "MBindReq", "MBoundTreeRsp", "MDtab", "MDtabReq",
    "MDtabRsp", "MEndpoint", "MPath", "MPathNameTree", "MReplicas",
    "MReplicasReq", "MVersionedDtab", "DELEGATOR_SVC", "INTERPRETER_SVC",
    "RESOLVER_SVC", "converters",
]
