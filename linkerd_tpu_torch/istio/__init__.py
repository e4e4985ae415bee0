"""Istio integration: Pilot discovery (SDS/RDS/apiserver), route/cluster
caches, the istio namer + interpreter, mixer telemetry, and request
identifiers.

Reference parity: linkerd 1.x's k8s/src/main/scala/io/buoyant/k8s/istio/
(MixerClient.scala:131, IstioNamer.scala:79, RouteCache.scala,
ClusterCache.scala, DiscoveryClient.scala, ApiserverClient.scala,
IstioIdentifierBase.scala) and
interpreter/k8s/.../IstioInterpreter.scala. The mixer
protobuf surface (mixer_pb.py) is GENERATED from istio's .proto files by
tools/proto_gen.py — the codegen path the reference drives through its
protoc plugin (grpc/gen/.../Generator.scala).

A copy of ``linkerd_tpu/istio/__init__.py``.
"""

from linkerd_tpu_torch.istio.pilot import (  # noqa: F401
    ApiserverClient, ClusterCache, DiscoveryClient, RouteCache, RouteRule,
)
from linkerd_tpu_torch.istio.namer import IstioNamer  # noqa: F401
from linkerd_tpu_torch.istio.mixer import MixerClient  # noqa: F401
