"""gRPC stack over the hand-written h2 transport.

TPU-native reimagining of the reference's grpc modules
(ref: grpc/runtime/src/main/scala/io/buoyant/grpc/runtime/ and grpc/gen):
instead of a protoc plugin emitting Scala, messages are declared inline with
a field-descriptor DSL (`proto.py`) that speaks the protobuf wire format, so
service definitions live next to the code that uses them (mesh API, scorer).
"""

from linkerd_tpu_torch.grpc.proto import Enum, Field, MapField, ProtoMessage
from linkerd_tpu_torch.grpc.codec import Codec, GrpcFramer
from linkerd_tpu_torch.grpc.status import GrpcStatus, GrpcError
from linkerd_tpu_torch.grpc.stream import GrpcStream, DecodingStream, EncodingStream
from linkerd_tpu_torch.grpc.dispatch import (
    ClientDispatcher, Rpc, ServerDispatcher, ServiceDef,
)
from linkerd_tpu_torch.grpc.var_event import VarEventStream

__all__ = [
    "Enum", "Field", "MapField", "ProtoMessage", "Codec", "GrpcFramer",
    "GrpcStatus", "GrpcError", "GrpcStream", "DecodingStream",
    "EncodingStream", "ClientDispatcher", "Rpc", "ServerDispatcher",
    "ServiceDef", "VarEventStream",
]
