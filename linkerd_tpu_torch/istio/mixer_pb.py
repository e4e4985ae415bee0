"""GENERATED by tools/proto_gen.py — do not edit.

Sources (linkerd 1.x's istio protos):
  istio/src/main/protobuf/google/protobuf/any.proto
  istio/src/main/protobuf/google/protobuf/duration.proto
  istio/src/main/protobuf/google/protobuf/timestamp.proto
  istio/src/main/protobuf/google/rpc/status.proto
  istio/src/main/protobuf/mixer/v1/attributes.proto
  istio/src/main/protobuf/mixer/v1/check.proto
  istio/src/main/protobuf/mixer/v1/report.proto
  istio/src/main/protobuf/mixer/v1/quota.proto
  istio/src/main/protobuf/mixer/v1/service.proto

A copy of ``linkerd_tpu/istio/mixer_pb.py``.
"""

from linkerd_tpu_torch.grpc import (  # noqa: F401
    Enum, Field, MapField, ProtoMessage, Rpc, ServiceDef,
)

class Any(ProtoMessage):
    """proto: google.protobuf.Any"""

class Duration(ProtoMessage):
    """proto: google.protobuf.Duration"""

class Timestamp(ProtoMessage):
    """proto: google.protobuf.Timestamp"""

class Status(ProtoMessage):
    """proto: google.rpc.Status"""

class Attributes(ProtoMessage):
    """proto: istio.mixer.v1.Attributes"""

class StringMap(ProtoMessage):
    """proto: istio.mixer.v1.StringMap"""

class CheckRequest(ProtoMessage):
    """proto: istio.mixer.v1.CheckRequest"""

class CheckResponse(ProtoMessage):
    """proto: istio.mixer.v1.CheckResponse"""

class ReportRequest(ProtoMessage):
    """proto: istio.mixer.v1.ReportRequest"""

class ReportResponse(ProtoMessage):
    """proto: istio.mixer.v1.ReportResponse"""

class QuotaRequest(ProtoMessage):
    """proto: istio.mixer.v1.QuotaRequest"""

class QuotaResponse(ProtoMessage):
    """proto: istio.mixer.v1.QuotaResponse"""

Any.FIELDS = {
    "type_url": Field(1, "string"),
    "value": Field(2, "bytes"),
}

Duration.FIELDS = {
    "seconds": Field(1, "int64"),
    "nanos": Field(2, "int32"),
}

Timestamp.FIELDS = {
    "seconds": Field(1, "int64"),
    "nanos": Field(2, "int32"),
}

Status.FIELDS = {
    "code": Field(1, "int32"),
    "message": Field(2, "string"),
    "details": Field(3, "message", message=Any, repeated=True),
}

Attributes.FIELDS = {
    "dictionary": MapField(1, "int32", "string"),
    "attribute_context": Field(2, "int32"),
    "reset_context": Field(3, "bool"),
    "string_attributes": MapField(4, "int32", "string"),
    "int64_attributes": MapField(5, "int32", "int64"),
    "double_attributes": MapField(6, "int32", "double"),
    "bool_attributes": MapField(7, "int32", "bool"),
    "timestamp_attributes": MapField(8, "int32", "message", val_message=Timestamp),
    "duration_attributes": MapField(9, "int32", "message", val_message=Duration),
    "bytes_attributes": MapField(10, "int32", "bytes"),
    "stringMap_attributes": MapField(11, "int32", "message", val_message=StringMap),
    "deleted_attributes": Field(12, "int32", repeated=True),
    "timestamp_attributes_HACK": MapField(13, "int32", "message", val_message=Timestamp),
    "duration_attributes_HACK": MapField(14, "int32", "message", val_message=Duration),
}

StringMap.FIELDS = {
    "map": MapField(1, "int32", "string"),
}

CheckRequest.FIELDS = {
    "request_index": Field(1, "int64"),
    "attribute_update": Field(2, "message", message=Attributes),
}

CheckResponse.FIELDS = {
    "request_index": Field(1, "int64"),
    "attribute_update": Field(2, "message", message=Attributes),
    "result": Field(3, "message", message=Status),
    "expiration": Field(4, "message", message=Duration),
}

ReportRequest.FIELDS = {
    "request_index": Field(1, "int64"),
    "attribute_update": Field(2, "message", message=Attributes),
}

ReportResponse.FIELDS = {
    "request_index": Field(1, "int64"),
    "attribute_update": Field(2, "message", message=Attributes),
    "result": Field(3, "message", message=Status),
}

QuotaRequest.FIELDS = {
    "request_index": Field(1, "int64"),
    "attribute_update": Field(2, "message", message=Attributes),
    "deduplication_id": Field(3, "string"),
    "quota": Field(4, "string"),
    "amount": Field(5, "int64"),
    "best_effort": Field(6, "bool"),
}

QuotaResponse.FIELDS = {
    "request_index": Field(1, "int64"),
    "attribute_update": Field(2, "message", message=Attributes),
    "result": Field(3, "message", message=Status),
    "expiration": Field(4, "message", message=Duration),
    "amount": Field(5, "int64"),
}

MIXER_SVC = ServiceDef("istio.mixer.v1.Mixer", [
    Rpc("Check", CheckRequest, CheckResponse, client_streaming=True, server_streaming=True),
    Rpc("Report", ReportRequest, ReportResponse, client_streaming=True, server_streaming=True),
    Rpc("Quota", QuotaRequest, QuotaResponse, client_streaming=True, server_streaming=True),
])
