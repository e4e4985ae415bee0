"""MixerClient: telemetry reporting / precondition checking against
istio-mixer over the in-repo gRPC runtime.

The wire surface (mixer_pb.py) is generated from istio's protos by
tools/proto_gen.py. Attribute encoding follows the reference exactly: a
per-request word dictionary is sent inline and attribute maps index into
it (ref MixerClient.scala:40-100 — the minimum attribute set that drives
mixer/prometheus request_count and request_duration metrics).

A copy of ``linkerd_tpu/istio/mixer.py``.
"""

from __future__ import annotations

import logging
from typing import List, Optional

from linkerd_tpu_torch.istio import mixer_pb as pb

log = logging.getLogger(__name__)


def mk_report_request(response_code: int, request_path: str,
                      target_service: str, source_label_app: str,
                      target_label_app: str, target_label_version: str,
                      duration_s: float) -> pb.ReportRequest:
    """Ref MixerClient.mkReportRequest (MixerClient.scala:41-100): the
    words used are sent as the request's own dictionary, so indices are
    self-describing."""
    words: List[str] = [
        "request.path", "target.service", "response.code",
        "source.labels", "target.labels", "response.duration",
        "app", "version",
        request_path, target_service, source_label_app,
        target_label_app, target_label_version,
    ]
    idx = {w: i for i, w in enumerate(words)}
    secs = int(duration_s)
    nanos = int((duration_s - secs) * 1e9)
    return pb.ReportRequest(attribute_update=pb.Attributes(
        dictionary={i: w for i, w in enumerate(words)},
        string_attributes={
            idx["request.path"]: request_path,
            idx["target.service"]: target_service,
        },
        int64_attributes={idx["response.code"]: int(response_code)},
        stringMap_attributes={
            idx["source.labels"]: pb.StringMap(
                map={idx["app"]: source_label_app}),
            idx["target.labels"]: pb.StringMap(map={
                idx["app"]: target_label_app,
                idx["version"]: target_label_version,
            }),
        },
        duration_attributes_HACK={
            idx["response.duration"]: pb.Duration(
                seconds=secs, nanos=nanos),
        },
    ))


class MixerClient:
    """report()/check() over an h2 service (raw H2Client or a full router
    client stack — ref MixerClient.scala:103-131)."""

    def __init__(self, h2_service, authority: str = ""):
        from linkerd_tpu_torch.grpc import ClientDispatcher
        self._dispatcher = ClientDispatcher(h2_service, authority=authority)

    async def report(self, response_code: int, request_path: str,
                     target_service: str, source_label_app: str,
                     target_label_app: str, target_label_version: str,
                     duration_s: float) -> pb.ReportResponse:
        req = mk_report_request(
            response_code, request_path, target_service, source_label_app,
            target_label_app, target_label_version, duration_s)
        reps = await self._dispatcher.call_stream(
            pb.MIXER_SVC, "Report", [req])
        try:
            return await reps.recv()
        except StopAsyncIteration:
            return pb.ReportResponse()

    async def check(self, attributes: Optional[pb.Attributes] = None
                    ) -> pb.CheckResponse:
        req = pb.CheckRequest(
            attribute_update=attributes or pb.Attributes())
        reps = await self._dispatcher.call_stream(
            pb.MIXER_SVC, "Check", [req])
        try:
            return await reps.recv()
        except StopAsyncIteration:
            return pb.CheckResponse()
