"""Kubernetes service discovery.

Ref: the reference's bespoke typed k8s client (k8s/ 2,463 LoC —
Api.scala, Watchable.scala chunked-watch machinery, EndpointsNamer,
ServiceNamer) rebuilt asyncio-native: a minimal authenticated API client,
a watch loop with resourceVersion resume / 410 re-list / jittered
backoff, and the namers that turn Endpoints churn into Var[Addr].

A copy of ``linkerd_tpu/k8s/__init__.py``.
"""

from linkerd_tpu_torch.k8s.client import K8sApi
from linkerd_tpu_torch.k8s.namer import EndpointsNamer

__all__ = ["K8sApi", "EndpointsNamer"]
