"""Consul service discovery.

Ref: consul/ client lib (v1.ConsulApi.scala blocking-index queries) and
namer/consul (ConsulNamer.scala, SvcAddr.scala:30-95 long-poll loop).
"""

from linkerd_tpu_torch.consul.client import ConsulApi
from linkerd_tpu_torch.consul.namer import ConsulNamer

__all__ = ["ConsulApi", "ConsulNamer"]
