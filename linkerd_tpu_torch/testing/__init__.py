"""Test/eval harnesses: fault injection, labeled traces.

A copy of ``linkerd_tpu/testing/__init__.py``.
"""

from linkerd_tpu_torch.testing.faults import FaultInjector, FaultSpec

__all__ = ["FaultInjector", "FaultSpec"]
