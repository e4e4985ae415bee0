"""Trace identifiers: ``TraceId`` of ``linkerd_tpu/router/tracing.py``.

Wire format for ``l5d-ctx-trace``: ``<trace_id>-<span_id>-<parent_id>-<flags>``
hex fields (128/64/64-bit), flags bit0 = sampled. The telemeter's scorer
spans are children of the traces their requests carry.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Optional

_rng = random.Random()


@dataclass
class TraceId:
    trace_id: int
    span_id: int
    parent_id: int = 0
    sampled: bool = True

    def encode(self) -> str:
        flags = 1 if self.sampled else 0
        return (f"{self.trace_id:032x}-{self.span_id:016x}-"
                f"{self.parent_id:016x}-{flags:02x}")

    @staticmethod
    def decode(s: str) -> Optional["TraceId"]:
        parts = s.strip().split("-")
        if len(parts) != 4:
            return None
        try:
            return TraceId(
                trace_id=int(parts[0], 16),
                span_id=int(parts[1], 16),
                parent_id=int(parts[2], 16),
                sampled=bool(int(parts[3], 16) & 1))
        except ValueError:
            return None

    @staticmethod
    def mk_root(sampled: bool = True) -> "TraceId":
        return TraceId(_rng.getrandbits(128), _rng.getrandbits(64), 0, sampled)

    def child(self) -> "TraceId":
        return TraceId(self.trace_id, _rng.getrandbits(64), self.span_id,
                       self.sampled)
