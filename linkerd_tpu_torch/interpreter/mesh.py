"""Reconnect backoff for the remote interpreters: ``Backoff`` of
``linkerd_tpu/interpreter/mesh.py``, copied alone (the ``io.l5d.mesh``
gRPC interpreter itself is not ported: ROADMAP Queue 1 item 17, the
mesh gRPC API).

Ref: interpreter/mesh/src/main/scala/io/buoyant/interpreter/mesh/Client.scala
backoffs param — jittered exponential backoff between watch reconnects.
"""

from __future__ import annotations

import random


class Backoff:
    """Jittered exponential backoff (ref: Client.scala backoffs param)."""

    def __init__(self, base: float = 0.1, max_: float = 10.0):
        self.base = base
        self.max = max_
        self._attempt = 0

    def reset(self) -> None:
        self._attempt = 0

    def next_delay(self) -> float:
        d = min(self.max, self.base * (2 ** self._attempt))
        self._attempt = min(self._attempt + 1, 30)
        return d * (0.5 + random.random() / 2)
