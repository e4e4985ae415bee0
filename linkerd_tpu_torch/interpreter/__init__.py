"""Interpreters: how a router binds logical names: a copy of
``linkerd_tpu/interpreter/__init__.py``. The port registers the
``default``, ``io.l5d.namerd.http`` and ``io.l5d.mesh`` kinds
(``interpreter.configs``); the ``io.l5d.fs`` interpreter named below is
refused by name (ROADMAP Queue 1 item 13).

Ref: interpreter/ in the reference — in-process (default ConfiguredDtabNamer,
``io.l5d.fs`` watched-file dtab) or remote via namerd (``io.l5d.mesh`` gRPC
streams with backoff-reconnect, interpreter/mesh/.../Client.scala).
"""

from linkerd_tpu_torch.interpreter.mesh import MeshClientInterpreter

__all__ = ["MeshClientInterpreter"]
