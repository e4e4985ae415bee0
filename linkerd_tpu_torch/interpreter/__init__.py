"""Interpreters: how a router binds logical names: the port's counterpart
of ``linkerd_tpu/interpreter/__init__.py``.

Ref: interpreter/ in the reference — in-process (default
ConfiguredDtabNamer) or remote via namerd's HTTP control API
(``io.l5d.namerd.http``, chunked-watch streams with backoff-reconnect).
The kinds are registered by ``interpreter.configs``; the reference's
``io.l5d.mesh`` interpreter is not ported yet (ROADMAP Queue 1 item 17,
the mesh gRPC API), nor are its thrift ``io.l5d.namerd``, ``io.l5d.fs``,
``io.l5d.k8s.configMap`` and istio interpreters (item 13).
"""

from linkerd_tpu_torch.interpreter.namerd_http import NamerdHttpInterpreter

__all__ = ["NamerdHttpInterpreter"]
