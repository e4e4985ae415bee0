"""namerd: the centralized naming control plane: a copy of
``linkerd_tpu/namerd/__init__.py``.

Ref: namerd/ in the reference — DtabStore-backed namespaces, served to
linkerds over the gRPC mesh API (namerd/iface/mesh) and an HTTP control
API (namerd/iface/control-http), assembled by NamerdConfig
(namerd/core/.../NamerdConfig.scala:28-95).
"""

from linkerd_tpu_torch.namerd.store import (
    DtabStore, DtabNamespaceAlreadyExists, DtabNamespaceDoesNotExist,
    DtabVersionMismatch, InMemoryDtabStore, VersionedDtab,
)
from linkerd_tpu_torch.namerd.core import Namerd, NamespacedInterpreters

__all__ = [
    "DtabStore", "DtabNamespaceAlreadyExists", "DtabNamespaceDoesNotExist",
    "DtabVersionMismatch", "InMemoryDtabStore", "VersionedDtab",
    "Namerd", "NamespacedInterpreters",
]
