"""Admin HTTP surface (ref: the reference's admin/ and linkerd/admin): a
copy of ``linkerd_tpu/admin/__init__.py``."""

from linkerd_tpu_torch.admin.server import AdminServer, Handler

__all__ = ["AdminServer", "Handler"]
