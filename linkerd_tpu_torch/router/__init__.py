"""Router core: identify -> bind -> balance -> dispatch: a copy of
``linkerd_tpu/router/__init__.py``.

Reference parity: linkerd's router/core (StackRouter, RoutingFactory,
DstBindingFactory) re-designed as asyncio service composition.
"""

from linkerd_tpu_torch.router.service import (
    Service, ServiceFactory, Filter, FnService, Status,
)

__all__ = ["Service", "ServiceFactory", "Filter", "FnService", "Status"]
