"""Reactive control loop: anomaly scores drive routing decisions: a copy of
``linkerd_tpu/control/__init__.py``.

The scorer measures sickness (telemetry/anomaly.py); this subsystem makes
the mesh *react* to it — the INSIGHT-survey "intelligent in-network
system" end state (PAPERS.md) where inference output closes the loop on
routing, in the spirit of Solyx AI Grid's telemetry-aware traffic
shifting across clusters. Three actuators share one hysteresis state
machine so the loop never flaps:

- ``ScoreWeightedBalancer`` (balancer.py) — multiplicative per-replica
  down-weighting inside the existing p2c/ewma/aperture pick paths:
  replicas trending anomalous receive less traffic *before* failure
  accrual would eject them, and keep a probe trickle so recovery is
  observable.
- ``MeshReactor`` (reactor.py) — cluster-level score aggregates past a
  guarded threshold (quorum + cooldown) generate a traffic-shifting dtab
  override, verified through l5dcheck's symbolic delegation
  (``override-unsafe``) before being CAS-published through the namerd
  store so every linkerd in the fleet shifts away from the sick cluster;
  automatically reverted when scores recover.
- ``AdaptiveAdmission`` (admission.py) — the routers' admission-control
  concurrency limits modulated by score trends and the drift monitor:
  shed earlier when the model says trouble is coming.

Every actuation is a traced, metered event (``control/*`` metrics
subtree, spans on override pushes, ``/control.json`` admin state).
Configured via the jaxAnomaly telemeter's ``control:`` block
(``ControlConfig``); assembled by the Linker, driven by ``ControlLoop``.
"""

from __future__ import annotations

from linkerd_tpu_torch.control.admission import AdaptiveAdmission
from linkerd_tpu_torch.control.balancer import ScoreWeightedBalancer, mk_weigher
from linkerd_tpu_torch.control.loop import ControlConfig, ControlLoop
from linkerd_tpu_torch.control.reactor import (
    LocalStoreClient, MeshReactor, NamerdHttpStoreClient, OverrideRejected,
)
from linkerd_tpu_torch.control.state import HysteresisGovernor

__all__ = [
    "AdaptiveAdmission", "ControlConfig", "ControlLoop",
    "HysteresisGovernor", "LocalStoreClient", "MeshReactor",
    "NamerdHttpStoreClient", "OverrideRejected", "ScoreWeightedBalancer",
    "mk_weigher",
]
