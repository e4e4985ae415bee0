"""``io.l5d.k8s.configMap`` interpreter: the base dtab from a watched
Kubernetes ConfigMap key.

Ref: the reference's interpreter/k8s module (ConfigMap-backed dtab added
alongside IstioInterpreter) — a ConfiguredDtabNamer whose dtab Activity
follows ``configMap[filename]`` through the k8s list+watch machinery
(resourceVersion resume, 410 re-list, backoff — k8s/client.py Watcher).

A copy of ``linkerd_tpu/interpreter/k8s_configmap.py``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

from linkerd_tpu_torch.config import ConfigError, register
from linkerd_tpu_torch.core import Activity, Dtab
from linkerd_tpu_torch.core.activity import Ok
from linkerd_tpu_torch.k8s.client import K8sApi, Watcher
from linkerd_tpu_torch.namer.core import ConfiguredDtabNamer, NameInterpreter

log = logging.getLogger(__name__)


class ConfigMapDtab:
    """Activity[Dtab] following one key of one ConfigMap."""

    def __init__(self, api: K8sApi, namespace: str, name: str,
                 filename: str):
        self.filename = filename
        self.activity: Activity[Dtab] = Activity.mutable()
        path = f"/api/v1/namespaces/{namespace}/configmaps/{name}"
        self._watcher = Watcher(api, path, self._on_obj, self._on_event)

    def start(self) -> "ConfigMapDtab":
        self._watcher.start()
        return self

    def close(self) -> None:
        self._watcher.stop()

    def _on_obj(self, obj: dict) -> None:
        if obj.get("kind") == "Status":
            # missing configmap: an EMPTY dtab (not an error) so routers
            # come up and re-bind when the map appears
            self.activity.update(Ok(Dtab.empty()))
            return
        text = (obj.get("data") or {}).get(self.filename, "")
        try:
            self.activity.update(Ok(Dtab.read(text)))
        except Exception as e:  # noqa: BLE001 — bad dtab: keep last good
            log.warning("configMap interpreter: bad dtab: %s", e)
            if not isinstance(self.activity.current, Ok):
                self.activity.set_exception(e)

    def _on_event(self, evt: dict) -> None:
        if evt.get("type") == "DELETED":
            self.activity.update(Ok(Dtab.empty()))
            return
        self._on_obj(evt.get("object") or {})


@register("interpreter", "io.l5d.k8s.configMap")
@dataclass
class ConfigMapInterpreterConfig:
    name: str = ""
    filename: str = "dtab"
    namespace: str = "default"
    host: str = "localhost"   # "" -> in-cluster service account
    port: int = 8001
    useTls: bool = False
    caCertPath: Optional[str] = None
    insecureSkipVerify: bool = False

    def mk(self, namers) -> NameInterpreter:
        if not self.name:
            raise ConfigError("io.l5d.k8s.configMap interpreter needs name")
        from linkerd_tpu_torch.k8s.namer import _mk_api
        api = _mk_api(self.host, self.port, self.useTls,
                      self.caCertPath, self.insecureSkipVerify)
        cm = ConfigMapDtab(api, self.namespace, self.name, self.filename)
        interp = ConfiguredDtabNamer(list(namers), dtab=cm.activity,
                                     on_bind=lambda: cm.start())
        interp._configmap = cm  # handle for close (tests)
        return interp
