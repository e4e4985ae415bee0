"""Minimal asyncio k8s API client with streaming watch.

Ref: k8s/src/main/scala/io/buoyant/k8s/{Api,Watchable}.scala —
service-account auth (token + CA bundle, ClientConfig.scala), JSON GETs,
and the chunked-HTTP watch stream: newline-delimited JSON events, resumed
from the last resourceVersion, re-listed on 410 Gone, retried forever
with jittered backoff (Watchable.scala:62-139).

A copy of ``linkerd_tpu/k8s/client.py``.
"""

from __future__ import annotations

import asyncio
import json
import logging
import random
import ssl
from typing import AsyncIterator, Dict, Optional, Tuple

log = logging.getLogger(__name__)

SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class K8sApiError(Exception):
    def __init__(self, status: int, body: str):
        super().__init__(f"k8s api {status}: {body[:200]}")
        self.status = status


class GoneError(K8sApiError):
    """410 Gone: the resourceVersion is too old; caller must re-list."""


class K8sApi:
    """One API server endpoint; connections are per-call (watches hold
    theirs open for their lifetime)."""

    def __init__(self, host: str, port: int = 443,
                 token: Optional[str] = None,
                 ca_cert_path: Optional[str] = None,
                 use_tls: bool = True,
                 insecure_skip_verify: bool = False):
        self.host = host
        self.port = port
        self.token = token
        self._ssl: Optional[ssl.SSLContext] = None
        if use_tls:
            # Verify against the given CA, else the system trust store.
            # Verification is only ever disabled by the EXPLICIT
            # insecure_skip_verify opt-in — never silently (a MITM on the
            # API server could otherwise inject endpoint addresses).
            self._ssl = ssl.create_default_context(cafile=ca_cert_path)
            if insecure_skip_verify:
                self._ssl.check_hostname = False
                self._ssl.verify_mode = ssl.CERT_NONE

    @staticmethod
    def from_service_account(host: str = "kubernetes.default.svc",
                             port: int = 443) -> "K8sApi":
        """In-cluster config (ref: ClientConfig.scala — no kubeconfig;
        token + CA from the mounted service account)."""
        with open(f"{SERVICE_ACCOUNT_DIR}/token") as f:
            token = f.read().strip()
        return K8sApi(host, port, token=token,
                      ca_cert_path=f"{SERVICE_ACCOUNT_DIR}/ca.crt")

    # -- plumbing ---------------------------------------------------------
    async def _connect(self) -> Tuple[asyncio.StreamReader,
                                      asyncio.StreamWriter]:
        return await asyncio.open_connection(
            self.host, self.port, ssl=self._ssl)

    def _request_head(self, path: str) -> bytes:
        lines = [f"GET {path} HTTP/1.1",
                 f"Host: {self.host}",
                 "Accept: application/json"]
        if self.token:
            lines.append(f"Authorization: Bearer {self.token}")
        return ("\r\n".join(lines) + "\r\n\r\n").encode()

    @staticmethod
    async def _read_head(reader: asyncio.StreamReader
                         ) -> Tuple[int, Dict[str, str]]:
        status_line = await reader.readline()
        if not status_line:
            raise ConnectionError("k8s api closed connection")
        status = int(status_line.split(b" ", 2)[1])
        headers: Dict[str, str] = {}
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        return status, headers

    @staticmethod
    async def _read_body(reader: asyncio.StreamReader,
                         headers: Dict[str, str]) -> bytes:
        if headers.get("transfer-encoding", "").lower() == "chunked":
            out = b""
            while True:
                size_line = await reader.readline()
                n = int(size_line.strip() or b"0", 16)
                if n == 0:
                    await reader.readline()
                    return out
                out += await reader.readexactly(n)
                await reader.readline()
        n = int(headers.get("content-length", "0"))
        return await reader.readexactly(n) if n else b""

    # -- API --------------------------------------------------------------
    async def request_json(self, method: str, path: str, obj=None,
                           timeout: float = 30.0):
        """One mutating API call; returns (status, parsed body|None).
        Used by the dtab store (TPR writes) — reads go via get_json."""
        from linkerd_tpu_torch.protocol.http.simple_client import request
        headers = {"Content-Type": "application/json"}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        body = b"" if obj is None else json.dumps(obj).encode()
        rsp = await request(self.host, self.port, method, path, body=body,
                            headers=headers, ssl=self._ssl, timeout=timeout)
        parsed = None
        if rsp.body:
            try:
                parsed = json.loads(rsp.body)
            except ValueError:
                parsed = None
        return rsp.status, parsed

    async def get_json(self, path: str):
        """GET; 404 returns the parsed Status object (callers map a
        missing resource to a negative binding, not an error)."""
        from linkerd_tpu_torch.protocol.http.simple_client import get as http_get
        headers = {}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        rsp = await http_get(self.host, self.port, path, headers=headers,
                             ssl=self._ssl, timeout=30.0)
        if rsp.status == 410:
            raise GoneError(rsp.status, rsp.body.decode("utf-8", "replace"))
        if rsp.status == 404:
            try:
                return json.loads(rsp.body)  # a k8s Status object
            except ValueError:
                return {"kind": "Status", "code": 404}
        if rsp.status != 200:
            raise K8sApiError(rsp.status,
                              rsp.body.decode("utf-8", "replace"))
        return json.loads(rsp.body)

    async def watch_events(self, path: str,
                           resource_version: Optional[str] = None
                           ) -> AsyncIterator[dict]:
        """One watch connection: yields parsed events until the server
        closes the stream. Raises GoneError on 410."""
        sep = "&" if "?" in path else "?"
        uri = f"{path}{sep}watch=true"
        if resource_version:
            uri += f"&resourceVersion={resource_version}"
        reader, writer = await self._connect()
        try:
            writer.write(self._request_head(uri))
            await writer.drain()
            status, headers = await self._read_head(reader)
            if status == 410:
                raise GoneError(status, "")
            if status != 200:
                body = await self._read_body(reader, headers)
                raise K8sApiError(status, body.decode("utf-8", "replace"))
            chunked = headers.get("transfer-encoding", "").lower() == "chunked"
            buf = b""
            while True:
                if chunked:
                    size_line = await reader.readline()
                    if not size_line:
                        return
                    n = int(size_line.strip() or b"0", 16)
                    if n == 0:
                        return
                    chunk = await reader.readexactly(n)
                    await reader.readline()
                else:
                    chunk = await reader.read(65536)
                    if not chunk:
                        return
                buf += chunk
                while b"\n" in buf:
                    line, _, buf = buf.partition(b"\n")
                    line = line.strip()
                    if line:
                        evt = json.loads(line)
                        # in-stream 410 (k8s sends ERROR event w/ code 410)
                        if evt.get("type") == "ERROR":
                            code = (evt.get("object") or {}).get("code")
                            if code == 410:
                                raise GoneError(410, "watch expired")
                            raise K8sApiError(code or 500, str(evt))
                        yield evt
        finally:
            writer.close()


class Watcher:
    """The resilient list+watch loop (ref: Watchable.scala:62-139).

    ``on_list(obj)`` receives each full re-list; ``on_event(evt)`` each
    watch event. Resumes from the newest resourceVersion; re-lists on
    410 Gone; retries forever with jittered exponential backoff.
    """

    def __init__(self, api: K8sApi, path: str, on_list, on_event,
                 backoff_base: float = 0.1, backoff_max: float = 10.0):
        self._api = api
        self._path = path
        self._on_list = on_list
        self._on_event = on_event
        self._base = backoff_base
        self._max = backoff_max
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.get_event_loop().create_task(self._run())

    def set_path(self, path: str) -> None:
        """Re-point the watch (e.g. API-group fallover). The loop reads
        self._path on every list/watch call, so the next cycle — forced
        by raising from on_list, or the next reconnect — uses it."""
        self._path = path

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _run(self) -> None:
        attempt = 0
        version: Optional[str] = None
        need_list = True
        while True:
            try:
                if need_list:
                    obj = await self._api.get_json(self._path)
                    version = (obj.get("metadata") or {}).get(
                        "resourceVersion")
                    self._on_list(obj)
                    need_list = False
                async for evt in self._api.watch_events(self._path, version):
                    attempt = 0
                    v = ((evt.get("object") or {}).get("metadata")
                         or {}).get("resourceVersion")
                    if v:
                        version = v
                    self._on_event(evt)
                # clean end of stream: re-watch from last version
            except asyncio.CancelledError:
                raise
            except GoneError:
                log.debug("k8s watch %s: 410 Gone, re-listing", self._path)
                need_list = True
            except Exception as e:  # noqa: BLE001 - retry forever
                log.debug("k8s watch %s: %s", self._path, e)
                delay = min(self._max, self._base * (2 ** attempt))
                attempt = min(attempt + 1, 30)
                await asyncio.sleep(delay * (0.5 + random.random() / 2))
