"""``io.l5d.marathon`` — Marathon (DC/OS) app-id namer.

Ref: marathon/ client (v2.Api.scala:195, AppIdNamer.scala:147 watch loop)
and namer/marathon MarathonInitializer.scala:166. Paths
``/#/io.l5d.marathon/<app-id-segments...>`` map to the app's running
tasks (host:port of the first port mapping), refreshed by polling
``/v2/apps/<id>/tasks`` (the reference polls too — Marathon has no watch
API; ttlMs default 5000).
"""

from __future__ import annotations

import asyncio
import json
import logging
import random
from dataclasses import dataclass
from typing import Dict, Optional

from linkerd_tpu_torch.config import register
from linkerd_tpu_torch.core import Activity, Path, Var
from linkerd_tpu_torch.core.activity import Ok, PENDING
from linkerd_tpu_torch.core.addr import ADDR_PENDING, Addr, Address, Bound, BoundName
from linkerd_tpu_torch.core.nametree import Leaf, NameTree, NEG
from linkerd_tpu_torch.namer.core import Namer

log = logging.getLogger(__name__)


def _b64url(data: bytes) -> str:
    import base64
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode("ascii")


class DcosAuthenticator:
    """DC/OS service-account auth (ref: namer/marathon/.../
    Authenticator.scala:109): sign ``{"uid": <uid>}`` as an RS256 JWT
    with the account's private key, POST ``{"uid","token"}`` to the ACS
    login endpoint, and cache the returned session token. A 401 from
    Marathon invalidates the cache so the next request re-authenticates
    (token expiry)."""

    def __init__(self, login_endpoint: str, uid: str,
                 private_key_pem: str):
        from urllib.parse import urlparse
        u = urlparse(login_endpoint)
        self.host = u.hostname or "leader.mesos"
        self.port = u.port or (443 if u.scheme == "https" else 80)
        self.use_tls = u.scheme == "https"
        self.path = u.path or "/acs/api/v1/auth/login"
        self.uid = uid
        self.private_key_pem = private_key_pem
        self._token: Optional[str] = None
        self._lock = asyncio.Lock()

    def _jwt(self) -> str:
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import padding

        key = serialization.load_pem_private_key(
            self.private_key_pem.encode(), password=None)
        header = _b64url(json.dumps(
            {"alg": "RS256", "typ": "JWT"}).encode())
        payload = _b64url(json.dumps({"uid": self.uid}).encode())
        signing_input = f"{header}.{payload}".encode("ascii")
        sig = key.sign(signing_input, padding.PKCS1v15(), hashes.SHA256())
        return f"{header}.{payload}.{_b64url(sig)}"

    def invalidate(self, observed: Optional[str] = None) -> None:
        """Drop the cached token — but only if it's still the one the
        caller saw fail, so concurrent pollers hitting expiry don't wipe
        a freshly-acquired token (one login per expiry, not one per
        poller)."""
        if observed is None or self._token == observed:
            self._token = None

    async def token(self) -> str:
        async with self._lock:
            if self._token is not None:
                return self._token
            import ssl as ssl_mod
            from linkerd_tpu_torch.protocol.http.simple_client import request

            body = json.dumps({"uid": self.uid,
                               "token": self._jwt()}).encode()
            ctx = ssl_mod.create_default_context() if self.use_tls else None
            rsp = await request(
                self.host, self.port, "POST", self.path, body=body,
                headers={"Content-Type": "application/json"},
                ssl=ctx, timeout=15.0)
            if rsp.status != 200:
                raise ConnectionError(
                    f"dcos login failed: {rsp.status}")
            token = (json.loads(rsp.body) or {}).get("token")
            if not token:
                raise ConnectionError("dcos login: no token in response")
            self._token = token
            return token


class MarathonApi:
    """Minimal /v2 client (GET JSON over a per-call connection)."""

    def __init__(self, host: str, port: int = 8080,
                 auth_token: Optional[str] = None,
                 authenticator: Optional[DcosAuthenticator] = None):
        self.host = host
        self.port = port
        self.auth_token = auth_token
        self.authenticator = authenticator

    async def _auth(self):
        """-> (headers, token-used)."""
        if self.authenticator is not None:
            tok = await self.authenticator.token()
            return {"Authorization": f"token={tok}"}, tok
        if self.auth_token:
            return {"Authorization": f"token={self.auth_token}"}, None
        return {}, None

    async def get_json(self, path: str):
        from linkerd_tpu_torch.protocol.http.simple_client import get as http_get
        headers, used = await self._auth()
        rsp = await http_get(self.host, self.port, path,
                             headers=headers, timeout=30.0)
        if rsp.status == 401 and self.authenticator is not None:
            # session token expired: re-auth once and reissue
            # (ref: Authenticator.scala UnauthorizedResponse handling);
            # invalidate only the token WE used, not a fresh one another
            # poller already fetched
            self.authenticator.invalidate(used)
            headers, _ = await self._auth()
            rsp = await http_get(self.host, self.port, path,
                                 headers=headers, timeout=30.0)
        try:
            parsed = json.loads(rsp.body) if rsp.body else None
        except ValueError:
            parsed = None
        return rsp.status, parsed


def _tasks_to_addr(data: Optional[dict]) -> Addr:
    addresses = []
    for t in (data or {}).get("tasks") or []:
        host = t.get("host")
        ports = t.get("ports") or []
        if host and ports:
            addresses.append(Address.mk(host, int(ports[0])))
    return Bound(frozenset(addresses))


class _AppPoll:
    def __init__(self, api: MarathonApi, app_id: str, ttl_s: float):
        self.addr: Var[Addr] = Var(ADDR_PENDING)
        self.exists = Var(None)  # None until first poll; then bool
        self._api = api
        self._app_id = app_id
        self._ttl = ttl_s
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.get_event_loop().create_task(self._run())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _run(self) -> None:
        while True:
            try:
                status, data = await self._api.get_json(
                    f"/v2/apps{self._app_id}/tasks")
                if status == 404:
                    self.exists.update(False)
                elif status == 200:
                    self.exists.update(True)
                    self.addr.update(_tasks_to_addr(data))
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 - keep polling
                log.debug("marathon poll %s: %s", self._app_id, e)
            await asyncio.sleep(self._ttl * (0.75 + random.random() / 2))


class MarathonNamer(Namer):
    """Longest-matching app-id binding: for ``/a/b/c`` tries app id
    ``/a/b/c``, then ``/a/b`` (residual ``/c``), then ``/a``
    (ref: AppIdNamer matches the longest existing app path)."""

    def __init__(self, api: MarathonApi, id_prefix: str = "io.l5d.marathon",
                 ttl_s: float = 5.0):
        self._api = api
        self._id_prefix = id_prefix
        self._ttl = ttl_s
        self._polls: Dict[str, _AppPoll] = {}

    def _poll(self, app_id: str) -> _AppPoll:
        p = self._polls.get(app_id)
        if p is None:
            p = _AppPoll(self._api, app_id, self._ttl)
            self._polls[app_id] = p
        p.start()
        return p

    def lookup(self, path: Path) -> Activity[NameTree]:
        if len(path) == 0:
            return Activity.value(NEG)
        # try longest prefix first (reference Alt over candidate ids)
        candidates = []
        for n in range(len(path), 0, -1):
            app_id = "/" + "/".join(path.take(n))
            candidates.append((n, app_id, self._poll(app_id)))

        exist_vars = [p.exists for _, _, p in candidates]

        def to_state(exists_states):
            for (n, app_id, poll), exists in zip(candidates, exists_states):
                if exists is None:
                    return PENDING  # still determining
                if exists:
                    bid = Path.of("#", self._id_prefix).concat(path.take(n))
                    return Ok(Leaf(BoundName(bid, poll.addr, path.drop(n))))
            return Ok(NEG)

        return Activity(Var.collect(exist_vars).map(to_state))

    def close(self) -> None:
        for p in self._polls.values():
            p.stop()


@register("namer", "io.l5d.marathon")
@dataclass
class MarathonNamerConfig:
    """Name via Marathon app ids:
    ``/#/io.l5d.marathon/<app>`` polls the tasks API every ``ttlMs``;
    DC/OS service-account JWT auth (ACS login, token refresh on 401)
    engages when credentials are configured."""

    host: str = "marathon.mesos"
    port: int = 8080
    ttlMs: int = 5000
    prefix: str = "/io.l5d.marathon"
    # DC/OS service-account auth (ref: MarathonSecret / DCOS_SERVICE_
    # ACCOUNT_CREDENTIAL): either the env var's JSON blob is picked up
    # automatically, or the three fields are set explicitly
    acsLoginEndpoint: str = ""
    acsUid: str = ""
    acsPrivateKey: str = ""

    def _authenticator(self) -> Optional[DcosAuthenticator]:
        import os

        from linkerd_tpu_torch.config import ConfigError

        endpoint, uid, key = (self.acsLoginEndpoint, self.acsUid,
                              self.acsPrivateKey)
        if (endpoint or uid or key) and not (endpoint and uid and key):
            raise ConfigError(
                "io.l5d.marathon: acsLoginEndpoint, acsUid and "
                "acsPrivateKey must be set together")
        if not (endpoint and uid and key):
            blob = os.environ.get("DCOS_SERVICE_ACCOUNT_CREDENTIAL", "")
            if not blob:
                return None
            # a PRESENT but unusable credential is a config error — the
            # alternative is silently-unauthenticated discovery that 401s
            # forever (ref: MarathonSecret strictness)
            try:
                cred = json.loads(blob)
            except ValueError as e:
                raise ConfigError(
                    f"DCOS_SERVICE_ACCOUNT_CREDENTIAL is not JSON: {e}"
                ) from None
            if cred.get("scheme", "RS256") != "RS256":
                raise ConfigError(
                    "DCOS_SERVICE_ACCOUNT_CREDENTIAL: only RS256 is "
                    f"supported, got {cred.get('scheme')!r}")
            endpoint = cred.get("login_endpoint", "")
            uid = cred.get("uid", "")
            key = cred.get("private_key", "")
            if not (endpoint and uid and key):
                raise ConfigError(
                    "DCOS_SERVICE_ACCOUNT_CREDENTIAL missing "
                    "login_endpoint/uid/private_key")
        return DcosAuthenticator(endpoint, uid, key)

    def mk(self) -> Namer:
        return MarathonNamer(
            MarathonApi(self.host, self.port,
                        authenticator=self._authenticator()),
            ttl_s=self.ttlMs / 1e3)
