"""The port's ``io.l5d.marathon`` namer (``linkerd_tpu_torch/namer/
marathon.py``) against the JAX package's, on the CPU.

- ``_tasks_to_addr`` on seeded task lists: the same addresses.
- App polling: both namers, built from their configs at a short
  ``ttlMs``, poll one scripted Marathon (``/v2/apps/<id>/tasks``, 404
  for an unknown app): the same longest-app-id bindings, residuals and
  addresses before and after a task is replaced, and Neg for no app.
- Config errors: the same ``ConfigError`` messages for partial ACS
  fields and for each bad ``DCOS_SERVICE_ACCOUNT_CREDENTIAL``.
- ``DcosAuthenticator``: with one RSA key the JWT bytes are equal
  (RS256 with PKCS#1 v1.5 is deterministic), and both log in, cache the
  session token and re-authenticate once on a 401.

Every await is bounded.
"""

import asyncio
import json

import numpy as np
import pytest

from linkerd_tpu.config import ConfigError as RefConfigError
from linkerd_tpu.core import Path as RefPath
from linkerd_tpu.namer import marathon as ref_marathon
from linkerd_tpu_torch.config import ConfigError as PortConfigError
from linkerd_tpu_torch.core import Path as PortPath
from linkerd_tpu_torch.namer import marathon as port_marathon
from linkerd_tpu_torch.protocol.http.message import Response
from linkerd_tpu_torch.protocol.http.server import HttpServer
from linkerd_tpu_torch.router.service import FnService

PKGS = (("ref", ref_marathon, RefPath), ("port", port_marathon, PortPath))


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, 60))


async def wait_for(fn, timeout=10.0):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while True:
        v = fn()
        if v:
            return v
        if loop.time() > deadline:
            raise AssertionError("condition not met in time")
        await asyncio.sleep(0.01)


@pytest.mark.parametrize("seed", (0, 1, 2, 3))
def test_tasks_to_addr_equal(seed):
    rng = np.random.default_rng(seed)
    tasks = []
    for i in range(int(rng.integers(0, 10))):
        t = {}
        if rng.random() < 0.9:
            t["host"] = f"10.0.{i}.{int(rng.integers(255))}"
        if rng.random() < 0.85:
            t["ports"] = [int(p) for p in rng.integers(
                1, 65535, size=int(rng.integers(0, 3)))]
        tasks.append(t)
    for data in ({"tasks": tasks}, None, {}):
        a = ref_marathon._tasks_to_addr(data)
        b = port_marathon._tasks_to_addr(data)
        assert sorted((x.host, x.port) for x in a.addresses) == \
            sorted((x.host, x.port) for x in b.addresses)


class ScriptedMarathon:
    def __init__(self):
        self.apps = {"/web": [("10.0.0.1", 31001), ("10.0.0.2", 31002)],
                     "/api/v1": [("10.1.0.1", 31010)]}
        self.paths = []

    async def handle(self, req):
        self.paths.append(req.uri)
        if not req.uri.startswith("/v2/apps/") or \
                not req.uri.endswith("/tasks"):
            return Response(status=400)
        app = req.uri[len("/v2/apps"):-len("/tasks")]
        if app not in self.apps:
            return Response(status=404, body=b'{"message": "no app"}')
        return Response(status=200, body=json.dumps({"tasks": [
            {"host": h, "ports": [p, p + 1]} for h, p in self.apps[app]
        ]}).encode())


def summary(act):
    state = act.current
    if type(state).__name__ != "Ok":
        return None
    tree = state.value
    if type(tree).__name__ == "Neg":
        return "neg"
    bound = tree.value
    return (bound.id_.show, bound.residual.show,
            sorted((a.host, a.port) for a in bound.addr.sample().addresses))


LOOKUPS = ("/web", "/web/rest/of", "/api/v1/users", "/api/v2", "/nosuch")


def test_app_polling_binds_the_same(monkeypatch):
    monkeypatch.delenv("DCOS_SERVICE_ACCOUNT_CREDENTIAL", raising=False)

    async def go():
        fake = ScriptedMarathon()
        server = await HttpServer(FnService(fake.handle)).start()
        namers, acts, seen = {}, {}, []
        try:
            for pkg, mod, path_cls in PKGS:
                namers[pkg] = mod.MarathonNamerConfig(
                    host="127.0.0.1", port=server.bound_port,
                    ttlMs=50).mk()
                acts[pkg] = [namers[pkg].lookup(path_cls.read(p))
                             for p in LOOKUPS]

            async def settle():
                await wait_for(lambda: [summary(a) for a in acts["ref"]]
                               == [summary(a) for a in acts["port"]]
                               and None not in map(summary, acts["ref"]))
                seen.append([summary(a) for a in acts["ref"]])

            await settle()
            fake.apps["/web"] = [("10.0.0.1", 31001), ("10.0.0.3", 31003)]
            await wait_for(lambda: all(summary(a[0]) != seen[0][0]
                                       for a in acts.values()))
            await settle()
            return seen
        finally:
            for n in namers.values():
                n.close()
            await server.close()

    first, replaced = run(go())
    assert first[0] == ("/#/io.l5d.marathon/web", "/",
                        [("10.0.0.1", 31001), ("10.0.0.2", 31002)])
    assert first[1][1] == "/rest/of"
    assert first[2][:2] == ("/#/io.l5d.marathon/api/v1", "/users")
    assert first[3] == first[4] == "neg"
    assert replaced[0][2] == [("10.0.0.1", 31001), ("10.0.0.3", 31003)]


BAD_CREDENTIALS = {
    "not json": "{nope",
    "bad scheme": json.dumps({"scheme": "HS256", "uid": "u",
                              "login_endpoint": "http://x/", "private_key":
                              "k"}),
    "missing fields": json.dumps({"uid": "u"}),
}


@pytest.mark.parametrize("case", ["partial fields"] + sorted(BAD_CREDENTIALS))
def test_config_errors_equal(case, monkeypatch):
    msgs = []
    for (pkg, mod, _), err in zip(PKGS, (RefConfigError, PortConfigError)):
        if case == "partial fields":
            monkeypatch.delenv("DCOS_SERVICE_ACCOUNT_CREDENTIAL",
                               raising=False)
            cfg = mod.MarathonNamerConfig(acsUid="svc")
        else:
            monkeypatch.setenv("DCOS_SERVICE_ACCOUNT_CREDENTIAL",
                               BAD_CREDENTIALS[case])
            cfg = mod.MarathonNamerConfig()
        with pytest.raises(err) as ei:
            cfg.mk()
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def key_pem(seed: int) -> str:
    pytest.importorskip("cryptography")
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric import rsa

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    return key.private_bytes(
        serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption()).decode()


class ScriptedDcos:
    """ACS login recording each JWT, and a token-guarded tasks endpoint
    whose sessions can be expired."""

    def __init__(self):
        self.generation = 0
        self.jwts = []

    async def handle(self, req):
        if req.uri.startswith("/acs/api/v1/auth/login"):
            body = json.loads(req.body)
            self.jwts.append((body["uid"], body["token"]))
            return Response(status=200, body=json.dumps(
                {"token": f"session-{self.generation}"}).encode())
        if req.headers.get("Authorization") != \
                f"token=session-{self.generation}":
            return Response(status=401, body=b"{}")
        return Response(status=200, body=json.dumps(
            {"tasks": [{"host": "10.0.0.1", "ports": [31001]}]}).encode())


@pytest.mark.parametrize("uid", ["svc-acct", "linkerd"])
def test_authenticator_jwt_bytes_and_reauth(uid):
    pem = key_pem(0)

    async def go():
        out = {}
        for pkg, mod, _ in PKGS:
            dcos = ScriptedDcos()
            server = await HttpServer(FnService(dcos.handle)).start()
            try:
                auth = mod.DcosAuthenticator(
                    f"http://127.0.0.1:{server.bound_port}"
                    f"/acs/api/v1/auth/login", uid, pem)
                api = mod.MarathonApi("127.0.0.1", server.bound_port,
                                      authenticator=auth)
                got = [await api.get_json("/v2/apps/web/tasks"),
                       await api.get_json("/v2/apps/web/tasks")]
                dcos.generation += 1
                got.append(await api.get_json("/v2/apps/web/tasks"))
                out[pkg] = (auth._jwt(), dcos.jwts, got)
            finally:
                await server.close()
        return out

    out = run(go())
    assert out["ref"] == out["port"]
    jwt, logins, got = out["port"]
    assert len(logins) == 2 and all(t == jwt for _, t in logins)
    assert [s for s, _ in got] == [200, 200, 200]
