"""The port's ``io.l5d.consul`` namer (``linkerd_tpu_torch/consul``)
against the JAX package's, on the CPU: both namers, built from their
configs, long-poll one scripted consul agent (blocking-index
``/v1/health/service/<svc>`` with ``X-Consul-Index``).

For each option (``includeTag``, ``setHost``, ``preferServiceAddress``,
``consistencyMode``, ``token``): the same bound ids, residuals,
addresses and metadata, before and after an index update; an unknown
service binds Neg; a service whose queries fail stays pending in both
and binds once they answer; both send the agent the same queries and
tokens. ``_entries_to_addr`` gives the same result on seeded entries.

Every await is bounded.
"""

import asyncio
import json
from urllib.parse import parse_qsl, urlsplit

import numpy as np
import pytest

from linkerd_tpu.consul import namer as ref_consul
from linkerd_tpu.core import Path as RefPath
from linkerd_tpu_torch.consul import namer as port_consul
from linkerd_tpu_torch.core import Path as PortPath
from linkerd_tpu_torch.protocol.http.message import Response
from linkerd_tpu_torch.protocol.http.server import HttpServer
from linkerd_tpu_torch.router.service import FnService


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


def entry(ip, port, node="node1", svc_addr=None):
    svc = {"Port": port}
    if svc_addr is not None:
        svc["Address"] = svc_addr
    return {"Node": {"Node": node, "Address": ip}, "Service": svc}


class ScriptedConsul:
    """Per-service entries and one index; a query at the current index
    parks until the index moves (or 2 s pass); a service in ``failing``
    answers 500. Records every query (less index and wait) with its
    token."""

    def __init__(self):
        self.index = 10
        self.services = {"web": [entry("10.1.1.1", 8300, "n1", "192.168.0.1"),
                                 entry("10.1.1.2", 8300, "n2")]}
        self.failing = set()
        self.queries = []
        self._changed = asyncio.Event()

    def set(self, svc, entries):
        self.services[svc] = entries
        self.index += 1
        self._changed.set()
        self._changed = asyncio.Event()

    async def handle(self, req):
        parts = urlsplit(req.uri)
        q = parse_qsl(parts.query, keep_blank_values=True)
        self.queries.append((parts.path, tuple(
            kv for kv in q if kv[0] not in ("index", "wait")),
            req.headers.get("X-Consul-Token")))
        want = dict(q).get("index")
        if want is not None and int(want) >= self.index:
            try:
                await asyncio.wait_for(self._changed.wait(), 2.0)
            except asyncio.TimeoutError:
                pass
        svc = parts.path.rsplit("/", 1)[1]
        if svc in self.failing:
            return Response(status=500, body=b"agent error")
        tag = dict(q).get("tag")
        entries = [e for e in self.services.get(svc, [])
                   if tag is None or tag in e.get("Tags", [tag])]
        rsp = Response(status=200, body=json.dumps(entries).encode())
        rsp.headers.set("X-Consul-Index", str(self.index))
        return rsp


def summary(act):
    state = act.current
    if type(state).__name__ != "Ok":
        return None
    tree = state.value
    if type(tree).__name__ == "Neg":
        return "neg"
    bound = tree.value
    addr = bound.addr.sample()
    return (bound.id_.show, bound.residual.show,
            sorted((a.host, a.port, tuple(sorted(a.meta)))
                   for a in addr.addresses),
            tuple(addr.meta))


OPTIONS = {
    "default": ({}, "/dc1/web/rest"),
    "includeTag": ({"includeTag": True}, "/dc1/canary/web"),
    "setHost": ({"setHost": True, "domain": "example"}, "/dc1/web"),
    "preferServiceAddress": ({"preferServiceAddress": False}, "/dc1/web"),
    "consistencyMode stale": ({"consistencyMode": "stale"}, "/dc1/web"),
    "consistencyMode consistent": ({"consistencyMode": "consistent"},
                                   "/dc1/web"),
    "token": ({"token": "s3cret"}, "/dc1/web"),
}


def unknown_path(opts):
    return "/dc1/canary/nosuch" if opts.get("includeTag") else "/dc1/nosuch"


def failing_path(opts):
    return "/dc1/canary/flaky" if opts.get("includeTag") else "/dc1/flaky"


@pytest.mark.parametrize("case", sorted(OPTIONS))
def test_namers_bind_the_same(case):
    opts, path = OPTIONS[case]

    async def go():
        agents = {"ref": ScriptedConsul(), "port": ScriptedConsul()}
        servers, namers, acts = {}, {}, {}

        def script(fn):
            for agent in agents.values():
                fn(agent)

        script(lambda a: a.failing.add("flaky"))
        try:
            for pkg, mod, path_cls in (("ref", ref_consul, RefPath),
                                       ("port", port_consul, PortPath)):
                servers[pkg] = await HttpServer(
                    FnService(agents[pkg].handle)).start()
                namers[pkg] = mod.ConsulNamerConfig(
                    host="127.0.0.1", port=servers[pkg].bound_port,
                    **opts).mk()
                acts[pkg] = [namers[pkg].lookup(path_cls.read(p)) for p in
                             (path, unknown_path(opts), failing_path(opts))]
            seen = []

            async def settle(want_failing):
                for pkg in ("ref", "port"):
                    await wait_for(lambda: summary(acts[pkg][0]) is not None
                                   and summary(acts[pkg][1]) is not None)
                    if want_failing:
                        await wait_for(lambda: summary(acts[pkg][2]))
                await wait_for(lambda: [summary(a) for a in acts["ref"]]
                               == [summary(a) for a in acts["port"]])
                seen.append([summary(a) for a in acts["ref"]])

            await settle(False)
            # the failing service stays pending in both
            assert summary(acts["ref"][2]) is None
            script(lambda a: a.set("web", [
                entry("10.2.2.2", 8301, "n3", "192.168.0.9"),
                entry("10.2.2.3", 8302, "n4")]))
            await wait_for(lambda: summary(acts["ref"][0]) != seen[0][0]
                           and summary(acts["port"][0]) != seen[0][0])
            await settle(False)
            script(lambda a: a.failing.clear())
            script(lambda a: a.set("flaky", [entry("10.3.3.3", 8303)]))
            await settle(True)
            return seen, {pkg: a.queries for pkg, a in agents.items()}
        finally:
            for n in namers.values():
                n.close()
            for srv in servers.values():
                await srv.close()

    seen, queries = run(go())
    first, updated, healed = seen
    assert first[1] == "neg" and first[2] is None
    assert first[0] != "neg" and updated[0] != first[0]
    assert [a[:2] for a in healed[2][2]] == [("10.3.3.3", 8303)]
    if case == "preferServiceAddress":
        assert [a[0] for a in first[0][2]] == ["10.1.1.1", "10.1.1.2"]
    elif case == "default":
        assert [a[0] for a in first[0][2]] == ["10.1.1.2", "192.168.0.1"]
        assert first[0][1] == "/rest"
    if case == "setHost":
        assert dict(first[0][3])["authority"] == "web.service.dc1.example"
    # both packages asked the same questions with the same token
    assert set(queries["ref"]) == set(queries["port"])
    assert all(q[2] == opts.get("token") for q in queries["port"])
    if "consistencyMode" in opts:
        assert all((opts["consistencyMode"], "") in q[1]
                   for q in queries["port"])


@pytest.mark.parametrize("seed", (0, 1, 2, 3))
def test_entries_to_addr_equal(seed):
    rng = np.random.default_rng(seed)
    entries = []
    for i in range(int(rng.integers(0, 12))):
        e = {"Node": {}, "Service": {}}
        if rng.random() < 0.9:
            e["Node"]["Address"] = f"10.0.{i}.{int(rng.integers(255))}"
        if rng.random() < 0.7:
            e["Node"]["Node"] = f"node{int(rng.integers(4))}"
        if rng.random() < 0.5:
            e["Service"]["Address"] = (
                "" if rng.random() < 0.2 else f"172.16.{i}.1")
        if rng.random() < 0.9:
            e["Service"]["Port"] = int(rng.integers(1, 65535))
        entries.append(e)
    for prefer in (True, False):
        a = ref_consul._entries_to_addr(entries, prefer)
        b = port_consul._entries_to_addr(entries, prefer)
        assert sorted((x.host, x.port, x.meta) for x in a.addresses) == \
            sorted((x.host, x.port, x.meta) for x in b.addresses)
        assert a.meta == b.meta
