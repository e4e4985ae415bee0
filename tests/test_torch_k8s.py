"""The k8s family in both packages: the io.l5d.k8s, io.l5d.k8s.ns and
io.l5d.k8s.external namers, the Kubernetes API client's watch loop, and
the io.l5d.ingress identifiers, each driven against one scripted fake
API server (the reference's technique: ``tests/test_k8s.py`` and
``tests/test_k8s_ingress.py``'s parse, identifier and end-to-end cases).

Each scenario runs once with the JAX package's modules and once with the
port's, against a fresh fake of its own, and returns what it saw as
plain values: bound trees and addresses, the order of address changes,
the watch requests' resourceVersions, 410 re-lists, label selectors,
negative bindings, identified destinations, answers through a linker.
The two packages' traces must be equal, and each holds what the
reference's own test asserts.

Every await is bounded (``run``), and every namer, cache and server a
scenario starts is stopped before it returns.
"""

import asyncio
import importlib
import json

import pytest

from linkerd_tpu_torch.protocol.http.message import Request, Response
from linkerd_tpu_torch.protocol.http.server import HttpServer
from linkerd_tpu_torch.router.service import FnService

PKGS = {"ref": "linkerd_tpu", "port": "linkerd_tpu_torch"}
WAIT_S = 10.0


def mod(pkg: str, name: str):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, 60))


async def wait_until(fn, what: str, timeout: float = WAIT_S):
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    while True:
        v = fn()
        if v:
            return v
        if loop.time() - t0 > timeout:
            raise AssertionError(f"{what}: not within {timeout} s")
        await asyncio.sleep(0.01)


def endpoints_obj(version: str, ips, port=8080, port_name="http",
                  name="web", ns="prod", labels=None):
    meta = {"resourceVersion": version, "name": name, "namespace": ns}
    if labels is not None:
        meta["labels"] = labels
    return {"kind": "Endpoints", "metadata": meta, "subsets": [{
        "addresses": [{"ip": ip} for ip in ips],
        "ports": [{"name": port_name, "port": port}],
    }]}


def service_obj(port: int, ips=("127.0.0.1",)):
    return {"kind": "Service",
            "metadata": {"name": "websvc", "namespace": "prod",
                         "resourceVersion": "7"},
            "spec": {"ports": [{"name": "http", "port": port}]},
            "status": {"loadBalancer": {"ingress": [
                {"ip": ip} for ip in ips]}}}


class FakeApi:
    """Serves one object a path (``objs``: path -> object, a 404 Status
    for any other) and a watch stream a path from a queue; keeps every
    request's URI."""

    def __init__(self, objs):
        self.objs = objs
        self.queues = {}
        self.uris = []

    def queue(self, path: str) -> asyncio.Queue:
        return self.queues.setdefault(path, asyncio.Queue())

    def push(self, path: str, evt) -> None:
        self.queue(path).put_nowait(evt)

    def service(self):
        async def handler(req: Request) -> Response:
            self.uris.append(req.uri)
            path = req.uri.split("?")[0]
            if "watch=true" in req.uri:
                q = self.queue(path)

                async def gen():
                    while True:
                        evt = await q.get()
                        if evt is None:  # end this stream
                            return
                        yield (json.dumps(evt) + "\n").encode()
                return Response(status=200, body_stream=gen())
            if path in self.objs:
                return Response(status=200,
                                body=json.dumps(self.objs[path]).encode())
            return Response(status=404, body=json.dumps(
                {"kind": "Status", "code": 404}).encode())
        return FnService(handler)

    async def start(self):
        self.server = await HttpServer(self.service()).start()
        return self.server.bound_port

    async def close(self):
        for q in self.queues.values():
            q.put_nowait(None)
        await asyncio.sleep(0)
        await self.server.close()

    def lists(self, path: str) -> int:
        return sum(u == path for u in self.uris)

    def watch_versions(self, path: str) -> list:
        """The resourceVersion each watch of ``path`` asked from."""
        out = []
        for u in self.uris:
            if u.split("?")[0] == path and "watch=true" in u:
                out.append(next((p.split("=", 1)[1] for p in
                                 u.split("?", 1)[1].split("&")
                                 if p.startswith("resourceVersion=")), None))
        return out


def tree_of(pkg: str, act):
    """An activity's current state as plain values."""
    activity = mod(pkg, "core.activity")
    nametree = mod(pkg, "core.nametree")
    st = act.current
    if not isinstance(st, activity.Ok):
        return type(st).__name__
    tree = st.value
    if isinstance(tree, nametree.Leaf):
        bn = tree.value
        return ("leaf", bn.id_.show, bn.residual.show)
    return type(tree).__name__


def addrs_of(pkg: str, var):
    addr = var.sample()
    if not isinstance(addr, mod(pkg, "core.addr").Bound):
        return type(addr).__name__
    return sorted((a.host, a.port) for a in addr.addresses)


WEB = "/api/v1/namespaces/prod/endpoints/web"


async def endpoints_lifecycle(pkg: str):
    """test_k8s.py's init, scale-up, scale-down and in-stream 410; a
    clean end of the watch stream resumes from the last version."""
    k8s = mod(pkg, "k8s.namer")
    client = mod(pkg, "k8s.client")
    Path = mod(pkg, "core").Path
    fake = FakeApi({WEB: endpoints_obj("100", ["10.0.0.1", "10.0.0.2"])})
    port = await fake.start()
    namer = k8s.EndpointsNamer(client.K8sApi("127.0.0.1", port,
                                             use_tls=False))
    out = []
    try:
        act = namer.lookup(Path.read("/prod/http/web/extra"))
        await wait_until(lambda: tree_of(pkg, act) != "Pending", "list")
        out.append(tree_of(pkg, act))
        bn = act.sample().value
        seen = []
        obs = bn.addr.observe(lambda a: seen.append(addrs_of(pkg, bn.addr)))
        steps = (
            ("101", ["10.0.0.1", "10.0.0.2", "10.0.0.3"]),
            ("102", ["10.0.0.3"]),
        )
        for version, ips in steps:
            fake.push(WEB, {"type": "MODIFIED",
                            "object": endpoints_obj(version, ips)})
            want = sorted((ip, 8080) for ip in ips)
            await wait_until(lambda: addrs_of(pkg, bn.addr) == want, version)
        # the server ends the stream: the watch resumes from 102
        fake.push(WEB, None)
        await wait_until(lambda: len(fake.watch_versions(WEB)) == 2,
                         "re-watch")
        fake.push(WEB, {"type": "MODIFIED",
                        "object": endpoints_obj("103", ["10.0.0.4"])})
        await wait_until(lambda: addrs_of(pkg, bn.addr) == [
            ("10.0.0.4", 8080)], "103")
        # watch expiry: in-stream 410 -> re-list -> the new state
        fake.objs[WEB] = endpoints_obj("200", ["10.9.9.9"])
        fake.push(WEB, {"type": "ERROR",
                        "object": {"kind": "Status", "code": 410}})
        await wait_until(lambda: addrs_of(pkg, bn.addr) == [
            ("10.9.9.9", 8080)], "re-list")
        await wait_until(lambda: len(fake.watch_versions(WEB)) == 3,
                         "watch after the re-list")
        obs.close()
        out += [seen, fake.lists(WEB), fake.watch_versions(WEB)]
    finally:
        namer.close()
        await fake.close()
    assert out[0] == ("leaf", "/#/io.l5d.k8s/prod/http/web", "/extra")
    assert out[2] == 2  # re-listed after Gone
    assert out[3] == ["100", "102", "200"]
    return out


def ports_and_lb(pkg: str):
    """test_k8s.py's numeric and missing ports, and the LoadBalancer
    ingress addresses of io.l5d.k8s.external."""
    k8s = mod(pkg, "k8s.namer")
    obj = endpoints_obj("1", ["10.0.0.1"], port=9090, port_name="admin")
    out = [sorted((a.host, a.port) for a in
                  k8s._endpoints_addrs(obj, sel).addresses)
           for sel in ("9090", "admin", "http")]
    svc = {"kind": "Service",
           "spec": {"ports": [{"name": "https", "port": 443}]},
           "status": {"loadBalancer": {"ingress": [
               {"ip": "35.1.2.3"}, {"hostname": "lb.example.com"}]}}}
    out += [sorted((a.host, a.port) for a in
                   k8s._lb_addrs(svc, sel).addresses)
            for sel in ("https", "443", "http")]
    assert out[:3] == [[("10.0.0.1", 9090)]] * 2 + [[]]
    assert out[3] == [("35.1.2.3", 443), ("lb.example.com", 443)]
    return out


async def missing_service(pkg: str):
    """A service the API server answers 404 for binds Neg."""
    k8s = mod(pkg, "k8s.namer")
    client = mod(pkg, "k8s.client")
    Path = mod(pkg, "core").Path
    fake = FakeApi({})
    port = await fake.start()
    namer = k8s.EndpointsNamer(client.K8sApi("127.0.0.1", port,
                                             use_tls=False))
    try:
        act = namer.lookup(Path.read("/prod/http/ghost"))
        await wait_until(lambda: tree_of(pkg, act) != "Pending", "list")
        short = namer.lookup(Path.read("/prod/http"))
        out = [tree_of(pkg, act), tree_of(pkg, short)]
    finally:
        namer.close()
        await fake.close()
    assert out == ["Neg", "Neg"]
    return out


async def label_selector(pkg: str):
    """With a label name, paths carry the value and the watch filters by
    it, on the server and client side."""
    k8s = mod(pkg, "k8s.namer")
    client = mod(pkg, "k8s.client")
    Path = mod(pkg, "core").Path
    fake = FakeApi({WEB: endpoints_obj("100", ["10.0.0.1"],
                                       labels={"version": "v1"})})
    port = await fake.start()
    namer = k8s.EndpointsNamer(
        client.K8sApi("127.0.0.1", port, use_tls=False),
        label_name="version")
    try:
        act = namer.lookup(Path.read("/prod/http/web/v1/rest"))
        await wait_until(lambda: tree_of(pkg, act) != "Pending", "v1")
        act9 = namer.lookup(Path.read("/prod/http/web/v9"))
        await wait_until(lambda: tree_of(pkg, act9) != "Pending", "v9")
        # a watch follows its list: read the requests once both are in
        await wait_until(lambda: all(
            any(f"version%3D{v}&watch=true" in u for u in fake.uris)
            for v in ("v1", "v9")), "the v1 and v9 watches")
        out = [tree_of(pkg, act), tree_of(pkg, act9),
               tree_of(pkg, namer.lookup(Path.read("/prod/http/web"))),
               sorted({u for u in fake.uris if "labelSelector" in u})]
    finally:
        namer.close()
        await fake.close()
    assert out[:3] == [("leaf", "/#/io.l5d.k8s/prod/http/web/v1", "/rest"),
                       "Neg", "Neg"]
    return out


async def linker_routes(pkg: str):
    """A router over the three k8s namers (endpoints by namespace, the
    namespace pinned, LoadBalancer ingress) to one live downstream."""
    linker_mod = mod(pkg, "linker")
    http = mod(pkg, "protocol.http")
    server = mod(pkg, "protocol.http.server")
    client = mod(pkg, "protocol.http.client")
    service = mod(pkg, "router.service")

    async def hello(req):
        return http.Response(status=200, body=b"from-pod")
    downstream = await server.serve(service.FnService(hello))
    dport = downstream.bound_port
    fake = FakeApi({
        WEB: endpoints_obj("1", ["127.0.0.1"], port=dport),
        "/api/v1/namespaces/prod/services/websvc": service_obj(dport),
    })
    port = await fake.start()
    cfg = f"""
routers:
- protocol: http
  label: k8sout
  dtab: |
    /svc/web => /#/io.l5d.k8s/prod/http/web ;
    /svc/ns => /#/io.l5d.k8s.ns/http/web ;
    /svc/ext => /#/io.l5d.k8s.external/prod/http/websvc ;
    /svc/ghost => /#/io.l5d.k8s/prod/http/ghost ;
  servers: [{{port: 0}}]
namers:
- {{kind: io.l5d.k8s, host: 127.0.0.1, port: {port}}}
- {{kind: io.l5d.k8s.ns, namespace: prod, host: 127.0.0.1, port: {port}}}
- {{kind: io.l5d.k8s.external, host: 127.0.0.1, port: {port}}}
"""
    kw = {"device": "cpu"} if pkg == "port" else {}
    linker = linker_mod.load_linker(cfg, **kw)
    await linker.start()
    proxy = client.HttpClient("127.0.0.1", linker.routers[0].server_ports[0])
    out = []
    try:
        for host in ("web", "ns", "ext", "ghost"):
            req = http.Request(uri="/")
            req.headers.set("Host", host)
            rsp = await proxy(req)
            out.append((host, rsp.status, rsp.body if rsp.status == 200
                        else b""))
    finally:
        await proxy.close()
        await linker.close()
        await fake.close()
        await downstream.close()
    assert out[:3] == [(h, 200, b"from-pod") for h in ("web", "ns", "ext")]
    assert out[3][1] >= 400
    return out


def ingress_obj(name="web-ingress", ns="prod", host="example.com",
                path="/api/.*", svc="api-svc", port="http",
                annotations=None, version="10"):
    return {
        "kind": "Ingress",
        "metadata": {"name": name, "namespace": ns,
                     "resourceVersion": version,
                     "annotations": annotations or {}},
        "spec": {"rules": [{"host": host, "http": {"paths": [{
            "path": path,
            "backend": {"serviceName": svc, "servicePort": port},
        }]}}]},
    }


def spec_of(spec):
    if spec is None:
        return None
    rule = lambda r: (r.host, r.path, r.svc, r.namespace, r.port)  # noqa
    return ([rule(r) for r in spec.rules],
            None if spec.fallback is None else rule(spec.fallback))


def parse_ingress(pkg: str):
    """test_k8s_ingress.py's backend shapes and annotation filter."""
    ingress = mod(pkg, "k8s.ingress")
    modern = {
        "metadata": {"name": "m", "namespace": "prod"},
        "spec": {
            "defaultBackend": {"service": {
                "name": "fallback", "port": {"number": 8080}}},
            "rules": [{"http": {"paths": [{
                "path": "/x",
                "backend": {"service": {"name": "svc-v1",
                                        "port": {"name": "http"}}},
            }]}}],
        },
    }
    out = [spec_of(ingress.parse_ingress(obj, "linkerd")) for obj in (
        ingress_obj(), modern,
        ingress_obj(annotations={"kubernetes.io/ingress.class": "nginx"}),
        ingress_obj(annotations={"kubernetes.io/ingress.class": "linkerd"}))]
    assert out[0][0][0][2:] == ("api-svc", "prod", "http")
    assert out[1][1][2:] == ("fallback", "prod", "8080")
    assert out[2] is None and out[3] is not None
    return out


INGRESSES = "/apis/extensions/v1beta1/ingresses"


class IngressApi(FakeApi):
    """An IngressList at any ``/ingresses`` path and one watch stream."""

    def __init__(self, items):
        super().__init__({})
        self.items = items

    def service(self):
        inner = super().service()

        async def handler(req: Request) -> Response:
            if "/ingresses" in req.uri and "watch=true" not in req.uri:
                self.uris.append(req.uri)
                return Response(status=200, body=json.dumps({
                    "kind": "IngressList",
                    "metadata": {"resourceVersion": "100"},
                    "items": self.items}).encode())
            return await inner(req)
        return FnService(handler)

    def push_ingress(self, evt) -> None:
        for path in [p for p in self.queues if "/ingresses" in p] or \
                [INGRESSES]:
            self.push(path, evt)


async def identify_all(pkg: str, identify, reqs) -> list:
    routing = mod(pkg, "router.routing")
    out = []
    for req in reqs:
        try:
            out.append((await identify(req)).path.show)
        except routing.IdentificationError as e:
            out.append(("unidentified", str(e)))
    return out


async def ingress_identifier(pkg: str):
    """test_k8s_ingress.py's identifier case: rules from the list, a
    non-matching host, a rule added by a watch event, the h2 twin."""
    ingress = mod(pkg, "k8s.ingress")
    core = mod(pkg, "core")
    message = mod(pkg, "protocol.http.message")
    h2 = mod(pkg, "protocol.h2.messages")
    fake = IngressApi([ingress_obj()])
    port = await fake.start()
    cfg = ingress.IngressIdentifier(host="127.0.0.1", port=port)
    h2cfg = ingress.H2IngressIdentifier(host="127.0.0.1", port=port)
    identify = cfg.mk(core.Path.of("svc"), core.Dtab.empty())
    h2id = h2cfg.mk(core.Path.of("svc"), core.Dtab.empty())

    def req(host, uri="/api/users"):
        r = message.Request(method="GET", uri=uri)
        r.headers.set("Host", host)
        return r

    try:
        out = [await identify_all(pkg, identify, [
            req("example.com"), req("other.com"),
            req("example.com", "/nope")])]
        added = ingress_obj(name="other", host="other.com",
                            svc="other-svc", port="8080", version="11")
        fake.items.append(added)  # what a later list shows
        fake.push_ingress({"type": "ADDED", "object": added})

        async def identified():
            return (await identify_all(pkg, identify, [req("other.com")]))[0]
        got = None
        for _ in range(int(WAIT_S / 0.02)):
            got = await identified()
            if isinstance(got, str):
                break
            await asyncio.sleep(0.02)
        out.append(got)
        out.append(await identify_all(pkg, h2id, [
            h2.H2Request(method="GET", path="/api/users", scheme="http",
                         authority="example.com:80"),
            h2.H2Request(method="GET", path="/api/users", scheme="http",
                         authority="other.com"),
            h2.H2Request(method="GET", path="/zzz", scheme="http",
                         authority="example.com")]))
    finally:
        for c in (cfg, h2cfg):
            if c._cache is not None:
                c._cache.stop()
        await fake.close()
    assert out[0][0] == "/svc/prod/http/api-svc"
    assert out[1] == "/svc/prod/8080/other-svc"
    assert out[2][:2] == ["/svc/prod/http/api-svc",
                          "/svc/prod/8080/other-svc"]
    return out


async def ingress_end_to_end(pkg: str, tmp_path):
    """A linker whose router identifies by Ingress rules and binds
    through the fs namer to a live downstream."""
    linker_mod = mod(pkg, "linker")
    http = mod(pkg, "protocol.http")
    server = mod(pkg, "protocol.http.server")
    client = mod(pkg, "protocol.http.client")
    service = mod(pkg, "router.service")
    fake = IngressApi([ingress_obj()])
    port = await fake.start()

    async def backend_handler(req):
        return http.Response(status=200, body=b"ingress-backend")
    backend = await server.serve(service.FnService(backend_handler))
    disco = tmp_path / pkg
    disco.mkdir()
    (disco / "api-svc").write_text(f"127.0.0.1 {backend.bound_port}\n")
    cfg = f"""
routers:
- protocol: http
  label: ingress
  identifier: {{kind: io.l5d.ingress, host: 127.0.0.1, port: {port}}}
  dtab: |
    /svc/prod/http => /#/io.l5d.fs ;
  servers: [{{port: 0}}]
namers:
- kind: io.l5d.fs
  rootDir: {disco}
"""
    kw = {"device": "cpu"} if pkg == "port" else {}
    linker = linker_mod.load_linker(cfg, **kw)
    await linker.start()
    proxy = client.HttpClient("127.0.0.1", linker.routers[0].server_ports[0])
    out = []
    try:
        for uri in ("/api/users", "/nope"):
            req = http.Request(uri=uri)
            req.headers.set("Host", "example.com")
            rsp = await proxy(req)
            out.append((rsp.status, rsp.body if rsp.status == 200 else b""))
        flat = linker.metrics.flatten()
        out.append(flat.get("rt/ingress/server/requests"))
    finally:
        await proxy.close()
        await linker.close()
        await backend.close()
        await fake.close()
    assert out == [(200, b"ingress-backend"), (400, b""), 2]
    return out


SCENARIOS = {
    "endpoints_lifecycle": endpoints_lifecycle,
    "ports_and_lb": ports_and_lb,
    "missing_service": missing_service,
    "label_selector": label_selector,
    "linker_routes": linker_routes,
    "parse_ingress": parse_ingress,
    "ingress_identifier": ingress_identifier,
    "ingress_end_to_end": ingress_end_to_end,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_k8s_alike(name, tmp_path):
    fn = SCENARIOS[name]
    outs = []
    for pkg in ("ref", "port"):
        args = (pkg, tmp_path) if name == "ingress_end_to_end" else (pkg,)
        got = fn(*args)
        outs.append(run(got) if asyncio.iscoroutine(got) else got)
    assert outs[1] == outs[0]


@pytest.mark.parametrize("kind", ["io.l5d.k8s", "io.l5d.k8s.ns",
                                  "io.l5d.k8s.external"])
def test_namer_configs_build_the_references_namers(kind):
    """Each k8s namer kind builds, from the same mapping, the reference's
    namer class on the same API address, id prefix and namespace."""
    outs = []
    for pkg in ("ref", "port"):
        mod(pkg, "k8s.namer")
        config = mod(pkg, "config")
        ncfg = config.instantiate("namer", {
            "kind": kind, "host": "127.0.0.1", "port": 1,
            "namespace": "prod"} if kind == "io.l5d.k8s.ns" else {
            "kind": kind, "host": "127.0.0.1", "port": 1}, "x")
        namer = ncfg.mk()
        outs.append((type(namer).__name__, ncfg.prefix, namer._id_prefix,
                     namer._fixed_ns, namer._api.host, namer._api.port))
        namer.close()
    assert outs[1] == outs[0]


async def watchers_after_close(pkg: str, tmp_path):
    """A linker whose router identifies by Ingress rules, closed after
    one request: the identifier's watch loop is still running (no close
    hook reaches an identifier), in both packages (ROADMAP Queue 3)."""
    linker_mod = mod(pkg, "linker")
    http = mod(pkg, "protocol.http")
    client = mod(pkg, "protocol.http.client")
    fake = IngressApi([ingress_obj()])
    port = await fake.start()
    cfg = f"""
routers:
- protocol: http
  label: ingress
  identifier: {{kind: io.l5d.ingress, host: 127.0.0.1, port: {port}}}
  servers: [{{port: 0}}]
"""
    kw = {"device": "cpu"} if pkg == "port" else {}
    linker = linker_mod.load_linker(cfg, **kw)
    await linker.start()
    proxy = client.HttpClient("127.0.0.1", linker.routers[0].server_ports[0])

    def watch_loops():
        return [t for t in asyncio.all_tasks() if not t.done() and
                t.get_coro().__qualname__ == "Watcher._run"]
    try:
        req = http.Request(uri="/api/users")
        req.headers.set("Host", "example.com")
        status = (await proxy(req)).status
    finally:
        await proxy.close()
        await linker.close()
    alive = watch_loops()
    for t in alive:
        t.cancel()
    await fake.close()
    return [status, len(alive)]


def test_identifier_watchers_outlive_the_linker(tmp_path):
    outs = [run(watchers_after_close(pkg, tmp_path)) for pkg in
            ("ref", "port")]
    # no namer binds the identified path: the router answers 400, and
    # the Ingress watch runs on after the linker closed
    assert outs[0] == outs[1] == [400, 1]
