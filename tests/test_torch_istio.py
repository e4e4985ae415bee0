"""The istio family in both packages: the mixer wire surface
(``mixer_pb``, ``mk_report_request``, ``MixerClient``), pilot's caches,
the io.l5d.k8s.istio namer, interpreter and identifiers, the
io.l5d.k8s.istio-ingress identifiers, and the io.l5d.istio telemeter on
a router (the reference's ``tests/test_istio.py`` but its logger cases,
which come with the router's ``loggers`` key).

Messages are held byte for byte: each package encodes the same message,
and each decodes the other's bytes back to them. The scenarios that need
a server run once with the JAX package's modules and once with the
port's, each against its own fake pilot, ingress API and mixer (served
by the port's HTTP and h2 servers), and return what they saw as plain
values; the two traces must be equal. Every await is bounded.
"""

import asyncio
import json

import pytest

from linkerd_tpu_torch.protocol.http.message import Request, Response
from linkerd_tpu_torch.protocol.http.server import HttpServer
from linkerd_tpu_torch.router.service import FnService
from tests.test_torch_k8s import IngressApi, ingress_obj, mod, run

PKGS = ("ref", "port")


class FakePilot:
    """SDS + RDS + apiserver in one fake HTTP service (the reference
    test's)."""

    def __init__(self):
        self.registrations = {}  # cluster|port|k=v... -> [(ip, port)]
        self.virtual_hosts = []  # [{"name": "dest|port", "domains": [..]}]
        self.route_rules = []    # [{"type","name","spec"}]

    def service(self):
        async def handler(req: Request) -> Response:
            path = req.uri.split("?", 1)[0]
            if path.startswith("/v1/registration/"):
                key = path[len("/v1/registration/"):]
                hosts = [{"ip_address": ip, "port": port}
                         for ip, port in self.registrations.get(key, [])]
                return Response(status=200,
                                body=json.dumps({"hosts": hosts}).encode())
            if path == "/v1/routes":
                return Response(status=200, body=json.dumps(
                    [{"virtual_hosts": self.virtual_hosts}]).encode())
            if path == "/v1alpha1/config/route-rule":
                return Response(status=200,
                                body=json.dumps(self.route_rules).encode())
            return Response(status=404)
        return FnService(handler)

    async def start(self) -> int:
        self.server = await HttpServer(self.service()).start()
        return self.server.bound_port

    async def close(self) -> None:
        await self.server.close()


REVIEWS = "reviews.default.svc.cluster.local"
RULES = [
    {"type": "route-rule", "name": "to-v1", "spec": {
        "destination": REVIEWS,
        "precedence": 2,
        "match": {"httpHeaders": {"uri": {"prefix": "/api/"}}},
        "rewrite": {"uri": "/v1/"},
        "route": [
            {"tags": {"version": "v1"}, "weight": 90},
            {"tags": {"version": "v2"}, "weight": 10},
        ],
    }},
    {"type": "route-rule", "name": "redirect-old", "spec": {
        "destination": REVIEWS,
        "precedence": 5,
        "match": {"httpHeaders": {"uri": {"exact": "/old"}}},
        "redirect": {"uri": "/new", "authority": "reviews"},
    }},
]


# -- the mixer's wire surface ------------------------------------------------

REPORTS = [
    (200, "/api", "reviews.default", "caller", "reviews", "v1", 0.25),
    (503, "/", "", "", "", "", 0.0),
    (0, "/päth?q=1", "svc-3.default", "linkerd", "svc-3", "", 12.000375),
]


@pytest.mark.parametrize("args", REPORTS, ids=[str(a[0]) for a in REPORTS])
def test_report_request_bytes_alike(args):
    got, want = (mod(pkg, "istio.mixer").mk_report_request(*args).encode()
                 for pkg in ("port", "ref"))
    assert got == want
    ref_pb, port_pb = (mod(pkg, "istio.mixer_pb") for pkg in PKGS)
    assert port_pb.ReportRequest.decode(want).encode() == want
    assert ref_pb.ReportRequest.decode(got).encode() == got


SAMPLES = {
    "string": ("s-é", "t"), "bytes": (b"\x00\xff", b"b"),
    "int64": (-1234567890123, 7), "int32": (-42, 42), "bool": (True, True),
    "double": (2.5, -0.125),
}


def sample(pb, cls, depth: int = 0):
    """A message of ``cls`` with every field set (nested messages two
    levels deep), built from one plan whatever the package."""
    kw = {}
    for name, fd in cls.FIELDS.items():
        if hasattr(fd, "key_kind"):  # a map field
            val = (lambda i: sample(pb, getattr(pb, fd.val_message.__name__),
                                    depth + 1)) \
                if fd.val_kind == "message" else \
                (lambda i, k=fd.val_kind: SAMPLES[k][i % 2])
            kw[name] = {3: val(0), 11: val(1)} if depth < 2 else {}
        elif fd.kind == "message":
            if depth < 2:
                sub = getattr(pb, fd.message.__name__)
                kw[name] = ([sample(pb, sub, depth + 1)] * 2 if fd.repeated
                            else sample(pb, sub, depth + 1))
        else:
            v = SAMPLES[fd.kind]
            kw[name] = list(v) if fd.repeated else v[0]
    return cls(**kw)


MESSAGES = sorted(n for n, v in vars(mod("ref", "istio.mixer_pb")).items()
                  if isinstance(v, type) and hasattr(v, "FIELDS")
                  and v.__module__.endswith("mixer_pb"))


@pytest.mark.parametrize("name", MESSAGES)
def test_mixer_message_bytes_alike(name):
    """Every message of mixer_pb, every field set: the same bytes from
    both packages, and each package decodes the other's."""
    ref_pb, port_pb = (mod(pkg, "istio.mixer_pb") for pkg in PKGS)
    want = sample(ref_pb, getattr(ref_pb, name)).encode()
    got = sample(port_pb, getattr(port_pb, name)).encode()
    assert got == want and len(got) > 0
    assert getattr(port_pb, name).decode(want).encode() == want
    assert getattr(ref_pb, name).decode(got).encode() == got


def test_mixer_service_alike():
    def rpcs(pb):
        return [(n, r.req_cls.__name__, r.rep_cls.__name__,
                 r.client_streaming, r.server_streaming)
                for n, r in pb.MIXER_SVC.rpcs.items()]
    ref_pb, port_pb = (mod(pkg, "istio.mixer_pb") for pkg in PKGS)
    assert port_pb.MIXER_SVC.full_name == ref_pb.MIXER_SVC.full_name
    assert rpcs(port_pb) == rpcs(ref_pb)


async def start_mixer(pkg: str):
    """A mixer served by ``pkg``'s gRPC runtime: (server, reports)."""
    grpc = mod(pkg, "grpc")
    pb = mod(pkg, "istio.mixer_pb")
    reports = []
    disp = grpc.ServerDispatcher()

    async def report(reqs):
        async def gen():
            async for r in reqs:
                reports.append(r)
                yield pb.ReportResponse(request_index=r.request_index)
        return gen()

    disp.register(pb.MIXER_SVC, "Report", report)
    server = await mod(pkg, "protocol.h2.server").H2Server(disp).start()
    return server, reports


async def mixer_client(pkg: str):
    """MixerClient.report over the package's h2 client to a mixer of the
    other package (bidi-streaming Report)."""
    other = "ref" if pkg == "port" else "port"
    server, seen = await start_mixer(other)
    h2 = mod(pkg, "protocol.h2.client").H2Client("127.0.0.1",
                                                   server.bound_port)
    client = mod(pkg, "istio.mixer").MixerClient(h2)
    try:
        out = []
        for args in REPORTS:
            rsp = await client.report(*args)
            out.append(type(rsp).__name__)
    finally:
        await h2.close()
        await server.close()
    out.append([r.encode() for r in seen])
    assert len(seen) == len(REPORTS)
    return out


# -- pilot, namer, identifier, interpreter ----------------------------------

def clients(pkg: str, port: int):
    pilot = mod(pkg, "istio.pilot")
    return (pilot.DiscoveryClient("127.0.0.1", port, interval=0.1),
            pilot.ApiserverClient("127.0.0.1", port, interval=0.1))


def rule_of(rule):
    return (rule.destination, rule.precedence,
            sorted((k, (m.exact, m.prefix, m.regex))
                   for k, m in rule.match_headers.items()),
            rule.rewrite_uri, rule.rewrite_authority, rule.redirect_uri,
            rule.redirect_authority,
            [(w.destination, w.weight, sorted(w.tags.items()))
             for w in rule.route])


async def pilot_caches(pkg: str):
    pilot = mod(pkg, "istio.pilot")
    fake = FakePilot()
    fake.virtual_hosts = [
        {"name": f"{REVIEWS}|http", "domains": ["reviews", "reviews.default"]},
        {"name": "bogus-name", "domains": ["x"]}]
    fake.route_rules = RULES
    port = await fake.start()
    discovery, apiserver = clients(pkg, port)
    clusters = pilot.ClusterCache(discovery)
    routes = pilot.RouteCache(apiserver)
    try:
        out = []
        for domain in ("reviews", "reviews.default", "x", "nope"):
            c = await asyncio.wait_for(clusters.get(domain), 5)
            out.append(None if c is None else (c.dest, c.port))
        rules = await asyncio.wait_for(routes.get_rules(), 5)
        out.append(sorted((n, rule_of(r)) for n, r in rules.items()))
    finally:
        for c in (clusters, routes, discovery, apiserver):
            c.close()
        await fake.close()
    assert out[:4] == [(REVIEWS, "http")] * 2 + [None, None]
    return out


async def wait_state(pkg: str, act, done, timeout: float = 10.0):
    activity = mod(pkg, "core.activity")
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    while not (isinstance(act.current, activity.Ok) and done(act.current)):
        if loop.time() - t0 > timeout:
            raise AssertionError(f"state {act.current} after {timeout} s")
        await asyncio.sleep(0.02)
    return act.current.value


def tree_value(pkg: str, tree):
    """A bound name tree as plain values: leaves with their id, residual
    and bound ports; unions with their weights."""
    nametree = mod(pkg, "core.nametree")
    addr = mod(pkg, "core.addr")
    if isinstance(tree, nametree.Leaf):
        bn = tree.value
        a = bn.addr.sample()
        return ("leaf", bn.id_.show, bn.residual.show,
                sorted((x.host, x.port) for x in a.addresses)
                if isinstance(a, addr.Bound) else type(a).__name__)
    if isinstance(tree, nametree.Union):
        return ("union", [(w.weight, tree_value(pkg, w.tree))
                          for w in tree.weighted])
    return type(tree).__name__


async def sds_lookup(pkg: str):
    core = mod(pkg, "core")
    nametree = mod(pkg, "core.nametree")
    fake = FakePilot()
    fake.registrations[f"{REVIEWS}|http|version=v1"] = [
        ("10.0.0.1", 8080), ("10.0.0.2", 8080)]
    port = await fake.start()
    discovery, _ = clients(pkg, port)
    namer = mod(pkg, "istio.namer").IstioNamer(discovery)
    try:
        act = namer.lookup(core.Path.read(f"/{REVIEWS}/version:v1/http/x"))
        tree = await wait_state(pkg, act, lambda st: isinstance(
            st.value, nametree.Leaf))
        act2 = namer.lookup(core.Path.read("/ghost/::/http"))
        ghost = await wait_state(pkg, act2, lambda st: True)
        out = [tree_value(pkg, tree), tree_value(pkg, ghost),
               tree_value(pkg, namer.lookup(core.Path.read("/a/b")).sample())]
    finally:
        namer.close()
        discovery.close()
        await fake.close()
    assert out == [
        ("leaf", f"/#/io.l5d.k8s.istio/{REVIEWS}/version:v1/http", "/x",
         [("10.0.0.1", 8080), ("10.0.0.2", 8080)]), "Neg", "Neg"]
    return out


def meta(pkg: str, uri: str, authority: str = "reviews", headers=None):
    return mod(pkg, "istio.identifier").RequestMeta(
        uri=uri, scheme="http", method="GET", authority=authority,
        get_header=(headers or {}).get)


async def identifier_logic(pkg: str):
    core = mod(pkg, "core")
    pilot = mod(pkg, "istio.pilot")
    fake = FakePilot()
    fake.virtual_hosts = [{"name": f"{REVIEWS}|http",
                           "domains": ["reviews"]}]
    fake.route_rules = RULES + [
        {"type": "route-rule", "name": "by-header", "spec": {
            "destination": REVIEWS, "precedence": 9,
            "match": {"httpHeaders": {"cookie": {"regex": ".*user=a.*"}}},
            "route": [{"tags": {"version": "v3"}}]}}]
    port = await fake.start()
    discovery, apiserver = clients(pkg, port)
    logic = mod(pkg, "istio.identifier").IstioIdentifierLogic(
        pilot.ClusterCache(discovery), pilot.RouteCache(apiserver),
        core.Path.read("/svc"), core.Dtab.empty())
    rewrites = []
    cases = [("/api/list", "reviews", None), ("/old", "reviews", None),
             ("/plain", "reviews", None),
             ("/api/x", "reviews", {"cookie": "k=1; user=a"}),
             ("/", "example.com:8443", None), ("/", "example.com", None),
             ("/", "a:b:c", None)]
    out = []
    try:
        for uri, authority, headers in cases:
            try:
                got = await logic.identify(
                    meta(pkg, uri, authority, headers), core.Dtab.empty(),
                    lambda u, a: rewrites.append((u, a)),
                    lambda u, a: ("redirect", u, a))
            except mod(pkg, "router.routing").IdentificationError as e:
                got = ("unidentified", str(e))
            out.append(got.path.show if hasattr(got, "path") else got)
    finally:
        for c in (logic.clusters, logic.routes, discovery, apiserver):
            c.close()
        await fake.close()
    out.append(rewrites)
    assert out[:3] == ["/svc/route/to-v1/http", ("redirect", "/new",
                                                 "reviews"),
                       f"/svc/dest/{REVIEWS}/::/http"]
    assert out[4] == "/svc/ext/example.com/8443"
    return out


def routes_dtab(pkg: str):
    interp = mod(pkg, "istio.interpreter")
    pilot = mod(pkg, "istio.pilot")
    rules = {r["name"]: pilot.RouteRule.parse(r["spec"]) for r in RULES}
    rules["no-route"] = pilot.RouteRule.parse({"destination": "a.b"})
    rules["no-dest"] = pilot.RouteRule.parse({"route": [{"weight": 1}]})
    dtab = interp.routes_dtab(rules)
    out = [dtab.show, [(d.prefix.show, d.dst.show) for d in dtab]]
    entry = [d for d in dtab if d.prefix.show == "/svc/route/to-v1"][0]
    out.append(sorted((w.weight, w.tree.value.show)
                      for w in entry.dst.weighted))
    assert out[2] == [
        (10.0, f"/#/io.l5d.k8s.istio/{REVIEWS}/version:v2"),
        (90.0, f"/#/io.l5d.k8s.istio/{REVIEWS}/version:v1")]
    return out


async def interpreter_binds_route(pkg: str):
    core = mod(pkg, "core")
    pilot = mod(pkg, "istio.pilot")
    nametree = mod(pkg, "core.nametree")
    fake = FakePilot()
    fake.route_rules = [RULES[0]]
    fake.registrations[f"{REVIEWS}|http|version=v1"] = [("10.0.1.1", 9080)]
    fake.registrations[f"{REVIEWS}|http|version=v2"] = [("10.0.2.1", 9080)]
    port = await fake.start()
    discovery, apiserver = clients(pkg, port)
    namer = mod(pkg, "istio.namer").IstioNamer(discovery)
    cache = pilot.RouteCache(apiserver)
    interp = mod(pkg, "istio.interpreter").mk_istio_interpreter(
        cache, [(core.Path.read("/io.l5d.k8s.istio"), namer)])
    try:
        act = interp.bind(core.Dtab.empty(),
                          core.Path.read("/svc/route/to-v1/http"))
        tree = await wait_state(pkg, act, lambda st: isinstance(
            st.value.simplified, nametree.Union) and all(
            isinstance(w.tree, nametree.Leaf) and isinstance(
                w.tree.value.addr.sample(), mod(pkg, "core.addr").Bound)
            for w in st.value.simplified.weighted))
        out = [tree_value(pkg, tree.simplified)]
        dest = interp.bind(core.Dtab.empty(), core.Path.read(
            f"/svc/dest/{REVIEWS}/::/http"))
        out.append(tree_value(pkg, (await wait_state(
            pkg, dest, lambda st: True)).simplified))
    finally:
        for c in (cache, namer, discovery, apiserver):
            c.close()
        await fake.close()
    assert out[0][0] == "union"
    assert sorted(w for w, _ in out[0][1]) == [10.0, 90.0]
    return out


# -- istio-ingress, end to end -----------------------------------------------

def ingress_pilot() -> FakePilot:
    fake = FakePilot()
    fake.virtual_hosts = [{"name": f"{REVIEWS}|http",
                           "domains": ["reviews", f"{REVIEWS}:9080"]}]
    fake.route_rules = RULES
    return fake


def istio_ingress(path: str = "/api/.*"):
    return [ingress_obj(
        name="shop", ns="default", host="shop.example.com", path=path,
        svc="reviews", port="9080",
        annotations={"kubernetes.io/ingress.class": "istio"})]


async def istio_ingress_linker(pkg: str, tmp_path):
    """An ingress (host, path) match, its numeric port named through RDS,
    the route rule's rewrite, an fs-bound backend; a host no rule names
    is unidentified (400)."""
    linker_mod = mod(pkg, "linker")
    http = mod(pkg, "protocol.http")
    server = mod(pkg, "protocol.http.server")
    client = mod(pkg, "protocol.http.client")
    service = mod(pkg, "router.service")
    pilot = ingress_pilot()
    pilot_port = await pilot.start()
    fake = IngressApi(istio_ingress())
    k8s_port = await fake.start()

    async def backend_handler(req):
        return http.Response(status=200, body=f"echo:{req.uri}".encode())
    backend = await server.serve(service.FnService(backend_handler))
    disco = tmp_path / pkg
    disco.mkdir()
    (disco / "reviews-v1").write_text(f"127.0.0.1 {backend.bound_port}\n")
    cfg = f"""
routers:
- protocol: http
  label: istio-ing
  identifier:
    kind: io.l5d.k8s.istio-ingress
    host: 127.0.0.1
    port: {k8s_port}
    apiserverHost: 127.0.0.1
    apiserverPort: {pilot_port}
    discoveryPort: {pilot_port}
    pollIntervalMs: 100
  dtab: |
    /svc/route/to-v1/http => /#/io.l5d.fs/reviews-v1 ;
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
        for host, uri in (("shop.example.com", "/api/users"),
                          ("other.example.com", "/api/users"),
                          ("shop.example.com", "/old")):
            req = http.Request(uri=uri)
            req.headers.set("Host", host)
            rsp = await proxy(req)
            out.append((rsp.status, rsp.body if rsp.status == 200 else b"",
                        rsp.headers.get("Location")))
    finally:
        await proxy.close()
        await linker.close()
        await backend.close()
        await fake.close()
        await pilot.close()
    assert out[:2] == [(200, b"echo:/v1/users", None), (400, b"", None)]
    return out


async def istio_ingress_h2(pkg: str):
    """The h2 twin: the route's rewrite in place, a redirect rule's 302,
    the empty-label dest fall-through."""
    config = mod(pkg, "config")
    core = mod(pkg, "core")
    h2 = mod(pkg, "protocol.h2.messages")
    mod(pkg, "istio.identifier")
    pilot = ingress_pilot()
    pilot_port = await pilot.start()
    fake = IngressApi(istio_ingress("/.*"))
    k8s_port = await fake.start()
    cfg = config.lookup("h2identifier", "io.l5d.k8s.istio-ingress")(
        host="127.0.0.1", port=k8s_port, apiserverHost="127.0.0.1",
        apiserverPort=pilot_port, discoveryPort=pilot_port,
        pollIntervalMs=100)
    identify = cfg.mk(core.Path.read("/svc"), core.Dtab.empty())
    out = []
    try:
        for path in ("/api/x", "/old", "/plain"):
            req = h2.H2Request(method="GET", path=path,
                               authority="shop.example.com")
            got = await asyncio.wait_for(identify(req), 10)
            out.append((got.path.show, req.path) if hasattr(got, "path")
                       and hasattr(got, "dtab") else
                       (got.status, got.headers.get("location")))
    finally:
        await fake.close()
        await pilot.close()
    assert out == [("/svc/route/to-v1/http", "/v1/x"),
                   (302, "http://reviews/new"),
                   (f"/svc/dest/{REVIEWS}/::/http", "/plain")]
    return out


# -- the io.l5d.istio telemeter on a router ----------------------------------

def without_duration(pkg: str, report) -> bytes:
    """A report's bytes with its response.duration zeroed."""
    pb = mod(pkg, "istio.mixer_pb")
    msg = pb.ReportRequest.decode(report.encode())
    attrs = msg.attribute_update
    for k in attrs.duration_attributes_HACK:
        attrs.duration_attributes_HACK[k] = pb.Duration()
    return msg.encode()


async def telemeter_reports(pkg: str, tmp_path):
    """A router with the io.l5d.istio telemeter: one report a response,
    by status, path and target, to a mixer of the same package."""
    linker_mod = mod(pkg, "linker")
    http = mod(pkg, "protocol.http")
    server = mod(pkg, "protocol.http.server")
    client = mod(pkg, "protocol.http.client")
    service = mod(pkg, "router.service")
    mixer, reports = await start_mixer(pkg)

    async def handler(req):
        return http.Response(status=503 if "fail" in req.uri else 200,
                             body=b"x")
    backend = await server.serve(service.FnService(handler))
    disco = tmp_path / pkg
    disco.mkdir()
    (disco / "web").write_text(f"127.0.0.1 {backend.bound_port}\n")
    cfg = f"""
routers:
- protocol: http
  label: out
  dtab: |
    /svc => /#/io.l5d.fs ;
  servers: [{{port: 0}}]
telemetry:
- kind: io.l5d.istio
  mixerHost: 127.0.0.1
  mixerPort: {mixer.bound_port}
  sourceApp: caller
  targetVersion: v7
namers:
- kind: io.l5d.fs
  rootDir: {disco}
"""
    kw = {"device": "cpu"} if pkg == "port" else {}
    linker = linker_mod.load_linker(cfg, **kw)
    await linker.start()
    proxy = client.HttpClient("127.0.0.1", linker.routers[0].server_ports[0])
    sent = [("web", "/a"), ("web", "/fail"), ("ghost", "/b"), ("web", "/c")]
    try:
        statuses = []
        for host, uri in sent:
            req = http.Request(uri=uri)
            req.headers.set("Host", host)
            statuses.append((await proxy(req)).status)
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        while len(reports) < len(sent) and loop.time() - t0 < 10:
            await asyncio.sleep(0.02)
        flat = linker.metrics.flatten()
        out = [statuses, [without_duration(pkg, r) for r in reports],
               flat.get("istio/reports"), flat.get("istio/report_failures")]
    finally:
        await proxy.close()
        await linker.close()
        await backend.close()
        await mixer.close()
    assert out[0][:2] == [200, 503] and len(out[1]) == len(sent)
    assert out[2] == len(sent) and out[3] == 0
    return out


SCENARIOS = {
    "mixer_client": mixer_client,
    "pilot_caches": pilot_caches,
    "sds_lookup": sds_lookup,
    "identifier_logic": identifier_logic,
    "routes_dtab": routes_dtab,
    "interpreter_binds_route": interpreter_binds_route,
    "istio_ingress_linker": istio_ingress_linker,
    "istio_ingress_h2": istio_ingress_h2,
    "telemeter_reports": telemeter_reports,
}
WITH_TMP = ("istio_ingress_linker", "telemeter_reports")


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_istio_alike(name, tmp_path):
    outs = []
    for pkg in PKGS:
        got = SCENARIOS[name](pkg, tmp_path) if name in WITH_TMP \
            else SCENARIOS[name](pkg)
        outs.append(run(got) if asyncio.iscoroutine(got) else got)
    assert outs[1] == outs[0]


@pytest.mark.parametrize("cat,kind", [
    ("namer", "io.l5d.k8s.istio"), ("interpreter", "io.l5d.k8s.istio"),
    ("identifier", "io.l5d.k8s.istio"),
    ("identifier", "io.l5d.k8s.istio-ingress"),
    ("h2identifier", "io.l5d.k8s.istio"),
    ("h2identifier", "io.l5d.k8s.istio-ingress"),
    ("telemeter", "io.l5d.istio"), ("logger", "io.l5d.k8s.istio")])
def test_istio_kinds_are_the_references(cat, kind):
    """Each istio kind registers, in both packages, a config class of the
    same name with the same fields and defaults."""
    got = []
    for pkg in PKGS:
        for m in ("namer", "interpreter", "identifier", "telemeter"):
            mod(pkg, f"istio.{m}")
        cls = mod(pkg, "config").lookup(cat, kind)
        got.append((cls.__name__, {f.name: f.default for f in
                                   cls.__dataclass_fields__.values()}))
    assert got[1] == got[0]


@pytest.mark.parametrize("text", [
    "routers:\n- protocol: http\n  interpreter: {kind: io.l5d.k8s.istio, "
    "host: 127.0.0.1, port: 1}\n",
    "routers:\n- protocol: http\n  identifier: {kind: io.l5d.k8s.istio, "
    "host: 127.0.0.1, port: 1, discoveryPort: 1}\n",
], ids=["interpreter", "identifier"])
def test_istio_kinds_load_on_a_running_loop_only(text):
    """The istio interpreter and identifiers start pilot pollers when
    built (the namer at its first lookup), so a linker naming one loads
    only on a running event
    loop: outside one (with no loop set for the thread), both packages
    raise the same RuntimeError (ROADMAP Queue 3). The CLIs load on
    their loop."""
    import warnings

    got = []
    for pkg in PKGS:
        kw = {"device": "cpu"} if pkg == "port" else {}
        asyncio.set_event_loop(None)
        with warnings.catch_warnings():
            # the poller's coroutine is never awaited
            warnings.simplefilter("ignore", RuntimeWarning)
            with pytest.raises(RuntimeError) as e:
                mod(pkg, "linker").load_linker(text, **kw)
        got.append(str(e.value))

        async def on_a_loop():
            linker = mod(pkg, "linker").load_linker(text, **kw)
            await linker.close()
            return "loads"
        got.append(run(on_a_loop()))
    assert got[:2] == got[2:] and got[1] == "loads"
    assert "event loop" in got[0]
