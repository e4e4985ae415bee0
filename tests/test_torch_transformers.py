"""The port's transformers, ``io.l5d.rewrite`` namer, fs announcer and
usage report against the JAX package's, on the CPU: the counterpart of
``tests/test_transformers.py``.

Each case runs both packages on the same inputs: each transformer's
addresses and prefixed ids, the namer wiring from config, the k8s
daemonset and localnode kinds over one fake API server, const and
rewrite, the rewrite namer mounted in an interpreter, the fs announce
and withdraw, and the usage report. A linker of each package routes
through ``io.l5d.specificHost`` over disco files that also name a host
no backend listens on, which the transformer drops.
"""

import asyncio
import importlib
import json

import pytest

from tests.test_torch_k8s import FakeApi, endpoints_obj

PKGS = {"ref": "linkerd_tpu", "port": "linkerd_tpu_torch"}


def mod(pkg: str, name: str):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


def run(coro, timeout=30):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def both(fn):
    out = {pkg: fn(pkg) for pkg in PKGS}
    assert out["port"] == out["ref"]
    return out["port"]


def bound(pkg, *hostports, **meta):
    addr = mod(pkg, "core.addr")
    return addr.Bound(frozenset(addr.Address.mk(h, p, **meta)
                                for h, p in hostports))


def hosts(addrs):
    return sorted((a.host, a.port) for a in addrs)


def instantiate(pkg, cat, raw):
    mod(pkg, "linker")  # the kinds register when the linker loads
    return mod(pkg, "config").instantiate(cat, raw)


# -- the address transformers -----------------------------------------------

def transform(pkg: str, case: str):
    T = mod(pkg, "namer.transformers")
    two = bound(pkg, ("10.0.0.1", 8080), ("10.0.0.2", 9090))
    if case == "port":
        return hosts(T.PortTransformer(4141).transform_addr(two).addresses)
    if case == "localhost":
        t = T.LocalhostTransformer(local_ips=frozenset({"10.0.0.1"}))
        return hosts(t.transform_addr(two).addresses)
    if case == "specificHost":
        t = T.SpecificHostTransformer("10.0.0.2")
        return hosts(t.transform_addr(two).addresses)
    if case == "subnet gateway":
        Var = mod(pkg, "core").Var
        gateways = Var(bound(pkg, ("10.0.1.200", 4140), ("10.0.2.200", 4140)))
        t = T.SubnetGatewayTransformer(gateways, "255.255.255.0")
        return hosts(t.transform_addr(bound(
            pkg, ("10.0.1.7", 8080), ("10.0.2.9", 8080),
            ("10.0.9.1", 8080))).addresses)
    if case == "replace":
        t = instantiate(pkg, "transformer", {
            "kind": "io.l5d.replace",
            "addrs": ["10.9.9.9 80", "10.9.9.8 81"]}).mk()
        return hosts(t.transform_addr(two).addresses)
    # the prefixed ids of a transformed leaf, for every address kind
    core, addr = mod(pkg, "core"), mod(pkg, "core.addr")
    bn = addr.BoundName(core.Path.read("/#/io.l5d.fs/web"), core.Var(two))
    out = []
    for t in (T.PortTransformer(4141), T.SpecificHostTransformer("10.0.0.2"),
              T.LocalhostTransformer(local_ips=frozenset({"10.0.0.1"}))):
        got = t.transform_leaf(bn)
        out.append((got.id_.show, hosts(got.addr.sample().addresses)))
    return out


@pytest.mark.parametrize("case", ["port", "localhost", "specificHost",
                                  "subnet gateway", "replace", "leaf ids"])
def test_address_transformers_alike(case):
    got = both(lambda pkg: transform(pkg, case))
    want = {
        "port": [("10.0.0.1", 4141), ("10.0.0.2", 4141)],
        "localhost": [("10.0.0.1", 8080)],
        "specificHost": [("10.0.0.2", 9090)],
        "subnet gateway": [("10.0.1.200", 4140), ("10.0.2.200", 4140)],
        "replace": [("10.9.9.8", 81), ("10.9.9.9", 80)],
    }.get(case)
    if want is not None:
        assert got == want
    else:
        assert [i for i, _ in got] == [
            "/%/io.l5d.port/#/io.l5d.fs/web",
            "/%/io.l5d.specificHost/#/io.l5d.fs/web",
            "/%/io.l5d.localhost/#/io.l5d.fs/web"]


def test_namer_transformers_from_config(tmp_path):
    disco = tmp_path / "disco"
    disco.mkdir()
    (disco / "web").write_text("10.0.0.1 8080\n10.0.0.2 9090\n")
    cfg = f"""
routers:
- protocol: http
  servers: [{{port: 0}}]
namers:
- kind: io.l5d.fs
  rootDir: {disco}
  transformers:
  - kind: io.l5d.port
    port: 4141
  - kind: io.l5d.specificHost
    host: 10.0.0.2
"""

    def go(pkg):
        async def main():
            linker = (mod(pkg, "linker").load_linker(cfg, device="cpu")
                      if pkg == "port" else mod(pkg, "linker").load_linker(cfg))
            try:
                namer = linker.namers[0][1]
                tree = namer.lookup(mod(pkg, "core").Path.read("/web")).sample()
                return (type(namer).__name__, tree.value.id_.show,
                        hosts(tree.value.addr.sample().addresses))
            finally:
                await linker.close()
        return run(main())
    assert both(go) == (
        "TransformingNamer",
        "/%/io.l5d.specificHost/%/io.l5d.port/#/io.l5d.fs/web",
        [("10.0.0.2", 4141)])


# -- the k8s kinds over one fake API server ---------------------------------

def test_localnode_subnet_and_hostnetwork_alike():
    def go(pkg):
        addr = mod(pkg, "core.addr")
        t = instantiate(pkg, "transformer", {
            "kind": "io.l5d.k8s.localnode", "podIp": "10.0.1.7"}).mk()
        out = [hosts(t.transform_addresses(frozenset({
            addr.Address.mk("10.0.1.20", 80),
            addr.Address.mk("10.0.2.20", 80)})))]
        t2 = instantiate(pkg, "transformer", {
            "kind": "io.l5d.k8s.localnode", "hostNetwork": True,
            "nodeName": "node-a"}).mk()
        out.append(hosts(t2.transform_addresses(frozenset({
            addr.Address.mk("10.0.1.20", 80, nodeName="node-a"),
            addr.Address.mk("10.0.2.20", 80, nodeName="node-b")}))))
        out.append(t2.kind)
        for raw in ({"kind": "io.l5d.k8s.localnode"},
                    {"kind": "io.l5d.k8s.localnode", "podIp": "10.0.1.7",
                     "netmask": "bogus"}):
            try:
                instantiate(pkg, "transformer", raw).mk()
            except Exception as e:  # noqa: BLE001
                out.append((type(e).__name__, str(e)))
        return out
    got = both(go)
    assert got[:3] == [[("10.0.1.20", 80)], [("10.0.1.20", 80)],
                       "io.l5d.k8s.localnode"]


GW = "/api/v1/namespaces/linkerd/endpoints/l5d"


def test_daemonset_over_one_fake_api_server_alike():
    """The daemonset transformer's gateways are the l5d service's
    endpoints, read from one fake API server by both packages: pods
    collapse onto their subnet's gateway, or onto their node's with
    ``hostNetwork``."""
    async def main():
        gw = endpoints_obj("1", [], port=4141, port_name="incoming",
                           name="l5d", ns="linkerd")
        gw["subsets"][0]["addresses"] = [
            {"ip": "10.0.1.1", "nodeName": "node-a"},
            {"ip": "10.0.2.1", "nodeName": "node-b"}]
        api = FakeApi({GW: gw})
        port = await api.start()
        out = {}
        try:
            for pkg in PKGS:
                addr = mod(pkg, "core.addr")
                got = []
                for host_network in (False, True):
                    t = instantiate(pkg, "transformer", {
                        "kind": "io.l5d.k8s.daemonset",
                        "namespace": "linkerd", "service": "l5d",
                        "port": "incoming", "k8sHost": "127.0.0.1",
                        "k8sPort": port, "hostNetwork": host_network}).mk()
                    pods = frozenset({
                        addr.Address.mk("10.0.1.20", 80, nodeName="node-b"),
                        addr.Address.mk("10.0.1.21", 80, nodeName="node-a"),
                        addr.Address.mk("10.0.9.30", 80, nodeName="node-x")})
                    for _ in range(500):
                        res = t.transform_addresses(pods)
                        if res:
                            break
                        await asyncio.sleep(0.01)
                    got.append((t.kind, hosts(res)))
                out[pkg] = got
        finally:
            await api.close()
        return out
    out = run(main())
    assert out["port"] == out["ref"] == [
        ("io.l5d.k8s.daemonset", [("10.0.1.1", 4141)]),
        ("io.l5d.k8s.daemonset", [("10.0.1.1", 4141), ("10.0.2.1", 4141)])]


# -- const and rewrite ------------------------------------------------------

def test_const_transformer_redirects_tree_alike():
    def go(pkg):
        core, nt, addr = (mod(pkg, n) for n in (
            "core", "core.nametree", "core.addr"))
        t = instantiate(pkg, "transformer", {
            "kind": "io.l5d.const", "path": "/$/inet/127.0.0.1/9990"}).mk()
        tree = nt.Leaf(addr.BoundName(core.Path.read("/#/x/web"),
                                      core.Var(addr.Bound(frozenset())),
                                      core.Path.read("/")))
        out = t.transform_tree(tree)
        return (type(out).__name__, out.value.show,
                t.transform_tree(nt.NEG) is nt.NEG)
    assert both(go) == ("Leaf", "/$/inet/127.0.0.1/9990", True)


def test_rewrite_namer_kind_alike():
    def go(pkg):
        core = mod(pkg, "core")
        n = instantiate(pkg, "namer", {
            "kind": "io.l5d.rewrite", "prefix": "/rw",
            "pattern": "/{env}/{svc}", "name": "/envs/{env}/{svc}"}).mk()
        tree = n.lookup(core.Path.read("/prod/web")).sample()
        neg = n.lookup(core.Path.read("/onlyone")).sample()
        errors = []
        for raw in ({"prefix": "/rw"},
                    {"prefix": "/rw", "pattern": "/{a}", "name": "/x/{b}"}):
            try:
                instantiate(pkg, "namer",
                            {"kind": "io.l5d.rewrite", **raw}).mk()
            except Exception as e:  # noqa: BLE001
                errors.append(str(e))
        return tree.value.show, type(neg).__name__, errors
    got = both(go)
    assert got[:2] == ("/envs/prod/web", "Neg") and len(got[2]) == 2


def test_rewrite_namer_mounted_in_interpreter_alike():
    def go(pkg):
        core = mod(pkg, "core")
        cfg = instantiate(pkg, "namer", {
            "kind": "io.l5d.rewrite", "prefix": "/rw",
            "pattern": "/{svc}", "name": "/$/inet/127.0.0.1/8080"})
        interp = mod(pkg, "namer.core").ConfiguredDtabNamer(
            [(core.Path.read(cfg.prefix), cfg.mk())])
        tree = interp.bind(core.Dtab.read("/svc => /#/rw"),
                           core.Path.read("/svc/web")).sample().simplified
        return type(tree).__name__, tree.value.id_.show
    got = both(go)
    assert got[0] == "Leaf" and "/inet/127.0.0.1/8080" in got[1]


# -- the fs announcer -------------------------------------------------------

def test_fs_announce_and_withdraw_alike(tmp_path):
    """A linker announces its server into a directory while it runs and
    withdraws it on close; the file's lines are the same in both
    packages, for a server on a fixed port and one on port 0."""
    def go(pkg):
        disco = tmp_path / pkg
        cfg = f"""
routers:
- protocol: http
  label: out
  servers:
  - port: 0
    announce: ["/#/io.l5d.fs/web", "/#/io.l5d.fs/api"]
announcers:
- kind: io.l5d.fs
  rootDir: {disco}
"""

        async def main():
            linker = (mod(pkg, "linker").load_linker(cfg, device="cpu")
                      if pkg == "port" else mod(pkg, "linker").load_linker(cfg))
            await linker.start()
            port = linker.routers[0].server_ports[0]
            files = {f: (disco / f).read_text().replace(str(port), "<port>")
                     for f in ("web", "api")}
            await linker.close()
            return files, sorted(p.name for p in disco.iterdir()
                                 if not p.name.endswith(".lock"))
        return run(main())
    files, left = both(go)
    assert files == {"web": "127.0.0.1 <port>\n", "api": "127.0.0.1 <port>\n"}
    assert left == []


def test_announce_errors_alike():
    """An announce path outside /#/ and one no announcer covers fail the
    load with the reference's words; so does a serversets announcer with
    no ZooKeeper address (refused by name until it was ported)."""
    base = ("routers:\n- protocol: http\n  servers:\n  - port: 0\n"
            "    announce: [{path}]\nannouncers:\n- kind: io.l5d.fs\n"
            "  rootDir: .\n")
    out = {}
    for pkg in PKGS:
        got = []
        for path in ("/io.l5d.fs/web", "/#/io.l5d.zk/web"):
            text = base.format(path=path)
            try:
                (mod(pkg, "linker").load_linker(text, device="cpu")
                 if pkg == "port" else mod(pkg, "linker").load_linker(text))
            except Exception as e:  # noqa: BLE001
                got.append(str(e))
        out[pkg] = got
    assert out["port"] == out["ref"] and len(out["port"]) == 2
    from linkerd_tpu.config import ConfigError as RefConfigError
    from linkerd_tpu_torch.config import ConfigError
    text = ("routers:\n- protocol: http\nannouncers:\n"
            "- {kind: io.l5d.serversets}\n")
    with pytest.raises(ConfigError) as port_err:
        mod("port", "linker").load_linker(text, device="cpu")
    with pytest.raises(RefConfigError) as ref_err:
        mod("ref", "linker").load_linker(text)
    assert str(port_err.value) == str(ref_err.value)
    assert "zkAddrs" in str(port_err.value)


# -- the usage report -------------------------------------------------------

def test_usage_report_alike():
    text = """
routers:
- protocol: http
  dtab: |
    /svc/secret-service => /#/io.l5d.fs ;
  identifier: {kind: io.l5d.methodAndHost}
  tenantIdentifier: {kind: header}
  loggers: [{kind: io.l5d.http.debug}]
  servers: [{port: 0, announce: [/#/io.l5d.fs/secret]}]
namers:
- kind: io.l5d.fs
  rootDir: /secret/path
  transformers: [{kind: io.l5d.port, port: 4141}]
announcers:
- {kind: io.l5d.fs, rootDir: /secret/announce}
"""

    def go(pkg):
        spec = mod(pkg, "linker").parse_linker_spec(text)
        return mod(pkg, "telemetry.usage").build_report(
            spec, orgId="acme", instance_id="i", start_time=0)
    report = both(go)
    assert "secret" not in json.dumps(report)
    assert report["namers"] == ["io.l5d.fs"]


# -- a linker routing through io.l5d.specificHost ---------------------------

def test_specific_host_routes_only_through_the_transform(tmp_path):
    """The disco file names the replica at 127.0.0.2, where nothing
    listens, and at 127.0.0.1; ``io.l5d.specificHost`` with host
    127.0.0.1 keeps only the second, so every request is answered, and
    without it half are not. The kind filters, as linkerd's does,
    though its config's docstring says it replaces the host (in both
    packages). Both linkers give the same answers and bound ids."""
    def go(pkg):
        disco = tmp_path / pkg
        disco.mkdir()
        http = mod(pkg, "protocol.http")
        server = mod(pkg, "protocol.http.server")
        client = mod(pkg, "protocol.http.client")
        service = mod(pkg, "router.service")

        async def main():
            async def handler(req):
                return http.Response(status=200, body=b"web")
            backend = await server.serve(service.FnService(handler))
            (disco / "web").write_text(f"127.0.0.2 {backend.bound_port}\n"
                                       f"127.0.0.1 {backend.bound_port}\n")
            out = []
            for transformers in ("", "  transformers:\n"
                                     "  - {kind: io.l5d.specificHost, "
                                     "host: 127.0.0.1}\n"):
                cfg = (f"routers:\n- protocol: http\n  label: edge\n"
                       f"  dtab: '/svc => /#/io.l5d.fs'\n"
                       f"  client: {{failureAccrual: {{kind: none}}, "
                       f"loadBalancer: {{kind: roundRobin}}}}\n"
                       f"  servers: [{{port: 0}}]\nnamers:\n"
                       f"- kind: io.l5d.fs\n  rootDir: {disco}\n"
                       + transformers)
                linker = (mod(pkg, "linker").load_linker(cfg, device="cpu")
                          if pkg == "port"
                          else mod(pkg, "linker").load_linker(cfg))
                await linker.start()
                proxy = client.HttpClient(
                    "127.0.0.1", linker.routers[0].server_ports[0])
                try:
                    answers = []
                    for _ in range(4):
                        req = http.Request(uri="/")
                        req.headers.set("Host", "web")
                        rsp = await proxy(req)
                        answers.append((rsp.status, rsp.body
                                        if rsp.status == 200 else b""))
                    out.append((sorted(answers), sorted(
                        k for k in linker.metrics.flatten()
                        if k.startswith("rt/edge/client/")
                        and k.endswith("/requests"))))
                finally:
                    await proxy.close()
                    await linker.close()
            await backend.close()
            return out
        return run(main())
    got = both(go)
    assert got[0] == ([(200, b"web")] * 2 + [(502, b"")] * 2,
                      ["rt/edge/client/#.io.l5d.fs.web/requests"])
    assert got[1] == ([(200, b"web")] * 4, [
        "rt/edge/client/%.io.l5d.specificHost.#.io.l5d.fs.web/requests"])


def test_daemonset_watch_outlives_the_linker(tmp_path):
    """A namer behind ``io.l5d.k8s.daemonset``: the transformer's own
    Endpoints watch of the gateways is still running after the linker
    closed (``TransformingNamer.close`` reaches the inner namer alone),
    in both packages (ROADMAP Queue 3)."""
    async def main(pkg):
        gw = endpoints_obj("1", ["10.0.1.1"], port=4141,
                           port_name="incoming", name="l5d", ns="linkerd")
        api = FakeApi({GW: gw})
        port = await api.start()
        disco = tmp_path / pkg
        disco.mkdir()
        cfg = f"""
routers:
- protocol: http
  servers: [{{port: 0}}]
namers:
- kind: io.l5d.fs
  rootDir: {disco}
  transformers:
  - {{kind: io.l5d.k8s.daemonset, namespace: linkerd, service: l5d,
     port: incoming, k8sHost: 127.0.0.1, k8sPort: {port}}}
"""

        def watch_loops():
            return [t for t in asyncio.all_tasks() if not t.done() and
                    t.get_coro().__qualname__ == "Watcher._run"]
        linker = (mod(pkg, "linker").load_linker(cfg, device="cpu")
                  if pkg == "port" else mod(pkg, "linker").load_linker(cfg))
        await linker.start()
        for _ in range(500):
            if api.lists(GW):
                break
            await asyncio.sleep(0.01)
        await linker.close()
        alive = watch_loops()
        for t in alive:
            t.cancel()
        await asyncio.gather(*alive, return_exceptions=True)
        await api.close()
        return api.lists(GW), len(alive)
    outs = {pkg: run(main(pkg)) for pkg in PKGS}
    assert outs["port"] == outs["ref"] == (1, 1)
