"""The port's ZooKeeper family (``linkerd_tpu_torch/zk``, ``namer/zk.py``,
the ``io.l5d.serversets`` announcer and ``testing/zkserver.py``) against
the JAX package's, on the CPU.

- jute: seeded records written by both ``Writer`` s are the same bytes,
  and both ``Reader`` s read them back the same.
- The wire both ways: the port's ``ZkClient`` against the reference's
  ``FakeZkServer``, and the reference's client against the port's: the
  same CRUD results, version errors, watch events and ephemerals.
- The namers: one ZooKeeper tree, both packages' ``io.l5d.serversets``,
  ``io.l5d.zkLeader`` and ``io.l5d.curator`` namers (built from their
  configs); the same bound ids, residuals, addresses and metadata
  before and after a member joins, dies and leaves, the leader changes
  and an instance goes.
- ``ZkAnnouncer``: both write byte-equal member JSON under the same
  path, and the member is gone after the announcement closes.

Every await is bounded.
"""

import asyncio
import json

import numpy as np
import pytest

from linkerd_tpu import announcer as ref_announcer
from linkerd_tpu.core import Path as RefPath
from linkerd_tpu.namer import zk as ref_namer
from linkerd_tpu.testing.zkserver import FakeZkServer as RefZkServer
from linkerd_tpu.zk import client as ref_client
from linkerd_tpu.zk import jute as ref_jute
from linkerd_tpu_torch import announcer as port_announcer
from linkerd_tpu_torch.core import Path as PortPath
from linkerd_tpu_torch.namer import zk as port_namer
from linkerd_tpu_torch.testing.zkserver import FakeZkServer as PortZkServer
from linkerd_tpu_torch.zk import client as port_client
from linkerd_tpu_torch.zk import jute as port_jute

SEEDS = (0, 1, 2)


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, 30))


async def wait_for(fn, timeout=5.0):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while True:
        v = fn()
        if v:
            return v
        if loop.time() > deadline:
            raise AssertionError("condition not met in time")
        await asyncio.sleep(0.01)


# -- jute ---------------------------------------------------------------------


def jute_ops(seed: int):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(64):
        k = int(rng.integers(6))
        if k == 0:
            ops.append(("int32", int(rng.integers(-2**31, 2**31))))
        elif k == 1:
            ops.append(("int64", int(rng.integers(-2**63, 2**63))))
        elif k == 2:
            ops.append(("boolean", bool(rng.integers(2))))
        elif k == 3:
            n = int(rng.integers(-1, 40))
            ops.append(("buffer", None if n < 0
                        else rng.bytes(n)))
        elif k == 4:
            ops.append(("ustring", "".join(
                chr(int(c)) for c in rng.integers(32, 0x3000, size=int(
                    rng.integers(0, 12))))))
        else:
            ops.append(("ustring_vector", [f"n{int(i)}" for i in
                                           rng.integers(1000, size=int(
                                               rng.integers(0, 5)))]))
    return ops


@pytest.mark.parametrize("seed", SEEDS)
def test_jute_bytes_equal(seed):
    ops = jute_ops(seed)
    out = []
    for jute in (ref_jute, port_jute):
        w = jute.Writer()
        for name, v in ops:
            getattr(w, name)(v)
        out.append(w.packet())
    assert out[0] == out[1]
    reads = []
    for jute in (ref_jute, port_jute):
        r = jute.Reader(out[0], 4)
        reads.append([getattr(r, name)() for name, _ in ops])
        assert r.remaining() == 0
    assert reads[0] == reads[1]


# -- the wire both ways -------------------------------------------------------


async def client_script(client_mod, hosts: str) -> list:
    """CRUD, a version error, a data and a children watch, sequential
    names and an ephemeral that dies with its session; returns what was
    read."""
    zk = client_mod.ZkClient(hosts).start()
    other = client_mod.ZkClient(hosts).start()
    out = []
    try:
        await zk.ensure_path("/a/b")
        out.append(await zk.create("/a/b/n1", b"v0"))
        data, stat = await zk.get_data("/a/b/n1")
        out.append((data, stat.version))
        await zk.set_data("/a/b/n1", b"v1", version=0)
        try:
            await zk.set_data("/a/b/n1", b"v2", version=0)
        except client_mod.ZkError as e:
            out.append(("error", e.code))
        fired = []
        ev = asyncio.Event()
        await zk.get_data("/a/b/n1", watch=lambda e: (
            fired.append((e.type, e.path)), ev.set()))
        await zk.set_data("/a/b/n1", b"v2")
        await asyncio.wait_for(ev.wait(), 5)
        out.append(fired)
        out.append(await zk.create("/a/b/seq_", b"", sequential=True))
        out.append(await zk.create("/a/b/seq_", b"", sequential=True))
        out.append(sorted(await zk.get_children("/a/b")))
        await other.create("/a/b/eph_", b"e", ephemeral=True,
                           sequential=True)
        gone = asyncio.Event()
        out.append(sorted(await zk.get_children(
            "/a/b", watch=lambda e: gone.set())))
        await other.close()
        await asyncio.wait_for(gone.wait(), 5)
        out.append(sorted(await zk.get_children("/a/b")))
        await zk.delete("/a/b/n1")
        out.append(await zk.exists("/a/b/n1"))
        try:
            await zk.get_data("/nope")
        except client_mod.ZkError as e:
            out.append(("error", e.code))
    finally:
        await other.close()
        await zk.close()
    return out


@pytest.mark.parametrize("pair", ["port_client_ref_server",
                                  "ref_client_port_server"])
def test_client_and_server_across_packages(pair):
    async def go():
        res = {}
        for name, client_mod, server_cls in (
                ("ref", ref_client, RefZkServer),
                ("port", port_client, PortZkServer),
                ("cross", port_client if pair.startswith("port")
                 else ref_client,
                 RefZkServer if pair.startswith("port") else PortZkServer)):
            server = await server_cls().start()
            try:
                res[name] = await client_script(client_mod, server.hosts)
            finally:
                await server.close()
        return res

    res = run(go())
    assert res["ref"] == res["port"] == res["cross"]
    assert res["ref"][2] == ("error", ref_client.ZK_BADVERSION)


# -- the namers ---------------------------------------------------------------


def member(host, port, status="ALIVE", shard=None):
    obj = {"serviceEndpoint": {"host": host, "port": port},
           "additionalEndpoints": {"admin": {"host": host,
                                             "port": port + 1000}},
           "status": status}
    if shard is not None:
        obj["shard"] = shard
    return json.dumps(obj).encode()


def instance(host, port, ssl_port=None):
    return json.dumps({"name": "api", "address": host, "port": port,
                       "sslPort": ssl_port}).encode()


def summary(act):
    """The activity's state: None while pending, "neg", or the bound
    id, residual, sorted addresses and metadata."""
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


LOOKUPS = (
    ("io.l5d.serversets", "/discovery/prod/web"),
    ("io.l5d.serversets", "/discovery/prod/web:admin"),
    ("io.l5d.serversets", "/discovery/prod/web/extra/seg"),
    ("io.l5d.serversets", "/not/there"),
    ("io.l5d.zkLeader", "/election/svc"),
    ("io.l5d.zkLeader", "/election/svc/rest"),
    ("io.l5d.curator", "/api/extra"),
    ("io.l5d.curator", "/nothing"),
)


def mk_namers(pkg_namer, path_cls, hosts: str) -> dict:
    addrs = [{"host": hosts.split(":")[0], "port": int(hosts.split(":")[1])}]
    cfgs = {
        "io.l5d.serversets": pkg_namer.ServersetsNamerConfig(zkAddrs=addrs),
        "io.l5d.zkLeader": pkg_namer.ZkLeaderNamerConfig(zkAddrs=addrs),
        "io.l5d.curator": pkg_namer.CuratorNamerConfig(
            zkAddrs=addrs, basePath="/disco"),
    }
    return {k: c.mk() for k, c in cfgs.items()}


def test_namers_bind_the_same_trees():
    async def go():
        server = await RefZkServer().start()
        server.set_node("/discovery/prod/web/member_0000000001",
                        member("10.0.0.1", 8080, shard=3))
        server.set_node("/election/svc/c_0000000001", b"10.0.0.1:9001")
        server.set_node("/election/svc/c_0000000002", b"10.0.0.2:9002")
        server.set_node("/disco/api/i-1", instance("10.1.0.1", 8080))
        server.set_node("/disco/api/i-2", instance("10.1.0.2", 8080, 8443))
        namers = {"ref": mk_namers(ref_namer, RefPath, server.hosts),
                  "port": mk_namers(port_namer, PortPath, server.hosts)}
        acts = {pkg: [namers[pkg][kind].lookup(path_cls.read(p))
                      for kind, p in LOOKUPS]
                for pkg, path_cls in (("ref", RefPath), ("port", PortPath))}
        steps = [
            lambda: None,
            lambda: server.set_node("/discovery/prod/web/member_0000000002",
                                    member("10.0.0.2", 8080)),
            lambda: server.set_node("/discovery/prod/web/member_0000000002",
                                    member("10.0.0.2", 8080, "DEAD")),
            lambda: server.delete_node(
                "/discovery/prod/web/member_0000000001"),
            lambda: server.delete_node("/election/svc/c_0000000001"),
            lambda: server.set_node("/election/svc/c_0000000000",
                                    b"10.0.0.9:9009"),
            lambda: server.delete_node("/disco/api/i-2"),
            lambda: server.set_node("/not/there/member_0000000001",
                                    member("10.0.0.7", 80)),
        ]
        seen = []
        try:
            for step in steps:
                step()
                # both packages settle on the same trees
                await wait_for(lambda: all(
                    summary(a) is not None for a in acts["ref"]))
                await asyncio.sleep(0.1)
                await wait_for(lambda: [summary(a) for a in acts["port"]]
                               == [summary(a) for a in acts["ref"]])
                seen.append([summary(a) for a in acts["ref"]])
        finally:
            for pkg in namers.values():
                for n in pkg.values():
                    n.close()
            await ref_namer.close_shared_zk()
            await port_namer.close_shared_zk()
            await server.close()
        return seen

    seen = run(go())
    # the script moved every lookup it meant to
    assert seen[0][0][2] == [("10.0.0.1", 8080, (("shard", 3),))]
    assert seen[1][0][2][1][:2] == ("10.0.0.2", 8080)
    assert seen[0][1][2][0][:2] == ("10.0.0.1", 9080)
    assert seen[0][2][1] == "/extra/seg"
    assert seen[0][3] == "neg" and seen[-1][3] != "neg"
    assert seen[3][0][2] == []
    assert seen[3][4][2][0][:2] == ("10.0.0.1", 9001)
    assert seen[4][4][2][0][:2] == ("10.0.0.2", 9002)
    assert seen[5][4][2][0][:2] == ("10.0.0.9", 9009)
    assert seen[5][5][1] == "/rest"
    assert [a[:2] for a in seen[5][6][2]] == [("10.1.0.1", 8080),
                                              ("10.1.0.2", 8443)]
    assert dict(seen[5][6][3])["ssl"] is True
    assert [a[:2] for a in seen[6][6][2]] == [("10.1.0.1", 8080)]
    assert seen[0][7] == "neg"


# -- the serversets announcer ---------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_announcer_writes_equal_members_and_withdraws(seed):
    rng = np.random.default_rng(seed)
    port = int(rng.integers(1024, 65535))
    name = f"svc{int(rng.integers(100))}"

    async def go():
        server = await RefZkServer().start()
        addrs = [{"host": "127.0.0.1", "port": server.port}]
        got = {}
        try:
            for pkg, mod, path_cls in (
                    ("ref", ref_announcer, RefPath),
                    ("port", port_announcer, PortPath)):
                ann = mod.ZkAnnouncerConfig(zkAddrs=addrs).mk()
                closable = ann.announce("10.2.0.1", port,
                                        path_cls.read(f"/{name}"))
                base = f"/discovery/{name}"
                await wait_for(lambda: server.children_of(base)
                               if base in server.nodes else None)
                (child,) = server.children_of(base)
                got[pkg] = (child, server.nodes[f"{base}/{child}"].data,
                            server.nodes[f"{base}/{child}"].ephemeral_owner
                            != 0)
                closable.close()
                await wait_for(lambda: not server.children_of(base))
                server.delete_node(base)
        finally:
            await ref_namer.close_shared_zk()
            await port_namer.close_shared_zk()
            await server.close()
        return got

    got = run(go())
    assert got["ref"] == got["port"]
    child, data, ephemeral = got["port"]
    assert child.startswith("member_") and ephemeral
    assert json.loads(data)["serviceEndpoint"] == {"host": "10.2.0.1",
                                                   "port": port}
