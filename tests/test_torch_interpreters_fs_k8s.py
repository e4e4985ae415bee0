"""The io.l5d.fs and io.l5d.k8s.configMap interpreters in both packages:
the base dtab followed live from a watched file and from a ConfigMap key
over ``ConfiguredDtabNamer`` (the reference's
``tests/test_interpreters_fs_k8s.py``).

Each scenario runs with the JAX package's modules and with the port's,
each against its own fs namer directory, file and fake API server, and
returns the bound trees it saw before and after the update; the two
packages' traces must be equal. Every await is bounded.
"""

import asyncio
import json

import pytest

from tests.test_torch_k8s import FakeApi, mod, run, tree_of, wait_until

CM = "/api/v1/namespaces/default/configmaps/l5d-dtab"


def configmap(dtab: str, version: int) -> dict:
    return {"kind": "ConfigMap",
            "metadata": {"name": "l5d-dtab", "namespace": "default",
                         "resourceVersion": str(version)},
            "data": {"dtab": dtab}}


def disco_dir(tmp_path, pkg: str):
    disco = tmp_path / pkg / "disco"
    disco.mkdir(parents=True)
    (disco / "web").write_text("127.0.0.1 9999\n")
    (disco / "api").write_text("127.0.0.1 8888\n")
    return disco


async def bound(pkg: str, interp, leaf_id: str):
    """The tree ``/svc`` binds to once it is a leaf named ``leaf_id``,
    and its addresses' ports."""
    core = mod(pkg, "core")
    act = interp.bind(core.Dtab.empty(), core.Path.read("/svc"))
    await wait_until(lambda: tree_of(pkg, act)[:2] == ("leaf", leaf_id),
                     leaf_id)
    bn = act.sample().value
    return tree_of(pkg, act), sorted(a.port for a in
                                     bn.addr.sample().addresses)


async def fs_follows_file(pkg: str, tmp_path):
    config = mod(pkg, "config")
    mod(pkg, "interpreter.configs")  # registers the kinds
    disco = disco_dir(tmp_path, pkg)
    dtab_file = tmp_path / pkg / "dtab"
    dtab_file.write_text("/svc => /#/io.l5d.fs/web ;\n")
    cfg = config.instantiate("interpreter", {
        "kind": "io.l5d.fs", "dtabFile": str(dtab_file)})
    namer = mod(pkg, "namer.fs").FsNamer(str(disco))
    interp = cfg.mk([(mod(pkg, "core").Path.read("/io.l5d.fs"), namer)])
    try:
        out = [await bound(pkg, interp, "/#/io.l5d.fs/web")]
        dtab_file.write_text("/svc => /#/io.l5d.fs/api ;\n")
        interp._file_dtab.refresh()  # deterministic poll
        out.append(await bound(pkg, interp, "/#/io.l5d.fs/api"))
    finally:
        interp._file_dtab.close()
        namer.close()
    assert out == [(("leaf", "/#/io.l5d.fs/web", "/"), [9999]),
                   (("leaf", "/#/io.l5d.fs/api", "/"), [8888])]
    return out


async def configmap_follows_updates(pkg: str, tmp_path):
    config = mod(pkg, "config")
    mod(pkg, "interpreter.configs")
    disco = disco_dir(tmp_path, pkg)
    fake = FakeApi({CM: configmap("/svc => /#/io.l5d.fs/web ;", 5)})
    port = await fake.start()
    cfg = config.instantiate("interpreter", {
        "kind": "io.l5d.k8s.configMap", "name": "l5d-dtab",
        "host": "127.0.0.1", "port": port})
    namer = mod(pkg, "namer.fs").FsNamer(str(disco))
    interp = cfg.mk([(mod(pkg, "core").Path.read("/io.l5d.fs"), namer)])
    try:
        out = [await bound(pkg, interp, "/#/io.l5d.fs/web")]
        fake.objs[CM] = configmap("/svc => /#/io.l5d.fs/api ;", 6)
        fake.push(CM, {"type": "MODIFIED", "object": fake.objs[CM]})
        out.append(await bound(pkg, interp, "/#/io.l5d.fs/api"))
        # a deleted ConfigMap leaves an empty dtab: /svc binds Neg
        fake.push(CM, {"type": "DELETED", "object": fake.objs[CM]})
        act = interp.bind(mod(pkg, "core").Dtab.empty(),
                          mod(pkg, "core").Path.read("/svc"))
        await wait_until(lambda: tree_of(pkg, act) == "Neg", "deleted")
        out.append(tree_of(pkg, act))
        out.append(fake.watch_versions(CM))
    finally:
        interp._configmap.close()
        namer.close()
        await fake.close()
    assert out[:3] == [(("leaf", "/#/io.l5d.fs/web", "/"), [9999]),
                       (("leaf", "/#/io.l5d.fs/api", "/"), [8888]), "Neg"]
    return out


SCENARIOS = {"fs_follows_file": fs_follows_file,
             "configmap_follows_updates": configmap_follows_updates}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_interpreter_alike(name, tmp_path):
    outs = [run(SCENARIOS[name](pkg, tmp_path)) for pkg in ("ref", "port")]
    assert outs[1] == outs[0]


@pytest.mark.parametrize("raw", [
    {"kind": "io.l5d.fs"},
    {"kind": "io.l5d.fs", "dtabFile": "d", "pollIntervalSecs": 0.05},
    {"kind": "io.l5d.k8s.configMap"},
    {"kind": "io.l5d.k8s.configMap", "name": "m", "filename": "f",
     "namespace": "ns", "host": "127.0.0.1", "port": 1},
], ids=lambda raw: json.dumps(raw, sort_keys=True))
def test_interpreter_config_alike(raw):
    """The same mapping builds equal configs in both packages, and the
    same error where a key the kind needs is missing."""
    outs = []
    for pkg in ("ref", "port"):
        mod(pkg, "interpreter.configs")
        config = mod(pkg, "config")
        try:
            cfg = config.instantiate("interpreter", raw, "x")
            interp = cfg.mk([])
        except config.ConfigError as e:
            outs.append(("error", str(e)))
            continue
        outs.append((type(cfg).__name__, vars(cfg).copy(),
                     type(interp).__name__))
        for closer in ("_file_dtab", "_configmap"):
            if hasattr(interp, closer):
                getattr(interp, closer).close()
    assert outs[1] == outs[0]
