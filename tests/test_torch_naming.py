"""The port's naming core against the JAX package's on the same inputs:
Dtabs and name trees from a seeded generator (weighted unions,
alternation, ``~``, ``$``, ``!``, ``/$/inet``) read, shown, simplified,
evaluated and looked up alike; ``ConfiguredDtabNamer`` over an
``io.l5d.fs`` directory binds equal trees; and after the directory's
files are rewritten, the bound activities go through equal state
sequences."""

import numpy as np
import pytest

from linkerd_tpu.core import activity as ref_activity
from linkerd_tpu.core import addr as ref_addr
from linkerd_tpu.core import dtab as ref_dtab
from linkerd_tpu.core import nametree as ref_nametree
from linkerd_tpu.core.path import Path as RefPath
from linkerd_tpu.namer import ConfiguredDtabNamer as RefInterpreter
from linkerd_tpu.namer.fs import FsNamer as RefFsNamer
from linkerd_tpu_torch.core import activity as port_activity
from linkerd_tpu_torch.core import addr as port_addr
from linkerd_tpu_torch.core import dtab as port_dtab
from linkerd_tpu_torch.core import nametree as port_nametree
from linkerd_tpu_torch.core.path import Path as PortPath
from linkerd_tpu_torch.namer import ConfiguredDtabNamer as PortInterpreter
from linkerd_tpu_torch.namer.fs import FsNamer as PortFsNamer

PACKAGES = {
    "ref": (ref_nametree, ref_dtab, ref_addr, ref_activity, RefPath,
            RefInterpreter, RefFsNamer),
    "port": (port_nametree, port_dtab, port_addr, port_activity, PortPath,
             PortInterpreter, PortFsNamer),
}
SEGMENTS = ("svc", "web", "api", "users", "a", "b", "io.l5d.fs", "#", "$",
            "inet", "127.0.0.1", "8080", "x")
SERVICES = ("web", "api", "users", "empty", "gone", "bad")


class Gen:
    """Seeded text of paths, name trees and dtabs in the reference's
    grammar."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def pick(self, seq):
        return seq[int(self.rng.integers(len(seq)))]

    def path(self, wildcard: bool = False) -> str:
        n = int(self.rng.integers(1, 4))
        segs = [("*" if wildcard and self.rng.random() < 0.2
                 else self.pick(SEGMENTS)) for _ in range(n)]
        return "/" + "/".join(segs)

    def target(self) -> str:
        r = self.rng.random()
        if r < 0.15:
            return f"/$/inet/127.0.0.1/{int(self.rng.integers(1, 65535))}"
        if r < 0.45:
            return f"/#/io.l5d.fs/{self.pick(SERVICES)}"
        return self.path()

    def simple(self, depth: int) -> str:
        r = self.rng.random()
        if r < 0.08:
            return "~"
        if r < 0.14:
            return "$"
        if r < 0.18:
            return "!"
        if r < 0.3 and depth < 3:
            return "(" + self.tree(depth + 1) + ")"
        return self.target()

    def weighted(self, depth: int) -> str:
        t = self.simple(depth)
        if self.rng.random() < 0.4:
            w = self.pick((0.5, 1, 2, 0.25, 3.0, 0.125))
            return f"{w} * {t}"
        return t

    def union(self, depth: int) -> str:
        return " & ".join(self.weighted(depth)
                          for _ in range(int(self.rng.integers(1, 4))))

    def tree(self, depth: int = 0) -> str:
        return " | ".join(self.union(depth)
                          for _ in range(int(self.rng.integers(1, 4))))

    def dtab(self) -> str:
        n = int(self.rng.integers(1, 6))
        return ";\n".join(f"{self.path(wildcard=True)} => {self.tree()}"
                          for _ in range(n)) + ";"


def evaluated(tree):
    got = tree.eval()
    return None if got is None else sorted(
        p.show if hasattr(p, "show") else repr(p) for p in got)


def tree_views(pkg, text: str):
    nametree, path_cls = PACKAGES[pkg][0], PACKAGES[pkg][4]
    try:
        t = nametree.parse(text)
    except Exception as e:  # noqa: BLE001 — same error class both sides
        return ("error", type(e).__name__, str(e))
    return (t.show, t.simplified.show, evaluated(t),
            evaluated(t.simplified))


@pytest.mark.parametrize("seed", range(8))
def test_name_trees_read_show_simplify_eval_alike(seed):
    gen = Gen(seed)
    texts = [gen.tree() for _ in range(120)]
    texts += ["~", "$", "!", "/a | ~", "0.5 * /a & 0.5 * /b", "(/a | /b",
              "/a & | /b", "", "/a/b & (!| $)"]
    for text in texts:
        assert tree_views("port", text) == tree_views("ref", text), text


def dtab_views(pkg, text: str, paths):
    dtab, path_cls = PACKAGES[pkg][1], PACKAGES[pkg][4]
    try:
        d = dtab.Dtab.read(text)
    except Exception as e:  # noqa: BLE001
        return ("error", type(e).__name__, str(e))
    looked = []
    for p in paths:
        t = d.lookup(path_cls.read(p))
        looked.append((t.show, t.simplified.show))
    return d.show, len(d), looked


@pytest.mark.parametrize("seed", range(8))
def test_dtabs_read_show_and_lookup_alike(seed):
    gen = Gen(100 + seed)
    paths = [gen.path() for _ in range(30)] + ["/svc/web", "/svc/web/x"]
    for _ in range(40):
        text = gen.dtab()
        assert dtab_views("port", text, paths) == \
            dtab_views("ref", text, paths), text
    for text in ("/svc => /a ;; /svc => /b", "# a comment\n/svc => /a",
                 "/svc =>", "/svc => /a | ", "=> /a"):
        assert dtab_views("port", text, paths) == \
            dtab_views("ref", text, paths), text


def rendered(pkg, tree) -> str:
    """A bound tree as text: each leaf's id, residual and address state."""
    nametree, addr = PACKAGES[pkg][0], PACKAGES[pkg][2]

    def leaf(v):
        if isinstance(v, addr.BoundName):
            a = v.addr.sample()
            if isinstance(a, addr.Bound):
                state = ",".join(sorted(
                    f"{x.host}:{x.port}@{x.weight}" for x in a.addresses))
            else:
                state = type(a).__name__
            return f"[{v.id_.show} {v.residual.show} {state}]"
        return repr(v)

    return tree.map(leaf).show


def state_view(pkg, state) -> str:
    act = PACKAGES[pkg][3]
    if isinstance(state, act.Ok):
        return "Ok " + rendered(pkg, state.value)
    if isinstance(state, act.Failed):
        return f"Failed {type(state.exc).__name__}: {state.exc}"
    return type(state).__name__


FILES = {
    "web": "127.0.0.1 8001\n127.0.0.1 8002 2.0\n",
    "api": "10.0.0.1 9000\n",
    "users": "127.0.0.1 7001\n",
    "empty": "",
    "bad": "127.0.0.1 notaport\n",
}
REWRITES = [
    {"web": "127.0.0.1 8003\n", "api": None},
    {"gone": "10.1.1.1 80\n", "empty": "127.0.0.1 1\n", "bad": ""},
    {"web": None, "users": "127.0.0.1 7001\n127.0.0.1 7002\n"},
]


def write(root, files) -> None:
    for name, text in files.items():
        p = root / name
        if text is None:
            p.unlink(missing_ok=True)
        else:
            p.write_text(text)


def bind_sequences(pkg, root, dtab_text: str, paths, rewrites):
    """Each path's bound-tree state now and after each rewrite of the
    directory (refreshed by hand, as the namer's poll would)."""
    _, dtab, _, _, path_cls, interp_cls, fs_cls = PACKAGES[pkg]
    namer = fs_cls(str(root))
    interp = interp_cls([(path_cls.read("/io.l5d.fs"), namer)])
    acts = [interp.bind(dtab.Dtab.read(dtab_text), path_cls.read(p))
            for p in paths]
    seqs = [[] for _ in paths]
    watches = [a.states.observe(lambda st, s=s: s.append(state_view(pkg, st)))
               for a, s in zip(acts, seqs)]
    try:
        for files in rewrites:
            write(root, files)
            namer.refresh()
    finally:
        for w in watches:
            w.close()
        namer.close()
    return seqs


@pytest.mark.parametrize("seed", range(4))
def test_fs_bound_trees_and_rewrites_alike(seed, tmp_path):
    gen = Gen(200 + seed)
    dtab_text = (
        "/svc => /#/io.l5d.fs ;"
        "/svc/mix => 0.5 * /#/io.l5d.fs/web & 0.5 * /#/io.l5d.fs/api ;"
        "/svc/alt => /#/io.l5d.fs/empty | /#/io.l5d.fs/users ;"
        "/svc/direct => /$/inet/127.0.0.1/4140 ;"
        "/svc/none => ~ ;"
        f"/svc/gen => {gen.tree()} ;")
    names = ["/svc/" + s for s in SERVICES] + [
        "/svc/mix", "/svc/alt", "/svc/direct", "/svc/none", "/svc/gen",
        "/svc/web/extra/residual", "/other"]
    got = {}
    for pkg in PACKAGES:
        root = tmp_path / pkg
        root.mkdir()
        write(root, FILES)
        got[pkg] = bind_sequences(pkg, root, dtab_text, names, REWRITES)
    for name, a, b in zip(names, got["port"], got["ref"]):
        assert a == b, name
    assert any(len(s) > 1 for s in got["port"])  # the rewrites re-bound
