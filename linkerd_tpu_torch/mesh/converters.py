"""Proto <-> core-type converters for the mesh API: a copy of
``linkerd_tpu/mesh/converters.py``.

Ref: mesh/core/src/main/scala/io/buoyant/linkerd/mesh/Converters.scala —
same role: Path/Dtab/NameTree/Addr to and from their proto forms.
"""

from __future__ import annotations

import ipaddress
from typing import Optional

from linkerd_tpu_torch.core import Dtab, Path
from linkerd_tpu_torch.core.addr import (
    ADDR_NEG, ADDR_PENDING, Addr, AddrFailed, Address, Bound, BoundName,
)
from linkerd_tpu_torch.core.dtab import WILDCARD, Dentry, Prefix
from linkerd_tpu_torch.core.nametree import (
    Alt, Empty, Fail, Leaf, NameTree, Neg, Union, Weighted,
)
from linkerd_tpu_torch.mesh import messages as m


# ---- Path ------------------------------------------------------------------

def path_to_proto(p: Path) -> m.MPath:
    return m.MPath(elems=[seg.encode("utf-8") for seg in p])


def path_from_proto(mp: Optional[m.MPath]) -> Path:
    if mp is None:
        return Path()
    return Path(e.decode("utf-8") for e in mp.elems)


# ---- NameTree[Path] --------------------------------------------------------

def pathtree_to_proto(t: NameTree) -> m.MPathNameTree:
    if isinstance(t, Leaf):
        return m.MPathNameTree(leaf=m.MPathLeaf(id=path_to_proto(t.value)))
    if isinstance(t, Alt):
        return m.MPathNameTree(alt=m.MPathAlt(
            trees=[pathtree_to_proto(s) for s in t.trees]))
    if isinstance(t, Union):
        return m.MPathNameTree(union=m.MPathUnion(trees=[
            m.MPathWeighted(weight=w.weight, tree=pathtree_to_proto(w.tree))
            for w in t.weighted]))
    if isinstance(t, Fail):
        return m.MPathNameTree(fail=m.MEmpty())
    if isinstance(t, Empty):
        return m.MPathNameTree(empty=m.MEmpty())
    return m.MPathNameTree(neg=m.MEmpty())


def pathtree_from_proto(mt: Optional[m.MPathNameTree]) -> NameTree:
    from linkerd_tpu_torch.core.nametree import EMPTY, FAIL, NEG
    if mt is None:
        return NEG
    if mt.leaf is not None:
        return Leaf(path_from_proto(mt.leaf.id))
    if mt.alt is not None:
        return Alt(*(pathtree_from_proto(s) for s in mt.alt.trees))
    if mt.union is not None:
        return Union(*(Weighted(w.weight, pathtree_from_proto(w.tree))
                       for w in mt.union.trees))
    if mt.fail is not None:
        return FAIL
    if mt.empty is not None:
        return EMPTY
    return NEG


# ---- Dtab ------------------------------------------------------------------

def dtab_to_proto(dtab: Dtab) -> m.MDtab:
    dentries = []
    for d in dtab:
        elems = []
        for seg in d.prefix.segments:
            if seg == WILDCARD:
                elems.append(m.MPrefixElem(wildcard=m.MEmpty()))
            else:
                elems.append(m.MPrefixElem(label=seg.encode("utf-8")))
        dentries.append(m.MDentry(
            prefix=m.MPrefix(elems=elems),
            dst=pathtree_to_proto(d.dst)))
    return m.MDtab(dentries=dentries)


def dtab_from_proto(md: Optional[m.MDtab]) -> Dtab:
    if md is None:
        return Dtab.empty()
    dentries = []
    for d in md.dentries:
        segs = []
        for e in (d.prefix.elems if d.prefix is not None else []):
            if e.wildcard is not None:
                segs.append(WILDCARD)
            else:
                segs.append(e.label.decode("utf-8"))
        dentries.append(Dentry(Prefix(tuple(segs)),
                               pathtree_from_proto(d.dst)))
    return Dtab(dentries)


# ---- NameTree[BoundName] ---------------------------------------------------

def boundtree_to_proto(t: NameTree) -> m.MBoundNameTree:
    if isinstance(t, Leaf):
        bn: BoundName = t.value
        return m.MBoundNameTree(leaf=m.MBoundLeaf(
            id=path_to_proto(bn.id_), residual=path_to_proto(bn.residual)))
    if isinstance(t, Alt):
        return m.MBoundNameTree(alt=m.MBoundAlt(
            trees=[boundtree_to_proto(s) for s in t.trees]))
    if isinstance(t, Union):
        return m.MBoundNameTree(union=m.MBoundUnion(trees=[
            m.MBoundWeighted(weight=w.weight, tree=boundtree_to_proto(w.tree))
            for w in t.weighted]))
    if isinstance(t, Fail):
        return m.MBoundNameTree(fail=m.MEmpty())
    if isinstance(t, Empty):
        return m.MBoundNameTree(empty=m.MEmpty())
    return m.MBoundNameTree(neg=m.MEmpty())


def boundtree_from_proto(mt: Optional[m.MBoundNameTree],
                         mk_leaf) -> NameTree:
    """mk_leaf(id_path, residual_path) -> BoundName (caller supplies the
    live Var[Addr], typically backed by a Resolver stream)."""
    from linkerd_tpu_torch.core.nametree import EMPTY, FAIL, NEG
    if mt is None:
        return NEG
    if mt.leaf is not None:
        return Leaf(mk_leaf(path_from_proto(mt.leaf.id),
                            path_from_proto(mt.leaf.residual)))
    if mt.alt is not None:
        return Alt(*(boundtree_from_proto(s, mk_leaf) for s in mt.alt.trees))
    if mt.union is not None:
        return Union(*(Weighted(w.weight,
                                boundtree_from_proto(w.tree, mk_leaf))
                       for w in mt.union.trees))
    if mt.fail is not None:
        return FAIL
    if mt.empty is not None:
        return EMPTY
    return NEG


# ---- Addr <-> Replicas -----------------------------------------------------

def addr_to_replicas(addr: Addr) -> m.MReplicas:
    if isinstance(addr, Bound):
        eps = []
        for a in addr.addresses:
            try:
                ip = ipaddress.ip_address(a.host)
                af = (m.AddressFamily.INET6 if ip.version == 6
                      else m.AddressFamily.INET4)
                raw = ip.packed
            except ValueError:
                # unresolved hostname: ship utf-8 bytes under INET4 af
                # (the reference resolves before shipping; we defer)
                af = m.AddressFamily.INET4
                raw = a.host.encode("utf-8")
            meta = None
            node = dict(a.meta).get("nodeName")
            if node:
                meta = m.MEndpointMeta(nodeName=str(node))
            eps.append(m.MEndpoint(inet_af=af, address=raw, port=a.port,
                                   meta=meta))
        return m.MReplicas(bound=m.MReplicasBound(endpoints=eps))
    if isinstance(addr, AddrFailed):
        return m.MReplicas(failed=m.MReplicasFailed(message=addr.why))
    if addr is ADDR_NEG or type(addr).__name__ == "AddrNeg":
        return m.MReplicas(neg=m.MEmpty())
    return m.MReplicas(pending=m.MEmpty())


def addr_from_replicas(rep: m.MReplicas) -> Addr:
    if rep.bound is not None:
        addrs = []
        for ep in rep.bound.endpoints:
            try:
                host = str(ipaddress.ip_address(ep.address))
            except ValueError:
                host = ep.address.decode("utf-8", "replace")
            meta = {}
            if ep.meta is not None and ep.meta.nodeName:
                meta["nodeName"] = ep.meta.nodeName
            addrs.append(Address.mk(host, ep.port, **meta))
        return Bound(frozenset(addrs))
    if rep.failed is not None:
        return AddrFailed(rep.failed.message)
    if rep.neg is not None:
        return ADDR_NEG
    return ADDR_PENDING
