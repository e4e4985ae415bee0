"""DelegateTree — explained, step-by-step delegation: a copy of
``linkerd_tpu/namer/delegate.py``.

Ref: namer/core/src/main/scala/io/buoyant/namer/DelegateTree.scala:149 —
the dtab playground / delegator UI needs not just the bound result but the
chain of rewrites that produced it: which dentry matched, what each
intermediate path was, where the lookup went Neg or bound. Node kinds
mirror the reference ADT (Exception/Empty/Fail/Neg/Delegate/Alt/Union/
Leaf/Transformation).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

from linkerd_tpu_torch.core import Activity, Dtab, Path
from linkerd_tpu_torch.core.addr import BoundName
from linkerd_tpu_torch.core.dtab import Dentry
from linkerd_tpu_torch.core.nametree import (
    Alt, Empty, Fail, Leaf, NameTree, Neg, Union, Weighted,
)
from linkerd_tpu_torch.namer.core import (
    CONFIGURED_PREFIX, MAX_DEPTH, UTILITY_PREFIX, ConfiguredDtabNamer,
    utility_lookup,
)


@dataclass(frozen=True)
class DelegateTree:
    """One delegation step; ``path`` is the name at this step, ``dentry``
    the dtab rule that led here (None at the root / namer steps)."""

    path: Path
    dentry: Optional[Dentry] = None


@dataclass(frozen=True)
class DNeg(DelegateTree):
    pass


@dataclass(frozen=True)
class DFail(DelegateTree):
    pass


@dataclass(frozen=True)
class DEmpty(DelegateTree):
    pass


@dataclass(frozen=True)
class DException(DelegateTree):
    message: str = ""


@dataclass(frozen=True)
class DTooDeep(DException):
    """Delegation exceeded MAX_DEPTH — a typed marker so consumers
    (l5dcheck's cycle detection) never couple to the message wording."""


@dataclass(frozen=True)
class DLeaf(DelegateTree):
    bound: Optional[BoundName] = None


@dataclass(frozen=True)
class DDelegate(DelegateTree):
    child: Optional["DelegateTree"] = None


@dataclass(frozen=True)
class DAlt(DelegateTree):
    children: Tuple["DelegateTree", ...] = ()


@dataclass(frozen=True)
class DUnion(DelegateTree):
    weighted: Tuple[Tuple[float, "DelegateTree"], ...] = ()


def delegate_json(tree: DelegateTree) -> Any:
    """JSON shape for the delegator UI (DelegateApiHandler.scala:331)."""
    base = {"path": tree.path.show}
    if tree.dentry is not None:
        base["dentry"] = {"prefix": tree.dentry.prefix.show,
                          "dst": tree.dentry.dst.show}
    if isinstance(tree, DLeaf):
        base["type"] = "leaf"
        if tree.bound is not None:
            base["bound"] = {"id": tree.bound.id_.show,
                             "residual": tree.bound.residual.show}
        return base
    if isinstance(tree, DDelegate):
        base["type"] = "delegate"
        base["delegate"] = (delegate_json(tree.child)
                            if tree.child is not None else None)
        return base
    if isinstance(tree, DAlt):
        base["type"] = "alt"
        base["alt"] = [delegate_json(c) for c in tree.children]
        return base
    if isinstance(tree, DUnion):
        base["type"] = "union"
        base["union"] = [{"weight": w, "tree": delegate_json(t)}
                         for w, t in tree.weighted]
        return base
    if isinstance(tree, DException):
        base["type"] = "exception"
        base["message"] = tree.message
        return base
    base["type"] = type(tree).__name__[1:].lower()  # neg / fail / empty
    return base


class Delegator:
    """Synchronous delegation explainer over a ConfiguredDtabNamer.

    Uses the current state of each namer's lookup (pending namer lookups
    surface as exception nodes rather than blocking, since the UI wants an
    immediate explanation; ref DelegateApiHandler behavior).
    """

    def __init__(self, interpreter: ConfiguredDtabNamer):
        self._interp = interpreter

    def delegate(self, local_dtab: Dtab, path: Path) -> DelegateTree:
        from linkerd_tpu_torch.core.activity import Failed, Ok, Pending
        base_state = self._interp.dtab_activity.current
        base = base_state.value if isinstance(base_state, Ok) else Dtab.empty()
        return self._step(base + local_dtab, path, None, 0)

    # -- internals --------------------------------------------------------
    def _step(self, dtab: Dtab, path: Path, dentry: Optional[Dentry],
              depth: int) -> DelegateTree:
        if depth > MAX_DEPTH:
            return DTooDeep(path, dentry,
                            message=f"delegation deeper than {MAX_DEPTH}")
        if len(path) > 0 and path[0] == UTILITY_PREFIX:
            tree = utility_lookup(path)
            return self._graft(dtab, path, dentry, tree, depth)
        if len(path) > 0 and path[0] == CONFIGURED_PREFIX:
            return self._configured(dtab, path, dentry, depth)
        # dtab rewrite step: later dentries first (finagle precedence)
        matches: List[Tuple[Dentry, NameTree]] = []
        for d in reversed(dtab):
            if d.prefix.matches(path):
                residual = path.drop(len(d.prefix))
                matches.append(
                    (d, d.dst.map(lambda p, r=residual: p.concat(r))))
        if not matches:
            return DNeg(path, dentry)
        children = [self._graft(dtab, path, d, t, depth)
                    for d, t in matches]
        if len(children) == 1:
            return children[0]
        return DAlt(path, dentry, children=tuple(children))

    def _graft(self, dtab: Dtab, path: Path, dentry: Optional[Dentry],
               tree: NameTree, depth: int) -> DelegateTree:
        """Explain a NameTree[Path] produced at ``path`` by ``dentry``."""
        if isinstance(tree, Leaf):
            nxt = tree.value
            if isinstance(nxt, BoundName):
                return DLeaf(path, dentry, bound=nxt)
            return DDelegate(path, dentry,
                             child=self._step(dtab, nxt, None, depth + 1))
        if isinstance(tree, Alt):
            # nested branches keep the originating dentry: every step of
            # an Alt/Union produced by one rule must attribute to it
            # (the delegator UI and l5dcheck walk terminals by dentry)
            return DAlt(path, dentry, children=tuple(
                self._graft(dtab, path, dentry, t, depth)
                for t in tree.trees))
        if isinstance(tree, Union):
            return DUnion(path, dentry, weighted=tuple(
                (w.weight, self._graft(dtab, path, dentry, w.tree, depth))
                for w in tree.weighted))
        if isinstance(tree, Fail):
            return DFail(path, dentry)
        if isinstance(tree, Empty):
            return DEmpty(path, dentry)
        return DNeg(path, dentry)

    def _configured(self, dtab: Dtab, path: Path,
                    dentry: Optional[Dentry], depth: int) -> DelegateTree:
        from linkerd_tpu_torch.core.activity import Failed, Ok, Pending
        rest = path.drop(1)
        for prefix, namer in self._interp.namers:
            if rest.starts_with(prefix):
                act = namer.lookup(rest.drop(len(prefix)))
                st = act.current
                if isinstance(st, Ok):
                    return self._graft(dtab, path, dentry, st.value, depth)
                if isinstance(st, Failed):
                    return DException(path, dentry, message=str(st.exc))
                return DException(path, dentry, message="lookup pending")
        return DNeg(path, dentry)
