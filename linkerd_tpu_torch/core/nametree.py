"""NameTree — the algebra of name resolution results: a copy of
``linkerd_tpu/core/nametree.py``.

Reference parity: ``com.twitter.finagle.NameTree`` (used pervasively:
router/core/.../Dst.scala:75 ``Dst.BoundTree``, namer/core delegation).

A NameTree[T] is one of:

- ``Leaf(value)``            — a concrete destination
- ``Alt(trees...)``          — ordered failover: first usable subtree wins
- ``Union(Weighted(w, t)..)``— weighted traffic split across usable subtrees
- ``Neg``                    — negative resolution (no binding)
- ``Empty``                  — bound, but to an empty replica set
- ``Fail``                   — resolution failed permanently

``simplified`` and ``eval`` implement the same collapse rules the reference
relies on for alt-fallback and weighted unions. The dtab text syntax
(``/a | /b``, ``0.7 * /a & 0.3 * /b``, ``~``, ``!``, ``$``) is parsed by
:func:`parse` for Leaf values of type Path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Generic, Optional, Tuple, TypeVar

from linkerd_tpu_torch.core.path import Path

T = TypeVar("T")
U = TypeVar("U")


class NameTree(Generic[T]):
    """Base class; nodes are immutable dataclasses below."""

    __slots__ = ()

    # -- combinators ------------------------------------------------------
    def map(self, fn: Callable[[T], U]) -> "NameTree[U]":
        if isinstance(self, Leaf):
            return Leaf(fn(self.value))
        if isinstance(self, Alt):
            return Alt(*[t.map(fn) for t in self.trees])
        if isinstance(self, Union):
            return Union(*[Weighted(w.weight, w.tree.map(fn)) for w in self.weighted])
        return self  # Neg / Empty / Fail

    def flat_map(self, fn: Callable[[T], "NameTree[U]"]) -> "NameTree[U]":
        if isinstance(self, Leaf):
            return fn(self.value)
        if isinstance(self, Alt):
            return Alt(*[t.flat_map(fn) for t in self.trees])
        if isinstance(self, Union):
            return Union(*[Weighted(w.weight, w.tree.flat_map(fn)) for w in self.weighted])
        return self

    @property
    def simplified(self) -> "NameTree[T]":
        """Collapse the tree per finagle's NameTree.simplify rules:
        Alt drops Neg branches and short-circuits at Fail; Union filters
        only Neg and Fail (Empty is kept — an empty replica set is a
        binding, not a non-binding) and collapses a single surviving
        branch regardless of weight."""
        if isinstance(self, Alt):
            out = []
            for t in self.trees:
                s = t.simplified
                if isinstance(s, Fail):
                    # Fail short-circuits everything after it in an Alt.
                    out.append(s)
                    break
                if isinstance(s, Neg):
                    continue  # skip negs; later branches may bind
                out.append(s)
            if not out:
                return NEG
            if len(out) == 1:
                return out[0]
            return Alt(*out)
        if isinstance(self, Union):
            ws = []
            for w in self.weighted:
                s = w.tree.simplified
                if isinstance(s, (Neg, Fail)):
                    continue
                ws.append(Weighted(w.weight, s))
            if not ws:
                return NEG
            if len(ws) == 1:
                return ws[0].tree
            return Union(*ws)
        return self

    def eval(self) -> Optional[frozenset]:
        """Evaluate to a set of leaf values (finagle ``NameTree.eval``).

        Neg and Fail evaluate to ``None`` (no binding); Empty to the empty
        frozenset (bound to zero replicas).
        """
        return _eval(self.simplified)

    @property
    def show(self) -> str:
        return _show(self)

    def __repr__(self) -> str:
        return f"NameTree({_show(self)})"


def _eval(s: "NameTree[T]") -> Optional[frozenset]:
    """Evaluate an already-simplified tree (avoids re-simplifying subtrees)."""
    if isinstance(s, Leaf):
        return frozenset([s.value])
    if isinstance(s, Empty):
        return frozenset()
    if isinstance(s, (Neg, Fail)):
        return None
    if isinstance(s, Alt):
        for t in s.trees:
            e = _eval(t)
            if e is not None:
                return e
        return None
    if isinstance(s, Union):
        acc: set = set()
        any_ok = False
        for w in s.weighted:
            e = _eval(w.tree)
            if e is not None:
                any_ok = True
                acc |= e
        return frozenset(acc) if any_ok else None
    raise AssertionError(f"unreachable: {s!r}")


@dataclass(frozen=True, repr=False)
class Leaf(NameTree[T]):
    value: T


@dataclass(frozen=True, repr=False, init=False)
class Alt(NameTree[T]):
    trees: Tuple[NameTree[T], ...]

    def __init__(self, *trees: NameTree[T]):
        object.__setattr__(self, "trees", tuple(trees))


@dataclass(frozen=True)
class Weighted(Generic[T]):
    weight: float
    tree: NameTree[T]


@dataclass(frozen=True, repr=False, init=False)
class Union(NameTree[T]):
    weighted: Tuple[Weighted[T], ...]

    def __init__(self, *weighted: Weighted[T]):
        object.__setattr__(self, "weighted", tuple(weighted))


@dataclass(frozen=True, repr=False)
class Neg(NameTree[T]):
    pass


@dataclass(frozen=True, repr=False)
class Empty(NameTree[T]):
    pass


@dataclass(frozen=True, repr=False)
class Fail(NameTree[T]):
    pass


NEG: NameTree = Neg()
EMPTY: NameTree = Empty()
FAIL: NameTree = Fail()


def _show(t: NameTree) -> str:
    if isinstance(t, Leaf):
        v = t.value
        return v.show if isinstance(v, Path) else repr(v)
    if isinstance(t, Alt):
        return "(" + " | ".join(_show(x) for x in t.trees) + ")"
    if isinstance(t, Union):
        return "(" + " & ".join(
            (f"{w.weight} * {_show(w.tree)}" if w.weight != 1.0 else _show(w.tree))
            for w in t.weighted
        ) + ")"
    if isinstance(t, Neg):
        return "~"
    if isinstance(t, Empty):
        return "$"
    if isinstance(t, Fail):
        return "!"
    raise AssertionError(t)


# -- dtab destination text syntax -------------------------------------------
#
# Grammar matches finagle NameTreeParsers precedence: Alt ('|') binds
# loosest, Union ('&') next, and a weight attaches to a single simple tree.
#
# tree     := union ('|' union)*
# union    := weighted ('&' weighted)*
# weighted := ['<float> *'] simple
# simple   := path | '~' | '$' | '!' | '(' tree ')'


class _P:
    def __init__(self, s: str):
        self.s = s
        self.i = 0

    def ws(self):
        while self.i < len(self.s) and self.s[self.i].isspace():
            self.i += 1

    def peek(self) -> str:
        self.ws()
        return self.s[self.i] if self.i < len(self.s) else ""

    def eat(self, ch: str):
        self.ws()
        if self.peek() != ch:
            raise ValueError(f"expected {ch!r} at {self.i} in {self.s!r}")
        self.i += 1

    def number(self) -> Optional[float]:
        self.ws()
        j = self.i
        while j < len(self.s) and (self.s[j].isdigit() or self.s[j] == "."):
            j += 1
        if j == self.i:
            return None
        # Only a weight if followed by '*'
        k = j
        while k < len(self.s) and self.s[k].isspace():
            k += 1
        if k < len(self.s) and self.s[k] == "*":
            val = float(self.s[self.i:j])
            self.i = k + 1
            return val
        return None

    def path(self) -> Path:
        self.ws()
        if self.peek() != "/":
            raise ValueError(f"expected path at {self.i} in {self.s!r}")
        j = self.i
        while j < len(self.s) and not self.s[j].isspace() and self.s[j] not in "|&()":
            j += 1
        p = Path.read(self.s[self.i:j])
        self.i = j
        return p

    def simple(self) -> NameTree[Path]:
        c = self.peek()
        if c == "~":
            self.i += 1
            return NEG
        if c == "$":
            self.i += 1
            return EMPTY
        if c == "!":
            self.i += 1
            return FAIL
        if c == "(":
            self.i += 1
            t = self.tree()
            self.eat(")")
            return t
        return Leaf(self.path())

    def weighted(self) -> Weighted[Path]:
        w = self.number()
        t = self.simple()
        return Weighted(1.0 if w is None else w, t)

    def union(self) -> NameTree[Path]:
        ws = [self.weighted()]
        while self.peek() == "&":
            self.i += 1
            ws.append(self.weighted())
        if len(ws) == 1 and ws[0].weight == 1.0:
            return ws[0].tree
        return Union(*ws)

    def tree(self) -> NameTree[Path]:
        trees = [self.union()]
        while self.peek() == "|":
            self.i += 1
            trees.append(self.union())
        return trees[0] if len(trees) == 1 else Alt(*trees)

    def parse(self) -> NameTree[Path]:
        t = self.tree()
        self.ws()
        if self.i != len(self.s):
            raise ValueError(f"trailing garbage at {self.i} in {self.s!r}")
        return t


def parse(s: str) -> NameTree[Path]:
    """Parse dtab destination syntax into a NameTree[Path]."""
    return _P(s).parse()
