"""Override verification for the mesh reactor: the port's own copy of
what ``linkerd_tpu/control/reactor.py``'s ``verify_override`` reaches in
l5dcheck (``tools/analysis/semantic/dtab_check.py``).

l5dcheck lives in ``tools/``, which imports ``linkerd_tpu``, so the port
keeps the ``override-unsafe`` rule here: the probe namers and the
symbolic delegation they drive (``ProbeNamer``, ``probe_interpreter``,
``DtabAnalysis.dentry_outcomes``), the prefix algebra
(``prefix_subsumes``, ``probe_path_for``, ``terminals``,
``dst_leaf_paths``) and ``check_override`` itself, each definition as
in the original and its messages word for word. ``Finding`` and
``ConfigSource`` are minimal stand-ins for l5dcheck's: an override is
generated text with no suppressions, so each finding is unsuppressed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

from linkerd_tpu_torch.core import Activity, Dtab, Path, Var
from linkerd_tpu_torch.core.addr import Address, Bound, BoundName
from linkerd_tpu_torch.core.dtab import Dentry, Prefix, WILDCARD
from linkerd_tpu_torch.core.nametree import (
    Alt, Fail, Leaf, NameTree, Neg, Union,
)
from linkerd_tpu_torch.namer.core import ConfiguredDtabNamer, Namer
from linkerd_tpu_torch.namer.delegate import (
    DAlt, DDelegate, DelegateTree, DException, DFail, DNeg, DTooDeep,
    DUnion, Delegator,
)


@dataclass
class Finding:
    """One l5dcheck finding (the fields of ``tools.analysis.core.Finding``
    that the reactor reads: ``message`` and ``suppressed``)."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    severity: str = "error"
    suppressed: bool = False


class ConfigSource:
    """The generated override text under analysis: the parts of
    l5dcheck's ``ConfigSource`` that line attribution and ``finding``
    use."""

    def __init__(self, rel: str, text: str):
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()

    def line_of(self, *needles: str) -> int:
        """1-based line of the first line containing every needle; 0
        when nothing matches."""
        for i, line in enumerate(self.lines, start=1):
            if all(n in line for n in needles):
                return i
        return 0

    def finding(self, rule: str, message: str, *, line: int = 0,
                severity: str = "error") -> Finding:
        return Finding(rule, self.rel, line, 0, message, severity=severity)


# wildcard prefix segments are probed with a representative literal; any
# literal works because ProbeNamer binds everything and dentry matching
# treats a non-'*' segment uniformly
PROBE_SEG = "l5dcheck-probe"


class ProbeNamer(Namer):
    """Static stand-in for a configured namer: binds every residual.

    The analysis is about the dtab's own structure; assuming the namer
    binds is the conservative choice for shadowing (a later dentry that
    reaches a configured namer is treated as terminal)."""

    def __init__(self, prefix: Path):
        self._prefix = prefix

    def lookup(self, path: Path) -> Activity:
        bid = Path.of("#") + self._prefix + path
        addr = Var(Bound.of(Address.mk("0.0.0.0", 1)))
        return Activity.value(Leaf(BoundName(bid, addr, Path())))


def probe_interpreter(namer_prefixes: Sequence[Path],
                      dtab: Dtab) -> ConfiguredDtabNamer:
    return ConfiguredDtabNamer(
        [(p, ProbeNamer(p)) for p in namer_prefixes],
        dtab=Activity.value(dtab))


def probe_path_for(prefix: Prefix, extra: Tuple[str, ...] = (PROBE_SEG,)
                   ) -> Path:
    """A concrete path the prefix matches: wildcards instantiated, one
    residual segment appended (identifiers always produce a residual)."""
    segs = [PROBE_SEG if s == WILDCARD else s for s in prefix.segments]
    return Path.of(*segs, *extra)


def terminals(tree: DelegateTree) -> Iterator[DelegateTree]:
    """Leaf-position nodes of a DelegateTree explanation."""
    if isinstance(tree, DDelegate):
        if tree.child is not None:
            yield from terminals(tree.child)
        else:
            yield tree
    elif isinstance(tree, DAlt):
        for c in tree.children:
            yield from terminals(c)
    elif isinstance(tree, DUnion):
        for _w, c in tree.weighted:
            yield from terminals(c)
    else:
        yield tree


def prefix_subsumes(general: Prefix, specific: Prefix) -> bool:
    """True when ``general`` matches every path ``specific`` matches:
    it is no longer, and each of its segments covers the corresponding
    one ('*' covers anything; a literal only covers the same literal —
    a literal never covers the other prefix's '*')."""
    if len(general) > len(specific):
        return False
    for g, s in zip(general.segments, specific.segments):
        if g == WILDCARD:
            continue
        if s == WILDCARD or g != s:
            return False
    return True


def dst_leaf_paths(tree: NameTree) -> Iterator[Path]:
    if isinstance(tree, Leaf):
        if isinstance(tree.value, Path):
            yield tree.value
    elif isinstance(tree, Alt):
        for t in tree.trees:
            yield from dst_leaf_paths(t)
    elif isinstance(tree, Union):
        for w in tree.weighted:
            yield from dst_leaf_paths(w.tree)


def _dentry_anchor_map(source: ConfigSource, dtab: Dtab) -> dict:
    """dentry-index -> line. The k-th dentry with prefix P anchors to
    the k-th source line whose own dentry text has EXACTLY that prefix:
    substring matching would anchor '/svc' onto an earlier '/svc/web'
    line, and prefix-only matching would collapse two '/svc => ...'
    dentries onto one line — either way a waiver trailing one dentry
    would silently cover another's findings."""
    lines_by_prefix: dict = {}
    for i, line in enumerate(source.lines, start=1):
        for chunk in line.split(";"):
            if "=>" in chunk:
                lhs = chunk.split("=>", 1)[0].strip()
                lines_by_prefix.setdefault(lhs, []).append(i)
    anchors: dict = {}
    seen: dict = {}
    for idx, dentry in enumerate(dtab):
        pfx = dentry.prefix.show
        k = seen.get(pfx, 0)
        seen[pfx] = k + 1
        cands = lines_by_prefix.get(pfx, [])
        anchors[idx] = cands[k] if k < len(cands) else (
            cands[-1] if cands else source.line_of(pfx, "=>"))
    return anchors


class DtabAnalysis:
    """All dtab rules over one (dtab, configured-namer-prefixes) pair.

    ``where`` labels the owning config section (e.g. ``routers[0].dtab``
    or a namerd storage namespace) in messages.
    """

    def __init__(self, source: ConfigSource, dtab: Dtab,
                 namer_prefixes: Sequence[Path], where: str):
        self.source = source
        self.dtab = dtab
        self.namer_prefixes = list(namer_prefixes)
        self.where = where
        self.interp = probe_interpreter(self.namer_prefixes, dtab)
        self.delegator = Delegator(self.interp)
        self._unbound_dentries: set = set()
        self._outcomes: dict = {}  # dentry -> terminals (memoized: the
        # shadow pass would otherwise re-delegate every pair, O(n^2))
        self._anchors = _dentry_anchor_map(source, dtab)

    # -- helpers -----------------------------------------------------------
    def delegate(self, path: Path) -> DelegateTree:
        return self.delegator.delegate(Dtab.empty(), path)

    def dentry_outcomes(self, dentry: Dentry) -> List[DelegateTree]:
        """Terminal nodes reachable through ``dentry`` alone: its dst
        tree applied to a probe path, every Path leaf delegated onward
        through the full dtab (the runtime's leaf-by-leaf grafting)."""
        cached = self._outcomes.get(dentry)
        if cached is not None:
            return cached
        probe = probe_path_for(dentry.prefix)
        residual = probe.drop(len(dentry.prefix))
        grafted = dentry.dst.map(lambda p, r=residual: p.concat(r))
        outs: List[DelegateTree] = []
        for leaf in dst_leaf_paths(grafted):
            outs.extend(terminals(self.delegate(leaf)))
        # non-Path leaves of the dst tree (~ / $ / !) terminate directly
        def literal_terms(t: NameTree) -> Iterator[DelegateTree]:
            if isinstance(t, Neg):
                yield DNeg(probe, dentry)
            elif isinstance(t, Fail):
                yield DFail(probe, dentry)
            elif isinstance(t, Alt):
                for s in t.trees:
                    yield from literal_terms(s)
            elif isinstance(t, Union):
                for w in t.weighted:
                    yield from literal_terms(w.tree)
        outs.extend(literal_terms(dentry.dst))
        self._outcomes[dentry] = outs
        return outs


def check_override(base: Dtab, override: Dtab,
                   namer_prefixes: Optional[Sequence[Path]],
                   where: str = "override") -> List[Finding]:
    """``override-unsafe``: verify a control-plane-GENERATED override
    dtab (the MeshReactor's traffic shift) before it is published.

    An override is a dentry appended to the live namespace dtab, so it
    takes precedence over everything before it. Unsafe shapes:

    - **cycle** — the override's destination delegates back into a loop
      (classic: failing over a cluster to itself, or to an alias that
      resolves through it); the fleet would bind nothing.
    - **unroutable** — the destination reaches no configured namer /
      resolves only to Neg; "shift away from sick" must never mean
      "shift into a wall".
    - **collateral shadowing** — the override's prefix is broader than
      an existing rule it would silently preempt (a wildcard, or a
      prefix strictly subsuming a more specific base dentry): the shift
      would hijack traffic the reactor was not told to move. Replacing
      a dentry with the SAME prefix is the override's whole point and
      is not flagged.

    Symbolic delegation over the REAL Delegator (the same machinery as
    every other dtab rule), so verification can't drift from what the
    fleet's interpreters would do.

    ``namer_prefixes=None`` means the caller does NOT know the fleet's
    namers (a linker bound to a remote namerd): /#/ destinations are
    then assumed bindable (a zero-length probe prefix matches every
    configured-namer path) and only the namer-independent rules —
    cycles, collateral shadowing — can fire."""
    unknown_namers = namer_prefixes is None
    prefixes = [Path()] if unknown_namers else list(namer_prefixes)
    combined = base + override
    text = "\n".join(f"{d.show} ;" for d in combined)
    source = ConfigSource("<override>", text)
    analysis = DtabAnalysis(source, combined, prefixes, where)
    findings: List[Finding] = []
    base_len = len(base)
    for k, dentry in enumerate(override):
        line = base_len + k + 1  # one dentry per line in `text`
        if WILDCARD in dentry.prefix.segments:
            findings.append(source.finding(
                "override-unsafe",
                f"{where}: override dentry '{dentry.show}' has a "
                f"wildcard prefix — it would claim traffic for every "
                f"matching service, not just the sick cluster",
                line=line))
        for b in base:
            if b.prefix != dentry.prefix and prefix_subsumes(
                    dentry.prefix, b.prefix):
                findings.append(source.finding(
                    "override-unsafe",
                    f"{where}: override dentry '{dentry.show}' shadows "
                    f"the more specific rule '{b.show}' — the shift "
                    f"would hijack traffic beyond its target cluster",
                    line=line))
                break
        outs = analysis.dentry_outcomes(dentry)
        if any(isinstance(t, DTooDeep) for t in outs):
            findings.append(source.finding(
                "override-unsafe",
                f"{where}: override dentry '{dentry.show}' delegates "
                f"into a cycle — resolution would abort at MAX_DEPTH "
                f"and the cluster would bind nothing",
                line=line))
        elif outs and all(isinstance(t, (DNeg, DException))
                          for t in outs):
            known = ("<unknown: remote namerd>" if unknown_namers
                     else (sorted(p.show for p in prefixes) or ["<none>"]))
            findings.append(source.finding(
                "override-unsafe",
                f"{where}: override dentry '{dentry.show}' is "
                f"unroutable — its destination reaches no configured "
                f"namer (prefixes: {known}) and resolves only to Neg",
                line=line))
    return findings
