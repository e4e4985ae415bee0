"""Dtab analysis by symbolic delegation over the REAL resolution
machinery.

l5dcheck never reimplements dtab semantics: it builds a
``ConfiguredDtabNamer`` whose configured namers are replaced by
``ProbeNamer`` stand-ins (every residual binds — live discovery state is
out of scope for a static check) and runs the repo's ``Delegator`` over
probe paths. Whatever the delegator reports — Alt precedence, wildcard
prefixes, utility namers, the MAX_DEPTH recursion bound — is exactly
what the data plane would do, so the analysis can't drift from the
interpreter.

Rules:

- ``dtab-syntax``      the dtab (or a dst tree) doesn't parse
- ``dtab-cycle``       delegation revisits a path / exceeds MAX_DEPTH
- ``dtab-unbound``     a dst under /#/ (or /$/) matches no configured namer
- ``dtab-neg-only``    a dentry whose destination can only resolve to Neg
- ``dtab-shadowed``    a dentry fully covered by a later, non-Neg dentry
- ``dtab-dead-branch`` weight-zero union branches; Alt branches after !

A copy of ``tools/analysis/semantic/dtab_check.py`` on the port's own
parsers and registry.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

from linkerd_tpu_torch.core import Activity, Dtab, Path, Var
from linkerd_tpu_torch.core.addr import Address, Bound, BoundName
from linkerd_tpu_torch.core.dtab import Dentry, Prefix, WILDCARD
from linkerd_tpu_torch.core.nametree import (
    Alt, Fail, Leaf, NameTree, Neg, Union,
)
from linkerd_tpu_torch.namer.core import _UTILITY, ConfiguredDtabNamer, Namer
from linkerd_tpu_torch.namer.delegate import (
    DAlt, DDelegate, DelegateTree, DException, DFail, DNeg, DTooDeep,
    DUnion, Delegator,
)
from linkerd_tpu_torch.check.core import Finding
from linkerd_tpu_torch.check.loader import ConfigSource

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


def _namer_reachable(rest: Path, namer_prefixes: Sequence[Path]) -> bool:
    """Can ``/#/<rest>`` (+ any residual) reach a configured namer?
    Segment-wise agreement over the common length: the residual appended
    at delegation time extends ``rest``, so a shorter ``rest`` that
    agrees so far may still match once extended."""
    for prefix in namer_prefixes:
        n = min(len(rest), len(prefix))
        if tuple(rest[:n]) == tuple(prefix[:n]):
            return True
    return False


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

    def can_go_neg(self, dentry: Dentry) -> bool:
        return any(isinstance(t, (DNeg, DException))
                   for t in self.dentry_outcomes(dentry))

    # -- rules -------------------------------------------------------------
    def run(self) -> Iterator[Finding]:
        yield from self.check_unbound()
        yield from self.check_cycles_and_neg_only()
        yield from self.check_shadowed()
        yield from self.check_dead_branches()

    def check_unbound(self) -> Iterator[Finding]:
        self._unbound_dentries = set()
        for idx, dentry in enumerate(self.dtab):
            for leaf in dst_leaf_paths(dentry.dst):
                if len(leaf) > 0 and leaf[0] == "#":
                    if not _namer_reachable(leaf.drop(1),
                                            self.namer_prefixes):
                        self._unbound_dentries.add(idx)
                        known = sorted(p.show for p in self.namer_prefixes)
                        yield self.source.finding(
                            "dtab-unbound",
                            f"{self.where}: dentry '{dentry.show}' sends "
                            f"traffic to {leaf.show} but no configured "
                            f"namer covers it (configured prefixes: "
                            f"{known or ['<none>']}); this branch always "
                            f"resolves Neg",
                            line=self._anchors[idx])
                elif len(leaf) > 1 and leaf[0] == "$":
                    if leaf[1] not in _UTILITY:
                        self._unbound_dentries.add(idx)
                        yield self.source.finding(
                            "dtab-unbound",
                            f"{self.where}: dentry '{dentry.show}' uses "
                            f"unknown utility namer /$/{leaf[1]} (known: "
                            f"{sorted(_UTILITY)}); this branch always "
                            f"resolves Neg",
                            line=self._anchors[idx])

    def check_cycles_and_neg_only(self) -> Iterator[Finding]:
        for idx, dentry in enumerate(self.dtab):
            outs = self.dentry_outcomes(dentry)
            line = self._anchors[idx]
            cycles = [t for t in outs if isinstance(t, DTooDeep)]
            if cycles:
                at = cycles[0].path.show
                if len(at) > 64:
                    at = at[:64] + "…"
                yield self.source.finding(
                    "dtab-cycle",
                    f"{self.where}: dentry '{dentry.show}' delegates into "
                    f"a cycle — resolution would abort at the interpreter's "
                    f"MAX_DEPTH recursion bound (path at the limit: {at})",
                    line=line)
                continue  # depth-bounded walk; neg-only would be noise
            if idx in self._unbound_dentries:
                continue  # already attributed to the missing namer
            if outs and all(isinstance(t, DNeg) for t in outs):
                yield self.source.finding(
                    "dtab-neg-only",
                    f"{self.where}: dentry '{dentry.show}' can only "
                    f"resolve to Neg — no later rewrite, configured "
                    f"namer, or utility matches its destination; every "
                    f"path it claims is effectively unrouteable",
                    line=line)

    def check_shadowed(self) -> Iterator[Finding]:
        dentries = list(self.dtab)
        for i, earlier in enumerate(dentries):
            for later in dentries[i + 1:]:
                if not prefix_subsumes(later.prefix, earlier.prefix):
                    continue
                if self.can_go_neg(later):
                    continue  # later may fall through; earlier still live
                yield self.source.finding(
                    "dtab-shadowed",
                    f"{self.where}: dentry '{earlier.show}' is shadowed "
                    f"by the later dentry '{later.show}' — later entries "
                    f"take precedence and that one never falls through "
                    f"to Neg, so this rule can never route traffic",
                    line=self._anchors[i])
                break  # one shadow report per dentry

    def check_dead_branches(self) -> Iterator[Finding]:
        for idx, dentry in enumerate(self.dtab):
            yield from self._dead_in_tree(dentry, dentry.dst,
                                          self._anchors[idx])

    def _dead_in_tree(self, dentry: Dentry, tree: NameTree,
                      line: int) -> Iterator[Finding]:
        if isinstance(tree, Union):
            for w in tree.weighted:
                if w.weight == 0.0:
                    yield self.source.finding(
                        "dtab-dead-branch",
                        f"{self.where}: dentry '{dentry.show}' carries a "
                        f"weight-zero union branch "
                        f"'0.0 * {w.tree.show}' — it can never receive "
                        f"traffic; delete it or give it weight",
                        line=line)
                yield from self._dead_in_tree(dentry, w.tree, line)
        elif isinstance(tree, Alt):
            for k, sub in enumerate(tree.trees):
                if isinstance(sub, Fail) and k + 1 < len(tree.trees):
                    dead = " | ".join(t.show for t in tree.trees[k + 1:])
                    yield self.source.finding(
                        "dtab-dead-branch",
                        f"{self.where}: dentry '{dentry.show}' has "
                        f"alternatives after '!' — Fail short-circuits "
                        f"an Alt, so '{dead}' is unreachable",
                        line=line)
                    break
                yield from self._dead_in_tree(dentry, sub, line)


def parse_dtab(source: ConfigSource, text: str, where: str
               ) -> Tuple[Optional[Dtab], List[Finding]]:
    try:
        return Dtab.read(text), []
    except ValueError as e:
        return None, [source.finding(
            "dtab-syntax", f"{where}: dtab does not parse: {e}",
            needles=("dtab",))]


def check_dtab(source: ConfigSource, dtab_text: str,
               namer_prefixes: Sequence[Path], where: str
               ) -> List[Finding]:
    dtab, findings = parse_dtab(source, dtab_text, where)
    if dtab is None:
        return findings
    findings.extend(DtabAnalysis(source, dtab, namer_prefixes, where).run())
    return findings


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


def _claims_under(prefix: Prefix, dst: Path) -> bool:
    """Can ``prefix`` match some path under ``dst``? Segment-wise
    agreement over the common length ('*' covers anything): a dentry
    '/svc/web' claims paths under dstPrefix '/svc' even with no
    catch-all '/svc' rule."""
    n = min(len(prefix), len(dst))
    return all(p == WILDCARD or p == d
               for p, d in zip(prefix.segments[:n], tuple(dst)[:n]))


def dst_prefix_covered(source: ConfigSource, dtab: Dtab,
                       namer_prefixes: Sequence[Path],
                       dst_prefix: str, where: str) -> List[Finding]:
    """The router's identifier emits ``<dstPrefix>/<name>``; if NO
    dentry even claims a path under that prefix (and a generic probe
    resolves Neg), every identified request 4xx/5xxs at binding — the
    config steers all traffic into a wall. A dtab that routes only
    specific subpaths (``/svc/web => ...`` with no ``/svc`` catch-all)
    is legitimate and must not be flagged."""
    try:
        prefix = Path.read(dst_prefix)
    except ValueError as e:
        return [source.finding(
            "config-parse", f"{where}: bad dstPrefix {dst_prefix!r}: {e}",
            needles=("dstPrefix",))]
    if any(_claims_under(d.prefix, prefix) for d in dtab):
        return []
    analysis = DtabAnalysis(source, dtab, namer_prefixes, where)
    probe = prefix + Path.of(PROBE_SEG)
    outs = list(terminals(analysis.delegate(probe)))
    if all(isinstance(t, DNeg) for t in outs):
        line = (source.line_of("dstPrefix", dst_prefix)
                or source.line_of("dtab")
                or source.line_of("routers"))
        return [source.finding(
            "router-dst-uncovered",
            f"{where}: no dentry covers identifier prefix {prefix.show} "
            f"— identified requests can never bind (probe "
            f"{probe.show} resolves Neg through the whole dtab)",
            line=line)]
    return []
