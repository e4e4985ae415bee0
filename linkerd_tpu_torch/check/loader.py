"""Config sources for l5dcheck: text, parsed data, YAML suppressions.

A ``ConfigSource`` is one linker or namerd YAML document. Suppressions
ride in YAML comments with the exact l5dlint syntax (and the same
justification requirement)::

    dtab: |
      /svc => /#/io.l5d.fs ;  # l5d: ignore[dtab-unbound] — bound in prod

Line attribution: semantic findings anchor to the first line whose text
contains the offending fragment (a dentry, a ``kind:``, a port), so a
suppression on that line — or the comment line above it — applies,
matching ``SourceFile.suppression_for``.

A copy of ``tools/analysis/semantic/loader.py`` on the port's own
parsers and registry.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from linkerd_tpu_torch.check.core import (
    _SUPPRESS_RE, Finding, Suppression, suppression_at,
)


class ConfigSource:
    """One YAML/JSON config document under analysis."""

    def __init__(self, rel: str, text: str, base_dir: Optional[str] = None):
        self.rel = rel
        self.text = text
        # cert paths etc. resolve relative to the config file's directory
        self.base_dir = base_dir or "."
        self.lines = text.splitlines()
        self.suppressions: Dict[int, Suppression] = {}
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if m:
                rules = tuple(r.strip() for r in m.group(1).split(",")
                              if r.strip())
                self.suppressions[i] = Suppression(
                    i, rules, (m.group(2) or "").strip())

    @staticmethod
    def from_file(path: str, repo_root: Optional[str] = None
                  ) -> "ConfigSource":
        with open(path, "r", encoding="utf-8") as fh:
            text = fh.read()
        rel = (os.path.relpath(path, repo_root)
               if repo_root else path)
        return ConfigSource(rel, text, base_dir=os.path.dirname(
            os.path.abspath(path)))

    def suppression_for(self, rule: str, line: int) -> Optional[Suppression]:
        """Same placement rules as python sources (one shared
        definition: ``core.suppression_at``)."""
        return suppression_at(self.suppressions, self.lines, rule, line)

    # -- line attribution --------------------------------------------------
    def line_of(self, *needles: str, after: int = 0, before: int = 0) -> int:
        """1-based line of the first line in ``(after, before)`` (0 =
        unbounded) containing every needle; 0 when nothing matches (the
        finding still reports, it just can't be line-suppressed — better
        than a wrong anchor)."""
        for i, line in enumerate(self.lines, start=1):
            if i <= after:
                continue
            if before and i >= before:
                break
            if all(n in line for n in needles):
                return i
        return 0

    def finding(self, rule: str, message: str, *,
                line: int = 0, needles: tuple = (),
                severity: str = "error") -> Finding:
        if not line and needles:
            line = self.line_of(*needles)
        return Finding(rule, self.rel, line, 0, message, severity=severity)


def resolve_path(source: ConfigSource, path: str) -> str:
    """A path referenced from a config, resolved like the runtime would
    resolve it (cwd == the config's directory for assembled runs)."""
    if os.path.isabs(path):
        return path
    return os.path.join(source.base_dir, path)
