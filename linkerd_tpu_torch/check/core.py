"""The parts of l5dcheck's shared infrastructure
(``tools/analysis/core.py``) that the semantic config check reads:
inline ``# l5d: ignore[rule] — why`` suppressions, their placement, and
``Finding``. Each definition is as in the original."""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

SEVERITIES = ("error", "warning")

# `# l5d: ignore[rule-a,rule-b] — why this is deliberate`
_SUPPRESS_RE = re.compile(
    r"#\s*l5d:\s*ignore\[([a-zA-Z0-9_,\- ]+)\]\s*(?:[—:-]+\s*(\S.*))?")


@dataclass
class Suppression:
    line: int
    rules: Tuple[str, ...]
    justification: str

    @property
    def justified(self) -> bool:
        return bool(self.justification.strip())


def suppression_at(suppressions: Dict[int, "Suppression"],
                   lines: Sequence[str], rule: str,
                   line: int) -> Optional["Suppression"]:
    """The one definition of suppression placement (python sources AND
    l5dcheck YAML share it): a suppression applies to findings on its
    own line, or — when it is a comment-ONLY line — to the line
    directly below it. A suppression trailing code binds to that code
    alone (it must not leak onto the next statement/dentry)."""
    for ln in (line, line - 1):
        sup = suppressions.get(ln)
        if sup and rule in sup.rules:
            if ln == line - 1:
                above = lines[ln - 1].strip() if 1 <= ln <= len(lines) else ""
                if not above.startswith("#"):
                    continue
            return sup
    return None


@dataclass
class Finding:
    rule: str
    path: str  # repo-relative
    line: int
    col: int
    message: str
    severity: str = "error"
    suppressed: bool = False
    justification: str = ""

    def show(self) -> str:
        mark = " (suppressed)" if self.suppressed else ""
        return (f"{self.path}:{self.line}:{self.col}: "
                f"[{self.rule}] {self.message}{mark}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

