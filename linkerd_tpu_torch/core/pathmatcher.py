"""PathMatcher: prefix matching with variable capture over Paths: a copy of
``linkerd_tpu/core/pathmatcher.py``.

Reference parity: finagle/buoyant/src/main/scala/com/twitter/finagle/buoyant/
PathMatcher.scala:1-92 — matches a path against a segment pattern where
``{var}`` captures one segment and ``*`` matches any one segment; captured
variables substitute into templated strings (e.g. a TLS commonName of
``{service}.example.com``). Used by per-prefix client/svc configuration
(linkerd/core/.../Client.scala, Svc.scala; StackRouter.Client.PerClientParams
router/core/.../Router.scala:271-303).
"""

from __future__ import annotations

import re
from typing import Dict, Optional

from linkerd_tpu_torch.core.path import Path

_VAR_RE = re.compile(r"\{([^}/]+)\}")


class PathMatcher:
    """A segment-pattern prefix matcher with ``{var}`` captures."""

    def __init__(self, expr: str):
        self.expr = expr
        self._segments = tuple(Path.read(expr))

    def extract(self, path: Path) -> Optional[Dict[str, str]]:
        """Variables captured if ``path`` starts with this pattern, else None.

        A literal segment must equal the path segment; ``*`` matches any one
        segment; ``{name}`` matches any one segment and captures it.
        """
        if len(path) < len(self._segments):
            return None
        vars_: Dict[str, str] = {}
        for pat, seg in zip(self._segments, path):
            if pat == "*":
                continue
            m = _VAR_RE.fullmatch(pat)
            if m is not None:
                vars_[m.group(1)] = seg
            elif pat != seg:
                return None
        return vars_

    def matches(self, path: Path) -> bool:
        return self.extract(path) is not None

    @property
    def var_names(self) -> frozenset:
        """Names this pattern captures (for load-time template checks)."""
        out = set()
        for seg in self._segments:
            m = _VAR_RE.fullmatch(seg)
            if m is not None:
                out.add(m.group(1))
        return frozenset(out)

    def substitute(self, path: Path, template: str) -> Optional[str]:
        """``template`` with ``{var}`` replaced by captures from ``path``;
        None if the path doesn't match or a referenced var wasn't captured.
        """
        vars_ = self.extract(path)
        if vars_ is None:
            return None
        return self.substitute_vars(vars_, template)

    @staticmethod
    def substitute_vars(vars_: Dict[str, str], template: str) -> Optional[str]:
        missing = False

        def repl(m: "re.Match[str]") -> str:
            nonlocal missing
            if m.group(1) not in vars_:
                missing = True
                return m.group(0)
            return vars_[m.group(1)]

        out = _VAR_RE.sub(repl, template)
        return None if missing else out

    def __repr__(self) -> str:
        return f"PathMatcher({self.expr!r})"
