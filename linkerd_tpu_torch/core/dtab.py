"""Dtab — delegation tables: a copy of ``linkerd_tpu/core/dtab.py``.

Reference parity: ``com.twitter.finagle.Dtab`` / ``Dentry`` as used by
ConfiguredDtabNamer (namer/core, ConfiguredDtabNamer.scala:14-42)
and the namerd control plane. A dtab is an ordered list of delegation rules
``prefix => dst``; lookup rewrites a path by the *last* matching rules first
(later entries take precedence), combining alternatives with Alt.

Prefix segments may be the wildcard ``*`` which matches any single segment.

Text syntax::

    /svc => /host ;
    /host/web => /srv/web-v1 | /srv/web-v0 ;
    /srv => 0.9 * /#/io.l5d.fs & 0.1 * /#/canary
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Iterable, List, Tuple

from linkerd_tpu_torch.core.path import Path
from linkerd_tpu_torch.core.nametree import Alt, Leaf, NameTree, NEG, parse as parse_tree


WILDCARD = "*"

# ``#`` at line start or after whitespace opens a to-end-of-line comment
# (so l5dcheck suppressions and operator notes survive inside YAML block
# scalars and fs dtab files); ``#`` directly after ``/`` is the
# configured-namer path segment (``/#/io.l5d.fs``) and is never a
# comment, nor is ``#/`` (a comment can't shadow a path continuation).
_COMMENT_RE = re.compile(r"(?:^|(?<=\s))#(?!/).*")


@dataclass(frozen=True)
class Prefix:
    """A dentry prefix: path segments, each a literal or ``*`` wildcard."""

    segments: Tuple[str, ...]

    @staticmethod
    def read(s: str) -> "Prefix":
        # '*' is a valid Path segment, so prefix syntax is plain path syntax.
        return Prefix(tuple(Path.read(s)))

    def matches(self, path: Path) -> bool:
        if len(self.segments) > len(path):
            return False
        return all(
            pseg == WILDCARD or pseg == seg
            for pseg, seg in zip(self.segments, path)
        )

    def __len__(self) -> int:
        return len(self.segments)

    @property
    def show(self) -> str:
        return Path(self.segments).show


@dataclass(frozen=True)
class Dentry:
    prefix: Prefix
    dst: NameTree[Path]

    @staticmethod
    def read(s: str) -> "Dentry":
        if "=>" not in s:
            raise ValueError(f"dentry must contain '=>': {s!r}")
        pfx, dst = s.split("=>", 1)
        return Dentry(Prefix.read(pfx), parse_tree(dst.strip()))

    @property
    def show(self) -> str:
        return f"{self.prefix.show} => {self.dst.show}"


class Dtab(Tuple[Dentry, ...]):
    __slots__ = ()

    def __new__(cls, dentries: Iterable[Dentry] = ()) -> "Dtab":
        return super().__new__(cls, tuple(dentries))

    @staticmethod
    def read(s: str) -> "Dtab":
        """Parse ``;``-separated dentries (trailing ``;`` allowed).
        ``#``-to-end-of-line comments are stripped first (see
        ``_COMMENT_RE``)."""
        s = "\n".join(_COMMENT_RE.sub("", line) for line in s.splitlines())
        dentries = []
        for part in s.split(";"):
            part = part.strip()
            if part:
                dentries.append(Dentry.read(part))
        return Dtab(dentries)

    @staticmethod
    def empty() -> "Dtab":
        return Dtab()

    def concat(self, other: "Dtab") -> "Dtab":
        return Dtab(tuple(self) + tuple(other))

    def __add__(self, other) -> "Dtab":  # type: ignore[override]
        return self.concat(other)

    def lookup(self, path: Path) -> NameTree[Path]:
        """Rewrite ``path`` by all matching dentries, later entries first.

        Matching entries' dst trees (leaves extended with the residual path)
        are combined into an Alt; no match yields Neg.
        (ref: finagle Dtab.lookup semantics relied on by
        ConfiguredDtabNamer.scala:19-23)
        """
        matches: List[NameTree[Path]] = []
        for dentry in reversed(self):
            if dentry.prefix.matches(path):
                residual = path.drop(len(dentry.prefix))
                matches.append(dentry.dst.map(lambda p, r=residual: p.concat(r)))
        if not matches:
            return NEG
        if len(matches) == 1:
            return matches[0]
        return Alt(*matches)

    @property
    def show(self) -> str:
        return ";".join(d.show for d in self)

    def __repr__(self) -> str:
        return f"Dtab({self.show!r})"
