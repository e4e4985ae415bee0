"""Slash-delimited hierarchical paths: a copy of
``linkerd_tpu/core/path.py``.

``com.twitter.finagle.Path`` as linkerd uses it for logical names
(``/svc/users``). Paths are immutable tuples of UTF-8 segments.
"""

from __future__ import annotations

from typing import Iterable, Tuple


class Path(Tuple[str, ...]):
    """An immutable, slash-rendered sequence of name segments.

    ``Path.read("/svc/users")`` -> ``Path(("svc", "users"))``;
    ``path.show`` -> ``"/svc/users"``. The empty path shows as ``"/"``.
    """

    __slots__ = ()

    def __new__(cls, segments: Iterable[str] = ()) -> "Path":
        segs = tuple(segments)
        for s in segs:
            if not isinstance(s, str):
                raise TypeError(f"path segment must be str, got {type(s).__name__}")
            if "/" in s or s == "":
                raise ValueError(f"invalid path segment: {s!r}")
        return super().__new__(cls, segs)

    @staticmethod
    def read(s: str) -> "Path":
        s = s.strip()
        if s in ("", "/"):
            return Path()
        if not s.startswith("/"):
            raise ValueError(f"path must start with '/': {s!r}")
        return Path(seg for seg in s.split("/")[1:] if seg != "")

    @staticmethod
    def of(*segments: str) -> "Path":
        return Path(segments)

    @property
    def show(self) -> str:
        return "/" + "/".join(self) if self else "/"

    @property
    def is_empty(self) -> bool:
        return len(self) == 0

    def starts_with(self, prefix: "Path") -> bool:
        return len(prefix) <= len(self) and tuple(self[: len(prefix)]) == tuple(prefix)

    def drop(self, n: int) -> "Path":
        return Path(tuple.__getitem__(self, slice(n, None)))

    def take(self, n: int) -> "Path":
        return Path(tuple.__getitem__(self, slice(None, n)))

    def concat(self, other: "Path") -> "Path":
        return Path(tuple(self) + tuple(other))

    def child(self, seg: str) -> "Path":
        return Path(tuple(self) + (seg,))

    def __add__(self, other) -> "Path":  # type: ignore[override]
        if isinstance(other, str):
            # A bare str would iterate char-by-char through Path(iterable);
            # require an explicit Path.read/child instead.
            raise TypeError("use path.child(seg) or path + Path.read(...) for str")
        return self.concat(Path(other))

    def __repr__(self) -> str:
        return f"Path({self.show!r})"

    def __str__(self) -> str:
        return self.show


EMPTY = Path()
