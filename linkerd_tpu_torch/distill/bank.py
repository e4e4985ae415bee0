"""The specialist bank: per-route heads, generations, and exports. A
copy of ``linkerd_tpu/distill/bank.py``.

``SpecialistBank`` is the Python-side source of truth for what the
engines' weight slab serves: the base model identity, a monotonically
increasing generation (the delta fence), and one ``HeadInfo`` per
specialist route. The pipeline mutates it only after a publish landed,
so the bank state and the slab state move together. ``state()`` is the
view the reference's ``/model.json`` renders: which routes run a
specialist, distilled from which base checkpoint, at which generation.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from linkerd_tpu_torch.lifecycle.export import export_bank_blob, route_hash


@dataclass
class HeadInfo:
    """One promoted specialist head."""

    dst: str                  # the route's dst path (the hash preimage)
    route_hash: int
    version: int              # head version (stamps the model section)
    snapshot: Any             # ModelSnapshot (host numpy)
    base_version: int         # base checkpoint the head distilled from
    generation: int           # bank generation that first served it
    promoted_at: float = field(default_factory=time.time)
    retrains: int = 1         # times this route's head was (re)promoted

    def meta(self) -> Dict[str, Any]:
        return {
            "dst": self.dst,
            "route_hash": self.route_hash,
            "version": self.version,
            "base_version": self.base_version,
            "generation": self.generation,
            "promoted_at": self.promoted_at,
            "retrains": self.retrains,
        }


class SpecialistBank:
    """Head registry + generation counter (see module docstring)."""

    def __init__(self, max_heads: int = 32):
        if max_heads < 1:
            raise ValueError("max_heads must be >= 1")
        self.max_heads = max_heads
        self.generation = 0
        self.base_version: Optional[int] = None
        self.heads: Dict[int, HeadInfo] = {}  # route_hash -> HeadInfo
        self._next_head_version = 1

    def __len__(self) -> int:
        return len(self.heads)

    @property
    def full(self) -> bool:
        return len(self.heads) >= self.max_heads

    def head_for(self, dst: str) -> Optional[HeadInfo]:
        return self.heads.get(route_hash(dst))

    def next_head_version(self) -> int:
        v = self._next_head_version
        self._next_head_version += 1
        return v

    def upsert(self, dst: str, snapshot: Any, version: int,
               base_version: int, generation: int) -> HeadInfo:
        rh = route_hash(dst)
        prev = self.heads.get(rh)
        if prev is None and self.full:
            raise ValueError(
                f"bank is full ({self.max_heads} heads); cannot add "
                f"{dst!r}")
        info = HeadInfo(dst=dst, route_hash=rh, version=version,
                        snapshot=snapshot, base_version=base_version,
                        generation=generation,
                        retrains=(prev.retrains + 1) if prev else 1)
        self.heads[rh] = info
        return info

    def remove(self, dst: str) -> Optional[HeadInfo]:
        return self.heads.pop(route_hash(dst), None)

    def export_full(self, base_snap: Any, base_version: int,
                    generation: int, quant: str) -> bytes:
        """The full ``L5DWTS02`` blob for the CURRENT head set under
        ``generation`` (the caller owns when generations bump)."""
        return export_bank_blob(
            base_snap, base_version, generation,
            {rh: (h.version, h.snapshot) for rh, h in self.heads.items()},
            quant=quant)

    def state(self) -> Dict[str, Any]:
        """The /model.json per-route bank view."""
        return {
            "generation": self.generation,
            "base_version": self.base_version,
            "max_heads": self.max_heads,
            "heads": {str(h.route_hash): h.meta()
                      for h in self.heads.values()},
        }
