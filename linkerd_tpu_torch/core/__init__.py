"""Core naming algebra and reactive cells: a copy of
``linkerd_tpu/core/__init__.py``.

Reference parity: finagle's ``Path``/``Dtab``/``NameTree``/``Name`` and
``com.twitter.util.{Var, Activity}`` as used throughout
linkerd's ``namer/core`` and ``router/core``.
"""

from linkerd_tpu_torch.core.path import Path
from linkerd_tpu_torch.core.nametree import NameTree, Leaf, Alt, Union, Neg, Empty, Fail, Weighted
from linkerd_tpu_torch.core.dtab import Dentry, Dtab
from linkerd_tpu_torch.core.var import Var, Closable
from linkerd_tpu_torch.core.activity import Activity, Pending, Ok, Failed
from linkerd_tpu_torch.core.addr import Addr, Address

__all__ = [
    "Path", "NameTree", "Leaf", "Alt", "Union", "Neg", "Empty", "Fail",
    "Weighted", "Dentry", "Dtab", "Var", "Closable", "Activity", "Pending",
    "Ok", "Failed", "Addr", "Address",
]
