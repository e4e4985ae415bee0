"""Weight carry-over between host numpy trees and the port's tensors.

The JAX package's params reach the port as numpy (for example
``jax.tree_util.tree_map(np.asarray, params)``); checkpoints hold the
same numpy trees. Layout is kept as is: ``w`` stays ``[in, out]``.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from linkerd_tpu_torch import DeviceLike, resolve_device


def params_from_numpy(tree: Any, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dict/list of arrays -> the same nesting of tensors on
    ``device`` (copies; float32 unless ``dtype`` is given)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        arr = np.asarray(node, np.float32)
        return torch.tensor(arr, dtype=dtype or torch.float32, device=dev)

    return conv(tree)


def params_to_numpy(tree: Any) -> Any:
    """The reverse: tensors -> float32 numpy copies on the host (copies
    even of CPU tensors, so a later in-place update of a tensor does not
    reach the arrays)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    return tree.detach().to("cpu", torch.float32, copy=True).numpy()
