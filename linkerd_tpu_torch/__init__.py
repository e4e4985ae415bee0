"""PyTorch/CUDA port of ``linkerd_tpu``'s device path.

The package stands alone: it imports ``torch`` and never ``jax`` or
anything of ``linkerd_tpu``. Its entry points run on the CUDA device
unless the caller asks for the CPU by name; with no CUDA device they
raise rather than carry on on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` or a CUDA device -> that CUDA device, raising when CUDA
    is absent; ``"cpu"`` only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: use cuda, or cpu by name")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


__all__ = ["resolve_device", "DeviceLike"]
