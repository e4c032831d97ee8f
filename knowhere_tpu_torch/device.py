"""The device the port places its tensors on.

The default is ``"cuda"``: the port is written for one NVIDIA H100, and
nothing falls back to the CPU on its own. Tests and CPU-only callers select
``"cpu"`` explicitly with :func:`set_device`; every kernel wrapper then runs
its plain PyTorch version because its inputs lie on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

# Every f32 product of the port (coarse probe, k-means, refine, FLAT phase 2)
# runs in full f32: TF32 keeps ~10 mantissa bits and would move top-k
# boundaries against the reference.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_DEVICE = torch.device("cuda")


def set_device(device) -> None:
    """Select the device for every tensor the port creates from now on."""
    global _DEVICE
    _DEVICE = torch.device(device)


def get_device() -> torch.device:
    return _DEVICE


def to_device(a) -> torch.Tensor:
    """numpy array (or tensor) -> tensor on the port's device."""
    if isinstance(a, torch.Tensor):
        return a.to(_DEVICE)
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # read-only views (memmaps, blobs) are copied
        a = a.copy()
    return torch.from_numpy(a).to(_DEVICE)
