"""The device the port places its tensors on.

The default is ``"cuda"``: the port is written for one NVIDIA H100, and
nothing falls back to the CPU on its own. Tests and CPU-only callers select
``"cpu"`` explicitly with :func:`set_device`; every kernel wrapper then runs
its plain PyTorch version because its inputs lie on the CPU.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

# Every f32 product of the port (coarse probe, k-means, refine, FLAT phase 2)
# runs in full f32: TF32 keeps ~10 mantissa bits and would move top-k
# boundaries against the reference.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_DEVICE = torch.device("cuda")
_SCOPE = threading.local()  # .device: this thread's scoped_device, if one is open


def set_device(device) -> None:
    """Select the device for every tensor the port creates from now on."""
    global _DEVICE
    _DEVICE = torch.device(device)


def get_device() -> torch.device:
    """The calling thread's scoped device where it has one open, else the
    device set_device selected."""
    return getattr(_SCOPE, "device", None) or _DEVICE


@contextlib.contextmanager
def scoped_device(device):
    """Run a block with ``device`` as the port's device and, where it is a
    CUDA device, as torch.cuda's current device; both are restored after.
    The sharded indexes (parallel/sharding.py) build and search each shard
    inside this scope, so every module that places tensors with
    :func:`to_device` puts that shard's on its own device. The scope holds
    for the calling thread only, as ``jax.default_device`` does: another
    thread (a build pool's worker) keeps its own device."""
    dev = torch.device(device)
    saved = getattr(_SCOPE, "device", None)
    _SCOPE.device = dev
    try:
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            yield dev
    finally:
        _SCOPE.device = saved


def to_device(a) -> torch.Tensor:
    """numpy array (or tensor) -> tensor on the port's device."""
    dev = get_device()
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # read-only views (memmaps, blobs) are copied
        a = a.copy()
    return torch.from_numpy(a).to(dev)
