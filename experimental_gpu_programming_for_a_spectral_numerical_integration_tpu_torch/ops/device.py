"""Where the port's tensors go when the caller does not say.

The port runs on the card: a factory given no device, and any input that is
not a torch tensor (numpy, list, tuple of floats), go to the current CUDA
device.  A torch tensor keeps its own device, which is how a caller asks for
the CPU.  There is no fallback to the CPU.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["default_device", "canonical_device", "as_tensor", "cached_constants"]


def default_device() -> torch.device:
    """The device the port runs on when the caller names none: the current
    CUDA device.  There is no fallback to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless asked otherwise; "
            "pass device='cpu' or CPU tensors to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def canonical_device(device=None) -> torch.device:
    """``torch.device`` with the CUDA index filled in, so caches keyed on a
    device see one key per card; ``None`` is :func:`default_device`."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def as_tensor(x, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A torch tensor keeps its device; any other input (numpy, list, tuple
    of floats) goes to :func:`default_device`."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(x, dtype=dtype, device=default_device())


def cached_constants(build):
    """``functools.lru_cache`` for a function that makes device constants,
    run with ``torch.func``'s transforms suspended: a tensor made inside
    ``torch.func.jvp`` is wrapped for that transform, and a cache first
    filled there would hand the dead wrapper to every later call."""
    @functools.lru_cache(maxsize=None)
    @functools.wraps(build)
    def cached(*args):
        with torch._C._DisableFuncTorch():
            return build(*args)
    return cached
