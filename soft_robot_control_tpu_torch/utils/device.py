"""Device resolution for the port's entry points."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`; a CUDA device with no card present
    raises rather than falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    return dev


def run_dtype(dev: torch.device) -> torch.dtype:
    """The campaign scripts' precision on `dev`: float64 on the CPU,
    float32 on the card (the JAX scripts enable x64 on the CPU only)."""
    return torch.float64 if dev.type == "cpu" else torch.float32


def as_tensor(a, dtype=None, device=None) -> torch.Tensor:
    """A tensor of `a` (tensor, numpy array or nested list) with the given
    dtype and device; numpy input is copied, so read-only arrays are safe."""
    if torch.is_tensor(a):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def to_numpy(a) -> np.ndarray:
    """`a` (tensor on any device, array or list) as a numpy array."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
