"""Flat-array marshalling helpers.

The reference's RPC wire helpers (sofacontrol/utils.py:417-431, used by
the GuSTOsrv float64[] messages), as the JAX package keeps them: for any
external transport a user wires in. Numpy on the host; a tensor is copied
to the host first.
"""

from __future__ import annotations

import numpy as np

from soft_robot_control_tpu_torch.utils.device import to_numpy


def arr2np(x, dim: int, squeeze: bool = False) -> np.ndarray:
    """Flat list -> (-1, dim) float64 array (optionally squeezed)."""
    a = np.asarray(to_numpy(x), dtype="float64").reshape(-1, dim)
    return a.squeeze() if squeeze else a


def np2arr(x) -> list:
    """Array -> flat python list."""
    return np.asarray(to_numpy(x)).flatten().tolist()
