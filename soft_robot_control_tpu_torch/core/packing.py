"""State packing: the framework-wide convention is ``x = [v; q]``
(velocity first, then position), on single states ``(n,)`` or batches
``(..., n)``."""

from __future__ import annotations

import torch


def qv2x(q, v):
    """Pack position q and velocity v into x = [v; q] (last axis)."""
    return torch.cat((v, q), dim=-1)


def x2qv(x):
    """Unpack x = [v; q] -> (q, v)."""
    n = x.shape[-1] // 2
    return x[..., n:], x[..., :n]


def vq2qv(x):
    """Reorder x = [v; q] -> [q; v]."""
    q, v = x2qv(x)
    return torch.cat((q, v), dim=-1)
