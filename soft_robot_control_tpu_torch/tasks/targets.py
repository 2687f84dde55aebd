"""Tracking target generators: figure-8 ("infinity sign") and circle
trajectories on output coordinates and a 1-D sinusoid (examples/diamond/
diamond.py:259-316, examples/trunk/trunk.py:275-325). The port's own numpy
copy of the JAX package's tasks/targets.py."""

from __future__ import annotations

import numpy as np


def figure8(M: int = 1, T: float = 10.0, N: int = 1000, radius: float = 1.0,
            t0: float = 0.0):
    """Figure-8 in 2 output dims: (x, y) = r sin(t), r sin(t) cos(t).

    M repetitions of period T sampled with N points per period; matches the
    reference construction (examples/diamond/diamond.py:276-283).
    Returns (t, z) with z (M*N+1, 2).
    """
    t = np.linspace(0, M * T, M * N + 1)
    th = 2 * np.pi / T * (t - t0)
    x = radius * np.sin(th)
    y = radius * np.sin(th) * np.cos(th)
    return t, np.stack([x, y], axis=1)


def circle(M: int = 1, T: float = 10.0, N: int = 1000, radius: float = 1.0,
           t0: float = 0.0):
    """Circle in 2 output dims (used by trunk/hardware recipes)."""
    t = np.linspace(0, M * T, M * N + 1)
    th = 2 * np.pi / T * (t - t0)
    return t, np.stack([radius * np.cos(th) - radius, radius * np.sin(th)],
                       axis=1)


def sine_setpoint(T: float = 4.0, duration: float = 10.0, dt: float = 0.01,
                  amplitude: float = 1.0):
    """1-D sinusoid target."""
    t = np.arange(0, duration, dt)
    return t, (amplitude * np.sin(2 * np.pi * t / T))[:, None]
