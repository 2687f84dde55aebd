"""Typed containers: quadratic cost weights and tracking targets.

Plain attribute holders; what they hold (numpy arrays or tensors) is the
caller's choice, and the services that take them cast it to their own dtype
and device.
"""

from __future__ import annotations

import numpy as np


class QuadraticCost:
    """Quadratic OCP cost weights (Q, R, Qf)."""

    def __init__(self, Q=None, R=None, Qf=None):
        self.Q = Q
        self.R = R
        self.Qf = Qf

    def __repr__(self):
        def shp(m):
            return None if m is None else tuple(np.shape(m))

        return f"QuadraticCost(Q={shp(self.Q)}, R={shp(self.R)}, Qf={shp(self.Qf)})"


class Target:
    """Tracking target: times t with outputs z and/or inputs u (per time or
    constant), and for some controllers the states x, the full output map Hf
    and a linearization (A, B)."""

    def __init__(self, t=None, u=None, z=None, x=None, Hf=None, A=None, B=None):
        self.t = t
        self.u = u
        self.z = z
        self.x = x
        self.Hf = Hf
        self.A = A
        self.B = B


def load_target_file(path: str) -> Target:
    """Load a Target from a saved simulation pickle (keys t, u, z, Hf)."""
    from soft_robot_control_tpu_torch.utils.io import load_data

    data = load_data(path)
    return Target(t=data.get("t"), u=data.get("u"), z=data.get("z"), Hf=data.get("Hf"))
