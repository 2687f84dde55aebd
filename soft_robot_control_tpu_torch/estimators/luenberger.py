"""Discrete Luenberger observer for a linear ROM: a constant gain L from
the dual DARE (A', C', Q, R), and the update

    x+ = A x + B u + d + L (y - C x),

with the innovation taken at the previous estimate."""

from __future__ import annotations

import torch

from soft_robot_control_tpu_torch.lqr.riccati import dare
from soft_robot_control_tpu_torch.utils.device import (as_tensor,
                                                       resolve_device)


def luenberger_gain(A_d, C, Q, R):
    """L = -K' of the dual DARE (A_d', C', Q, R): tensors on one device,
    solved in their promoted dtype."""
    dt = A_d.dtype
    for a in (C, Q, R):
        dt = torch.promote_types(dt, a.dtype)
    L, _ = dare(A_d.to(dt).T, C.to(dt).T, Q.to(dt), R.to(dt))
    return -L.T


def luenberger_update(model, x, u, y, L):
    """One observer step (tensors); y is the full-order measurement, the
    innovation taken at the previous estimate."""
    x_pred = model.update_dynamics(x, u, model.A_d, model.B_d, model.d_d)
    return x_pred + L @ (model.zfyf_to_zy(yf=y) - model.C @ x)


class DiscreteLuenbergerObserver:
    """Stateful observer x+ = f(x, u) + L (y - C x) over a linear ROM with a
    measurement model, on the model's device (or `device`); the gain and
    the estimate in `dtype`."""

    def __init__(self, dyn_sys, Q, R, device=None, dtype=torch.float64):
        self.device = resolve_device(
            getattr(dyn_sys, "device", "cuda") if device is None else device)
        if dyn_sys.C is None:
            raise RuntimeError("Need to set meas. model in dyn_sys")
        self.dyn_sys = dyn_sys
        t = lambda a: as_tensor(a, dtype, self.device)
        self.C = t(dyn_sys.C)
        self.L = luenberger_gain(t(dyn_sys.A_d), self.C, t(Q), t(R))
        self.x = None
        self.z = None

    def _t(self, a):
        return as_tensor(a, self.C.dtype, self.device)

    def initialize(self, xf):
        self.x = self._t(self.dyn_sys.rom.project_x(self._t(xf)))
        self._update_z()

    def update(self, u, y, dt=None, **kwargs):
        y_red = self._t(self.dyn_sys.zfyf_to_zy(yf=y))
        self.x = (self._t(self.dyn_sys.update_state(self.x, self._t(u)))
                  + self.L @ (y_red - self.C @ self.x))
        self._update_z()

    def _update_z(self):
        if self.dyn_sys.H is not None:
            self.z = self.dyn_sys.x_to_zfyf(self.x, zf=True)
        else:
            self.z = self.dyn_sys.x_to_zfyf(self.x, yf=True)
