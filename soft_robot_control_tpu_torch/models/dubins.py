"""Analytic Dubins-car model: the artifact-free GuSTO test case, with
analytic Jacobians, batched over leading axes.

    x = (px, py, theta),  u = (speed, turn rate),
    f(x, u) = (u0 cos theta, u0 sin theta, u1).
"""

from __future__ import annotations

import numpy as np
import torch


class DubinsCar:
    nonlinear_observer = False

    def __init__(self, dtype=torch.float64, device="cuda"):
        from soft_robot_control_tpu_torch.utils.device import resolve_device

        self.n_x = 3
        self.n_u = 2
        self.n_z = 3
        self.dtype = dtype
        self.device = resolve_device(device)
        self.H = torch.eye(3, dtype=dtype, device=self.device)

    def _t(self, a):
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def f(self, x, u):
        x, u = self._t(x), self._t(u)
        th = x[..., 2]
        return torch.stack([u[..., 0] * torch.cos(th),
                            u[..., 0] * torch.sin(th), u[..., 1]], dim=-1)

    def get_continuous_dynamics(self, x, u):
        """(f, A, B) at states x (..., 3) and inputs u (..., 2)."""
        x, u = self._t(x), self._t(u)
        th, v = x[..., 2], u[..., 0]
        c, s = torch.cos(th), torch.sin(th)
        zero, one = torch.zeros_like(th), torch.ones_like(th)
        A = torch.stack([torch.stack([zero, zero, -v * s], -1),
                         torch.stack([zero, zero, v * c], -1),
                         torch.stack([zero, zero, zero], -1)], -2)
        B = torch.stack([torch.stack([c, zero], -1),
                         torch.stack([s, zero], -1),
                         torch.stack([zero, one], -1)], -2)
        return self.f(x, u), A, B

    def get_discrete_dynamics(self, x, u, dt):
        """Forward-Euler discretization of the affine expansion."""
        x, u = self._t(x), self._t(u)
        f, A, B = self.get_continuous_dynamics(x, u)
        d = f - (A @ x[..., None])[..., 0] - (B @ u[..., None])[..., 0]
        Ad = torch.eye(3, dtype=self.dtype, device=self.device) + dt * A
        return Ad, dt * B, dt * d

    def get_characteristic_vals(self):
        return np.ones(self.n_x), np.ones(self.n_x)

    def get_next_state(self, x, u, dt):
        x = self._t(x)
        return x + dt * self.f(x, u)

    def rollout(self, x0, u, dt):
        """States (N+1, 3) of one input sequence u (N, 2)."""
        x = self._t(x0)
        u = self._t(u)
        xs = [x]
        for k in range(u.shape[0]):
            x = self.get_next_state(x, u[k], dt)
            xs.append(x)
        return torch.stack(xs)
