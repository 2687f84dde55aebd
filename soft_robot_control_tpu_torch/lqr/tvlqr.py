"""Finite-horizon time-varying tracking LQR
(sofacontrol/lqr/traj_tracking_lqr.py): interpolate the nominal (t, x, u)
target onto the controller's dt grid, fetch the model's Jacobians at every
nominal point in one call (on a TPWL model, one launch of the select
kernel), then the backward Riccati recursion

    K_i = -(R + B'PB)^-1 B'PA
    P  <- Q + K'RK + (A + BK)' P (A + BK)

as a reversed loop over the horizon on tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from soft_robot_control_tpu_torch.utils.device import as_tensor


def interp_rows(t_query, t_grid, X):
    """Row-wise linear interpolation of X (T, d), sampled at t_grid, at the
    points t_query: (Q, d), constant beyond the ends (jnp.interp), on X's
    device (a numpy X gives a CPU tensor) in float64 unless X is a
    floating tensor."""
    from soft_robot_control_tpu_torch.control.linear_mpc import interp

    X = as_tensor(X) if torch.is_tensor(X) else as_tensor(X, torch.float64)
    t = lambda a: as_tensor(a, X.dtype, X.device).reshape(-1)
    return interp(t(t_query), t(t_grid), X)


def tv_lqr_backward(A, B, Q, R):
    """Backward recursion over stacked Jacobians A (..., T, n, n), B (...,
    T, n, m). Returns gains K (..., T, m, n) ordered forward in time and
    P (..., T+1, n, n). P is initialized to Q (traj_tracking_lqr.py:19)."""
    Q = as_tensor(Q, A.dtype, A.device)
    R = as_tensor(R, A.dtype, A.device)
    T = A.shape[-3]
    P = Q.expand(A.shape[:-3] + Q.shape)
    Ks, Ps = [None] * T, [None] * T
    for i in reversed(range(T)):
        A_t, B_t = A[..., i, :, :], B[..., i, :, :]
        Bt = B_t.transpose(-1, -2)
        K_t = -torch.linalg.solve(R + Bt @ P @ B_t, Bt @ P @ A_t)
        Acl = A_t + B_t @ K_t
        P = (Q + K_t.transpose(-1, -2) @ R @ K_t
             + Acl.transpose(-1, -2) @ P @ Acl)
        # re-symmetrize: roundoff asymmetry amplifies through Acl'P Acl
        # over long horizons
        P = 0.5 * (P + P.transpose(-1, -2))
        Ks[i], Ps[i] = K_t, P
    P0 = Q.expand(A.shape[:-3] + Q.shape)
    return torch.stack(Ks, dim=-3), torch.stack(Ps + [P0], dim=-3)


class TrajTrackingLQR:
    """Finite-horizon tracking LQR policy (traj_tracking_lqr.py:5-48)."""

    def __init__(self, dt, model, cost_params):
        self.dt = dt
        self.model = model
        self.cost_params = cost_params
        self.x_bar = None
        self.u_bar = None

    def compute_policy(self, target):
        """target: Target with (t, x, u). Returns (x_bar, u_bar, K) as
        tensors on the model's device."""
        final_time = float(np.asarray(target.t)[-1])
        nbr_steps = int(final_time / self.dt)
        t_steps = self.dt * np.arange(nbr_steps)

        x_nom = interp_rows(t_steps, target.t, target.x)
        u_nom = interp_rows(t_steps, target.t, target.u)

        dev = self.model.device
        A, B, _ = self.model.get_jacobians(x_nom.to(dev), dt=self.dt)
        K, _ = tv_lqr_backward(A, B, self.cost_params.Q, self.cost_params.R)
        self.x_bar, self.u_bar = x_nom.to(dev), u_nom.to(dev)
        return self.x_bar, self.u_bar, K
