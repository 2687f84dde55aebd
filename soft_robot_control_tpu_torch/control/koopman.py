"""Koopman MPC controller.

Keep the scaled delay-embedding buffer, lift the current zeta (projected
with W for truncated models), query the linear MPC service in the lifted
space, splice the plans on the rollout-horizon grid, scale the inputs back
to physical units, optionally hold inputs (zero-order hold), and reproject
a measurement that leaves the polytope Y. The schedule runs on the host in
Python floats rounded to 4 decimals, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from soft_robot_control_tpu_torch.control.policies import _interp_rows
from soft_robot_control_tpu_torch.models.koopman import (KoopmanData,
                                                         KoopmanObserver)
from soft_robot_control_tpu_torch.utils.device import (as_tensor,
                                                       resolve_device,
                                                       to_numpy)


def _interp_prev(tq, t, Y):
    """Zero-order-hold ('previous') interpolation of the rows of Y."""
    t = np.asarray(t, float)
    Y = np.asarray(Y, float)
    idx = np.clip(np.searchsorted(t, np.asarray(tq), side="right") - 1, 0,
                  len(t) - 1)
    return Y[idx]


class KoopmanMPC:
    """The controller; the lifting and the Y projection run on the model's
    device (or `device`), the plan and the command are numpy arrays."""

    def __init__(self, dyn_sys, delay=2, u0=None, wait=True,
                 solver_service=None, device=None, **kwargs):
        self.device = resolve_device(
            getattr(dyn_sys, "device", "cuda") if device is None else device)
        self.dyn_sys = dyn_sys
        self.input_dim = dyn_sys.m
        self.state_dim = dyn_sys.N
        self.dt = dyn_sys.Ts
        self.observer = KoopmanObserver()
        self.Y = kwargs.get("Y")
        self.u0 = (np.zeros(self.input_dim) if u0 is None
                   else np.asarray(u0, float))
        self.t_compute = 0.0
        self.u = self.u0
        self.solve_times = []
        self.data = KoopmanData(dyn_sys.scale, dyn_sys.delays)
        self.rollout_horizon = kwargs.get("rollout_horizon", 1)
        self.input_hold = kwargs.get("input_hold", False)
        self.t_opt = None
        self.u_opt = None
        self.x_opt = None
        self.x_opt_full = None
        self.wait = wait
        self.MPC = solver_service
        self.z_opt_horizon = []
        self.t_opt_horizon = []
        self.t_delay = delay
        self.sim_dt = None

    def set_service(self, service):
        self.MPC = service

    def set_sim_timestep(self, dt):
        self.sim_dt = dt

    def recompute_policy(self, t_step):
        step = round(round(t_step, 4) / self.dt)
        return int(step % self.rollout_horizon) == 0

    def compute_policy(self, t_step, zeta_belief):
        """Lift, query the service, and splice its plan in."""
        W = self.dyn_sys.W
        xlift = to_numpy(W @ self.dyn_sys.lift_data(*zeta_belief).to(W))
        self.MPC.send_request(round(t_step, 4), xlift, wait=True)
        if not self.MPC.check_if_done():
            self.MPC.force_wait()
        t_opt_p, u_opt_p, x_opt_p, t_solve = self.MPC.get_solution(
            self.state_dim, self.input_dim)
        t_opt_p = np.round(t_opt_p, 4)
        u_opt_p = self.data.scaling.scale_up(u=u_opt_p)
        self.solve_times.append(t_solve)

        u_ext = np.vstack((u_opt_p, u_opt_p[-1:, :]))
        if self.t_opt is None:
            t_new = self.dt * np.arange(self.rollout_horizon + 1)
            self.t_opt = t_new
            self.u_opt = _interp_rows(t_new, t_opt_p, u_ext)
            self.x_opt = _interp_rows(t_new, t_opt_p, x_opt_p)
            self.x_opt_full = x_opt_p[None]
        else:
            t_new = self.t_opt[-1] + self.dt * np.arange(
                self.rollout_horizon + 1)
            u_new = _interp_rows(t_new, t_opt_p, u_ext)
            x_new = _interp_rows(t_new, t_opt_p, x_opt_p)
            self.t_opt = np.round(np.concatenate((self.t_opt, t_new[1:])), 4)
            self.u_opt = np.concatenate((self.u_opt[:-1, :], u_new))
            self.x_opt = np.concatenate((self.x_opt, x_new[1:, :]))
            self.x_opt_full = np.concatenate((self.x_opt_full,
                                              x_opt_p[None]))

        H = to_numpy(self.dyn_sys.H)
        self.z_opt_horizon.append(self.data.scaling.scale_up(
            y=(H @ x_opt_p.T).T))
        self.t_opt_horizon.append(t_opt_p)

    def compute_input(self, t_step, zeta_belief):
        self.MPC.force_spin()
        if self.input_hold:
            return _interp_prev(np.asarray([t_step]), self.t_opt,
                                self.u_opt)[0]
        return _interp_rows(np.asarray([t_step]), self.t_opt, self.u_opt)[0]

    def evaluate(self, sim_time, y, x, u_prev):
        """The command at sim_time from the measurement y (the model's
        output coordinates; an array, or a tensor on any device, as the
        closed loop hands it) and the previous command."""
        # the delay buffer is host numpy: one copy of the measurement
        y = to_numpy(y)
        sim_time = round(sim_time, 4)
        self.observer.update(None, y, None)
        if self.Y is not None:
            y_t = as_tensor(np.asarray(y, float), device=self.device)
            if not bool(self.Y.contains(y_t)):
                y = to_numpy(self.Y.project(y_t))
        self.data.add_measurement(y, u_prev)
        if round(sim_time, 4) < round(self.t_delay, 4):
            self.u = self.u0
        else:
            if round(sim_time - self.t_delay, 4) >= round(self.t_compute, 4):
                zeta_belief = self.data.get_zeta()
                if self.recompute_policy(self.t_compute):
                    self.compute_policy(self.t_compute, zeta_belief)
                self.u = self.compute_input(self.t_compute, zeta_belief)
                self.t_compute = round(self.t_compute + self.dt, 4)
        self.u = np.atleast_1d(np.asarray(self.u))
        return self.u.copy()

    def save_controller_info(self):
        H = to_numpy(self.dyn_sys.H)
        return {
            "t_opt": self.t_opt, "u_opt": self.u_opt,
            "z_opt": self.data.scaling.scale_up(y=(H @ self.x_opt.T).T),
            "z_rollout": self.z_opt_horizon, "t_rollout": self.t_opt_horizon,
            "solve_times": self.solve_times,
            "rollout_time": self.rollout_horizon * self.dt,
        }
