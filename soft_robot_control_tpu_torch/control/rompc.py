"""ROMPC: reduced-order MPC on a single linearization, with a Luenberger
observer and DARE feedback.

Linear MPC plans over the LinearROM; the control is
u = ubar(t) + K (x_hat - xbar(t)) with the infinite-horizon DARE gain, and
the observer is updated after the control is applied. The schedule
(delay, controller ticks, replans) runs on the host in Python floats
rounded to 4 decimals, as in the JAX package: another rounding would land
a replan one tick off.
"""

from __future__ import annotations

import numpy as np
import torch

from soft_robot_control_tpu_torch.control.policies import _interp_rows
from soft_robot_control_tpu_torch.estimators.luenberger import (
    DiscreteLuenbergerObserver)
from soft_robot_control_tpu_torch.lqr.riccati import dare
from soft_robot_control_tpu_torch.utils.device import (as_tensor,
                                                       resolve_device,
                                                       to_numpy)


class ROMPC:
    """The controller on the model's device (or `device`), its DARE gain
    and observer in `dtype`; the plan and the command are numpy arrays on
    the host."""

    def __init__(self, dyn_sys, cost, costL, dt, N_replan=None, delay=2,
                 u0=None, wait=True, solver_service=None, device=None,
                 dtype=torch.float64):
        self.device = resolve_device(
            getattr(dyn_sys, "device", "cuda") if device is None else device)
        self.dyn_sys = dyn_sys
        self.dt = dt
        self.input_dim = dyn_sys.get_input_dim()
        self.state_dim = dyn_sys.get_state_dim()
        self.t_compute = 0.0
        self.t_delay = delay
        self.u0 = (np.zeros(self.input_dim) if u0 is None
                   else np.asarray(u0, float))
        self.u = self.u0
        self.N_replan = N_replan if N_replan is not None else 1
        self.t_opt = None
        self.u_opt = None
        self.x_opt = None
        self.solve_times = []
        self.wait = wait
        self.t_next_solve = 0
        self.initialized = False
        self.MPC = solver_service
        self.dtype = dtype
        t = lambda a: as_tensor(a, dtype, self.device)
        K, _ = dare(t(dyn_sys.A_d), t(dyn_sys.B_d), t(cost.Q), t(cost.R))
        self.K = to_numpy(K)
        self.observer = DiscreteLuenbergerObserver(
            dyn_sys, costL.Q, costL.R, device=self.device, dtype=dtype)
        self.sim_dt = None

    def set_service(self, service):
        self.MPC = service

    def set_sim_timestep(self, dt):
        self.sim_dt = dt

    def evaluate(self, sim_time, y, x, u_prev):
        """The command at sim_time: u0 during the delay, then the plan with
        DARE feedback at controller ticks; the observer is initialized from
        the full state x on the first call and updated after the command."""
        if not self.initialized:
            self.observer.initialize(to_numpy(x))

        if round(sim_time, 4) < round(self.t_delay, 4):
            self.u = self.u0
        else:
            if round(sim_time - self.t_delay, 4) >= round(self.t_compute, 4):
                if round(self.t_compute, 4) >= round(self.t_next_solve, 4):
                    self._solve_ocp()
                x_hat = to_numpy(self.observer.x)
                u_bar = _interp_rows(np.asarray([self.t_compute]),
                                     self.t_opt, self.u_opt)[0]
                x_bar = _interp_rows(np.asarray([self.t_compute]),
                                     self.t_opt, self.x_opt)[0]
                self.u = u_bar + self.K @ (x_hat - x_bar)
                self.t_compute = round(self.t_compute + self.dt, 4)
                self.MPC.force_spin()

        self.u = np.atleast_1d(np.asarray(self.u))
        self.observer.update(self.u, y)
        return self.u.copy()

    def _solve_ocp(self):
        if not self.initialized:
            self.MPC.send_request(self.t_compute,
                                  to_numpy(self.observer.x), wait=True)
            self._splice(init=True)
            self.initialized = True
        else:
            self._splice()
        self.MPC.send_request(self.t_opt[-1], self.x_opt[-1, :],
                              wait=self.wait)
        self.t_next_solve = round(float(self.t_opt[-1]), 6)

    def _splice(self, init=False):
        if not self.MPC.check_if_done():
            print("MPC cannot provide real-time compatibility, "
                  "consider modifying problem")
            self.MPC.force_wait()
        t_opt_p, u_opt_p, x_opt_p, t_solve = self.MPC.get_solution(
            self.state_dim, self.input_dim)
        self.solve_times.append(t_solve)
        u_ext = np.vstack((u_opt_p, u_opt_p[-1:, :]))
        if init:
            self.t_opt = self.dt * np.arange(self.N_replan + 1)
            self.u_opt = _interp_rows(self.t_opt, t_opt_p, u_ext)
            self.x_opt = _interp_rows(self.t_opt, t_opt_p, x_opt_p)
        else:
            t_new = self.t_opt[-1] + self.dt * np.arange(self.N_replan + 1)
            u_new = _interp_rows(t_new, t_opt_p, u_ext)
            x_new = _interp_rows(t_new, t_opt_p, x_opt_p)
            self.t_opt = np.concatenate((self.t_opt, t_new[1:]))
            self.u_opt = np.concatenate((self.u_opt[:-1, :], u_new))
            self.x_opt = np.concatenate((self.x_opt, x_new[1:, :]))

    def save_controller_info(self):
        x_opt = as_tensor(self.x_opt, self.dtype, self.device)
        return {"t_opt": self.t_opt, "u_opt": self.u_opt,
                "z_opt": to_numpy(self.dyn_sys.x_to_zfyf(x_opt, zf=True)),
                "solve_times": self.solve_times,
                "rollout_time": self.N_replan * self.dt}
