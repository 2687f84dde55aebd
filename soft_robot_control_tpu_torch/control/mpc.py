"""Receding-horizon SCP MPC controllers with plan splicing: the `scp`
controllers of sofacontrol/tpwl/controllers.py:209-346 (TPWL: LQR feedback
around the plan, DARE gains at every TPWL point computed at construction,
in one batched call) and sofacontrol/SSM/controllers.py:140-250 (SSM:
feedforward only, manifold observer, recompute every N_replan steps).

The solver runs in-process through GuSTOService (control/service.py),
with its asynchronous plan hand-off: a new solve is requested for the end
of the current plan while the current plan executes, and spliced onto the
global (t_opt, u_opt, x_opt) arrays on the N_replan * dt grid. Plans and
gains are numpy arrays on the host, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from soft_robot_control_tpu_torch.control.policies import (
    TemplateController, _host, _interp_rows)
from soft_robot_control_tpu_torch.estimators.ssm_observer import SSMObserver
from soft_robot_control_tpu_torch.lqr.riccati import dare
from soft_robot_control_tpu_torch.utils.device import as_tensor, to_numpy


def _plan_outputs(dyn_sys, x, **kw):
    """Full-order outputs of plan states x (numpy) as numpy, computed in
    the model's output dtype on its device."""
    ref = dyn_sys.z_ref
    return to_numpy(dyn_sys.x_to_zfyf(as_tensor(x, ref.dtype, ref.device),
                                      **kw))


class _Splice:
    """The plan splice both controllers share (tpwl/controllers.py:288-324,
    SSM/controllers.py:193-233)."""

    def _splice(self, init=False, zf=True):
        if not self.GuSTO.check_if_done():
            print("GuSTO cannot provide real-time compatibility, "
                  "consider modifying problem")
            self.GuSTO.force_wait()
        t_opt_p, u_opt_p, x_opt_p, t_solve = self.GuSTO.get_solution(
            self.state_dim, self.input_dim)
        self.solve_times.append(t_solve)

        u_ext = np.vstack((u_opt_p, u_opt_p[-1:, :]))
        if init:
            t_new = self.dt * np.arange(self.N_replan + 1)
            self.t_opt = t_new
            self.u_opt = _interp_rows(t_new, t_opt_p, u_ext)
            self.x_opt = _interp_rows(t_new, t_opt_p, x_opt_p)
        else:
            t_new = self.t_opt[-1] + self.dt * np.arange(self.N_replan + 1)
            u_new = _interp_rows(np.round(t_new, 4), t_opt_p, u_ext)
            x_new = _interp_rows(np.round(t_new, 4), t_opt_p, x_opt_p)
            self.t_opt = np.concatenate((self.t_opt, t_new[1:]))
            self.u_opt = np.concatenate((self.u_opt[:-1, :], u_new))
            self.x_opt = np.concatenate((self.x_opt, x_new[1:, :]))

        self.z_opt_horizon.append(
            _plan_outputs(self.dyn_sys, x_opt_p, zf=True) if zf
            else to_numpy(self.dyn_sys.x_to_zfyf(as_tensor(
                x_opt_p, self.dyn_sys.dtype, self.dyn_sys.device))))
        self.t_opt_horizon.append(t_opt_p)


class scp(_Splice, TemplateController):
    """TPWL SCP MPC (tpwl/controllers.py:209-346)."""

    def __init__(self, dyn_sys, cost, dt, N_replan=None, observer=None,
                 delay=2, u0=None, wait=True, solver_service=None, **kwargs):
        super().__init__(dyn_sys, None, dt=dt, observer=observer, delay=delay,
                         u0=u0)
        self.N_replan = N_replan if N_replan is not None else 1
        self.t_opt = None
        self.u_opt = None
        self.x_opt = None
        self.wait = wait
        self.t_next_solve = 0
        self.initialized = False
        self.solve_times = []
        self.z_opt_horizon = []
        self.t_opt_horizon = []
        self.mpc = kwargs.pop("mpc", False)
        # LQR feedback around the plan (the reference's default);
        # feedback=False flies the feedforward alone, as the reference's SSM
        # controller does
        self.feedback = bool(kwargs.pop("feedback", True))
        # optional feedback cost: gains from the DARE with this R instead
        # of the MPC's R (the plan keeps the MPC cost)
        feedback_R = kwargs.pop("feedback_R", None)
        self.GuSTO = solver_service  # set via set_service() if None

        # DARE feedback gains at every TPWL point (tpwl/controllers.py:
        # 239-246), one batched DARE over the P points. A dictionary that
        # is discrete at this dt supplies its own A_d/B_d: re-discretizing
        # the continuous family there would reintroduce the Galerkin
        # resolvent error and corrupt the gains.
        if not self.feedback:
            self.K = None
        else:
            if (getattr(dyn_sys, "A_d", None) is not None
                    and getattr(dyn_sys, "pre_discretized_dt", None) is not None
                    and abs(dyn_sys.pre_discretized_dt - dt) < 1e-12):
                A_d, B_d = dyn_sys.A_d, dyn_sys.B_d
            else:
                A_d, B_d, _ = dyn_sys.discretize_dynamics(
                    dyn_sys.A_c, dyn_sys.B_c, dyn_sys.d_c, dt)
            Q = as_tensor(cost.Q, A_d.dtype, A_d.device)
            R_fb = cost.R if feedback_R is None else feedback_R
            R_fb = np.asarray(R_fb, float)
            if R_fb.ndim == 0:     # scalar knob => R * I, sized from the
                # input dimension, not cost.R (which may itself be scalar)
                R_fb = float(R_fb) * np.eye(int(B_d.shape[-1]))
            R = as_tensor(R_fb, A_d.dtype, A_d.device)
            K, _ = dare(A_d, B_d, Q, R)
            self.K = to_numpy(K)

    def set_service(self, service):
        self.GuSTO = service

    def compute_policy(self, t_step, x_belief):
        """(tpwl/controllers.py:248-274)"""
        if not self.initialized:
            self.run_GuSTO(t_step, x_belief, wait=True)
            self.update_policy(init=True)
            self.initialized = True
        else:
            self.update_policy()
        # request the solve for the next window, starting at the plan's end
        self.t_next_solve = round(float(self.t_opt[-1]), 6)
        x0 = x_belief if self.mpc else self.x_opt[-1, :]
        self.run_GuSTO(self.t_opt[-1], x0, wait=self.wait)

    def run_GuSTO(self, t0, x0, wait):
        self.GuSTO.send_request(t0, _host(x0), wait=wait)

    def recompute_policy(self, t_step):
        return round(t_step, 4) >= round(self.t_next_solve, 4)

    def update_policy(self, init=False):
        """Splice the newest horizon into the global plan
        (tpwl/controllers.py:288-324)."""
        self._splice(init)

    def compute_input(self, t_step, x_belief):
        """u = u_bar(t) + K_nearest (x_belief - x_bar(t))
        (tpwl/controllers.py:326-333)."""
        self.GuSTO.force_spin()
        u_bar = _interp_rows(np.asarray([t_step]), self.t_opt, self.u_opt)[0]
        if self.K is None:
            return u_bar
        x_bar = _interp_rows(np.asarray([t_step]), self.t_opt, self.x_opt)[0]
        i_near = int(self.dyn_sys.calc_nearest_point(
            as_tensor(x_bar, torch.float64, self.dyn_sys.device)))
        u = u_bar + self.K[i_near] @ (_host(x_belief) - x_bar)
        return u

    def save_controller_info(self):
        return {
            "t_opt": self.t_opt, "u_opt": self.u_opt,
            "z_opt": _plan_outputs(self.dyn_sys, self.x_opt, zf=True),
            "solve_times": self.solve_times,
            "rollout_time": self.N_replan * self.dt,
            "z_rollout": self.z_opt_horizon, "t_rollout": self.t_opt_horizon,
        }


class scp_ssm(_Splice, TemplateController):
    """SSM SCP MPC: manifold observer and feedforward-only control
    (SSM/controllers.py:140-250)."""

    def __init__(self, dyn_sys, cost, dt, N_replan=None, delay=2, u0=None,
                 wait=True, solver_service=None, Y=None, **kwargs):
        super().__init__(dyn_sys, None, dt=dt,
                         observer=SSMObserver(dyn_sys), delay=delay, u0=u0)
        self.N_replan = N_replan if N_replan is not None else 1
        self.t_opt = None
        self.u_opt = None
        self.x_opt = None
        self.wait = wait
        self.initialized = False
        self.solve_times = []
        self.z_opt_horizon = []
        self.t_opt_horizon = []
        self.cost = cost
        self.GuSTO = solver_service
        self.Y = Y

    def set_service(self, service):
        self.GuSTO = service

    def evaluate(self, sim_time, y, x, u_prev):
        """Adds the measurement-polyhedron reprojection
        (SSM/controllers.py:96-97) before the standard tick."""
        m = self.dyn_sys
        if self.Y is not None:
            y = as_tensor(y, m.dtype, m.device)
            if not bool(self.Y.contains(y)):
                y = self.Y.project(y)
        sim_time = round(sim_time, 4)
        self.observer.update(None, y, None)
        if round(sim_time, 4) < round(self.t_delay, 4):
            self.u = self.u0
        else:
            if round(sim_time - self.t_delay, 4) >= round(self.t_compute, 4):
                if self.recompute_policy(self.t_compute):
                    self.compute_policy(self.t_compute, self.observer.x)
                self.u = self.compute_input(self.t_compute, self.observer.x)
                self.t_compute = round(self.t_compute + self.dt, 4)
        self.u = np.atleast_1d(_host(self.u))
        return self.u.copy()

    def recompute_policy(self, t_step):
        """Replan every N_replan controller steps (SSM/controllers.py:
        188-191)."""
        step = round(round(t_step, 4) / self.dt)
        return int(step % self.N_replan) == 0

    def compute_policy(self, t_step, x_belief):
        if not self.initialized:
            self.GuSTO.send_request(t_step, _host(x_belief), wait=True)
            self.update_policy(init=True)
            self.initialized = True
        else:
            self.GuSTO.send_request(t_step, _host(x_belief), wait=self.wait)
            self.update_policy()

    def update_policy(self, init=False):
        self._splice(init, zf=False)

    def compute_input(self, t_step, x_belief):
        """Feedforward only (SSM/controllers.py:235-239)."""
        self.GuSTO.force_spin()
        return _interp_rows(np.asarray([t_step]), self.t_opt, self.u_opt)[0]

    def save_controller_info(self):
        m = self.dyn_sys
        return {
            "t_opt": self.t_opt, "u_opt": self.u_opt,
            "z_opt": to_numpy(m.x_to_zfyf(as_tensor(self.x_opt, m.dtype,
                                                     m.device))),
            "solve_times": self.solve_times,
            "rollout_time": self.N_replan * self.dt,
            "z_rollout": self.z_opt_horizon, "t_rollout": self.t_opt_horizon,
        }
