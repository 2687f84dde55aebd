"""Online control policies implementing the `evaluate(t, y, x, u_prev)`
contract of the closed-loop harness (sofacontrol/tpwl/controllers.py):
TemplateController (delay window, controller-dt scheduling on a rounded
t_compute grid, observer update every simulation tick), ilqr,
TrajTracking, StateDLQR, StateCLQR and OpenLoop. The receding-horizon
`scp` controllers live in control/mpc.py.

Measurements and plant states arrive as tensors (or arrays); the policies'
plans and gains are numpy arrays on the host, as in the JAX package, and
the commands they return are numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from soft_robot_control_tpu_torch.estimators.full_state import (
    FullStateObserver)
from soft_robot_control_tpu_torch.lqr.ilqr import iLQR
from soft_robot_control_tpu_torch.lqr.riccati import care, solve_riccati
from soft_robot_control_tpu_torch.lqr.tvlqr import (TrajTrackingLQR,
                                                    tv_lqr_backward)
from soft_robot_control_tpu_torch.utils.device import as_tensor, to_numpy


def _interp_rows(tq, t, Y):
    """np.interp of every column of Y (K, C) from the knots t (K,) at the
    points tq (Q,): (Q, C), constant beyond the ends."""
    t = np.asarray(t, float)
    Y = np.asarray(Y, float)
    return np.stack([np.interp(tq, t, Y[:, j]) for j in range(Y.shape[1])],
                    axis=1)


def _host(x):
    """A state or command as a float64 numpy array."""
    return np.asarray(to_numpy(x), float)


class TemplateController:
    """Timing/observer scaffold (tpwl/controllers.py:17-132)."""

    def __init__(self, dyn_sys, cost_params, dt=0.01, observer=None, delay=2,
                 u0=None):
        self.dyn_sys = dyn_sys
        self.dt = dt
        self.input_dim = dyn_sys.get_input_dim()
        self.state_dim = dyn_sys.get_state_dim()
        self.cost_params = cost_params
        if observer is not None:
            self.observer = observer
        else:
            self.observer = FullStateObserver(self.state_dim, dyn_sys.H)
        self.t_delay = delay
        self.u0 = np.zeros(self.input_dim) if u0 is None else np.asarray(u0, float)
        self.t_compute = 0.0
        self.u = self.u0
        self.sim_dt = None

    def set_sim_timestep(self, dt):
        self.sim_dt = dt

    def recompute_policy(self, t_step):
        return t_step == 0

    def compute_policy(self, t_step, x_belief):
        raise NotImplementedError

    def compute_input(self, t_step, x_belief):
        raise NotImplementedError

    def evaluate(self, sim_time, y, x, u_prev):
        """One controller tick (tpwl/controllers.py:85-117 semantics,
        including the round(., 4) scheduling grid). The full state x is
        projected onto the ROM every tick, on the ROM's device."""
        sim_time = round(sim_time, 4)
        x_actual = self.dyn_sys.rom.project_x(as_tensor(x)) \
            if hasattr(self.dyn_sys, "rom") else x
        self.observer.update(u_prev, y, self.sim_dt, x=x_actual)

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

    def save_controller_info(self):
        info = {"cost_params": self.cost_params}
        if self.observer is not None and hasattr(self.observer, "get_observer_params"):
            info["observer_params"] = self.observer.get_observer_params()
        if self.dyn_sys is not None:
            info["dyn_sys_params"] = self.dyn_sys.get_sim_params()
            info["state_dim"] = self.dyn_sys.get_state_dim()
            info["input_dim"] = self.dyn_sys.get_input_dim()
        return info


class ilqr(TemplateController):
    """Single-shot iLQR policy with time-varying feedback
    (tpwl/controllers.py:135-206)."""

    def __init__(self, dyn_sys, cost_params, target, dt=0.01, observer=None,
                 delay=2.0, u0=None, feedback_R=None, **kwargs):
        super().__init__(dyn_sys, cost_params, dt=dt, observer=observer,
                         delay=delay, u0=u0)
        self.target = target
        # feedback_R decouples the planning input cost from the feedback
        # gains: with it set, K is recomputed along the converged
        # (x_bar, u_bar) by a tracking-LQR backward pass at that R (cheap-R
        # gains amplify model error into saturation on the plant);
        # feedback_R=np.inf gives the pure-feedforward replay
        self.feedback_R = feedback_R
        self.setpoint_reaching = True
        self.validate_problem()
        tf = kwargs.get("tf") if self.setpoint_reaching else float(np.asarray(target.t)[-1])
        if tf is None:
            raise RuntimeError("Final time not set for single-shooting ilqr")
        self.final_time = tf
        self.planning_horizon = int(self.final_time / self.dt)
        self.policy = iLQR(dt=self.dt, model=dyn_sys, cost_params=cost_params,
                           planning_horizon=self.planning_horizon,
                           config=kwargs.get("config"))
        self.x_bar = None
        self.u_bar = None
        self.K = None

    def validate_problem(self):
        t = self.target
        assert t.z is not None and t.Hf is not None
        assert np.asarray(t.Hf).shape[0] == np.asarray(t.z).shape[-1]
        if np.asarray(t.z).ndim == 2:
            self.setpoint_reaching = False
        out_dim = self.dyn_sys.get_output_dim()
        if self.setpoint_reaching:
            assert np.shape(self.cost_params.Qf) == (out_dim, out_dim)
        assert np.shape(self.cost_params.Q) == (out_dim, out_dim)
        assert np.shape(self.cost_params.R) == (self.input_dim, self.input_dim)

    def compute_policy(self, t_step, x_belief):
        z = np.asarray(self.target.z, float)
        if self.setpoint_reaching:
            z_target = np.tile(z, (self.planning_horizon + 1, 1))
        else:
            tq = np.linspace(0, self.final_time, self.planning_horizon + 1)
            z_target = _interp_rows(tq, self.target.t, z)
        self.policy.set_target(z_target)
        self.x_bar, self.u_bar, self.K = self.policy.ilqr_computation(
            _host(x_belief))
        if self.feedback_R is not None:
            R_fb = np.asarray(self.feedback_R, float)
            if R_fb.ndim == 0 and not np.isfinite(R_fb):
                self.K = np.zeros_like(np.asarray(self.K))
                return
            if R_fb.ndim == 0:
                R_fb = float(R_fb) * np.eye(self.input_dim)
            # the Jacobians along the plan in one call
            H = self.dyn_sys.H
            t = lambda a: as_tensor(a, H.dtype, H.device)
            A, B, _ = self.dyn_sys.get_jacobians(
                t(self.x_bar[:-1]), u=t(self.u_bar), dt=self.dt)
            Hn = to_numpy(H).astype(float)
            Qx = Hn.T @ np.asarray(self.cost_params.Q, float) @ Hn
            K, _ = tv_lqr_backward(A, B, Qx, R_fb)
            self.K = to_numpy(K)

    def compute_input(self, t_step, x_belief):
        if t_step > self.final_time:
            self.u = self.u0
        else:
            step = min(int(t_step / self.dt), self.planning_horizon - 1)
            self.u = self.u_bar[step] + self.K[step] @ (
                _host(x_belief) - self.x_bar[step])
        return self.u


class TrajTracking(TemplateController):
    """Offline finite-horizon tracking LQR (tpwl/controllers.py:349-395)."""

    def __init__(self, dyn_sys, cost_params, target, dt=0.01, observer=None,
                 delay=2.0, u0=None, **kwargs):
        super().__init__(dyn_sys, cost_params, dt=dt, observer=observer,
                         delay=delay, u0=u0)
        self.target = target
        self.validate_problem()
        self.final_time = float(np.asarray(target.t)[-1])
        self.policy = TrajTrackingLQR(dt=dt, model=dyn_sys,
                                      cost_params=cost_params)
        x_bar, u_bar, K = self.policy.compute_policy(target)
        self.x_bar, self.u_bar, self.K = (_host(x_bar), _host(u_bar),
                                          _host(K))

    def validate_problem(self):
        t = self.target
        assert t.x is not None and t.u is not None and t.t is not None
        assert np.asarray(t.x).ndim == 2 and np.asarray(t.u).ndim == 2
        assert np.asarray(t.u).shape[-1] == self.input_dim
        assert np.asarray(t.x).shape[-1] == self.state_dim
        assert np.shape(self.cost_params.Q) == (self.state_dim, self.state_dim)
        assert np.shape(self.cost_params.R) == (self.input_dim, self.input_dim)

    def compute_policy(self, t_step, x_belief):
        pass

    def compute_input(self, t_step, x_belief):
        if t_step > self.final_time:
            self.u = self.u0
        else:
            step = min(int(t_step / self.dt), len(self.K) - 1)
            self.u = np.atleast_1d(
                self.u_bar[step] + self.K[step] @ (_host(x_belief)
                                                   - self.x_bar[step]))
        return self.u


class StateDLQR(TemplateController):
    """Infinite-horizon discrete LQR setpoint regulation
    (tpwl/controllers.py:398-437); the gain from the fixed-point DARE on
    the model's device."""

    def __init__(self, dyn_sys, cost_params, target, dt=0.01, observer=None,
                 delay=2, u0=None, **kwargs):
        super().__init__(dyn_sys, cost_params, dt=dt, observer=observer,
                         delay=delay, u0=u0)
        self.target = target
        self.validate_problem()
        self.x_bar = np.asarray(target.x, float)
        self.u_bar = np.atleast_1d(np.asarray(target.u, float))
        self.K = self._gain(np.asarray(target.A, float),
                            np.asarray(target.B, float))

    def _t(self, a):
        return as_tensor(a, torch.float64, self.dyn_sys.device)

    def _gain(self, A, B):
        A_d, B_d, _ = self.dyn_sys.discretize_dynamics(
            self._t(A), self._t(B), self._t(np.zeros(self.state_dim)),
            self.dt)
        K, _ = solve_riccati(A_d, B_d, self._t(self.cost_params.Q),
                             self._t(self.cost_params.R))
        return to_numpy(K)

    def validate_problem(self):
        t = self.target
        assert t.A is not None and t.B is not None and t.u is not None \
            and t.x is not None
        assert np.asarray(t.A).shape == (self.state_dim, self.state_dim)
        assert np.asarray(t.B).shape == (self.state_dim, self.input_dim)
        assert np.shape(self.cost_params.Q) == (self.state_dim, self.state_dim)
        assert np.shape(self.cost_params.R) == (self.input_dim, self.input_dim)

    def compute_policy(self, t_step, x_belief):
        pass

    def compute_input(self, t_step, x_belief):
        self.u = self.u_bar + self.K @ (_host(x_belief) - self.x_bar)
        return self.u


class StateCLQR(StateDLQR):
    """Continuous-time infinite-horizon LQR (tpwl/controllers.py:440-444),
    the gain from the in-repo CARE solver."""

    def _gain(self, A, B):
        K, _ = care(self._t(A), self._t(B), self._t(self.cost_params.Q),
                    self._t(self.cost_params.R))
        return to_numpy(K)


class OpenLoop:
    """Open-loop input replay with optional observer
    (tpwl/controllers.py:447-489, open_loop_controller.py:208-241)."""

    def __init__(self, m, t_sequence, u_sequence, save_sequence, delay=1):
        self.m = m
        self.t_seq = np.asarray(t_sequence, float)
        u = self.convert_u_standard_form(np.asarray(u_sequence, float))
        self.u_seq = u.T  # (T, m)
        self.save_seq = save_sequence
        self.observer = None
        self.u = np.zeros(m)
        self.delay = delay
        self.sim_dt = None

    def convert_u_standard_form(self, u):
        """Coerce a control sequence to (m, T) standard form, transposing a
        (T, m) input and zeroing out malformed shapes with a warning
        (open_loop_controller.py:242-254 semantics)."""
        if u.ndim == 1:
            u = u.reshape(1, -1)
        if u.shape[0] != self.m and u.shape[1] == self.m:
            u = u.T
        elif u.shape[0] != self.m and u.shape[1] != self.m:
            print(f"Control sequence ({u.shape[0]} x {u.shape[1]}) does not "
                  f"specify proper number of inputs ({self.m} x -)")
            print("Setting control to zero")
            u = np.zeros((self.m, 1))
        return u

    def add_observer(self, observer):
        self.observer = observer

    def set_sim_timestep(self, dt):
        self.sim_dt = dt

    def evaluate(self, t, y, x, u_prev):
        if self.observer is not None:
            self.observer.update(self.u, y, self.sim_dt, x=x)
        t_compute = t - self.delay
        if t_compute < 0 or t_compute >= self.t_seq[-1]:
            self.u = np.zeros(self.m)
        else:
            # the reference replays at simulation time t, not t - delay
            # (tpwl/controllers.py:486)
            self.u = _interp_rows(np.asarray([t]), self.t_seq, self.u_seq)[0]
        return self.u.copy()
