"""In-process GuSTO solver service, the reference's ROS2 GuSTO node
replacement, with its client contract:

- `send_request(t0, x0, wait=False)` starts a solve, optionally on a
  background thread that overlaps the caller's simulation work (the thread
  issues its device work on the caller's CUDA stream);
- `check_if_done()` / `force_wait()` poll / block on the running solve;
- `get_solution(n_x, n_u)` returns (t, u, x, solve_time) of the last solve.

Targets are interpolated at t0 + dt*arange(N+1) with boundary fill, and
the previous solution, shifted in time, is the initial guess
(GuSTOSolverNode.gusto_callback semantics).
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from soft_robot_control_tpu_torch.scp.gusto import GuSTO
from soft_robot_control_tpu_torch.utils.device import to_numpy


def _interp_rows_fill(tq, t, Y):
    """Row-wise interpolation with boundary fill (interp1d fill_value=
    (Y[0], Y[-1]))."""
    t = np.asarray(t, float)
    Y = np.asarray(Y, float)
    return np.stack([np.interp(tq, t, Y[:, j]) for j in range(Y.shape[1])],
                    axis=1)


def start_on_caller_stream(device, fn, args):
    """A daemon thread running fn(*args) whose CUDA work goes to the stream
    that is current for the calling thread (on a CPU device, just the
    thread)."""
    device = torch.device(device)
    stream = (torch.cuda.current_stream(device) if device.type == "cuda"
              else None)

    def run():
        if stream is None:
            fn(*args)
            return
        with torch.cuda.stream(stream):
            fn(*args)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th


class GuSTOService:
    """Persistent GuSTO solver with target interpolation and warm starts,
    on the model's device."""

    def __init__(self, model, N, dt, Qz, R, x0, t=None, z=None, u=None,
                 Qzf=None, zf=None, U=None, X=None, Xf=None, dU=None,
                 verbose=0, warm_start=True, **kwargs):
        self.model = model
        self.N = N
        self.dt = dt
        self.Qzf = Qzf
        self.t = None if t is None else np.asarray(t, float)
        self.z = None if z is None else np.asarray(z, float)
        self.u = None if u is None else np.asarray(u, float)

        x_char, f_char = model.get_characteristic_vals()

        u_init = np.zeros((N, model.n_u))
        res = model.rollout(np.asarray(x0, float), u_init, dt)
        x_init = to_numpy(res[0] if isinstance(res, tuple) else res).astype(float)
        z0, zf0, u0 = self.get_target(0.0)
        self.gusto = GuSTO(model, N, dt, Qz, R, np.asarray(x0, float), u_init,
                           x_init, z=z0, u=u0, Qzf=Qzf, zf=zf0, U=U, X=X,
                           Xf=Xf, dU=dU, verbose=verbose,
                           warm_start=warm_start, x_char=x_char,
                           f_char=f_char, **kwargs)
        self.xopt, self.uopt, _, _ = self.gusto.get_solution()
        self.topt = self.dt * np.arange(self.N + 1)

        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def get_target(self, t0):
        """Interpolated (z, zf, u) over the solver horizon."""
        tq = t0 + self.dt * np.arange(self.N + 1)
        z = None
        if self.z is not None:
            if self.z.ndim == 2:
                z = _interp_rows_fill(tq, self.t, self.z)
            else:
                z = np.tile(self.z, (self.N + 1, 1))
        zf = z[-1, :] if (self.Qzf is not None and z is not None) else None
        u = None
        if self.u is not None:
            if self.u.ndim == 2:
                u = _interp_rows_fill(tq[:-1], self.t, self.u)
            else:
                u = np.tile(self.u, (self.N, 1))
        return z, zf, u

    def _solve(self, t0, x0):
        z, zf, u = self.get_target(t0)
        # warm start: the previous solution shifted to t0
        idx0 = int(np.argwhere(self.topt >= t0 - 1e-9)[0, 0]) \
            if np.any(self.topt >= t0 - 1e-9) else self.N
        u_init = np.repeat(self.uopt[-1:, :], self.N, axis=0)
        u_init[0:self.N - idx0] = self.uopt[idx0:, :]
        x_init = np.repeat(self.xopt[-1:, :], self.N + 1, axis=0)
        x_init[0:self.N + 1 - idx0] = self.xopt[idx0:, :]

        self.gusto.solve(np.asarray(x0, float), u_init, x_init, z=z, zf=zf, u=u)
        with self._lock:
            self.xopt, self.uopt, self.zopt, self.t_solve = self.gusto.get_solution()
            self.topt = t0 + self.dt * np.arange(self.N + 1)

    # client API ----------------------------------------------------------
    def send_request(self, t0, x0, wait=True):
        if wait:
            self._solve(t0, x0)
        else:
            self._thread = start_on_caller_stream(self.gusto.device,
                                                  self._solve, (t0, x0))

    def check_if_done(self):
        return self._thread is None or not self._thread.is_alive()

    def force_wait(self):
        if self._thread is not None:
            self._thread.join()

    def force_spin(self):
        pass

    def get_solution(self, n_x=None, n_u=None):
        self.force_wait()
        with self._lock:
            return (self.topt.copy(), self.uopt.copy(), self.xopt.copy(),
                    self.gusto.locp_solve_time)
