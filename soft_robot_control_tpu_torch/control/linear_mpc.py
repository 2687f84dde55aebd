"""Linear time-invariant MPC service (trust region off).

The LOCP with constant (A_d, B_d, d_d) over the horizon and no trust
region, behind the same client contract as GuSTOService (send_request /
check_if_done / force_wait / get_solution); the Koopman and ROMPC
controllers use it. When a solve is not accepted the previous plan is
extended by repeating its last step.

With the condensed backend each solve is one function on the device: the
dynamics and the target trajectory are on the device once, the horizon's
targets are interpolated there, and the result comes back as one packed
vector [x | u | residual stats]. Its QP solver (`qp_backend`, the JAX
package's names):
- 'xla': the adaptive dense ADMM, `solve_qp_dense`, to tolerance;
- 'pallas': a fixed budget of `qp_iters` iterations in `rho_stages` rho
  stages through the batched ADMM kernel at B=1 (`admm_staged_batched`,
  one launch a stage), after Ruiz equilibration; its residuals are
  measured afterwards in the unscaled space, so both backends face the
  same acceptance test.
The target is read onto the device at construction and again when
`service.target` is reassigned; changing the target object in place is not
seen.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from soft_robot_control_tpu_torch.control.service import (
    _interp_rows_fill, start_on_caller_stream)
from soft_robot_control_tpu_torch.qp.admm import accepted
from soft_robot_control_tpu_torch.utils.device import to_numpy


def interp(x, xp, fp):
    """jnp.interp along the first axis of fp (K, C) at the points x (Q,):
    linear between the knots xp (K,), constant fp[0] / fp[-1] beyond the
    ends. Returns (Q, C)."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(torch.finfo(xp.dtype).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0[:, None], fp[i - 1], fp[i - 1] + (
        delta / torch.where(dx0, torch.ones_like(dx), dx))[:, None] * df)
    f = torch.where((x < xp[0])[:, None], fp[0], f)
    return torch.where((x > xp[-1])[:, None], fp[-1], f)


class LinearMPCService:
    """Persistent linear MPC solver with the ROS-node semantics, on the
    model's device (or `device=`)."""

    def __init__(self, model, N, dt, cost_params, target, U=None, X=None,
                 Xf=None, dU=None, verbose=0, warm_start=True, **kwargs):
        from soft_robot_control_tpu_torch.utils.device import resolve_device

        self.model = model
        self.N = N
        self.dt = dt
        self._target = target
        self.cost_params = cost_params
        self.verbose = verbose
        self.device = resolve_device(
            kwargs.pop("device", getattr(model, "device", "cuda")))
        self._qp_backend = kwargs.pop("qp_backend", "xla")
        if self._qp_backend not in ("xla", "pallas"):
            raise ValueError(f"unknown qp_backend {self._qp_backend!r}")
        self._qp_iters = int(kwargs.pop("qp_iters", 150))
        self._rho_stages = int(kwargs.pop("rho_stages", 4))
        locp_backend = kwargs.pop("locp_backend", "dense")
        Q, R = to_numpy(cost_params.Q), to_numpy(cost_params.R)
        Qf = None if cost_params.Qf is None else to_numpy(cost_params.Qf)
        if locp_backend == "condensed":
            from soft_robot_control_tpu_torch.scp.locp_condensed import (
                CondensedLOCPAdapter)

            self.locp = CondensedLOCPAdapter(
                N, model.H, Q, R, Qzf=Qf, U=U, X=X, Xf=Xf, dU=dU,
                warm_start=warm_start, is_tr_active=False,
                device=self.device, **kwargs)
        else:
            from soft_robot_control_tpu_torch.scp.locp import LOCP

            self.locp = LOCP(N, model.H, Q, R, Qzf=Qf, U=U, X=X, Xf=Xf,
                             dU=dU, verbose=(verbose == 2),
                             warm_start=warm_start, is_tr_active=False,
                             device=self.device, **kwargs)

        A_d = to_numpy(model.A_d)
        n = A_d.shape[0]
        self.A_d = np.tile(A_d, (N, 1, 1))
        self.B_d = np.tile(to_numpy(model.B_d), (N, 1, 1))
        d = (to_numpy(model.d_d).reshape(-1) if getattr(model, "d_d", None)
             is not None else np.zeros(n))
        self.d_d = np.tile(d, (N, 1))

        self.xopt = None
        self.uopt = None
        self.topt = self.dt * np.arange(self.N + 1)
        self.t_solve = 0.0
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

        self._fused = None
        self._warm = bool(warm_start)
        self._fused_backend = locp_backend == "condensed"
        if self._fused_backend:
            self._setup_fused()

    @property
    def target(self):
        return self._target

    @target.setter
    def target(self, new_target):
        """Reassigning the target rebuilds the fused path's device copy."""
        self._target = new_target
        if self._fused_backend:
            self._setup_fused()

    def _setup_fused(self):
        """(Re)build the fused step from the current target, and run it
        once (the kernels build and load before the first query)."""
        from soft_robot_control_tpu_torch.qp.admm import (kkt_residuals,
                                                          solve_qp_dense)
        from soft_robot_control_tpu_torch.scp.locp_condensed import (
            CondensedParams)

        target = self._target
        spec = self.locp.spec
        sdt, dev = spec.dtype, self.device
        N_, nx, nz, nu = spec.N, spec.n_x, spec.n_z, spec.n_u
        t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=sdt,
                                      device=dev)
        Ad_c, Bd_c, dd_c = t(self.A_d)[None], t(self.B_d)[None], t(self.d_d)[None]
        skw = dict(self.locp.solver_kwargs)
        has_Qzf = self.cost_params.Qf is not None

        # the target on the device over its time grid; times offset by
        # t[0] in float64 before the cast, so that a long absolute time
        # axis keeps its resolution in float32
        self._t_off = (float(np.asarray(target.t).reshape(-1)[0])
                       if getattr(target, "t", None) is not None else 0.0)
        tz = z_dev = tu = u_dev = z_const = u_const = None
        if target.z is not None:
            if np.asarray(target.z).ndim == 2:
                tz = t(np.asarray(target.t, float) - self._t_off)
                z_dev = t(target.z)
            else:
                z_const = t(target.z)
        if target.u is not None:
            if np.asarray(target.u).ndim == 2:
                tu = t(np.asarray(target.t, float) - self._t_off)
                u_dev = t(target.u)
            else:
                u_const = t(target.u)
        steps = torch.arange(N_ + 1, dtype=sdt, device=dev)
        dt_c = torch.as_tensor(self.dt, dtype=sdt, device=dev)

        def window(t0):
            tq = t0 + dt_c * steps
            if z_dev is not None:
                z = interp(tq, tz, z_dev)
            elif z_const is not None:
                z = z_const.expand(N_ + 1, -1)
            else:
                z = torch.zeros((N_ + 1, nz), dtype=sdt, device=dev)
            if u_dev is not None:
                u = interp(tq[:-1], tu, u_dev)
            elif u_const is not None:
                u = u_const.expand(N_, -1)
            else:
                u = torch.zeros((N_, nu), dtype=sdt, device=dev)
            zf = z[-1] if has_Qzf else torch.zeros(nz, dtype=sdt, device=dev)
            return z, zf, u

        qp_backend = self._qp_backend
        qp_iters, rho_stages = self._qp_iters, self._rho_stages

        def step(t0, x0, w0, y0):
            z, zf, u_des = window(t0)
            P, q, A, l, ub, const, xfree, G = spec.assemble(CondensedParams(
                Ad=Ad_c, Bd=Bd_c, dd=dd_c, x0=x0[None], z=z[None],
                u_des=u_des[None], zf=zf[None]))
            if qp_backend == "pallas":
                w, y = _solve_pallas(P, q, A, l, ub, w0, y0,
                                     skw.get("rho", 0.1), qp_iters,
                                     rho_stages)
                stats = torch.cat(kkt_residuals(
                    P, q, A, l, ub, w[None], y[None])
                    + (torch.zeros(1, dtype=sdt, device=dev),))
            else:
                sol = solve_qp_dense(P[0], q[0], A[0], l[0], ub[0], x0=w0,
                                     y0=y0, **skw)
                w, y = sol.x, sol.y
                stats = torch.stack([sol.pri_res, sol.dua_res, sol.pri_sc,
                                     sol.dua_sc, torch.as_tensor(
                                         float(sol.solved), dtype=sdt,
                                         device=dev)])
            x_opt = spec.recover_x(xfree, G, w[None])[0]
            flat = torch.cat([x_opt.reshape(-1), w[:N_ * nu], stats])
            return flat, w, y

        self._fused_fn = step
        self._w = torch.zeros(spec.n_var, dtype=sdt, device=dev)
        self._y = torch.zeros(spec.n_con, dtype=sdt, device=dev)
        step(torch.zeros((), dtype=sdt, device=dev),
             torch.zeros(nx, dtype=sdt, device=dev), self._w, self._y)
        self._fused = True

    def get_target(self, t0):
        """(z, zf, u) over the horizon, interpolated on the host."""
        tq = t0 + self.dt * np.arange(self.N + 1)
        tgt = self.target
        z = None
        if tgt.z is not None:
            z_arr = np.asarray(tgt.z, float)
            if z_arr.ndim == 2:
                z = _interp_rows_fill(tq, tgt.t, z_arr)
            else:
                z = np.tile(z_arr, (self.N + 1, 1))
        zf = z[-1, :] if (self.cost_params.Qf is not None and z is not None) else None
        u = None
        if tgt.u is not None:
            u_arr = np.asarray(tgt.u, float)
            if u_arr.ndim == 2:
                u = _interp_rows_fill(tq[:-1], tgt.t, u_arr)
            else:
                u = np.tile(u_arr, (self.N, 1))
        return z, zf, u

    def _solve(self, t0, x0):
        if self._fused:
            self._solve_fused(t0, x0)
            return
        self._solve_host(t0, x0)

    def _solve_host(self, t0, x0):
        z, zf, u = self.get_target(t0)
        xk = np.zeros((self.N + 1, self.locp.spec.n_x))
        self.locp.update(self.A_d, self.B_d, self.d_d, np.asarray(x0, float),
                         xk, 0.0, 0.0, z=z, zf=zf, u=u)
        Jstar, success, _ = self.locp.solve()
        with self._lock:
            if success:
                self.xopt, self.uopt, _ = self.locp.get_solution()
            elif self.xopt is not None:
                # extend the previous plan
                self.xopt = np.concatenate((self.xopt[1:], self.xopt[-1:]), axis=0)
                self.uopt = np.concatenate((self.uopt[1:], self.uopt[-1:]), axis=0)
            else:
                raise RuntimeError("first linear MPC solve failed")
            self.t_solve = self.locp.solve_time
            self.topt = t0 + self.dt * np.arange(self.N + 1)

    def _solve_fused(self, t0, x0):
        spec = self.locp.spec
        sdt = spec.dtype
        N_, nx, nu = spec.N, spec.n_x, spec.n_u
        fallback = False
        t_s = time.time()
        # the offset in host float64 before the cast (see _setup_fused)
        flat, w, y = self._fused_fn(
            torch.as_tensor(float(t0) - self._t_off, dtype=sdt,
                            device=self.device),
            torch.as_tensor(np.asarray(x0, float), dtype=sdt,
                            device=self.device),
            self._w, self._y)
        flat = to_numpy(flat).astype(float)  # the one read of the result
        nX = (N_ + 1) * nx
        x_opt = flat[:nX].reshape(N_ + 1, nx)
        u_opt = flat[nX:nX + N_ * nu].reshape(N_, nu)
        st = flat[nX + N_ * nu:]
        success, pri_rel, dua_rel = accepted(st[4], *st[:4], sdt)
        with self._lock:
            if success:
                self.xopt = x_opt
                self.uopt = u_opt
                if self._warm:
                    self._w, self._y = w, y
            elif self.xopt is not None:
                print(f"linear MPC fused solve not accepted (pri_rel "
                      f"{pri_rel:.2e}, dua_rel {dua_rel:.2e}); "
                      "extending previous plan")
                self.xopt = np.concatenate((self.xopt[1:], self.xopt[-1:]),
                                           axis=0)
                self.uopt = np.concatenate((self.uopt[1:], self.uopt[-1:]),
                                           axis=0)
                self._w = torch.zeros_like(self._w)
                self._y = torch.zeros_like(self._y)
            else:
                # no plan to extend yet: this first query goes to the
                # adapter's adaptive solve (a fixed budget can miss tight
                # tolerances on a hard cold start)
                print(f"linear MPC fused FIRST solve not accepted (pri_rel "
                      f"{pri_rel:.2e}, dua_rel {dua_rel:.2e}); "
                      "solving it with the adaptive host adapter")
                fallback = True
            self.t_solve = time.time() - t_s
            self.topt = t0 + self.dt * np.arange(self.N + 1)
        if fallback:
            self._solve_host(t0, x0)

    # client API -----------------------------------------------------------
    def send_request(self, t0, x0, wait=True):
        if wait:
            self._solve(t0, x0)
        else:
            self._thread = start_on_caller_stream(self.device, self._solve,
                                                  (t0, x0))

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
                    self.t_solve)


def _solve_pallas(P, q, A, l, ub, w0, y0, rho, iters, stages):
    """One QP (batch axis 1 on P..ub) through Ruiz equilibration and the
    staged batched ADMM kernel at B=1: (w, y) unscaled."""
    from soft_robot_control_tpu_torch.control.batch_mpc import (
        admm_staged_batched, equilibrate_qp)

    Ps, qs, As, ls, us, w0s, y0s, (d_s, e_s, c_s) = equilibrate_qp(
        P, q, A, l, ub, w0[None], y0[None], 6)
    rho0 = torch.full((As.shape[1],), rho, dtype=q.dtype, device=q.device)
    w_b, y_b = admm_staged_batched(Ps, qs, As, ls, us, w0s, y0s, rho0,
                                   iters, stages)
    return d_s[0] * w_b[0], e_s[0] * y_b[0] / c_s[0]


def run_linear_mpc(model, N, dt, cost_params, x0, target, U=None, X=None,
                   Xf=None, dU=None, verbose=0, warm_start=True, **kwargs):
    """One synchronous solve: (x, u, z, t) of the plan from x0 at t=0."""
    svc = LinearMPCService(model, N, dt, cost_params, target, U=U, X=X,
                           Xf=Xf, dU=dU, verbose=verbose,
                           warm_start=warm_start, **kwargs)
    svc.send_request(0.0, x0, wait=True)
    t, u, x, _ = svc.get_solution()
    z = x @ to_numpy(model.H).T
    return x, u, z, t
