"""GuSTO: trust-region sequential convex programming, host loop.

Semantics of the JAX package's scp/gusto.py, with the reference's three
modifications to vanilla GuSTO:
1. if (delta, omega) were constant for two accepted solves but the QP cost
   increased, shrink delta;
2. no delta growth on good model accuracy;
3. no omega decrease when state constraints are satisfied.

The trajectory is linearized in one batched call of the model adapter (on a
TPWL model, one launch of the select kernel for all N states); the LOCP is
assembled and solved on the model's device. The outer loop runs on the
host: its iteration count is small and data-dependent. Three faster modes
replace it where the configuration allows:
- the one-shot path (max_gusto_iters=0, condensed backend, no trust
  region): one LOCP a query, gated on the QP's residuals and the Taylor
  accuracy ratio;
- device_tr=True: the whole trust-region loop through
  `GuSTOJit.solve_packed`, one packed result read a query;
- `GuSTOJit.solve_batch_fused` for batches (scp/gusto_jit.py).

Models with a nonlinear observer (the SSM adapter) wait for the SSM port.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from soft_robot_control_tpu_torch.qp.admm import accept_tolerances
from soft_robot_control_tpu_torch.utils.device import to_numpy

# Defaults of the reference (gusto.py:12-22)
DELTA0 = 1e4
OMEGA0 = 1.0
RHO = 0.1
BETA_FAIL = 0.5
BETA_SUCC = 2.0
EPSILON = 0.01
GAMMA_FAIL = 5.0
OMEGA_MAX = 1e10
MAX_ITERS = 500
CONVERGE = 0.1


@dataclass
class GuSTOParams:
    delta0: float = DELTA0
    omega0: float = OMEGA0
    rho: float = RHO
    beta_fail: float = BETA_FAIL
    beta_succ: float = BETA_SUCC
    gamma_fail: float = GAMMA_FAIL
    omega_max: float = OMEGA_MAX
    epsilon: float = EPSILON
    convg_thresh: float = CONVERGE
    max_gusto_iters: int = MAX_ITERS


class GuSTO:
    """Trust-region SCP solver over a model adapter (models/interfaces.py,
    models/dubins.py) on the adapter's device. Builds the LOCP once and
    solves at construction for the given initial guess, with up to
    MAX_ITERS iterations; later solves take `max_gusto_iters`."""

    def __init__(self, model, N, dt, Qz, R, x0, u_init, x_init, z=None, u=None,
                 Qzf=None, zf=None, U=None, X=None, Xf=None, dU=None,
                 verbose=0, warm_start=True, **kwargs):
        if getattr(model, "nonlinear_observer", False):
            raise NotImplementedError(
                "GuSTO with a nonlinear observer waits for the SSM port "
                "(ROADMAP.md, modules to port, item 11)")
        self.model = model
        self.device = model.device
        self.n_x = x0.shape[0]
        self.n_u = R.shape[0]
        self.n_z = Qz.shape[0]
        self.dt = dt
        self.N = N
        self.Qz, self.R, self.Qzf = Qz, R, Qzf
        self.U, self.X, self.Xf, self.dU = U, X, Xf, dU
        self.verbose = verbose
        self._H = to_numpy(model.H)

        p = GuSTOParams(
            delta0=kwargs.pop("delta0", DELTA0),
            omega0=kwargs.pop("omega0", OMEGA0),
            rho=kwargs.pop("rho", RHO),
            beta_fail=kwargs.pop("beta_fail", BETA_FAIL),
            beta_succ=kwargs.pop("beta_succ", BETA_SUCC),
            gamma_fail=kwargs.pop("gamma_fail", GAMMA_FAIL),
            omega_max=kwargs.pop("omega_max", OMEGA_MAX),
            epsilon=kwargs.pop("epsilon", EPSILON),
            convg_thresh=kwargs.pop("convg_thresh", CONVERGE),
            max_gusto_iters=MAX_ITERS,  # the first solve may take more
        )
        self.params = p
        max_iters_later = kwargs.pop("max_gusto_iters", MAX_ITERS)

        self.x_char = np.asarray(kwargs.pop("x_char", np.ones(self.n_x)), float)
        self.x_scale = 1.0 / np.abs(self.x_char)
        self.f_char = np.asarray(kwargs.pop("f_char", np.ones(self.n_x)), float)
        self.f_scale = 1.0 / np.abs(self.f_char)
        kwargs.pop("jit", None)
        # oneshot=False keeps the host loop in the real-time configuration
        self._use_oneshot = bool(kwargs.pop("oneshot", True))
        # rounds of relinearization inside one one-shot query
        self._oneshot_iters = max(1, int(kwargs.pop("oneshot_iters", 1)))
        # reject a plan whose planned output tail strays further than this
        # (inf-norm, output units) from the target, keeping the old plan
        self._plan_bound = kwargs.pop("plan_bound", None)
        # one-shot and device-loop acceptance thresholds (relative
        # residuals); by default the condensed adapter's f32/f64 gates
        self._accept_pri = kwargs.pop("accept_pri_rel", None)
        self._accept_dua = kwargs.pop("accept_dua_rel", None)
        # device_tr=True: the whole trust-region loop a query through
        # GuSTOJit (the reference's trust-region semantics, one result read)
        self._device_tr = bool(kwargs.pop("device_tr", False))
        self._device_tr_iters = int(kwargs.pop("device_tr_max_iters", 30))
        self._device_tr_qp_iters = int(kwargs.pop("device_tr_qp_iters", 400))
        self._device_tr_rho_qp = float(kwargs.pop("device_tr_rho_qp", 0.1))
        self._device_tr_qp_stages = int(kwargs.pop("device_tr_qp_stages", 4))

        locp_backend = kwargs.pop("locp_backend", "dense")
        if locp_backend == "condensed":
            # states eliminated exactly: N*nu + 1 variables
            if Qzf is not None or Xf is not None:
                raise NotImplementedError(
                    "condensed backend supports the no-terminal LOCP")
            from soft_robot_control_tpu_torch.scp.locp_condensed import (
                CondensedLOCPAdapter)

            self.locp = CondensedLOCPAdapter(
                N, model.H, Qz, R, U=U, X=X, dU=dU, x_char=self.x_char,
                warm_start=warm_start, device=self.device, **kwargs)
        elif locp_backend == "stage":
            raise NotImplementedError(
                "locp_backend='stage' (the stage-structured long-horizon "
                "LOCP) waits for ROADMAP.md, modules to port, item 13")
        else:
            from soft_robot_control_tpu_torch.scp.locp import LOCP

            self.locp = LOCP(N, model.H, Qz, R, Qzf=Qzf, U=U, X=X, Xf=Xf,
                             dU=dU, verbose=(verbose == 2),
                             warm_start=warm_start, x_char=self.x_char,
                             device=self.device, **kwargs)

        self._jit_tr = None
        if self._device_tr:
            if locp_backend != "condensed":
                raise NotImplementedError(
                    "device_tr requires locp_backend='condensed'")
            from soft_robot_control_tpu_torch.scp.gusto_jit import GuSTOJit

            self._jit_tr = GuSTOJit(
                model, N, dt, Qz, R, U=U, dU=dU, X=X,
                x_char=self.x_char, f_char=self.f_char,
                max_iters=self._device_tr_iters,
                qp_iters=self._device_tr_qp_iters,
                rho_qp=self._device_tr_rho_qp,
                qp_stages=self._device_tr_qp_stages,
                accept_pri=self._accept_pri, accept_dua=self._accept_dua,
                delta0=p.delta0, omega0=p.omega0, rho=p.rho,
                beta_fail=p.beta_fail, gamma_fail=p.gamma_fail,
                omega_max=p.omega_max, epsilon=p.epsilon,
                convg_thresh=p.convg_thresh,
                formulation="condensed", dtype=self.locp.spec.dtype)

        self.xopt = None
        self.uopt = None
        self.zopt = None
        self.locp_solve_time = None
        self.itr_count = 0
        self.plan_rejects = 0
        # why each rejected plan was dropped (excursion, residual,
        # non-finite)
        self.reject_log = []

        # real-time one-shot path: max_gusto_iters=0, the condensed backend
        # and no trust region
        self._oneshot = False
        self._warm_start = bool(warm_start)
        if (locp_backend == "condensed" and max_iters_later == 0
                and not self.locp.spec.trust_region
                and self._use_oneshot):
            self._oneshot = True
            spec = self.locp.spec
            self._os_w = torch.zeros(spec.n_var, dtype=spec.dtype,
                                     device=self.device)
            self._os_y = torch.zeros(spec.n_con, dtype=spec.dtype,
                                     device=self.device)

        # the first solve happens at construction, like the reference's
        self.solve(x0, u_init, x_init, z, zf, u)
        self.params.max_gusto_iters = max_iters_later

    # ------------------------------------------------------------------
    def _t(self, a):
        return torch.as_tensor(np.array(to_numpy(a)), dtype=self.model.dtype,
                               device=self.device)

    def _traj_dyn(self, x, u):
        """Discrete (A, B, d) along the trajectory, one batched call."""
        return self.model.get_discrete_dynamics(self._t(x), self._t(u),
                                                self.dt)

    def _traj_cont(self, x, u):
        return self.model.get_continuous_dynamics(self._t(x), self._t(u))

    def is_converged(self, x, u):
        dx = (1.0 / self.n_x) * np.sum(
            np.linalg.norm(self.x_scale * (x - self.x_k), axis=1))
        dsol = (1.0 / self.N) * dx
        return dsol, dsol <= self.params.convg_thresh

    def is_in_trust_region(self, x, delta):
        max_diff = np.max(np.max(np.abs(self.x_scale * (x - self.x_k)), axis=1))
        if max_diff - delta > self.params.epsilon:
            return max_diff, False
        return 0.0, True

    def state_constraints_violated(self, x):
        """Max 2-norm violation of X over the horizon."""
        if self.X is None:
            return 0.0, True
        viol = self.X.violation(torch.as_tensor(np.asarray(x, float)))
        max_violation = float(viol.max())
        return max_violation, max_violation <= self.params.epsilon

    def compute_accuracy(self, x, u, J):
        """Taylor-error model accuracy ratio rho_k over the horizon."""
        f_new, _, _ = self._traj_cont(x[:-1], u)
        fk, Ak, Bk = self._traj_cont(self.x_k[:-1], self.u_k)
        f_new, fk, Ak, Bk = (to_numpy(a).astype(float) for a in (f_new, fk, Ak, Bk))
        f_approx = fk + np.einsum("kij,kj->ki", Ak, x[:-1] - self.x_k[:-1]) \
            + np.einsum("kij,kj->ki", Bk, u - self.u_k)
        err = self.dt * np.sum(np.linalg.norm(
            self.f_scale * (f_new - f_approx), axis=1))
        approx = self.dt * np.sum(np.linalg.norm(self.f_scale * f_approx,
                                                 axis=1))
        return float(err / (J + approx))

    # ------------------------------------------------------------------
    def _oneshot_round(self, x_traj, u_traj, x0, z, u_des, w, y):
        """Linearize at (x_traj, u_traj), assemble, solve, recover, and
        accept only if the QP's relative residuals pass and the accuracy
        ratio rho_k <= rho: the host loop's gates. A rejected round keeps
        the incoming trajectory and drops the ADMM warm start."""
        from soft_robot_control_tpu_torch.qp.admm import solve_qp_dense
        from soft_robot_control_tpu_torch.scp.locp_condensed import (
            CondensedParams)

        spec = self.locp.spec
        sdt = spec.dtype
        N, nu = spec.N, spec.n_u
        Ad, Bd, dd = (a.to(sdt) for a in self.model.get_discrete_dynamics(
            x_traj[:-1].to(self.model.dtype), u_traj.to(self.model.dtype),
            self.dt))
        params = CondensedParams(Ad=Ad[None], Bd=Bd[None], dd=dd[None],
                                 x0=x0[None], z=z[None], u_des=u_des[None])
        P, q, A, l, ub, const, xfree, G = (a[0] for a in spec.assemble(params))
        sol = solve_qp_dense(P, q, A, l, ub, x0=w, y0=y,
                             **self.locp.solver_kwargs)
        u_opt = sol.x[:N * nu].reshape(N, nu)
        x_opt = spec.recover_x(xfree[None], G[None], sol.x[None])[0]
        J = sol.obj + const
        pri_rel = sol.pri_res / torch.clamp(sol.pri_sc, min=1.0)
        dua_rel = sol.dua_res / torch.clamp(sol.dua_sc, min=1.0)
        # Taylor-error accuracy of the step x_traj -> x_opt
        f, Ac, Bc = (a.to(sdt) for a in self.model.get_continuous_dynamics(
            torch.stack([x_opt[:-1], x_traj[:-1]]).to(self.model.dtype),
            torch.stack([u_opt, u_traj]).to(self.model.dtype)))
        fs = torch.as_tensor(self.f_scale, dtype=sdt, device=self.device)
        f_approx = f[1] + (Ac[1] @ (x_opt[:-1] - x_traj[:-1])[..., None]
                           + Bc[1] @ (u_opt - u_traj)[..., None])[..., 0]
        err = self.dt * torch.linalg.vector_norm(
            fs * (f[0] - f_approx), dim=1).sum()
        approx = self.dt * torch.linalg.vector_norm(fs * f_approx, dim=1).sum()
        rho_k = err / (J + approx)
        solved = torch.as_tensor(sol.solved, device=self.device)
        ok = ((solved | ((pri_rel < self._acc_pri)
                         & (dua_rel < self._acc_dua)))
              & (rho_k <= self.params.rho) & torch.isfinite(rho_k))
        x_keep = torch.where(ok, x_opt, x_traj)
        u_keep = torch.where(ok, u_opt, u_traj)
        w_keep = torch.where(ok, sol.x, torch.zeros_like(sol.x))
        y_keep = torch.where(ok, sol.y, torch.zeros_like(sol.y))
        stats = torch.stack([sol.pri_res, sol.dua_res, sol.pri_sc,
                             sol.dua_sc, solved.to(sdt), J, rho_k])
        return x_keep, u_keep, w_keep, y_keep, ok, stats

    def _plan_excursion(self, z_opt, z_arr):
        """Max deviation of the planned output over the tail half of the
        horizon from the target, on all output axes: a plan may start far
        from the target but must converge toward it."""
        z_o = np.asarray(z_opt, float)
        diff = np.abs(z_o - np.asarray(z_arr))[z_o.shape[0] // 2:]
        return float(np.max(diff)) if diff.size else 0.0

    def _solve_device_tr(self, x0, u_init, x_init, z, u):
        """The whole trust-region SCP loop through GuSTOJit, read back as
        one packed vector [x | u | iters, converged, J]."""
        t0 = time.time()
        N, nz, nu = self.N, self.n_z, self.n_u
        n_x = self._jit_tr.n_x
        z_arr = np.zeros((N + 1, nz)) if z is None else np.asarray(z)
        u_des = np.zeros((N, nu)) if u is None else np.asarray(u)
        flat = to_numpy(self._jit_tr.solve_packed(
            np.asarray(x0, float), np.asarray(u_init, float),
            np.asarray(x_init, float), z_arr, u_des)).astype(float)
        nX = (N + 1) * n_x
        x_opt = flat[:nX].reshape(N + 1, n_x)
        u_opt = flat[nX:nX + N * nu].reshape(N, nu)
        res_iters = int(flat[-3]) if np.isfinite(flat[-3]) else -1
        res_converged = bool(flat[-2] > 0.5) if np.isfinite(flat[-2]) else False
        success = bool(np.isfinite(x_opt).all() and np.isfinite(u_opt).all())
        if not success:
            self.reject_log.append({"reason": "nonfinite",
                                    "iters": res_iters})
        z_opt = self._z_of(x_opt) if success else None
        if success and self._plan_bound is not None:
            exc = self._plan_excursion(z_opt, z_arr)
            if not np.isfinite(exc) or exc > self._plan_bound:
                print(f"device-TR plan rejected (tail excursion {exc:.1f} > "
                      f"{self._plan_bound:.1f}, iters {res_iters}, "
                      f"converged {res_converged})")
                self.reject_log.append({
                    "reason": "excursion", "excursion": float(exc),
                    "iters": res_iters, "converged": res_converged})
                success = False
        if success:
            self.xopt = x_opt
            self.uopt = u_opt
            self.zopt = np.asarray(z_opt, float)
        else:
            # keep the old plan, as the host loop does
            self.plan_rejects += 1
            self.xopt = np.asarray(x_init, float)
            self.uopt = np.asarray(u_init, float)
            self.zopt = self._z_of(self.xopt)
        self.itr_count = res_iters
        self.locp_solve_time = time.time() - t0
        self.x_k = self.xopt
        self.u_k = self.uopt

    def _solve_oneshot(self, x0, u_init, x_init, z, u):
        """The real-time path: `oneshot_iters` rounds of linearize, solve
        and gate; keeps the previous plan when no round is accepted."""
        t0 = time.time()
        spec = self.locp.spec
        sdt = spec.dtype
        N, nz, nu = spec.N, spec.n_z, spec.n_u
        acc = accept_tolerances(sdt)
        self._acc_pri = acc[0] if self._accept_pri is None else self._accept_pri
        self._acc_dua = acc[1] if self._accept_dua is None else self._accept_dua
        z_arr = np.zeros((N + 1, nz)) if z is None else np.asarray(z)
        u_des = np.zeros((N, nu)) if u is None else np.asarray(u)
        t = lambda a: torch.as_tensor(np.array(a, float), dtype=sdt,
                                      device=self.device)
        x_traj, u_traj, w, y = t(x_init), t(u_init), self._os_w, self._os_y
        any_ok = False
        for _ in range(self._oneshot_iters):
            x_traj, u_traj, w, y, ok, stats = self._oneshot_round(
                x_traj, u_traj, t(x0), t(z_arr), t(u_des), w, y)
            any_ok = any_ok or bool(ok)
        st = to_numpy(stats).astype(float)
        pri_rel = st[0] / max(1.0, st[2])
        dua_rel = st[1] / max(1.0, st[3])
        x_opt = to_numpy(x_traj).astype(float)
        z_opt = self._z_of(x_opt)
        success = any_ok
        if success and self._plan_bound is not None:
            exc = self._plan_excursion(z_opt, z_arr)
            if not np.isfinite(exc) or exc > self._plan_bound:
                print(f"one-shot plan rejected (tail excursion {exc:.1f} > "
                      f"{self._plan_bound:.1f})")
                self.reject_log.append({
                    "reason": "excursion", "excursion": float(exc)})
                success = False
        if success:
            self.xopt = x_opt
            self.uopt = to_numpy(u_traj).astype(float)
            self.zopt = z_opt
            if self._warm_start:
                self._os_w, self._os_y = w, y
        else:
            # keep flying the old plan; the duals of a rejected solve would
            # seed the next one badly, so the warm start goes too
            print("one-shot LOCP not accepted "
                  f"(pri_rel {pri_rel:.2e}, dua_rel {dua_rel:.2e}, "
                  f"rho_k {st[6]:.2e})")
            if not any_ok:  # excursion rejects are logged above
                self.reject_log.append({
                    "reason": "residual", "pri_rel": float(pri_rel),
                    "dua_rel": float(dua_rel), "rho_k": float(st[6])})
            self.plan_rejects += 1
            self.xopt = np.asarray(x_init, float)
            self.uopt = np.asarray(u_init, float)
            self.zopt = self._z_of(self.xopt)
            self._os_w = torch.zeros_like(self._os_w)
            self._os_y = torch.zeros_like(self._os_y)
        self.itr_count = 1
        self.locp_solve_time = time.time() - t0
        self.x_k = self.xopt
        self.u_k = self.uopt

    def solve(self, x0, u_init, x_init, z=None, zf=None, u=None):
        """The SCP iteration loop (gusto.py:283-488 semantics)."""
        if self._jit_tr is not None:
            return self._solve_device_tr(x0, u_init, x_init, z, u)
        if self._oneshot and self.params.max_gusto_iters == 0:
            return self._solve_oneshot(x0, u_init, x_init, z, u)
        t0 = time.time()
        t_locp = 0.0
        p = self.params
        itr = 0
        self.u_k = np.asarray(u_init, float)
        self.x_k = np.asarray(x_init, float)

        A_d, B_d, d_d = self._traj_dyn(self.x_k[:-1], self.u_k)

        new_solution = True
        Jstar_prev = np.inf
        delta_prev = np.inf
        omega_prev = np.inf
        converged = False
        delta = p.delta0
        omega = p.omega0

        if self.verbose >= 1:
            print("|   J   | TR_viol |  rho_k  |  X_viol |   x-x_k |  delta  |  omega |")

        while itr <= p.max_gusto_iters and not converged and omega <= p.omega_max:
            rho_k = -1.0
            max_violation = -1.0
            dsol = -1.0
            delta_cur, omega_cur = delta, omega

            self.locp.update(A_d, B_d, d_d, np.asarray(x0, float), self.x_k,
                             delta, omega, z=z, zf=zf, u=u,
                             full=new_solution)
            new_solution = False

            Jstar, success, _ = self.locp.solve()
            if not success:
                print(f"Iteration {itr} of problem cannot be solved")
                self.xopt = np.copy(self.x_k)
                self.uopt = np.copy(self.u_k)
                self.zopt = self._z_of(self.xopt)
                self.locp_solve_time = t_locp
                return
            t_locp += self.locp.solve_time

            x_next, u_next, _ = self.locp.get_solution()

            e_tr, tr_satisfied = self.is_in_trust_region(x_next, delta)
            if tr_satisfied:
                rho_k = self.compute_accuracy(x_next, u_next, Jstar)
                if rho_k > p.rho and itr != 1:
                    delta = p.beta_fail * delta
                else:
                    # modification 1
                    if delta_prev == delta and omega_prev == omega and Jstar_prev <= Jstar:
                        delta = p.beta_fail * delta
                    delta_prev, Jstar_prev, omega_prev = delta, Jstar, omega

                    max_violation, X_satisfied = \
                        self.state_constraints_violated(x_next)

                    # modification 3: omega only grows
                    if not X_satisfied:
                        omega = p.gamma_fail * omega

                    dsol, converged = self.is_converged(x_next, u_next)
                    if not X_satisfied:
                        converged = False
                    new_solution = True
            else:
                omega = p.gamma_fail * omega

            itr += 1

            if self.verbose >= 1:
                print(f"{Jstar:.2e}, {e_tr:.2e}, {rho_k:.2e}, "
                      f"{max_violation:.2e}, {dsol:.2e}, {delta_cur:.2e}, "
                      f"{omega_cur:.2e}, {itr}")

            if new_solution:
                self.x_k = x_next.copy()
                self.u_k = u_next.copy()
                if p.max_gusto_iters >= 1:
                    A_d, B_d, d_d = self._traj_dyn(self.x_k[:-1], self.u_k)

        t_gusto = time.time() - t0
        if omega > p.omega_max:
            print("omega > omega_max, solution did not converge")
        if self.verbose >= 1:
            print(f"Solved in {itr} iterations/{t_gusto:.3f} s "
                  f"({t_locp:.3f} s in LOCP)")

        self.itr_count = itr
        self.xopt = np.copy(self.x_k)
        self.uopt = np.copy(self.u_k)
        self.zopt = self._z_of(self.xopt)
        self.locp_solve_time = t_locp

    def _z_of(self, x):
        return np.asarray(x @ self._H.T)

    def get_solution(self):
        return self.xopt, self.uopt, self.zopt, self.locp_solve_time
