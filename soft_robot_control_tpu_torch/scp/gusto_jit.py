"""GuSTO's trust-region SCP loop over whole batches on the device.

The host GuSTO (scp/gusto.py) follows the reference's data-dependent
Python loop. Here every step of a solve (linearization, LOCP assembly,
fixed-iteration ADMM, trust-region accept/reject, the delta and omega
schedules, the convergence test) runs as batched tensor operations on the
model's device, with the per-problem state carried in masks. Semantics
follow gusto.py:283-488 with the reference's modifications 1 and 3:
- reject when the solution leaves the scaled trust region -> omega grows;
- reject when the Taylor-accuracy ratio rho_k exceeds rho (except on
  iteration 1, the reference's nudge) -> delta shrinks;
- modification 1: accepted solve with unchanged (delta, omega) but
  non-decreasing cost -> delta shrinks;
- modification 3: state-constraint violation only ever grows omega;
- converged when the scaled mean state change falls under convg_thresh
  (and X is satisfied).

Two entry points with deliberately different semantics, as in the JAX
package:
- `solve` / `solve_batch` / `solve_packed`: a while loop. Each problem
  stops on its own (its carry is frozen), and the loop ends when none is
  active: one host read of the active mask an iteration. The condensed
  formulation is Ruiz-equilibrated, solved by the staged plain ADMM
  (`admm_staged_kinv`, `qp_stages` rho stages) and accepted only when its
  relative KKT residuals pass (the dual residual over the control block);
  the sparse one runs make_kinv + `admm_fixed_kinv`, or `admm_fixed` with
  x_step='chol'. These QP solvers are plain PyTorch, as they are XLA in the
  JAX package.
- `solve_batch_fused`: `max_iters` lockstep iterations with masks and no
  host read of its own (K^-1's `torch.linalg.cholesky` checks its errors
  on the host once an iteration). Every iteration solves all B LOCPs in
  one launch of the batched ADMM kernel (ops/admm_batched.py) with one
  shared rho row, no Ruiz scaling and no residual gate.
On a TPWL model each iteration also makes two launches of the select
kernel: the discrete rows along the linearization trajectory, and the
continuous rows at the new and the old trajectory for the accuracy ratio.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from soft_robot_control_tpu_torch.control.batch_mpc import (admm_fixed,
                                                            admm_fixed_kinv,
                                                            admm_staged_kinv,
                                                            equilibrate_qp)
from soft_robot_control_tpu_torch.ops.admm_batched import admm_batched
from soft_robot_control_tpu_torch.qp.admm import (OSQP_RHO_EQ_SCALE,
                                                  accept_tolerances,
                                                  kkt_residuals)
from soft_robot_control_tpu_torch.qp.blocked import make_kinv
from soft_robot_control_tpu_torch.scp.gusto import (BETA_FAIL, CONVERGE,
                                                    DELTA0, EPSILON,
                                                    GAMMA_FAIL, OMEGA0,
                                                    OMEGA_MAX, RHO)
from soft_robot_control_tpu_torch.scp.locp import LOCPParams, LOCPSpec
from soft_robot_control_tpu_torch.scp.locp_condensed import (CondensedParams,
                                                             CondensedSpec)
from soft_robot_control_tpu_torch.utils.device import as_tensor
from soft_robot_control_tpu_torch.utils.timing import span


class GuSTOJitResult(NamedTuple):
    x: torch.Tensor          # (N+1, n_x), batched (B, N+1, n_x)
    u: torch.Tensor          # (N, n_u)
    iters: torch.Tensor      # SCP iterations executed
    converged: torch.Tensor  # bool
    J: torch.Tensor          # last accepted QP objective


class GuSTOJit:
    """A full GuSTO solve for a fixed problem structure, on the model's
    device. model: an adapter with batched get_discrete_dynamics /
    get_continuous_dynamics (TPWLGuSTO, DubinsCar)."""

    def __init__(self, model, N, dt, Qz, R, U=None, dU=None, X=None,
                 x_char=None, f_char=None, max_iters: int = 20,
                 qp_iters: int = 100, rho_qp: float = 0.1,
                 delta0=DELTA0, omega0=OMEGA0, rho=RHO,
                 beta_fail=BETA_FAIL, gamma_fail=GAMMA_FAIL,
                 omega_max=OMEGA_MAX, epsilon=EPSILON,
                 convg_thresh=CONVERGE, x_step: str = "chol",
                 formulation: str = "sparse", dtype=torch.float64,
                 qp_stages: int = 2, scaling_iters: int = 6,
                 accept_pri=None, accept_dua=None):
        self.model = model
        self.device = model.device
        self.N = int(N)
        self.dt = float(dt)
        self.dtype = dtype
        self.max_iters = int(max_iters)
        self.qp_iters = int(qp_iters)
        self.x_step = x_step
        self.p = dict(delta0=delta0, omega0=omega0, rho=rho,
                      beta_fail=beta_fail, gamma_fail=gamma_fail,
                      omega_max=omega_max, epsilon=epsilon,
                      convg_thresh=convg_thresh)
        self.n_x, self.n_u = model.n_x, model.n_u
        self.n_z = np.asarray(Qz).shape[0]
        self.X = X
        # the condensed QP's acceptance gate: relative KKT residuals (a
        # stalled ADMM result would otherwise pass the trust-region tests:
        # rho_k is ~0 for a piecewise-linear model and delta0 never binds)
        self.qp_stages = max(1, int(qp_stages))
        self.scaling_iters = int(scaling_iters)
        acc = accept_tolerances(dtype)
        self.accept_pri = float(acc[0] if accept_pri is None else accept_pri)
        self.accept_dua = float(acc[1] if accept_dua is None else accept_dua)
        t = lambda a: as_tensor(a, dtype, self.device)
        self.spec = LOCPSpec(self.N, model.H, np.asarray(Qz), np.asarray(R),
                             U=U, dU=dU, X=X, x_char=x_char,
                             is_tr_active=True, dtype=dtype,
                             device=self.device)
        x_char = np.ones(self.n_x) if x_char is None else np.asarray(x_char)
        f_char = np.ones(self.n_x) if f_char is None else np.asarray(f_char)
        self.x_scale = t(1.0 / np.abs(x_char))
        self.f_scale = t(1.0 / np.abs(f_char))

        rho_vec = np.full(self.spec.n_con, rho_qp)
        nx, N_ = self.spec.n_x, self.spec.N
        rho_vec[self.spec.r_init:self.spec.r_init + nx] *= OSQP_RHO_EQ_SCALE
        rho_vec[self.spec.r_dyn:self.spec.r_dyn + N_ * nx] *= OSQP_RHO_EQ_SCALE
        self.rho_vec = t(rho_vec)

        # condensed: states eliminated, the trust region as affine rows with
        # one slack; the same optimum with an (N*nu+1)^2 KKT
        self.formulation = formulation
        if formulation == "condensed":
            self.cspec = CondensedSpec(
                self.N, model.H, np.asarray(Qz), np.asarray(R), U=U, dU=dU,
                X=X, trust_region=True, x_char=x_char, dtype=dtype,
                device=self.device)
            self.rho_vec_c = torch.full((self.cspec.n_con,), rho_qp,
                                        dtype=dtype, device=self.device)
        elif formulation != "sparse":
            raise ValueError(f"unknown formulation {formulation!r}")

    # ------------------------------------------------------------------
    def _t(self, a):
        return as_tensor(a, self.dtype, self.device)

    def _lin_d(self, x, u):
        """Discrete (A, B, d) at states x (B, N, n_x), inputs u (B, N, n_u):
        one batched call of the model."""
        md = self.model.dtype
        return tuple(a.to(self.dtype) for a in
                     self.model.get_discrete_dynamics(x.to(md), u.to(md),
                                                      self.dt))

    def _qp_dims(self):
        s = self.cspec if self.formulation == "condensed" else self.spec
        return s.n_var, s.n_con

    def _qp(self, x_k, u_k, x0, z, u_des, delta, omega, warm, fused):
        """Linearize along (x_k, u_k), assemble and solve every problem's
        LOCP: (x_n, u_n, J, (w, y), qp_ok)."""
        B, N, n_u = x_k.shape[0], self.N, self.n_u
        Ad, Bd, dd = self._lin_d(x_k[:, :-1], u_k)
        ok = torch.ones(B, dtype=torch.bool, device=self.device)
        if self.formulation == "condensed":
            with span("qp.assemble"):
                P, q, A, l, u_b, const, xfree, G = self.cspec.assemble(
                    CondensedParams(Ad=Ad, Bd=Bd, dd=dd, x0=x0, z=z,
                                    u_des=u_des, xk=x_k, delta=delta,
                                    omega=omega))
            if fused:
                Kinv = make_kinv(P, A, self.rho_vec_c)
                w, y = admm_batched(Kinv, A, q, l, u_b, self.rho_vec_c,
                                    warm[0], warm[1], self.qp_iters)
            else:
                w, y, ok = self._solve_condensed(P, q, A, l, u_b, warm)
            u_n = w[:, :N * n_u].reshape(B, N, n_u)
            x_n = self.cspec.recover_x(xfree, G, w)
        else:
            zeros = lambda *s: torch.zeros((B,) + s, dtype=self.dtype,
                                           device=self.device)
            with span("qp.assemble"):
                P, q, A, l, u_b, const = self.spec.assemble(LOCPParams(
                    Ad=Ad, Bd=Bd, dd=dd, x0=x0, xk=x_k, delta=delta,
                    omega=omega, z=z, zf=zeros(self.n_z), u_des=u_des))
            if fused:
                w, y = admm_batched(make_kinv(P, A, self.rho_vec), A, q, l,
                                    u_b, self.rho_vec, warm[0], warm[1],
                                    self.qp_iters)
            elif self.x_step == "kinv":
                w, y = admm_fixed_kinv(make_kinv(P, A, self.rho_vec), q, A,
                                       l, u_b, warm[0], warm[1],
                                       self.rho_vec, self.qp_iters)
            else:
                w, y = admm_fixed(P, q, A, l, u_b, warm[0], warm[1],
                                  self.rho_vec, self.qp_iters)
            x_n, u_n, _ = self.spec.split(w)
        # J on the unscaled P
        J = (0.5 * torch.einsum("bi,bij,bj->b", w, P, w)
             + (q * w).sum(dim=1) + const)
        return x_n, u_n, J, (w, y), ok

    def _solve_condensed(self, P, q, A, l, u_b, warm):
        """Ruiz equilibration, the staged plain ADMM and the relative-KKT
        gate qp_ok, whose dual residual covers the control block only (the
        slack's dual converges an order slower and only misprices the
        slack)."""
        Ps, qs, As, ls, us, w0s, y0s, (dv, ev, cc) = equilibrate_qp(
            P, q, A, l, u_b, warm[0], warm[1], self.scaling_iters)
        ws, ys = admm_staged_kinv(Ps, qs, As, ls, us, w0s, y0s,
                                  self.rho_vec_c, self.qp_iters,
                                  stages=self.qp_stages)
        w = dv * ws
        y = ev * ys / cc[:, None]
        pri, dua, pri_sc, dua_sc = kkt_residuals(P, q, A, l, u_b, w, y,
                                                 self.N * self.n_u)
        ok = ((pri < self.accept_pri * torch.clamp(pri_sc, min=1.0))
              & (dua < self.accept_dua * torch.clamp(dua_sc, min=1.0))
              & torch.isfinite(pri) & torch.isfinite(dua))
        return w, y, ok

    def _accuracy(self, x_n, u_n, x_k, u_k, J):
        """Taylor-error ratio rho_k of each problem; the dynamics at the new
        and the old trajectory come from one batched call."""
        md = self.model.dtype
        f, A, B = (a.to(self.dtype) for a in
                   self.model.get_continuous_dynamics(
                       torch.stack([x_n[:, :-1], x_k[:, :-1]]).to(md),
                       torch.stack([u_n, u_k]).to(md)))
        f_lin = f[1] + (A[1] @ (x_n[:, :-1] - x_k[:, :-1])[..., None]
                        + B[1] @ (u_n - u_k)[..., None])[..., 0]
        norm = lambda a: torch.linalg.vector_norm(self.f_scale * a, dim=2)
        err = self.dt * norm(f[0] - f_lin).sum(dim=1)
        approx = self.dt * norm(f_lin).sum(dim=1)
        return err / (J + approx)

    def _iteration(self, c, x0, z, u_des, fused):
        """One SCP iteration of every problem. `fused`: the lockstep form
        (masks from `active`, no residual gate); else the while-loop body,
        whose caller freezes the problems that are done."""
        with span("gusto.iteration"):
            (x_k, u_k, delta, omega, Jp, dp, op, itr, conv, warm, J_last) = c
            p = self.p
            x_n, u_n, J, warm_n, qp_ok = self._qp(x_k, u_k, x0, z, u_des,
                                                  delta, omega, warm, fused)
            dx = self.x_scale * (x_n - x_k)
            tr_ok = (dx.abs().amax(dim=(1, 2)) - delta) <= p["epsilon"]
            rho_k = self._accuracy(x_n, u_n, x_k, u_k, J)
            rho_bad = (rho_k > p["rho"]) & (itr != 1)
            mod1 = (dp == delta) & (op == omega) & (Jp <= J)
            if self.X is not None:
                X_ok = (self.X.violation(x_n[:, 1:]).amax(dim=1)
                        <= p["epsilon"])
            else:
                X_ok = torch.ones_like(tr_ok)
            dsol = torch.linalg.vector_norm(dx, dim=2).sum(dim=1) / (
                self.n_x * self.N)
            where = torch.where
            if fused:
                active = self._active(c)
                accept = active & tr_ok & ~rho_bad
                shrink = active & tr_ok & rho_bad
                grow = active & ~tr_ok
                conv_new = where(active, accept & (dsol <= p["convg_thresh"])
                                 & X_ok, conv)
                itr_new = itr + active.to(itr.dtype)
                carry_warm = accept
            else:
                # an unsolved QP is no SCP step: (x_k, delta, omega) stay and
                # the next iteration re-solves the same QP from where ADMM
                # stopped
                accept = tr_ok & ~rho_bad & qp_ok
                shrink = tr_ok & rho_bad & qp_ok
                grow = ~tr_ok & qp_ok
                conv_new = accept & (dsol <= p["convg_thresh"]) & X_ok
                itr_new = itr + 1
                carry_warm = accept | ~qp_ok
            delta_new = where(shrink, p["beta_fail"] * delta,
                              where(accept & mod1, p["beta_fail"] * delta,
                                    delta))
            omega_new = where(grow, p["gamma_fail"] * omega,
                              where(accept & ~X_ok, p["gamma_fail"] * omega,
                                    omega))
            return (_sel(accept, x_n, x_k), _sel(accept, u_n, u_k), delta_new,
                    omega_new, where(accept, J, Jp), where(accept, delta, dp),
                    where(accept, omega, op), itr_new, conv_new,
                    tuple(_sel(carry_warm, a, b)
                          for a, b in zip(warm_n, warm)),
                    where(accept, J, J_last))

    def _active(self, c):
        omega, itr, conv = c[3], c[7], c[8]
        return (~conv) & (omega <= self.p["omega_max"]) & (
            itr < self.max_iters)

    def _carry0(self, u_init, x_init):
        B = x_init.shape[0]
        full = lambda v: torch.full((B,), v, dtype=self.dtype,
                                    device=self.device)
        nv, nc = self._qp_dims()
        warm = (torch.zeros((B, nv), dtype=self.dtype, device=self.device),
                torch.zeros((B, nc), dtype=self.dtype, device=self.device))
        inf = full(float("inf"))
        return (x_init, u_init, full(self.p["delta0"]),
                full(self.p["omega0"]), inf, inf, inf,
                torch.zeros(B, dtype=torch.int32, device=self.device),
                torch.zeros(B, dtype=torch.bool, device=self.device), warm,
                inf)

    def _inputs(self, x0, u_init, x_init, z, u_des):
        x0 = self._t(x0)
        if u_des is None:
            u_des = torch.zeros(x0.shape[:-1] + (self.N, self.n_u),
                                dtype=self.dtype, device=self.device)
        return (x0, self._t(u_init), self._t(x_init), self._t(z),
                self._t(u_des))

    def _run_while(self, x0, u_init, x_init, z, u_des):
        """The while loop over a batch: each problem's carry freezes once it
        is done, exactly as under a vmapped while_loop."""
        c = self._carry0(u_init, x_init)
        while True:
            active = self._active(c)
            if not bool(active.any()):  # one host read an iteration
                break
            new = self._iteration(c, x0, z, u_des, fused=False)
            c = tuple(tuple(_sel(active, a, b) for a, b in zip(n, o))
                      if isinstance(n, tuple) else _sel(active, n, o)
                      for n, o in zip(new, c))
        return GuSTOJitResult(x=c[0], u=c[1], iters=c[7], converged=c[8],
                              J=c[10])

    # ------------------------------------------------------------------
    def solve(self, x0, u_init, x_init, z, u_des=None):
        """One full GuSTO solve. z: (N+1, n_z); u_des: (N, n_u)."""
        args = [a[None] for a in self._inputs(x0, u_init, x_init, z, u_des)]
        return GuSTOJitResult(*(a[0] for a in self._run_while(*args)))

    def solve_packed(self, x0, u_init, x_init, z, u_des=None):
        """solve() with the result packed on the device into one vector
        [x.ravel | u.ravel | iters, converged, J], for one read."""
        r = self.solve(x0, u_init, x_init, z, u_des)
        tail = torch.stack([r.iters.to(self.dtype),
                            r.converged.to(self.dtype), r.J])
        return torch.cat([r.x.reshape(-1), r.u.reshape(-1), tail])

    def solve_batch(self, x0, u_init, x_init, z, u_des=None):
        """GuSTO over a batch of problems (leading axis on every input);
        each element's result is solve()'s on that element."""
        return self._run_while(*self._inputs(x0, u_init, x_init, z, u_des))

    def solve_batch_fused(self, x0, u_init, x_init, z, u_des=None):
        """Batch GuSTO in `max_iters` lockstep iterations, each one launch
        of the batched ADMM kernel for all B LOCPs; no host read of its own
        (`make_kinv`'s Cholesky checks its errors on the host once an
        iteration)."""
        with span("gusto.call"):
            x0, u_init, x_init, z, u_des = self._inputs(x0, u_init, x_init,
                                                        z, u_des)
            c = self._carry0(u_init, x_init)
            for _ in range(self.max_iters):
                c = self._iteration(c, x0, z, u_des, fused=True)
            return GuSTOJitResult(x=c[0], u=c[1], iters=c[7],
                                  converged=c[8], J=c[10])


def _sel(mask, a, b):
    """a where mask (B,) else b, broadcast over a's trailing axes."""
    return torch.where(mask.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
