"""Long-horizon LOCP: stage-structured assembly and matrix-free ADMM.

The dense LOCPSpec materializes (n_con, n_var) templates, which at N ~ 200
is the scaling wall. This module never forms the dense (P, A):

- A w and A' v are stage-sliced products over the stacked (A_k, B_k)
  dynamics and the small U / dU / X polytopes;
- the ADMM x-step matrix K = P + sigma I + A' diag(rho) A is assembled
  directly as block-tridiagonal blocks (stage diagonal and sub-diagonal)
  and solved by cyclic reduction ('cr', qp/cyclic_reduction.py) or by the
  sequential block Cholesky ('scan', qp/structured.py).

The constraint rows follow LOCPSpec's layout (init, dynamics, [trust
region, s >= 0], U, dU, X), so bounds and duals are interchangeable with
the dense path. The fixed iteration count runs as a Python loop.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from soft_robot_control_tpu_torch.qp.admm import OSQP_RHO_EQ_SCALE
from soft_robot_control_tpu_torch.qp.cyclic_reduction import (bmv, cr_factor,
                                                              cr_solve)
from soft_robot_control_tpu_torch.qp.structured import btd_factor, btd_solve
from soft_robot_control_tpu_torch.utils.device import (as_tensor,
                                                       resolve_device,
                                                       to_numpy)


def _f64(a):
    return np.array(to_numpy(a), dtype=np.float64)


class StageLOCP:
    """Stage-structured LOCP on `device` in `dtype`.

    With trust_region=True the slack s_k joins the stage block
    ([x_k, u_k, s_k]); the rows +-x_scale (x_k - xbar_k) - s_k <= delta add
    2 rho xs^2 to the x diagonal and 2 nx rho + rho to the s diagonal (the
    pairs and s >= 0), and the (x, s) cross terms cancel pairwise, so K
    stays block-tridiagonal."""

    def __init__(self, N, H, Qz, R, U=None, dU=None, X=None, rho: float = 0.1,
                 sigma: float = 1e-6, trust_region: bool = False,
                 x_char=None, dtype=torch.float64, kkt_solver: str = "cr",
                 device="cuda"):
        if kkt_solver not in ("cr", "scan"):
            raise ValueError(f"unknown kkt_solver {kkt_solver!r}")
        self.kkt_solver = kkt_solver
        self.device = resolve_device(device)
        self.N = int(N)
        self.H = _f64(H)
        self.Qz = _f64(Qz)
        self.R = _f64(R)
        self.n_x = self.H.shape[1]
        self.n_z = self.Qz.shape[0]
        self.n_u = self.R.shape[0]
        self.U, self.dU, self.X = U, dU, X
        self.sigma = float(sigma)
        self.dtype = dtype
        self.tr = bool(trust_region)
        self.x_scale = (np.ones(self.n_x) if x_char is None
                        else 1.0 / np.abs(_f64(x_char)))
        nx, nu, N_ = self.n_x, self.n_u, self.N
        self.ns = 1 if self.tr else 0
        self.nb = nx + nu + self.ns
        self.n_var = (N_ + 1) * nx + N_ * nu + (N_ + 1) * self.ns

        # row layout (LOCPSpec's order: init, dyn, [tr, s>=0], U, dU, X)
        rows = 0
        self.r_init = rows
        rows += nx
        self.r_dyn = rows
        rows += N_ * nx
        if self.tr:
            self.r_tr = rows
            rows += 2 * nx * (N_ + 1)
            self.r_s = rows
            rows += N_ + 1
        self.mU = 0 if U is None else np.asarray(U.A).shape[0]
        if U is not None:
            self.r_U = rows
            rows += N_ * self.mU
        self.mdU = 0 if dU is None else np.asarray(dU.A).shape[0]
        if dU is not None:
            self.r_dU = rows
            rows += (N_ - 1) * self.mdU
        self.mX = 0 if X is None else np.asarray(X.A).shape[0]
        if X is not None:
            self.r_X = rows
            rows += N_ * self.mX
        self.n_con = rows

        rho_np = np.full(self.n_con, rho)
        rho_np[self.r_init:self.r_init + nx] *= OSQP_RHO_EQ_SCALE
        rho_np[self.r_dyn:self.r_dyn + N_ * nx] *= OSQP_RHO_EQ_SCALE
        self.rho_vec = self._t(rho_np)
        self.rho_eq = float(rho * OSQP_RHO_EQ_SCALE)
        self.rho_in = float(rho)

        # the constant matrices, built in float64 and cast once
        self._xs = self._t(self.x_scale)
        self._HQH = self._t(2.0 * self.H.T @ self.Qz @ self.H)
        self._R2 = self._t(2.0 * self.R)
        self._Qzt, self._Rt, self._Ht = (self._t(a) for a in (
            self.Qz, self.R, self.H))
        sets = {"U": U, "dU": dU, "X": X}
        self._SA = {k: self._t(s.A) for k, s in sets.items() if s is not None}
        self._Sb = {k: self._t(s.b) for k, s in sets.items() if s is not None}
        # rho_in A'A of each set: its rows' share of K
        self._gram = {k: self._t(rho * np.asarray(s.A).T @ np.asarray(s.A))
                      for k, s in sets.items() if s is not None}

    def _t(self, a):
        return as_tensor(np.asarray(a, dtype=np.float64), self.dtype,
                         self.device)

    def _zeros(self, *shape):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    # -- variable packing ---------------------------------------------------
    def split(self, w):
        nx, nu, N = self.n_x, self.n_u, self.N
        x = w[:(N + 1) * nx].reshape(N + 1, nx)
        u = w[(N + 1) * nx:(N + 1) * nx + N * nu].reshape(N, nu)
        s = w[(N + 1) * nx + N * nu:] if self.tr else None
        return x, u, s

    def join(self, x, u, s=None):
        parts = [x.reshape(-1), u.reshape(-1)]
        if self.tr:
            parts.append(self._zeros(self.N + 1) if s is None
                         else s.reshape(-1))
        return torch.cat(parts)

    # -- matrix-free constraint application ---------------------------------
    def A_mv(self, Ad, Bd, w):
        """A @ w without materializing A."""
        x, u, sl = self.split(w)
        dyn = x[1:] - bmv(Ad, x[:-1]) - bmv(Bd, u)
        parts = [x[0], dyn.reshape(-1)]
        if self.tr:
            xs = self._xs
            plus = xs[None, :] * x - sl[:, None]
            minus = -xs[None, :] * x - sl[:, None]
            parts.append(torch.stack([plus, minus], dim=1).reshape(-1))
            parts.append(sl)
        if self.U is not None:
            parts.append((u @ self._SA["U"].T).reshape(-1))
        if self.dU is not None:
            parts.append(((u[1:] - u[:-1]) @ self._SA["dU"].T).reshape(-1))
        if self.X is not None:
            parts.append((x[1:] @ self._SA["X"].T).reshape(-1))
        return torch.cat(parts)

    def At_mv(self, Ad, Bd, v):
        """A' @ v without materializing A."""
        nx, N = self.n_x, self.N
        v_init = v[self.r_init:self.r_init + nx]
        v_dyn = v[self.r_dyn:self.r_dyn + N * nx].reshape(N, nx)
        Atv = bmv(Ad.transpose(1, 2), v_dyn)
        x_out = (torch.cat([v_init[None], v_dyn])
                 + torch.cat([-Atv, self._zeros(1, nx)]))
        u_out = -bmv(Bd.transpose(1, 2), v_dyn)
        s_out = None
        if self.tr:
            v_tr = v[self.r_tr:self.r_tr + 2 * nx * (N + 1)].reshape(
                N + 1, 2, nx)
            x_out = x_out + self._xs[None, :] * (v_tr[:, 0] - v_tr[:, 1])
            s_out = (-torch.sum(v_tr[:, 0] + v_tr[:, 1], dim=1)
                     + v[self.r_s:self.r_s + N + 1])
        if self.U is not None:
            v_U = v[self.r_U:self.r_U + N * self.mU].reshape(N, self.mU)
            u_out = u_out + v_U @ self._SA["U"]
        if self.dU is not None:
            v_d = v[self.r_dU:self.r_dU + (N - 1) * self.mdU].reshape(
                N - 1, self.mdU)
            c = v_d @ self._SA["dU"]
            z1 = self._zeros(1, self.n_u)
            u_out = u_out + torch.cat([z1, c]) - torch.cat([c, z1])
        if self.X is not None:
            v_X = v[self.r_X:self.r_X + N * self.mX].reshape(N, self.mX)
            x_out = x_out + torch.cat([self._zeros(1, nx),
                                       v_X @ self._SA["X"]])
        return self.join(x_out, u_out, s_out)

    # -- bounds and linear objective -----------------------------------------
    def bounds(self, x0, dd, delta=None, xk=None):
        N, nx = self.N, self.n_x
        inf = float("inf")
        full = lambda n, val: torch.full((n,), val, dtype=self.dtype,
                                         device=self.device)
        l = [x0, dd.reshape(-1)]
        u = [x0, dd.reshape(-1)]
        if self.tr:
            hi = delta + self._xs[None, :] * xk
            lo = delta - self._xs[None, :] * xk
            l.append(full(2 * nx * (N + 1), -inf))
            u.append(torch.stack([hi, lo], dim=1).reshape(-1))
            l.append(self._zeros(N + 1))
            u.append(full(N + 1, inf))
        for key, reps in (("U", N), ("dU", N - 1), ("X", N)):
            if key in self._Sb:
                b = self._Sb[key]
                l.append(full(reps * b.shape[0], -inf))
                u.append(b.repeat(reps))
        return torch.cat(l), torch.cat(u)

    def P_mv(self, w):
        """P @ w (cvxpy convention, factor 2) without materializing P."""
        x, u, sl = self.split(w)
        return self.join(x @ self._HQH.T, u @ self._R2.T,
                         None if sl is None else torch.zeros_like(sl))

    def q_vec(self, z, u_des, omega=None):
        q_x = -2.0 * (z @ self._Qzt @ self._Ht)
        q_u = -2.0 * (u_des @ self._Rt)
        q_s = None
        if self.tr:
            om = 0.0 if omega is None else omega
            q_s = torch.as_tensor(om, dtype=self.dtype,
                                  device=self.device).expand(self.N + 1)
        return self.join(q_x, q_u, q_s)

    # -- block-tridiagonal K assembly -----------------------------------------
    def K_blocks(self, Ad, Bd):
        """Stage blocks of K = P + sigma I + A' diag(rho) A in stage order
        [x_k, u_k(, s_k)]: diag (N+1, nb, nb), the last stage x_N padded
        with identity on the u slot; lower (N, nb, nb)."""
        nx, nu, nb, N = self.n_x, self.n_u, self.nb, self.N
        dt, dev = self.dtype, self.device
        r_eq, r_in = self.rho_eq, self.rho_in
        I_x = torch.eye(nx, dtype=dt, device=dev)
        HQH = self._HQH + self.sigma * I_x
        R2 = self._R2 + self.sigma * torch.eye(nu, dtype=dt, device=dev)
        UtU = self._gram.get("U", self._zeros(nu, nu))
        dtd = self._gram.get("dU", self._zeros(nu, nu))
        XtX = self._gram.get("X", self._zeros(nx, nx))
        # trust region (inequality rho): each +- row pair gives 2 rho xs_i^2
        # on the x diagonal; s_k has -1 in its 2 nx rows and +1 in its
        # positivity row; sigma regularizes the s slot too
        xs2 = (torch.diag(self._t(2.0 * r_in * self.x_scale ** 2))
               if self.tr else None)
        s_diag = 2.0 * nx * r_in + r_in + self.sigma

        ks = torch.arange(N, device=dev)
        one = lambda m: m.to(dt)[:, None, None]
        first, later = one(ks == 0), one(ks > 0)
        inner, before_last = one((ks > 0) & (ks < N)), one(ks < N - 1)
        At = Ad.transpose(1, 2)
        Dxx = HQH + r_eq * (At @ Ad)
        Dxx = Dxx + first * r_eq * I_x
        # dynamics row k-1 (+I on x_k) and X row k-1
        Dxx = Dxx + later * (r_eq * I_x + XtX)
        if self.tr:
            Dxx = Dxx + xs2
        Duu = R2 + r_eq * (Bd.transpose(1, 2) @ Bd) + UtU
        Duu = Duu + dtd * inner + dtd * before_last
        Dxu = r_eq * (At @ Bd)
        diag = torch.cat([torch.cat([Dxx, Dxu], dim=2),
                          torch.cat([Dxu.transpose(1, 2), Duu], dim=2)],
                         dim=1)
        # the last stage: x_N (and s_N), identity on the u slot
        DxxN = HQH + r_eq * I_x + XtX
        if self.tr:
            DxxN = DxxN + xs2
        DN = torch.eye(nx + nu, dtype=dt, device=dev)
        DN[:nx, :nx] = DxxN
        diag = torch.cat([diag, DN[None]])
        # sub-diagonal block k: stage k+1 rows, stage k columns. Dynamics
        # row k (+I on x_{k+1}, -A_k on x_k, -B_k on u_k) gives
        # [-rho_eq A_k, -rho_eq B_k] in the x rows; dU row k gives -dtd on
        # u_{k+1} x u_k (none after the last input)
        lower = torch.cat([
            torch.cat([-r_eq * Ad, -r_eq * Bd], dim=2),
            torch.cat([torch.zeros((N, nu, nx), dtype=dt, device=dev),
                       -dtd * before_last], dim=2)], dim=1)
        if self.tr:
            # the slack couples only within its own stage
            diag = torch.nn.functional.pad(diag, (0, 1, 0, 1))
            diag[:, -1, -1] = s_diag
            lower = torch.nn.functional.pad(lower, (0, 1, 0, 1))
        return diag, lower

    # -- stage order ---------------------------------------------------------
    def to_stages(self, w):
        x, u, sl = self.split(w)
        cols = [x, torch.cat([u, self._zeros(1, self.n_u)])]
        if self.tr:
            cols.append(sl[:, None])
        return torch.cat(cols, dim=1)                      # (N+1, nb)

    def from_stages(self, blocks):
        nx, nu = self.n_x, self.n_u
        s = blocks[:, nx + nu] if self.tr else None
        return self.join(blocks[:, :nx], blocks[:-1, nx:nx + nu], s)

    # -- full solve ----------------------------------------------------------
    def solve(self, Ad, Bd, dd, x0, z, u_des=None, iters: int = 200,
              alpha: float = 1.6, w0=None, y0=None, delta=None, omega=None,
              xk=None):
        """Fixed-iteration ADMM, matrix-free, with the structured x-step.
        With trust_region=True, (delta, omega, xk) parameterize the trust
        region. Returns (w, y)."""
        t = lambda a: as_tensor(a, self.dtype, self.device)
        Ad, Bd, dd, x0, z = t(Ad), t(Bd), t(dd), t(x0), t(z)
        u_des = (self._zeros(self.N, self.n_u) if u_des is None
                 else t(u_des))
        if self.tr:
            delta, omega, xk = t(delta), t(omega), t(xk)
        q = self.q_vec(z, u_des, omega=omega)
        l, u_b = self.bounds(x0, dd, delta=delta, xk=xk)
        rho, sigma = self.rho_vec, self.sigma

        diag, lower = self.K_blocks(Ad, Bd)
        if self.kkt_solver == "cr":
            factors = cr_factor(diag, lower)
            kkt = lambda b: cr_solve(factors, b)
        else:
            factors = btd_factor(diag, lower)
            kkt = lambda b: btd_solve(*factors, b)

        w = self._zeros(self.n_var) if w0 is None else t(w0)
        y = self._zeros(self.n_con) if y0 is None else t(y0)
        zc = torch.minimum(torch.maximum(self.A_mv(Ad, Bd, w), l), u_b)
        for _ in range(int(iters)):
            rhs = sigma * w - q + self.At_mv(Ad, Bd, rho * zc - y)
            w_t = self.from_stages(kkt(self.to_stages(rhs)))
            z_t = self.A_mv(Ad, Bd, w_t)
            w_new = alpha * w_t + (1 - alpha) * w
            z_rel = alpha * z_t + (1 - alpha) * zc
            zc = torch.minimum(torch.maximum(z_rel + y / rho, l), u_b)
            y = y + rho * (z_rel - zc)
            w = w_new
        return w, y


class StageLOCPAdapter:
    """LOCP-compatible wrapper (update / solve / get_solution, the contract
    of scp/locp.py) over a trust-region StageLOCP, so the host GuSTO loop
    runs long horizons without dense assembly."""

    def __init__(self, N, H, Qz, R, U=None, X=None, dU=None, x_char=None,
                 iters: int = 400, dtype=torch.float64, device="cuda",
                 **_ignored):
        self.stage = StageLOCP(N, H, Qz, R, U=U, dU=dU, X=X,
                               trust_region=True, x_char=x_char, dtype=dtype,
                               device=device)
        self.iters = int(iters)
        self._w = None
        self._y = None
        self._params = None
        self.solve_time = 0.0

    def _solve(self, Ad, Bd, dd, x0, xk, delta, omega, z, u_des, w0, y0):
        """(w, y) and the objective (cvxpy convention, constants included)
        and the primal and dual residuals, on the device."""
        st = self.stage
        w, y = st.solve(Ad, Bd, dd, x0, z, u_des=u_des, iters=self.iters,
                        w0=w0, y0=y0, delta=delta, omega=omega, xk=xk)
        q = st.q_vec(z, u_des, omega=omega)
        const = (torch.einsum("kz,zw,kw->k", z, st._Qzt, z).sum()
                 + torch.sum(u_des @ st._Rt * u_des))
        Pw = st.P_mv(w)
        J = 0.5 * w @ Pw + q @ w + const
        l, u_b = st.bounds(x0, dd, delta=delta, xk=xk)
        Aw = st.A_mv(Ad, Bd, w)
        pri = torch.clamp(torch.maximum(torch.max(Aw - u_b),
                                        torch.max(l - Aw)), min=0.0)
        dua = torch.max(torch.abs(Pw + q + st.At_mv(Ad, Bd, y)))
        return w, y, J, pri, dua

    def update(self, Ad, Bd, dd, x0, xk, delta, omega, z=None, zf=None,
               u=None, full=True, Hd=None, cd=None):
        st = self.stage
        t = lambda a: as_tensor(a, st.dtype, st.device)
        z = st._zeros(st.N + 1, st.n_z) if z is None else t(z)
        u_des = st._zeros(st.N, st.n_u) if u is None else t(u)
        self._params = (t(Ad), t(Bd), t(dd).reshape(st.N, st.n_x), t(x0),
                        t(xk), t(delta), t(omega), z, u_des)

    def solve(self):
        t0 = time.time()
        st = self.stage
        w0 = st._zeros(st.n_var) if self._w is None else self._w
        y0 = st._zeros(st.n_con) if self._y is None else self._y
        w, y, J, pri, dua = self._solve(*self._params, w0, y0)
        J, pri, dua = torch.stack([J, pri, dua]).tolist()  # the one read
        self.solve_time = time.time() - t0
        self._w, self._y = w, y
        # 'solved inaccurate' acceptance of the fixed-iteration ADMM
        success = pri < 1e-4 and dua < 1e-3
        return (J, True, self) if success else (np.inf, False, None)

    def get_solution(self):
        x, u, s = self.stage.split(self._w)
        return to_numpy(x), to_numpy(u), to_numpy(s)
