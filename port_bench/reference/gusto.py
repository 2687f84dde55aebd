"""Batched GuSTO in lockstep on a TPWL dictionary, written plainly.

B trajectory optimizations run `max_iters` sequential convex programming
iterations side by side. An iteration of each problem:

1. takes the nearest point's discrete (A, B, d) at the first N states of
   its current trajectory (x_k, u_k);
2. builds the sparse LOCP in w = [x_0..x_N | u_0..u_{N-1} | s_0..s_N]:
   cost sum_k |H x_k - z_k|^2_Qz + |u_k|^2_R + omega sum_k s_k; rows
   x_0 = x0 and x_{k+1} = A_k x_k + B_k u_k + d_k (rho boosted 1e3),
   |x_k - xk_k|_inf <= delta + s_k, s_k >= 0, lb <= u_k <= ub;
3. runs a fixed number of ADMM iterations from the last accepted warm
   start, with K^-1 of P + sigma I + A' diag(rho) A;
4. judges the new trajectory: in the trust region (max |x - x_k| - delta
   <= epsilon), and the Taylor accuracy ratio rho_k = err / (J + approx)
   of the continuous dynamics at the nearest points of the new and the old
   trajectory under rho (but on iteration 1); accepts, shrinks delta or
   grows omega as GuSTO does (with its modification 1: an accepted step at
   unchanged (delta, omega) whose cost did not fall shrinks delta), and
   marks it converged when the mean state change is under the threshold.
A problem that has converged, or whose omega passed its cap, or that ran
`max_iters` iterations, keeps its state.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .numerics import Numerics
from .tpwl import Dictionary, distances

SIGMA, ALPHA = 1e-6, 1.6
RHO_EQ_SCALE = 1e3


@dataclass
class GuSTOSettings:
    N: int
    dt: float
    Qz: float            # Qz I on the outputs
    R: float             # R I on the commands
    u_lb: float
    u_ub: float
    max_iters: int
    qp_iters: int
    rho_qp: float = 0.1
    delta0: float = 1e4
    omega0: float = 1.0
    rho: float = 0.1
    beta_fail: float = 0.5
    gamma_fail: float = 5.0
    omega_max: float = 1e10
    epsilon: float = 0.01
    convg_thresh: float = 0.1


class BatchGuSTO:
    """The reference of GuSTOJit.solve_batch_fused (sparse formulation, no
    state constraints, unit state and dynamics scales)."""

    def __init__(self, dic: Dictionary, num: Numerics, s: GuSTOSettings):
        self.dic, self.num, self.s = dic, num, s
        N, nx, nu = s.N, dic.n_x, dic.n_u
        dev, dt = dic.A.device, num.dtype
        self.off_u = (N + 1) * nx
        self.off_s = self.off_u + N * nu
        self.n_var = self.off_s + N + 1
        self.r_dyn = nx
        self.r_tr = self.r_dyn + N * nx
        self.r_s = self.r_tr + 2 * nx * (N + 1)
        self.r_U = self.r_s + N + 1
        self.n_con = self.r_U + 2 * N * nu
        nv, nc = self.n_var, self.n_con
        inf = float("inf")
        eye = lambda k: torch.eye(k, dtype=dt, device=dev)
        P = torch.zeros((nv, nv), dtype=dt, device=dev)
        HQH = 2.0 * s.Qz * num.mm(dic.H.T, dic.H)
        for k in range(N + 1):
            P[k * nx:(k + 1) * nx, k * nx:(k + 1) * nx] = HQH
        for k in range(N):
            i = self.off_u + k * nu
            P[i:i + nu, i:i + nu] = 2.0 * s.R * eye(nu)
        A = torch.zeros((nc, nv), dtype=dt, device=dev)
        l = torch.full((nc,), -inf, dtype=dt, device=dev)
        u = torch.full((nc,), inf, dtype=dt, device=dev)
        A[:nx, :nx] = eye(nx)
        for k in range(N):
            r = self.r_dyn + k * nx
            A[r:r + nx, (k + 1) * nx:(k + 2) * nx] = eye(nx)
        for k in range(N + 1):
            r = self.r_tr + 2 * nx * k
            A[r:r + nx, k * nx:(k + 1) * nx] = eye(nx)
            A[r + nx:r + 2 * nx, k * nx:(k + 1) * nx] = -eye(nx)
            A[r:r + 2 * nx, self.off_s + k] = -1.0
            A[self.r_s + k, self.off_s + k] = 1.0
            l[self.r_s + k] = 0.0
        two = torch.tensor([[1.0], [-1.0]], dtype=dt, device=dev)
        for k in range(N):
            r = self.r_U + 2 * nu * k
            c = self.off_u + k * nu
            A[r:r + 2 * nu, c:c + nu] = torch.kron(eye(nu), two)
            u[r:r + 2 * nu] = torch.tensor([s.u_ub, -s.u_lb], dtype=dt,
                                           device=dev).repeat(nu)
        self.P, self.A, self.l, self.u = P, A, l, u
        rho = torch.full((nc,), s.rho_qp, dtype=dt, device=dev)
        rho[:self.r_tr] *= RHO_EQ_SCALE
        self.rho = rho

    def _nearest(self, x):
        return torch.argmin(distances(self.dic, x), dim=1)

    def _qp(self, x_k, u_k, x0, z, delta, omega, warm):
        dic, num, s = self.dic, self.num, self.s
        Bsz, N, nx, nu = x_k.shape[0], s.N, dic.n_x, dic.n_u
        i = self._nearest(x_k[:, :-1].reshape(-1, nx)).reshape(Bsz, N)
        Ad, Bd, dd = dic.A[i], dic.B[i], dic.d[i]
        P = self.P.expand(Bsz, -1, -1)
        A = self.A.repeat(Bsz, 1, 1)
        l = self.l.repeat(Bsz, 1)
        u = self.u.repeat(Bsz, 1)
        for k in range(N):
            r = self.r_dyn + k * nx
            A[:, r:r + nx, k * nx:(k + 1) * nx] = -Ad[:, k]
            A[:, r:r + nx, self.off_u + k * nu:self.off_u + (k + 1) * nu] = (
                -Bd[:, k])
        dflat = dd.reshape(Bsz, -1)
        l[:, self.r_dyn:self.r_tr] = dflat
        u[:, self.r_dyn:self.r_tr] = dflat
        l[:, :nx] = x0
        u[:, :nx] = x0
        tr = torch.stack([delta[:, None, None] + x_k,
                          delta[:, None, None] - x_k], dim=2)
        u[:, self.r_tr:self.r_s] = tr.reshape(Bsz, -1)
        q = torch.zeros((Bsz, self.n_var), dtype=x0.dtype, device=x0.device)
        q[:, :self.off_u] = (-2.0 * s.Qz * num.einsum(
            "bkz,zi->bki", z, dic.H)).reshape(Bsz, -1)
        q[:, self.off_s:] = omega[:, None]
        const = s.Qz * (z * z).sum(dim=(1, 2))
        w, y = self._admm(P, q, A, l, u, *warm)
        J = (0.5 * num.einsum("bi,bi->b", w, num.mv(P, w))
             + num.einsum("bi,bi->b", q, w) + const)
        x_n = w[:, :self.off_u].reshape(Bsz, N + 1, nx)
        u_n = w[:, self.off_u:self.off_s].reshape(Bsz, N, nu)
        return x_n, u_n, J, (w, y)

    def _admm(self, P, q, A, l, u, w, y):
        num, rho = self.num, self.rho
        n = P.shape[-1]
        eye = torch.eye(n, dtype=P.dtype, device=P.device)
        At = A.transpose(-1, -2)
        K = P + SIGMA * eye + num.mm(At * rho[None, None, :], A)
        d = torch.rsqrt(torch.diagonal(K, dim1=-2, dim2=-1))
        Ks = K * d[..., :, None] * d[..., None, :]
        Ls = torch.linalg.cholesky(Ks)
        Li = torch.linalg.solve_triangular(Ls, eye.expand_as(Ls), upper=False)
        Li = num.mm(Li, 2.0 * eye - num.mm(Ls, Li))
        M1 = Li * d[..., None, :]
        Kinv = num.mm(M1.transpose(-1, -2), M1)
        z = torch.clamp(num.mv(A, w), l, u)
        for _ in range(self.s.qp_iters):
            rhs = SIGMA * w - q + num.mv(At, rho * z - y)
            x_t = num.mv(Kinv, rhs)
            z_t = num.mv(A, x_t)
            w = ALPHA * x_t + (1 - ALPHA) * w
            z_rel = ALPHA * z_t + (1 - ALPHA) * z
            z_new = torch.clamp(z_rel + y / rho, l, u)
            y = y + rho * (z_rel - z_new)
            z = z_new
        return w, y

    def _accuracy(self, x_n, u_n, x_k, u_k, J):
        dic, num, s = self.dic, self.num, self.s
        Bsz, N, nx = x_n.shape[0], s.N, dic.n_x
        X = torch.stack([x_n[:, :-1], x_k[:, :-1]])      # (2, B, N, nx)
        U = torch.stack([u_n, u_k])
        i = self._nearest(X.reshape(-1, nx)).reshape(X.shape[:3])
        Ac, Bc, dc = dic.Ac[i], dic.Bc[i], dic.dc[i]
        f = num.mv(Ac, X) + num.mv(Bc, U) + dc
        f_lin = f[1] + num.mv(Ac[1], x_n[:, :-1] - x_k[:, :-1]) + num.mv(
            Bc[1], u_n - u_k)
        norm = lambda a: torch.linalg.vector_norm(a, dim=2)
        err = s.dt * norm(f[0] - f_lin).sum(dim=1)
        approx = s.dt * norm(f_lin).sum(dim=1)
        return err / (J + approx)

    def run(self, x0, u_init, x_init, z):
        """(x (B, N+1, n_x), u (B, N, n_u), iterations (B,), converged (B,),
        J (B,)) of every problem, from x0 (B, n_x), the initial trajectory
        u_init (B, N, n_u), x_init (B, N+1, n_x) and targets z (B, N+1,
        n_z)."""
        num, s = self.num, self.s
        x0, x_k, u_k, z = (num.t(a) for a in (x0, x_init, u_init, z))
        Bsz, dev, dt = x0.shape[0], x0.device, x0.dtype
        full = lambda v: torch.full((Bsz,), v, dtype=dt, device=dev)
        delta, omega = full(s.delta0), full(s.omega0)
        Jp, dp, op, J_last = full(torch.inf), full(torch.inf), \
            full(torch.inf), full(torch.inf)
        itr = torch.zeros(Bsz, dtype=torch.int64, device=dev)
        conv = torch.zeros(Bsz, dtype=torch.bool, device=dev)
        warm = (torch.zeros((Bsz, self.n_var), dtype=dt, device=dev),
                torch.zeros((Bsz, self.n_con), dtype=dt, device=dev))
        sel = lambda m, a, b: torch.where(
            m.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
        for _ in range(s.max_iters):
            x_n, u_n, J, warm_n = self._qp(x_k, u_k, x0, z, delta, omega,
                                           warm)
            dx = x_n - x_k
            tr_ok = (dx.abs().amax(dim=(1, 2)) - delta) <= s.epsilon
            rho_k = self._accuracy(x_n, u_n, x_k, u_k, J)
            rho_bad = (rho_k > s.rho) & (itr != 1)
            mod1 = (dp == delta) & (op == omega) & (Jp <= J)
            dsol = torch.linalg.vector_norm(dx, dim=2).sum(dim=1) / (
                x0.shape[1] * s.N)
            active = ~conv & (omega <= s.omega_max) & (itr < s.max_iters)
            accept = active & tr_ok & ~rho_bad
            shrink = active & tr_ok & rho_bad
            grow = active & ~tr_ok
            conv = torch.where(active, accept & (dsol <= s.convg_thresh),
                               conv)
            itr = itr + active.to(itr.dtype)
            new_delta = torch.where(shrink | (accept & mod1),
                                    s.beta_fail * delta, delta)
            new_omega = torch.where(grow, s.gamma_fail * omega, omega)
            x_k, u_k = sel(accept, x_n, x_k), sel(accept, u_n, u_k)
            Jp = torch.where(accept, J, Jp)
            dp = torch.where(accept, delta, dp)
            op = torch.where(accept, omega, op)
            J_last = torch.where(accept, J, J_last)
            warm = tuple(sel(accept, a, b) for a, b in zip(warm_n, warm))
            delta, omega = new_delta, new_omega
        return x_k, u_k, itr, conv, J_last
