"""Batched closed-loop MPC + EKF on a TPWL dictionary, written plainly.

Each of B loops starts from rest with its EKF at the same state and
identity covariance, and runs `windows` replanning windows. A window:

1. shifts the last plan by N_replan steps (past the horizon the last point
   repeats);
2. takes the nearest point's (A, B, d) at the first N plan states;
3. eliminates the states (x_k = xfree_k + G_k u) and builds the condensed
   QP in u: cost sum_k |H x_k - z_k|^2_Qz + |u|^2_R over k = 1..N, rows
   lb <= u <= ub as two inequalities a coordinate;
4. Ruiz-equilibrates it with OSQP's cost scaling;
5. runs a fixed number of ADMM iterations in stages; before each stage the
   per-row rho is folded into the rows (A <- sqrt(rho) A) and K^-1 of
   P + sigma I + A'A is built from a Jacobi-scaled Cholesky factor with one
   Newton step on its inverse; between stages each QP's rho is rebalanced
   by OSQP's residual ratio;
6. runs N_replan ticks: u = u_plan + K_i (x_hat - x_plan) with the DARE gain
   of the plan point's nearest point, the command clamped to the box, the
   plant stepped at its own nearest point, the measurement taken with its
   noise, and the EKF predicted at the estimate's nearest point and
   corrected.

It returns the output z and the command u of every tick.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .numerics import Numerics
from .tpwl import Dictionary, nearest

SIGMA, ALPHA = 1e-6, 1.6
RHO_MIN, RHO_MAX = 1e-6, 1e6
BIG = 1e30


@dataclass
class MPCSettings:
    N: int
    N_replan: int
    Qz: float            # Qz = Qz I on the outputs
    R: float             # R = R I on the commands
    u_lb: float
    u_ub: float
    qp_iters: int
    rho_stages: int
    rho: float
    scaling_iters: int
    W: float             # EKF process covariance W I
    V: float             # and measurement covariance V I
    noise_std: float
    dare_iters: int = 40


def dare_gains(dic: Dictionary, num: Numerics, s: MPCSettings):
    """K_i = -(R + B'PB)^-1 B'PA of every point, P by the doubling
    algorithm, with Q = H' Qz H."""
    A, Bm = dic.A, dic.B
    n, m = dic.n_x, dic.n_u
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    Q = s.Qz * num.mm(dic.H.T, dic.H)
    R = s.R * torch.eye(m, dtype=A.dtype, device=A.device)
    Bt = Bm.transpose(-1, -2)
    G = num.mm(Bm, torch.linalg.solve(R, Bt))
    Ak, Gk, Hk = A, G, Q.expand_as(A)
    for _ in range(s.dare_iters):
        W = eye + num.mm(Gk, Hk)
        WinvA = torch.linalg.solve(W, Ak)
        A1 = num.mm(Ak, WinvA)
        G1 = Gk + num.mm(Ak, torch.linalg.solve(
            W, num.mm(Gk, Ak.transpose(-1, -2))))
        H1 = Hk + num.mm(num.mm(Ak.transpose(-1, -2), Hk), WinvA)
        Ak, Gk, Hk = A1, G1, H1
    BtP = num.mm(Bt, Hk)
    return -torch.linalg.solve(R + num.mm(BtP, Bm), num.mm(BtP, A))


class ClosedLoop:
    """The reference of BatchMPC.build_fused on one dictionary."""

    def __init__(self, dic: Dictionary, num: Numerics, s: MPCSettings):
        self.dic, self.num, self.s = dic, num, s
        dev, dt = dic.A.device, num.dtype
        self.K = dare_gains(dic, num, s)
        N, nu = s.N, dic.n_u
        self.n_var, self.n_con = N * nu, 2 * N * nu
        # rows [u_j <= ub; -u_j <= -lb] for each coordinate of each step
        two = torch.tensor([[1.0], [-1.0]], dtype=dt, device=dev)
        self.A_U = torch.kron(torch.eye(self.n_var, dtype=dt, device=dev), two)
        self.u_U = torch.tensor([s.u_ub, -s.u_lb], dtype=dt,
                                device=dev).repeat(self.n_var)
        self.l_U = torch.full((self.n_con,), -BIG, dtype=dt, device=dev)

    # -- one window --------------------------------------------------------
    def _condense(self, Ad, Bd, dd, x0, z):
        """(P, q, xfree, G) of the condensed QP."""
        num, dic, s = self.num, self.dic, self.s
        N, nu = s.N, dic.n_u
        Bsz = x0.shape[0]
        x = x0
        G = torch.zeros((Bsz, dic.n_x, N * nu), dtype=x.dtype,
                        device=x.device)
        xs, Gs = [x], [G]
        for k in range(N):
            A = Ad[:, k]
            G = num.mm(A, G)
            G[:, :, k * nu:(k + 1) * nu] += Bd[:, k]
            x = num.mv(A, x) + dd[:, k]
            xs.append(x)
            Gs.append(G)
        xfree, G = torch.stack(xs, dim=1), torch.stack(Gs, dim=1)
        HG = num.einsum("ij,bkjm->bkim", dic.H, G[:, 1:])
        e = num.einsum("ij,bkj->bki", dic.H, xfree[:, 1:]) - z[:, 1:]
        P = 2.0 * s.Qz * num.einsum("bkiv,bkiw->bvw", HG, HG)
        q = 2.0 * s.Qz * num.einsum("bkiv,bki->bv", HG, e)
        P = P + 2.0 * s.R * torch.eye(N * nu, dtype=P.dtype, device=P.device)
        return P, q, xfree, G

    def _ruiz(self, P, q, A):
        Bsz, n = q.shape
        m = A.shape[1]
        d = torch.ones((Bsz, n), dtype=P.dtype, device=P.device)
        e = torch.ones((Bsz, m), dtype=P.dtype, device=P.device)
        c = torch.ones(Bsz, dtype=P.dtype, device=P.device)
        one = torch.ones((), dtype=P.dtype, device=P.device)
        for _ in range(self.s.scaling_iters):
            col_x = torch.maximum(P.abs().amax(dim=1), A.abs().amax(dim=1))
            col_y = A.abs().amax(dim=2)
            dd = torch.where(col_x > 1e-12, 1.0 / torch.sqrt(
                torch.clamp(col_x, min=1e-12)), one)
            ee = torch.where(col_y > 1e-12, 1.0 / torch.sqrt(
                torch.clamp(col_y, min=1e-12)), one)
            P = P * dd[:, :, None] * dd[:, None, :]
            q = q * dd
            A = A * ee[:, :, None] * dd[:, None, :]
            d, e = d * dd, e * ee
            gamma = 1.0 / torch.clamp(torch.maximum(
                P.abs().amax(dim=1).mean(dim=1), q.abs().amax(dim=1)),
                min=1e-12)
            P = P * gamma[:, None, None]
            q = q * gamma[:, None]
            c = c * gamma
        return P, q, A, d, e, c

    def _kinv(self, P, A):
        num = self.num
        n = P.shape[-1]
        eye = torch.eye(n, dtype=P.dtype, device=P.device)
        K = P + SIGMA * eye + num.mm(A.transpose(-1, -2), A)
        d = torch.rsqrt(torch.diagonal(K, dim1=-2, dim2=-1))
        Ks = K * d[..., :, None] * d[..., None, :]
        Ls = torch.linalg.cholesky(Ks)
        Li = torch.linalg.solve_triangular(Ls, eye.expand_as(Ls), upper=False)
        Li = num.mm(Li, 2.0 * eye - num.mm(Ls, Li))
        M1 = Li * d[..., None, :]
        return num.mm(M1.transpose(-1, -2), M1)

    def _admm(self, Kinv, A, q, l, u, w, y, iters):
        """Fixed iterations at unit rho (rho folded into the rows)."""
        num = self.num
        z = torch.clamp(num.mv(A, w), l, u)
        At = A.transpose(-1, -2)
        for _ in range(iters):
            rhs = SIGMA * w - q + num.mv(At, z - y)
            x_t = num.mv(Kinv, rhs)
            z_t = num.mv(A, x_t)
            w = ALPHA * x_t + (1 - ALPHA) * w
            z_rel = ALPHA * z_t + (1 - ALPHA) * z
            z_new = torch.clamp(z_rel + y, l, u)
            y = y + (z_rel - z_new)
            z = z_new
        return w, y

    def _rho_multiplier(self, P, q, A, l, u, w, y):
        num = self.num
        amax = lambda t: t.abs().amax(dim=-1)
        Ax = num.mv(A, w)
        z = torch.clamp(Ax, l, u)
        pri = amax(Ax - z)
        pri_sc = torch.clamp(torch.maximum(amax(Ax), amax(z)), min=1e-12)
        Px = num.mv(P, w)
        Aty = num.mv(A.transpose(-1, -2), y)
        dua = amax(Px + q + Aty)
        dua_sc = torch.maximum(torch.maximum(amax(Px), amax(Aty)),
                               torch.clamp(amax(q), min=1e-12))
        return torch.sqrt((pri / pri_sc)
                          / torch.clamp(dua / dua_sc, min=1e-18))

    def _solve(self, P, q, A, l, u, w, y):
        s = self.s
        Bsz, m = l.shape
        per = max(1, s.qp_iters // s.rho_stages)
        rho = torch.full((Bsz, m), s.rho, dtype=q.dtype, device=q.device)
        for k in range(s.rho_stages):
            srt = torch.sqrt(rho)
            As = A * srt[:, :, None]
            w, ys = self._admm(self._kinv(P, As), As, q, srt * l, srt * u, w,
                               y / srt, per)
            y = srt * ys
            if k < s.rho_stages - 1:
                mult = self._rho_multiplier(P, q, A, l, u, w, y)
                rho = torch.clamp(rho * mult[:, None], RHO_MIN, RHO_MAX)
        return w, y

    def _window(self, x0, x_plan, u_plan, z_win, warm):
        dic, s = self.dic, self.s
        Bsz, N, n = x0.shape[0], s.N, dic.n_x
        k = s.N_replan
        sh = lambda a: torch.cat([a[:, k:], a[:, -1:].expand(-1, k, -1)], 1)
        x_plan, u_plan = sh(x_plan), sh(u_plan)
        i = nearest(dic, x_plan[:, :-1].reshape(-1, n)).reshape(Bsz, N)
        P, q, xfree, G = self._condense(dic.A[i], dic.B[i], dic.d[i], x0,
                                        z_win - dic.z_ref)
        A = self.A_U.expand(Bsz, -1, -1)
        l = self.l_U.expand(Bsz, -1)
        u = self.u_U.expand(Bsz, -1)
        w0, y0 = warm
        Ps, qs, As, d, e, c = self._ruiz(P, q, A)
        w, y = self._solve(Ps, qs, As, e * l, e * u, w0 / d,
                           c[:, None] * y0 / e)
        w = d * w
        y = e * y / c[:, None]
        u_plan = w.reshape(Bsz, N, dic.n_u)
        x_plan = xfree + self.num.einsum("bkim,bm->bki", G, w)
        return x_plan, u_plan, (w, y)

    def _tick(self, x_p, x_e, Sig, x_bar, u_bar, noise):
        dic, num, s = self.dic, self.num, self.s
        eye = torch.eye(dic.n_x, dtype=x_p.dtype, device=x_p.device)
        i_bar, i_p, i_e = (nearest(dic, x) for x in (x_bar, x_p, x_e))
        u = u_bar + num.mv(self.K[i_bar], x_e - x_bar)
        u = torch.clamp(u, s.u_lb, s.u_ub)
        x_next = num.mv(dic.A[i_p], x_p) + num.mv(dic.B[i_p], u) + dic.d[i_p]
        y = num.mv(dic.C, x_next) + dic.y_ref + s.noise_std * noise
        A_e = dic.A[i_e]
        x_pr = num.mv(A_e, x_e) + num.mv(dic.B[i_e], u) + dic.d[i_e]
        S_pr = num.mm(num.mm(A_e, Sig), A_e.transpose(-1, -2)) + s.W * eye
        C = dic.C
        Sm = num.mm(num.mm(C, S_pr), C.T) + s.V * torch.eye(
            C.shape[0], dtype=C.dtype, device=C.device)
        Kf = torch.linalg.solve(Sm.transpose(-1, -2), num.mm(
            C, S_pr.transpose(-1, -2))).transpose(-1, -2)
        x_e = x_pr + num.mv(Kf, y - dic.y_ref - num.mv(C, x_pr))
        Sig = num.mm(eye - num.mm(Kf, C), S_pr)
        z = num.mv(dic.H, x_next) + dic.z_ref
        return x_next, x_e, Sig, z, u

    def run(self, x_plant0, x_est0, z_target, noise):
        """z_target (B, windows, N+1, n_z) absolute, noise (windows,
        N_replan, B, n_y) standard normal. Returns z (B, T, n_z) and u (B,
        T, n_u)."""
        dic, num, s = self.dic, self.num, self.s
        x_p, x_e = num.t(x_plant0), num.t(x_est0)
        z_target, noise = num.t(z_target), num.t(noise)
        Bsz = x_p.shape[0]
        dev, dt = x_p.device, x_p.dtype
        Sig = torch.eye(dic.n_x, dtype=dt, device=dev).expand(Bsz, -1, -1)
        x_plan = x_e[:, None].expand(-1, s.N + 1, -1)
        u_plan = torch.zeros((Bsz, s.N, dic.n_u), dtype=dt, device=dev)
        warm = (torch.zeros((Bsz, self.n_var), dtype=dt, device=dev),
                torch.zeros((Bsz, self.n_con), dtype=dt, device=dev))
        zs, us = [], []
        for w in range(z_target.shape[1]):
            x_plan, u_plan, warm = self._window(x_e, x_plan, u_plan,
                                                z_target[:, w], warm)
            for k in range(s.N_replan):
                x_p, x_e, Sig, z, u = self._tick(
                    x_p, x_e, Sig, x_plan[:, k], u_plan[:, k], noise[w, k])
                zs.append(z)
                us.append(u)
        return torch.stack(zs, dim=1), torch.stack(us, dim=1)
