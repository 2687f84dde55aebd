"""LOCP: the convex subproblem of GuSTO, assembled directly as a dense QP.

Decision variables  w = [x_0..x_N | u_0..u_{N-1} | s_0..s_N]; objective
(cvxpy convention, no 1/2 factor)

    J = sum_k (u_k - u_des_k)' R (u_k - u_des_k)
      + sum_k (H_k x_k + c_k - z_k)' Qz (H_k x_k + c_k - z_k)
      + (H_N x_N + c_N - zf)' Qzf (...)          [terminal, optional]
      + omega * sum_k s_k                        [trust-region slack]
      + ||Nu u||^2                               [nullspace penalty, optional]

constraints
    x_{k+1} = A_k x_k + B_k u_k + d_k            (equalities)
    x_0 = x0
    |x_scale * (x_k - xbar_k)|_inf <= delta + s_k,  s_k >= 0
    U.A u_k <= U.b;   dU.A (u_{k+1} - u_k) <= dU.b
    X.A (H_k x_k + c_k) <= X.b  for k=1..N;   Xf.A x_N <= Xf.b

The parameter-independent parts of (P, A, l, u) are built once; `assemble`
fills in the per-solve blocks for a whole batch of problems at once (every
array of `LOCPParams` carries a leading batch axis B). One-sided rows keep
their infinite bound.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from soft_robot_control_tpu_torch.qp.admm import solve_qp_dense
from soft_robot_control_tpu_torch.utils.device import as_tensor, resolve_device


class LOCPParams(NamedTuple):
    """Per-solve data, batched over a leading axis B."""
    Ad: torch.Tensor            # (B, N, nx, nx)
    Bd: torch.Tensor            # (B, N, nx, nu)
    dd: torch.Tensor            # (B, N, nx)
    x0: torch.Tensor            # (B, nx)
    xk: torch.Tensor            # (B, N+1, nx) trust-region centre
    delta: torch.Tensor         # scalar or (B,) trust-region radius
    omega: torch.Tensor         # scalar or (B,) slack weight
    z: torch.Tensor             # (B, N+1, nz) tracking target
    zf: torch.Tensor            # (B, nz) terminal target
    u_des: torch.Tensor         # (B, N, nu) input target
    Hd: Optional[torch.Tensor] = None  # (B, N+1, nz, nx) observer Jacobians
    cd: Optional[torch.Tensor] = None  # (B, N+1, nz) observer offsets


def _block_diagonal(M, rows, cols, offset: int = 0):
    """Writable view (B, r, c, K) of the K diagonal blocks (k, k + offset) of
    M (B, rows[0]*rows[1], cols[0]*cols[1]) cut into blocks of (r, c)."""
    blk = M.unflatten(2, cols).unflatten(1, rows)
    return torch.diagonal(blk[:, :, :, offset:], dim1=1, dim2=3)


class LOCPSpec:
    """Static problem structure: dimensions, costs, constraint sets."""

    def __init__(self, N, H, Qz, R, Qzf=None, U=None, X=None, Xf=None, dU=None,
                 x_char=None, nonlinear_observer=False, is_tr_active=True,
                 input_nullspace=None, dtype=torch.float64, device="cuda"):
        self.device = resolve_device(device)
        self.dtype = dtype
        f64 = lambda a: np.array(
            a.detach().cpu().numpy() if torch.is_tensor(a) else a,
            dtype=np.float64)
        self.N = int(N)
        self.H = f64(H)
        self.Qz = f64(Qz)
        self.R = f64(R)
        self.Qzf = None if Qzf is None else f64(Qzf)
        self.U, self.X, self.Xf, self.dU = U, X, Xf, dU
        self.nonlinear_observer = bool(nonlinear_observer)
        self.tr_active = bool(is_tr_active)
        self.input_nullspace = (None if input_nullspace is None
                                else f64(input_nullspace))

        self.n_x = self.H.shape[1]
        self.n_z = self.Qz.shape[0]
        self.n_u = self.R.shape[0]
        if x_char is None:
            self.x_scale = np.ones(self.n_x)
        else:
            self.x_scale = 1.0 / np.abs(f64(x_char))

        N, nx, nu = self.N, self.n_x, self.n_u
        # variable layout
        self.off_x = 0
        self.off_u = (N + 1) * nx
        self.off_s = self.off_u + N * nu
        self.n_var = self.off_s + ((N + 1) if self.tr_active else 0)

        # constraint row layout
        rows = 0
        self.r_init = rows
        rows += nx
        self.r_dyn = rows
        rows += N * nx
        if self.tr_active:
            self.r_tr = rows
            rows += 2 * nx * (N + 1)
            self.r_s = rows
            rows += N + 1
        if self.U is not None:
            self.r_U = rows
            rows += N * np.asarray(self.U.A).shape[0]
        if self.dU is not None:
            self.r_dU = rows
            rows += (N - 1) * np.asarray(self.dU.A).shape[0]
        if self.X is not None:
            self.r_X = rows
            rows += N * np.asarray(self.X.A).shape[0]
        if self.Xf is not None:
            self.r_Xf = rows
            rows += np.asarray(self.Xf.A).shape[0]
        self.n_con = rows

        self._build_static()

    # ------------------------------------------------------------------
    def _build_static(self):
        """Precompute the parameter-independent parts of (P, A, l, u)."""
        N, nx, nu = self.N, self.n_x, self.n_u
        nv, nc = self.n_var, self.n_con

        # P template (cvxpy-convention quad forms => factor 2 in 0.5 w'Pw)
        P = np.zeros((nv, nv))
        for k in range(N):
            i = self.off_u + k * nu
            P[i:i + nu, i:i + nu] = 2.0 * self.R
        if not self.nonlinear_observer:
            HQH = 2.0 * self.H.T @ self.Qz @ self.H
            for k in range(N + 1):
                i = k * nx
                P[i:i + nx, i:i + nx] += HQH
            if self.Qzf is not None:
                i = N * nx
                P[i:i + nx, i:i + nx] += 2.0 * self.H.T @ self.Qzf @ self.H
        if self.input_nullspace is not None:
            Nu = self.input_nullspace  # (r, nu), applied per step
            NtN = 2.0 * Nu.T @ Nu
            for k in range(N):
                i = self.off_u + k * nu
                P[i:i + nu, i:i + nu] += NtN

        # A template and the static pieces of (l, u)
        A = np.zeros((nc, nv))
        l = np.full(nc, -np.inf)
        u = np.full(nc, np.inf)

        # initial condition rows: x_0 = x0 (bounds set per solve)
        A[self.r_init:self.r_init + nx, 0:nx] = np.eye(nx)

        # dynamics rows: x_{k+1} - A_k x_k - B_k u_k = d_k; the +I on
        # x_{k+1} is static, A_k and B_k are scattered per solve
        for k in range(N):
            r = self.r_dyn + k * nx
            A[r:r + nx, (k + 1) * nx:(k + 2) * nx] = np.eye(nx)

        if self.tr_active:
            # trust region: +/- x_scale*(x_k - xbar_k) - s_k <= delta
            for k in range(N + 1):
                r = self.r_tr + 2 * nx * k
                A[r:r + nx, k * nx:(k + 1) * nx] = np.diag(self.x_scale)
                A[r:r + nx, self.off_s + k] = -1.0
                A[r + nx:r + 2 * nx, k * nx:(k + 1) * nx] = -np.diag(
                    self.x_scale)
                A[r + nx:r + 2 * nx, self.off_s + k] = -1.0
            # slack positivity s_k >= 0
            for k in range(N + 1):
                A[self.r_s + k, self.off_s + k] = 1.0
                l[self.r_s + k] = 0.0

        if self.U is not None:
            UA, Ub = np.asarray(self.U.A), np.asarray(self.U.b)
            mU = UA.shape[0]
            for k in range(N):
                r = self.r_U + k * mU
                A[r:r + mU, self.off_u + k * nu:self.off_u + (k + 1) * nu] = UA
                u[r:r + mU] = Ub

        if self.dU is not None:
            dA, db = np.asarray(self.dU.A), np.asarray(self.dU.b)
            mdU = dA.shape[0]
            for k in range(N - 1):
                r = self.r_dU + k * mdU
                A[r:r + mdU,
                  self.off_u + (k + 1) * nu:self.off_u + (k + 2) * nu] = dA
                A[r:r + mdU,
                  self.off_u + k * nu:self.off_u + (k + 1) * nu] = -dA
                u[r:r + mdU] = db

        if self.X is not None and not self.nonlinear_observer:
            # linear case: X is a polytope on the STATE x_k for k=1..N; only
            # the nonlinear-observer case routes the constraint through the
            # output linearization
            XA, Xb = np.asarray(self.X.A), np.asarray(self.X.b)
            mX = XA.shape[0]
            for k in range(N):
                r = self.r_X + k * mX
                A[r:r + mX, (k + 1) * nx:(k + 2) * nx] = XA
                u[r:r + mX] = Xb

        if self.Xf is not None:
            XfA, Xfb = np.asarray(self.Xf.A), np.asarray(self.Xf.b)
            mXf = XfA.shape[0]
            A[self.r_Xf:self.r_Xf + mXf, N * nx:(N + 1) * nx] = XfA
            u[self.r_Xf:self.r_Xf + mXf] = Xfb

        t = lambda a: as_tensor(a, self.dtype, self.device)
        self._P_static, self._A_static = t(P), t(A)
        self._l_static, self._u_static = t(l), t(u)
        self._H, self._Qz, self._R = t(self.H), t(self.Qz), t(self.R)
        self._Qzf = None if self.Qzf is None else t(self.Qzf)
        self._x_scale = t(self.x_scale)

    # ------------------------------------------------------------------
    def assemble(self, p: LOCPParams):
        """(P, q, A, l, u, const) of 0.5 w'Pw + q'w + const, l <= A w <= u,
        each with the leading batch axis of `p`."""
        N, nx, nu = self.N, self.n_x, self.n_u
        dt, dev = self.dtype, self.device
        Bsz = p.x0.shape[0]
        P = self._P_static.expand(Bsz, -1, -1)
        A = self._A_static.repeat(Bsz, 1, 1)
        l = self._l_static.repeat(Bsz, 1)
        u = self._u_static.repeat(Bsz, 1)
        q = torch.zeros((Bsz, self.n_var), dtype=dt, device=dev)
        Qz, R = self._Qz, self._R
        dyn = slice(self.r_dyn, self.r_dyn + N * nx)
        xs = slice(self.off_x, self.off_u)
        us = slice(self.off_u, self.off_u + N * nu)
        xN = slice(N * nx, (N + 1) * nx)

        # dynamics blocks: -A_k at (k, k), -B_k at (k, k); bounds = d_k
        _block_diagonal(A[:, dyn, xs], (N, nx), (N + 1, nx)).sub_(
            p.Ad.permute(0, 2, 3, 1))
        _block_diagonal(A[:, dyn, us], (N, nx), (N, nu)).copy_(
            -p.Bd.permute(0, 2, 3, 1))
        dd_flat = p.dd.reshape(Bsz, N * nx)
        l[:, dyn] = dd_flat
        u[:, dyn] = dd_flat

        # initial condition bounds
        init = slice(self.r_init, self.r_init + nx)
        l[:, init] = p.x0
        u[:, init] = p.x0

        # trust region bounds: delta +/- x_scale * xbar, rows [+x; -x] per k
        if self.tr_active:
            delta = torch.as_tensor(p.delta, dtype=dt, device=dev).reshape(
                -1, 1, 1)
            sx = self._x_scale * p.xk
            tr_u = torch.stack([delta + sx, delta - sx], dim=2)
            u[:, self.r_tr:self.r_tr + 2 * nx * (N + 1)] = tr_u.reshape(
                Bsz, -1)

        # control: (u - u_des)'R(u - u_des) => q_u = -2 R u_des
        uR = p.u_des @ R
        q[:, us] = (-2.0 * uR).reshape(Bsz, -1)
        const = (uR * p.u_des).sum(dim=(1, 2))

        if self.nonlinear_observer:
            # time-varying H_k: quadratic blocks into P, linear into q
            P = P.clone()
            HQH = 2.0 * torch.einsum("bkzi,zw,bkwj->bkij", p.Hd, Qz, p.Hd)
            _block_diagonal(P[:, xs, xs], (N + 1, nx), (N + 1, nx)).add_(
                HQH.permute(0, 2, 3, 1))
            resid = p.cd - p.z                                # (B, N+1, nz)
            q[:, xs] += 2.0 * torch.einsum(
                "bkz,zw,bkwi->bki", resid, Qz, p.Hd).reshape(Bsz, -1)
            const = const + torch.einsum("bkz,zw,bkw->b", resid, Qz, resid)
            if self._Qzf is not None:
                Qzf, HN = self._Qzf, p.Hd[:, N]
                P[:, xN, xN] += 2.0 * HN.transpose(1, 2) @ Qzf @ HN
                rf = p.cd[:, N] - p.zf
                q[:, xN] += 2.0 * torch.einsum("bz,zw,bwi->bi", rf, Qzf, HN)
                const = const + torch.einsum("bz,zw,bw->b", rf, Qzf, rf)
            # state constraints through the output linearization, k = 1..N
            if self.X is not None:
                XA = as_tensor(self.X.A, dt, dev)
                Xb = as_tensor(self.X.b, dt, dev)
                mX = XA.shape[0]
                XAH = torch.einsum("ci,bkij->bkcj", XA, p.Hd[:, 1:])
                rX = slice(self.r_X, self.r_X + N * mX)
                _block_diagonal(A[:, rX, xs], (N, mX), (N + 1, nx),
                                offset=1).copy_(XAH.permute(0, 2, 3, 1))
                u[:, rX] = (Xb - torch.einsum(
                    "ci,bki->bkc", XA, p.cd[:, 1:])).reshape(Bsz, -1)
        else:
            H = self._H
            # (H x_k - z_k)'Qz(...) => q_x = -2 H'Qz z_k
            q[:, xs] += (-2.0 * torch.einsum(
                "bkz,zw,wi->bki", p.z, Qz, H)).reshape(Bsz, -1)
            const = const + torch.einsum("bkz,zw,bkw->b", p.z, Qz, p.z)
            if self._Qzf is not None:
                Qzf = self._Qzf
                q[:, xN] += -2.0 * p.zf @ Qzf @ H
                const = const + torch.einsum("bz,zw,bw->b", p.zf, Qzf, p.zf)

        # slack weight
        if self.tr_active:
            q[:, self.off_s:] = torch.as_tensor(
                p.omega, dtype=dt, device=dev).reshape(-1, 1)

        return P, q, A, l, u, const

    # unpackers ----------------------------------------------------------
    def split(self, w):
        """(x, u, s) of a solution w (..., n_var); s is None without a
        trust region."""
        N, nx, nu = self.N, self.n_x, self.n_u
        lead = w.shape[:-1]
        x = w[..., self.off_x:self.off_u].reshape(lead + (N + 1, nx))
        u = w[..., self.off_u:self.off_u + N * nu].reshape(lead + (N, nu))
        s = w[..., self.off_s:] if self.tr_active else None
        return x, u, s


class LOCP:
    """Stateful wrapper with the reference's update/solve/get_solution API
    for one problem (no batch axis), holding warm-start vectors between
    solves."""

    def __init__(self, N, H, Qz, R, Qzf=None, U=None, X=None, Xf=None, dU=None,
                 verbose=False, warm_start=True, x_char=None,
                 nonlinear_observer=False, is_tr_active=True,
                 input_nullspace=None, dtype=torch.float64, device="cuda",
                 **solver_kwargs):
        self.spec = LOCPSpec(N, H, Qz, R, Qzf=Qzf, U=U, X=X, Xf=Xf, dU=dU,
                             x_char=x_char,
                             nonlinear_observer=nonlinear_observer,
                             is_tr_active=is_tr_active,
                             input_nullspace=input_nullspace, dtype=dtype,
                             device=device)
        self.warm_start = warm_start
        self.verbose = verbose
        if "eps_abs" not in solver_kwargs and dtype == torch.float32:
            # f32 cannot reach the f64-parity 1e-8 targets; OSQP's own
            # default accuracy is 1e-3: aim between
            solver_kwargs["eps_abs"] = 1e-5
            solver_kwargs["eps_rel"] = 1e-5
        self.solver_kwargs = solver_kwargs
        self._w_prev = None
        self._y_prev = None
        self._params = None
        self._solution = None
        self.solve_time = 0.0

    def update(self, Ad, Bd, dd, x0, xk, delta, omega, z=None, zf=None, u=None,
               full=True, Hd=None, cd=None):
        spec = self.spec
        N, nx, nz, nu = spec.N, spec.n_x, spec.n_z, spec.n_u

        def t(a, shape):
            """`a` (array, tensor or list of per-step arrays) as a (1, ...)
            tensor; None gives zeros."""
            if a is None:
                return torch.zeros((1,) + shape, dtype=spec.dtype,
                                   device=spec.device)
            if isinstance(a, (list, tuple)):
                a = np.stack([
                    b.detach().cpu().numpy() if torch.is_tensor(b)
                    else np.asarray(b) for b in a])
            return as_tensor(a, spec.dtype, spec.device).reshape(
                (1,) + shape)

        self._params = LOCPParams(
            Ad=t(Ad, (N, nx, nx)), Bd=t(Bd, (N, nx, nu)), dd=t(dd, (N, nx)),
            x0=t(x0, (nx,)), xk=t(xk, (N + 1, nx)), delta=t(delta, ()),
            omega=t(omega, ()), z=t(z, (N + 1, nz)), zf=t(zf, (nz,)),
            u_des=t(u, (N, nu)), Hd=t(Hd, (N + 1, nz, nx)),
            cd=t(cd, (N + 1, nz)))

    def solve(self):
        """Returns (Jstar, success, stats); Jstar uses the cvxpy convention
        (objective including constants)."""
        t0 = time.time()
        P, q, A, l, u, const = (a[0] for a in self.spec.assemble(self._params))
        warm = self.warm_start and self._w_prev is not None
        sol = solve_qp_dense(P, q, A, l, u,
                             x0=self._w_prev if warm else None,
                             y0=self._y_prev if warm else None,
                             **self.solver_kwargs)
        Jstar = float(sol.obj + const)  # host read: the solve has finished
        self.solve_time = time.time() - t0
        self._solution = sol
        if self.warm_start:
            self._w_prev = sol.x
            self._y_prev = sol.y
        # accept 'solved inaccurate' results (OSQP semantics), relative to
        # the problem's residual scales; f32 bottoms out near 1e-4..1e-3
        if self.spec.dtype == torch.float32:
            acc_pri, acc_dua = 1e-3, 1e-2
        else:
            acc_pri, acc_dua = 1e-5, 1e-4
        pri_rel = float(sol.pri_res) / max(1.0, float(sol.pri_sc))
        dua_rel = float(sol.dua_res) / max(1.0, float(sol.dua_sc))
        success = bool(sol.solved) or (pri_rel < acc_pri and
                                       dua_rel < acc_dua)
        return (Jstar, True, self) if success else (np.inf, False, None)

    def get_solution(self):
        x, u, s = self.spec.split(self._solution.x.detach().cpu().numpy())
        return x, u, s
