"""Condensed LOCP: the state trajectory eliminated through the dynamics.

The dynamics equalities are eliminated exactly by forward substitution,

    x_k = xfree_k + G_k u,   xfree_{k+1} = A_k xfree_k + d_k,
    G_{k+1} = A_k G_k + B_k E_k   (E_k selects u_k's block),

which leaves a QP in u alone (N*nu variables, plus one slack with the trust
region). Every array carries a leading batch axis B. Supported: output
tracking through a constant H or a time-varying map (Hd, cd) for nonlinear
observers, a terminal cost Qzf, R and u_des, U and dU polyhedra on the
inputs, X on the predicted states x_1..x_N, and GuSTO's trust region
|x_scale (x_k - xk_k)|_inf <= delta + s with one shared slack s >= 0 whose
linear cost is omega.

The U and dU rows do not depend on the linearization and are built once;
the X and trust-region rows go through G, so with either of them A is a
fresh tensor a QP.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

_BIG = 1e30  # bound of a one-sided row


class CondensedParams(NamedTuple):
    Ad: torch.Tensor          # (B, N, nx, nx)
    Bd: torch.Tensor          # (B, N, nx, nu)
    dd: torch.Tensor          # (B, N, nx)
    x0: torch.Tensor          # (B, nx)
    z: torch.Tensor           # (B, N+1, nz) targets
    u_des: torch.Tensor       # (B, N, nu)
    Hd: Optional[torch.Tensor] = None     # (B, N+1, nz, nx) output map
    cd: Optional[torch.Tensor] = None     # (B, N+1, nz) output offsets
    # trust region (a spec with trust_region=True)
    xk: Optional[torch.Tensor] = None     # (B, N+1, nx) linearization traj
    delta: Optional[torch.Tensor] = None  # scalar or (B,) radius
    omega: Optional[torch.Tensor] = None  # scalar or (B,) slack weight
    zf: Optional[torch.Tensor] = None     # (B, nz) terminal target (Qzf)


class CondensedSpec:
    """Static structure of the condensed LOCP.

    H: (nz, nx) output map (used when nonlinear_observer is False). U/dU:
    Polyhedron-like with .A/.b on the inputs; X on the predicted states.
    """

    def __init__(self, N: int, H, Qz, R, U=None, dU=None, X=None,
                 nonlinear_observer: bool = False, trust_region: bool = False,
                 x_char=None, dtype=torch.float32, Qzf=None, device="cuda"):
        from soft_robot_control_tpu_torch.utils.device import (as_tensor,
                                                               resolve_device)

        self.N = int(N)
        self.device = resolve_device(device)
        self.dtype = dtype
        t = lambda a: as_tensor(a, dtype, self.device)
        self.H = t(H)
        self.n_z, self.n_x = self.H.shape
        self.Qz = t(Qz)
        self.Qzf = None if Qzf is None else t(Qzf)
        self.R = t(R)
        self.n_u = self.R.shape[0]
        self.U, self.dU, self.X = U, dU, X
        self.nonlinear_observer = bool(nonlinear_observer)
        self.trust_region = bool(trust_region)
        x_char = np.ones(self.n_x) if x_char is None else np.asarray(x_char)
        self.x_scale = t(1.0 / np.abs(x_char))
        self.n_var = self.N * self.n_u + (1 if self.trust_region else 0)

        # row layout: U, dU, X, then the trust region (+ side, - side,
        # s >= 0); all inequalities, so no equality-rho boost
        N_, nu, nv = self.N, self.n_u, self.n_var
        eye = torch.eye(N_, dtype=dtype, device=self.device)
        A_rows, l_rows, u_rows = [], [], []
        low = lambda k: torch.full((k,), -_BIG, dtype=dtype,
                                   device=self.device)
        if U is not None:
            UA, Ub = t(U.A), t(U.b)
            A_rows.append(torch.kron(eye, UA))
            u_rows.append(Ub.repeat(N_))
            l_rows.append(low(N_ * UA.shape[0]))
        if dU is not None:
            DA, Db = t(dU.A), t(dU.b)
            D = (torch.diag(torch.ones(N_ - 1, dtype=dtype,
                                       device=self.device), 1) - eye)[:-1]
            A_rows.append(torch.kron(D, DA))
            u_rows.append(Db.repeat(N_ - 1))
            l_rows.append(low((N_ - 1) * DA.shape[0]))
        rows = sum(a.shape[0] for a in A_rows)
        self.r_X = rows
        if X is not None:
            self._XA, self._Xb = t(X.A), t(X.b)
            rows += N_ * self._XA.shape[0]
        self.r_tr = rows
        if self.trust_region:
            rows += 2 * N_ * self.n_x + 1
        self._dynamic = X is not None or self.trust_region
        if A_rows:
            A = torch.cat(A_rows, dim=0)
            # the slack's column is zero in the input rows
            self._A = torch.cat([A, A.new_zeros(A.shape[0], nv - N_ * nu)],
                                dim=1)
            self._l = torch.cat(l_rows)
            self._u = torch.cat(u_rows)
        elif not self._dynamic:
            # unconstrained: one vacuous row keeps the ADMM's shapes
            self._A = torch.zeros((1, nv), dtype=dtype, device=self.device)
            self._l = low(1)
            self._u = -low(1)
            rows = 1
        else:
            self._A = torch.zeros((0, nv), dtype=dtype, device=self.device)
            self._l = self._u = low(0)
        self.n_con = rows

    # ------------------------------------------------------------------
    def predict(self, params: CondensedParams):
        """Forward-substitution maps: xfree (B, N+1, nx), G (B, N+1, nx,
        N*nu)."""
        N, nu = self.N, self.n_u
        x = params.x0.to(params.Ad.dtype)
        G = torch.zeros(x.shape[:1] + (self.n_x, N * nu), dtype=x.dtype,
                        device=x.device)
        xs, Gs = [x], [G]
        for k in range(N):
            A = params.Ad[:, k]
            G = A @ G
            G[:, :, k * nu:(k + 1) * nu] += params.Bd[:, k]
            x = (A @ x[..., None])[..., 0] + params.dd[:, k]
            xs.append(x)
            Gs.append(G)
        return torch.stack(xs, dim=1), torch.stack(Gs, dim=1)

    # ------------------------------------------------------------------
    def assemble(self, params: CondensedParams):
        """Build (P, q, A, l, u, const, xfree, G) of
        0.5 w'Pw + q'w + const  s.t.  l <= A w <= u, batched over B, with
        J equal to the sparse LOCP's objective at its optimum."""
        N, nx, nu, nz = self.N, self.n_x, self.n_u, self.n_z
        dt, dev = self.dtype, self.device
        xfree, G = self.predict(params)
        Bsz = xfree.shape[0]
        Qz = self.Qz
        z = params.z.to(dt)
        if self.nonlinear_observer:
            Hk = params.Hd.to(dt)                         # (B, N+1, nz, nx)
            HG = torch.einsum("bkij,bkjm->bkim", Hk, G)
            e = torch.einsum("bkij,bkj->bki", Hk, xfree) + params.cd.to(dt) - z
        else:
            HG = torch.einsum("ij,bkjm->bkim", self.H, G)  # (B,N+1,nz,Nu)
            e = torch.einsum("ij,bkj->bki", self.H, xfree) - z
        # stage costs k=1..N; the k=0 stage is a constant (x_0 is u-free)
        P = 2.0 * torch.einsum("bkiv,ij,bkjw->bvw", HG[:, 1:], Qz, HG[:, 1:])
        q = 2.0 * torch.einsum("bkiv,ij,bkj->bv", HG[:, 1:], Qz, e[:, 1:])
        const = torch.einsum("bki,ij,bkj->b", e, Qz, e)
        if self.Qzf is not None:
            # terminal cost (H_N x_N + c_N - zf)' Qzf (...) on top of the
            # stage costs, as in the sparse LOCP
            zf = (torch.zeros((Bsz, nz), dtype=dt, device=dev)
                  if params.zf is None else params.zf.to(dt))
            ef = e[:, N] + z[:, N] - zf
            HGN = HG[:, N]
            P = P + 2.0 * torch.einsum("biv,ij,bjw->bvw", HGN, self.Qzf, HGN)
            q = q + 2.0 * torch.einsum("biv,ij,bj->bv", HGN, self.Qzf, ef)
            const = const + torch.einsum("bi,ij,bj->b", ef, self.Qzf, ef)
        Rb = torch.kron(torch.eye(N, dtype=dt, device=dev), self.R)
        P = P + 2.0 * Rb
        ud = params.u_des.to(dt).reshape(Bsz, -1)
        q = q - 2.0 * ud @ Rb.T
        const = const + torch.einsum("bi,ij,bj->b", ud, Rb, ud)
        if self.trust_region:
            # the slack: no quadratic term, linear cost omega
            P = torch.nn.functional.pad(P, (0, 1, 0, 1))
            omega = torch.as_tensor(params.omega, dtype=dt, device=dev)
            q = torch.cat([q, omega.reshape(-1, 1).expand(Bsz, 1)], dim=1)

        if not self._dynamic:
            return (P, q, self._A.expand(Bsz, -1, -1),
                    self._l.expand(Bsz, -1), self._u.expand(Bsz, -1), const,
                    xfree, G)
        A_rows = [self._A.expand(Bsz, -1, -1)]
        l_rows = [self._l.expand(Bsz, -1)]
        u_rows = [self._u.expand(Bsz, -1)]
        pad = (0, self.n_var - N * nu)
        low = lambda k: torch.full((Bsz, k), -_BIG, dtype=dt, device=dev)
        if self.X is not None:
            XA, mX = self._XA, self._XA.shape[0]
            XG = torch.einsum("ij,bkjm->bkim", XA, G[:, 1:])
            A_rows.append(torch.nn.functional.pad(
                XG.reshape(Bsz, N * mX, N * nu), pad))
            u_rows.append((self._Xb - torch.einsum(
                "ij,bkj->bki", XA, xfree[:, 1:])).reshape(Bsz, -1))
            l_rows.append(low(N * mX))
        if self.trust_region:
            xs = self.x_scale
            dx_free = (xs * (xfree[:, 1:] - params.xk.to(dt)[:, 1:])
                       ).reshape(Bsz, -1)
            SG = (xs[:, None] * G[:, 1:]).reshape(Bsz, N * nx, N * nu)
            ones = torch.ones((Bsz, N * nx, 1), dtype=dt, device=dev)
            delta = torch.as_tensor(params.delta, dtype=dt,
                                    device=dev).reshape(-1, 1)
            # x_scale (x - xk) - s <= delta  and  -x_scale (x - xk) - s <= delta
            A_rows += [torch.cat([SG, -ones], dim=2),
                       torch.cat([-SG, -ones], dim=2)]
            u_rows += [(delta - dx_free).expand(Bsz, -1),
                       (delta + dx_free).expand(Bsz, -1)]
            l_rows += [low(N * nx), low(N * nx)]
            # s >= 0
            srow = torch.zeros((Bsz, 1, self.n_var), dtype=dt, device=dev)
            srow[:, 0, -1] = 1.0
            A_rows.append(srow)
            l_rows.append(torch.zeros((Bsz, 1), dtype=dt, device=dev))
            u_rows.append(-low(1))
        return (P, q, torch.cat(A_rows, dim=1), torch.cat(l_rows, dim=1),
                torch.cat(u_rows, dim=1), const, xfree, G)

    # ------------------------------------------------------------------
    def recover_x(self, xfree, G, u_opt):
        """State trajectory of the input plan: xfree + G u; a trailing slack
        in u_opt is ignored."""
        u_opt = u_opt[..., :self.N * self.n_u]
        return xfree + torch.einsum("bkim,bm->bki", G, u_opt)


class CondensedLOCPAdapter:
    """The LOCP interface (update / solve / get_solution) over
    CondensedSpec for one problem, for the host GuSTO loop
    (locp_backend='condensed') and the LTI MPC service. Each solve runs the
    dense ADMM QP solver (`solve_qp_dense`) to tolerance, warm-started from
    the previous solution."""

    def __init__(self, N, H, Qz, R, Qzf=None, U=None, X=None, Xf=None,
                 dU=None, x_char=None, nonlinear_observer=False,
                 verbose=False, warm_start=True, dtype=torch.float64,
                 is_tr_active=True, device="cuda", **solver_kwargs):
        if Xf is not None:
            raise NotImplementedError(
                "condensed backend supports the no-terminal-set LOCP")
        # is_tr_active=False drops the slacked trust region: the mode for
        # one LOCP a query, where delta never binds
        self.spec = CondensedSpec(int(N), H, Qz, R, U=U, dU=dU, X=X,
                                  nonlinear_observer=bool(nonlinear_observer),
                                  trust_region=bool(is_tr_active),
                                  x_char=x_char, dtype=dtype, Qzf=Qzf,
                                  device=device)
        self.warm_start = bool(warm_start)
        self.solve_time = 0.0
        self._params = None
        self._w_prev = None
        self._y_prev = None
        self._sol = None
        if "eps_abs" not in solver_kwargs and dtype == torch.float32:
            solver_kwargs["eps_abs"] = 1e-5
            solver_kwargs["eps_rel"] = 1e-5
        self.solver_kwargs = dict(solver_kwargs)

    def update(self, Ad, Bd, dd, x0, xk, delta, omega, z=None, zf=None,
               u=None, full=True, Hd=None, cd=None):
        from soft_robot_control_tpu_torch.utils.device import as_tensor

        spec = self.spec
        N, nx, nz, nu = spec.N, spec.n_x, spec.n_z, spec.n_u

        def t(a, shape):
            """`a` as a (1, *shape) tensor; None gives zeros."""
            if a is None:
                return torch.zeros((1,) + shape, dtype=spec.dtype,
                                   device=spec.device)
            return as_tensor(a, spec.dtype, spec.device).reshape(
                (1,) + shape)

        self._params = CondensedParams(
            Ad=t(Ad, (N, nx, nx)), Bd=t(Bd, (N, nx, nu)), dd=t(dd, (N, nx)),
            x0=t(x0, (nx,)), z=t(z, (N + 1, nz)), u_des=t(u, (N, nu)),
            Hd=t(Hd, (N + 1, nz, nx)), cd=t(cd, (N + 1, nz)),
            xk=t(xk, (N + 1, nx)), delta=t(delta, ()), omega=t(omega, ()),
            zf=None if zf is None else t(zf, (nz,)))

    def assemble_solve(self, w0=None, y0=None):
        """Assemble the current problem and solve it to tolerance:
        (QPSolution, const, xfree, G)."""
        from soft_robot_control_tpu_torch.qp.admm import solve_qp_dense

        P, q, A, l, u, const, xfree, G = self.spec.assemble(self._params)
        sol = solve_qp_dense(P[0], q[0], A[0], l[0], u[0], x0=w0, y0=y0,
                             **self.solver_kwargs)
        return sol, const[0], xfree, G

    def solve(self):
        """(J, True, self) when the QP was solved or its relative residuals
        pass the acceptance gates, else (inf, False, None)."""
        t0 = time.time()
        warm = self.warm_start and self._w_prev is not None
        sol, const, xfree, G = self.assemble_solve(
            self._w_prev if warm else None, self._y_prev if warm else None)
        J = float(sol.obj + const)  # host read: the solve has finished
        self.solve_time = time.time() - t0
        self._sol = (sol, xfree, G)
        if self.warm_start:
            self._w_prev = sol.x
            self._y_prev = sol.y
        from soft_robot_control_tpu_torch.qp.admm import accepted

        success = accepted(sol.solved, sol.pri_res, sol.dua_res, sol.pri_sc,
                           sol.dua_sc, self.spec.dtype)[0]
        return (J, True, self) if success else (np.inf, False, None)

    def get_solution(self):
        """(x (N+1, nx), u (N, nu), s) of the last solve, as numpy."""
        sol, xfree, G = self._sol
        N, nu = self.spec.N, self.spec.n_u
        w = sol.x.detach().cpu().numpy()
        u = w[:N * nu].reshape(N, nu)
        x = self.spec.recover_x(xfree, G, sol.x[None])[0]
        s = w[N * nu:] if self.spec.trust_region else np.zeros(1)
        return x.detach().cpu().numpy(), u, s
