"""Condensed LOCP: the state trajectory eliminated through the dynamics.

In the real-time MPC mode (no trust region) the dynamics equalities are
eliminated exactly by forward substitution,

    x_k = xfree_k + G_k u,   xfree_{k+1} = A_k xfree_k + d_k,
    G_{k+1} = A_k G_k + B_k E_k   (E_k selects u_k's block),

which leaves a QP in u alone (N*nu variables). Every array carries a
leading batch axis B. Supported: output tracking through a constant H, R
and u_des, U and dU polyhedra. The trust region, the state constraint X,
the time-varying output map (Hd, cd) and the terminal cost Qzf are not
ported yet and raise NotImplementedError.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

_TODO = " is not ported yet (see ROADMAP.md, modules to port, item 8)"


class CondensedParams(NamedTuple):
    Ad: torch.Tensor          # (B, N, nx, nx)
    Bd: torch.Tensor          # (B, N, nx, nu)
    dd: torch.Tensor          # (B, N, nx)
    x0: torch.Tensor          # (B, nx)
    z: torch.Tensor           # (B, N+1, nz) targets
    u_des: torch.Tensor       # (B, N, nu)
    Hd: Optional[torch.Tensor] = None   # time-varying output map: not ported
    cd: Optional[torch.Tensor] = None


class CondensedSpec:
    """Static structure of the condensed real-time LOCP.

    H: (nz, nx) output map. U/dU: Polyhedron-like with .A/.b.
    """

    def __init__(self, N: int, H, Qz, R, U=None, dU=None, X=None,
                 nonlinear_observer: bool = False, trust_region: bool = False,
                 dtype=torch.float32, Qzf=None, device="cuda"):
        from soft_robot_control_tpu_torch.utils.device import (as_tensor,
                                                               resolve_device)

        for name, val in (("X", X is not None),
                          ("nonlinear_observer", nonlinear_observer),
                          ("trust_region", trust_region),
                          ("Qzf", Qzf is not None)):
            if val:
                raise NotImplementedError(f"CondensedSpec {name}" + _TODO)
        self.N = int(N)
        self.device = resolve_device(device)
        self.dtype = dtype
        t = lambda a: as_tensor(a, dtype, self.device)
        self.H = t(H)
        self.n_z, self.n_x = self.H.shape
        self.Qz = t(Qz)
        self.R = t(R)
        self.n_u = self.R.shape[0]
        self.n_var = self.N * self.n_u

        # constraint rows, all inequalities; they do not depend on the
        # linearization, so A, l, u are built once here
        N_ = self.N
        eye = torch.eye(N_, dtype=dtype, device=self.device)
        big = 1e30
        A_rows, l_rows, u_rows = [], [], []
        if U is not None:
            UA, Ub = t(U.A), t(U.b)
            A_rows.append(torch.kron(eye, UA))
            u_rows.append(Ub.repeat(N_))
            l_rows.append(torch.full((N_ * UA.shape[0],), -big, dtype=dtype,
                                     device=self.device))
        if dU is not None:
            DA, Db = t(dU.A), t(dU.b)
            D = (torch.diag(torch.ones(N_ - 1, dtype=dtype,
                                       device=self.device), 1) - eye)[:-1]
            A_rows.append(torch.kron(D, DA))
            u_rows.append(Db.repeat(N_ - 1))
            l_rows.append(torch.full(((N_ - 1) * DA.shape[0],), -big,
                                     dtype=dtype, device=self.device))
        if A_rows:
            self._A = torch.cat(A_rows, dim=0)
            self._l = torch.cat(l_rows)
            self._u = torch.cat(u_rows)
        else:  # unconstrained: one vacuous row keeps the ADMM's shapes
            self._A = torch.zeros((1, self.n_var), dtype=dtype,
                                  device=self.device)
            self._l = torch.full((1,), -big, dtype=dtype, device=self.device)
            self._u = torch.full((1,), big, dtype=dtype, device=self.device)
        self.n_con = self._A.shape[0]

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
        0.5 u'Pu + q'u + const  s.t.  l <= A u <= u, batched over B."""
        if params.Hd is not None or params.cd is not None:
            raise NotImplementedError("time-varying output maps" + _TODO)
        N = self.N
        xfree, G = self.predict(params)
        Bsz = xfree.shape[0]
        H, Qz = self.H, self.Qz
        HG = torch.einsum("ij,bkjm->bkim", H, G)            # (B,N+1,nz,Nu)
        e = torch.einsum("ij,bkj->bki", H, xfree) - params.z.to(H.dtype)
        # stage costs k=1..N; the k=0 stage is a constant (x_0 is u-free)
        P = 2.0 * torch.einsum("bkiv,ij,bkjw->bvw", HG[:, 1:], Qz, HG[:, 1:])
        q = 2.0 * torch.einsum("bkiv,ij,bkj->bv", HG[:, 1:], Qz, e[:, 1:])
        const = torch.einsum("bki,ij,bkj->b", e, Qz, e)
        Rb = torch.kron(torch.eye(N, dtype=H.dtype, device=H.device), self.R)
        P = P + 2.0 * Rb
        ud = params.u_des.to(H.dtype).reshape(Bsz, -1)
        q = q - 2.0 * ud @ Rb.T
        const = const + torch.einsum("bi,ij,bj->b", ud, Rb, ud)
        A = self._A.expand(Bsz, -1, -1)
        l = self._l.expand(Bsz, -1)
        u = self._u.expand(Bsz, -1)
        return P, q, A, l, u, const, xfree, G

    # ------------------------------------------------------------------
    def recover_x(self, xfree, G, u_opt):
        """State trajectory of the input plan: xfree + G u."""
        u_opt = u_opt[..., :self.N * self.n_u]
        return xfree + torch.einsum("bkim,bm->bki", G, u_opt)
