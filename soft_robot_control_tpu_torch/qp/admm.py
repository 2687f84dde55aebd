"""OSQP-style ADMM for dense QPs (min 0.5 x'Px + q'x  s.t.  l <= Ax <= u).

`_ruiz_equilibrate` works on a batch of QPs and serves the fixed-iteration
solvers of control/batch_mpc.py. `solve_qp_dense` solves one QP to
tolerance with OSQP's semantics: over-relaxed ADMM with a sigma-regularized
x-step, per-constraint rho (equality rows get 1e3 x rho), Ruiz
equilibration with cost scaling, adaptive rho with refactorization, warm
start of (x, y), and a polish step on the guessed active set. Its loop is
a Python `while` that reads the termination flag from the device once per
check.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from soft_robot_control_tpu_torch.qp.blocked import make_kinv

OSQP_RHO_EQ_SCALE = 1e3
RHO_MIN, RHO_MAX = 1e-6, 1e6  # clamp of a re-balanced rho


def _ruiz_equilibrate(P, q, A, iters: int = 10):
    """Ruiz equilibration of the KKT matrix [[P, A'], [A, 0]] plus OSQP
    cost scaling, for a batch: P (B,n,n), q (B,n), A (B,m,n) with m >= 1.
    Returns scaled (P, q, A) and the scalings d (B,n), e (B,m), c (B,)
    with x = d * x_scaled."""
    Bsz, n = q.shape
    m = A.shape[1]
    d = torch.ones((Bsz, n), dtype=P.dtype, device=P.device)
    e = torch.ones((Bsz, m), dtype=P.dtype, device=P.device)
    c = torch.ones(Bsz, dtype=P.dtype, device=P.device)
    one = torch.ones((), dtype=P.dtype, device=P.device)
    for _ in range(int(iters)):
        col_x = torch.maximum(P.abs().amax(dim=1), A.abs().amax(dim=1))
        col_y = A.abs().amax(dim=2)
        # zero-norm rows/cols (a vacuous constraint row) stay unscaled
        dd = torch.where(col_x > 1e-12,
                         1.0 / torch.sqrt(torch.clamp(col_x, min=1e-12)), one)
        ee = torch.where(col_y > 1e-12,
                         1.0 / torch.sqrt(torch.clamp(col_y, min=1e-12)), one)
        P = P * dd[:, :, None] * dd[:, None, :]
        q = q * dd
        A = A * ee[:, :, None] * dd[:, None, :]
        d = d * dd
        e = e * ee
        gamma = 1.0 / torch.clamp(
            torch.maximum(P.abs().amax(dim=1).mean(dim=1), q.abs().amax(dim=1)),
            min=1e-12)
        P = P * gamma[:, None, None]
        q = q * gamma[:, None]
        c = c * gamma
    return P, q, A, d, e, c


class QPSolution(NamedTuple):
    x: torch.Tensor        # primal solution (n,)
    y: torch.Tensor        # dual solution (m,)
    z: torch.Tensor        # Ax at solution (m,)
    obj: torch.Tensor      # objective value 0.5 x'Px + q'x
    pri_res: torch.Tensor  # ||Ax - z||_inf
    dua_res: torch.Tensor  # ||Px + q + A'y||_inf
    iters: int             # ADMM iterations executed
    solved: bool           # residuals under tolerance
    pri_sc: torch.Tensor   # primal residual scale (inf-norms)
    dua_sc: torch.Tensor   # dual residual scale


def _amax(t):
    return t.abs().amax()


def _residuals(P, q, A, x, y, z):
    """(pri, pri_sc, dua, dua_sc) of the QP (P, q, A) at (x, y, z)."""
    Ax = A @ x
    Px = P @ x
    Aty = A.T @ y
    pri = _amax(Ax - z)
    pri_sc = torch.maximum(_amax(Ax), _amax(z))
    dua = _amax(Px + q + Aty)
    dua_sc = torch.maximum(torch.maximum(_amax(Px), _amax(Aty)), _amax(q))
    return pri, pri_sc, dua, dua_sc


def accept_tolerances(dtype):
    """(pri, dua): the relative KKT residuals (over max(scale, 1)) under
    which a QP result that missed its own tolerance is still accepted, as
    OSQP accepts 'solved inaccurate'. float32 bottoms out near 1e-4..1e-3."""
    return (1e-3, 1e-2) if dtype == torch.float32 else (1e-5, 1e-4)


def accepted(solved, pri, dua, pri_sc, dua_sc, dtype):
    """(ok, pri_rel, dua_rel) as host values: a QP result is taken when it
    was solved or both relative residuals pass accept_tolerances(dtype)."""
    acc_pri, acc_dua = accept_tolerances(dtype)
    pri_rel = float(pri) / max(1.0, float(pri_sc))
    dua_rel = float(dua) / max(1.0, float(dua_sc))
    return (bool(solved) or (pri_rel < acc_pri and dua_rel < acc_dua),
            pri_rel, dua_rel)


def kkt_residuals(P, q, A, l, u, w, y, n_dual: Optional[int] = None):
    """(pri, dua, pri_sc, dua_sc) in OSQP's convention at (w, y), z being
    Aw clipped to [l, u], for a batch: P (B,n,n), A (B,m,n), vectors (B,.).
    n_dual: the dual residual over the first n_dual variables only."""
    amax = lambda a: a.abs().amax(dim=-1)
    Aw = torch.einsum("bmn,bn->bm", A, w)
    z = torch.clamp(Aw, l, u)
    Pw = torch.einsum("bij,bj->bi", P, w)
    Aty = torch.einsum("bmn,bm->bn", A, y)
    return (amax(Aw - z), amax((Pw + q + Aty)[:, :n_dual]),
            torch.maximum(amax(Aw), amax(z)),
            torch.maximum(torch.maximum(amax(Pw), amax(Aty)), amax(q)))


def _polish(P, q, A, l, u, y, delta=1e-7, refine_steps: int = 3):
    """OSQP-style solution polishing.

    Guess the active set from the ADMM duals (y<0 -> lower active,
    y>0 -> upper active), then solve the equality-constrained KKT with the
    inactive multipliers pinned to zero, via a masked Schur complement and
    iterative refinement. A singular system (active rows that are
    dependent, their regularization lost in the rounding) gives a
    non-finite candidate, which the caller's residual test rejects, as
    JAX's LU solve does; it does not raise."""
    n = P.shape[0]
    low_active = y < 0
    up_active = y > 0
    zero = torch.zeros((), dtype=P.dtype, device=P.device)
    b = torch.where(low_active, l, torch.where(up_active, u, zero))
    # rows with an infinite b cannot be active
    finite = torch.isfinite(b)
    mask = ((low_active | up_active) & finite).to(P.dtype)
    b = torch.where(finite, b, zero)

    Hc = torch.linalg.cholesky_ex(
        P + delta * torch.eye(n, dtype=P.dtype, device=P.device))[0]
    solve_H = lambda r: torch.cholesky_solve(r.reshape(n, -1), Hc).reshape(
        r.shape)
    G = A @ solve_H(A.T)                                 # A H^-1 A' (m, m)
    M = mask[:, None] * mask[None, :] * G + torch.diag(
        1.0 - mask + delta * mask)
    nu = torch.linalg.solve_ex(M, mask * (A @ solve_H(-q) - b))[0]
    x_p = solve_H(-q - A.T @ nu)

    # iterative refinement on the unregularized masked KKT; corrections are
    # solved with the regularized factorizations, and inactive nu entries
    # stay exactly 0
    for _ in range(refine_steps):
        r1 = -q - P @ x_p - A.T @ (mask * nu)
        r2 = mask * (b - A @ x_p)
        dx0 = solve_H(r1)
        dnu = torch.linalg.solve_ex(M, mask * (A @ dx0) - r2)[0]
        x_p = x_p + dx0 - solve_H(A.T @ (mask * dnu))
        nu = nu + dnu
    return x_p, mask * nu, torch.clamp(A @ x_p, l, u)


def solve_qp_dense(P, q, A, l, u,
                   x0: Optional[torch.Tensor] = None,
                   y0: Optional[torch.Tensor] = None,
                   rho: float = 0.1, sigma: float = 1e-6, alpha: float = 1.6,
                   eps_abs: float = 1e-8, eps_rel: float = 1e-8,
                   max_iter: int = 4000, check_every: int = 25,
                   polish: bool = True, adaptive_rho: bool = True,
                   rho_every: int = 200, scaling_iters: int = 10,
                   x_solver: str = "auto") -> QPSolution:
    """Solve one dense QP, P (n,n), A (m,n) with m >= 1, on the tensors'
    device. Warm start via (x0, y0). The defaults aim at 1e-8 residuals.

    x_solver picks the x-step linear solve: 'chol' factors K and calls
    `torch.cholesky_solve` every iteration; 'kinv' builds the explicit
    K^-1 (`make_kinv`) so that every iteration is one mat-vec. 'auto' is
    'chol'. Either is rebuilt when rho is re-balanced."""
    if x_solver == "auto":
        x_solver = "chol"
    if x_solver not in ("chol", "kinv"):
        raise ValueError(f"unknown x_solver {x_solver!r}")
    dtype, dev = P.dtype, P.device
    n, m = P.shape[0], A.shape[0]
    if m < 1:
        raise ValueError("solve_qp_dense needs at least one constraint row "
                         "(add a vacuous one: zero row, infinite bounds)")
    P0, q0, A0, l0, u0 = P, q, A, l, u

    if scaling_iters > 0:
        P, q, A, d_vec, e_vec, c_cost = (t[0] for t in _ruiz_equilibrate(
            P[None], q[None], A[None], scaling_iters))
        l, u = e_vec * l0, e_vec * u0
    else:
        d_vec = torch.ones(n, dtype=dtype, device=dev)
        e_vec = torch.ones(m, dtype=dtype, device=dev)
        c_cost = torch.ones((), dtype=dtype, device=dev)

    eq = (torch.isfinite(l) & torch.isfinite(u)
          & ((u - l).abs() <= 1e-14 * (1 + u.abs())))
    rho_scale = torch.where(eq, OSQP_RHO_EQ_SCALE, 1.0).to(dtype)
    I = torch.eye(n, dtype=dtype, device=dev)

    def factor(rho_s):
        rhov = rho_s * rho_scale
        if x_solver == "kinv":
            return make_kinv(P[None], A[None], rhov, sigma)[0]
        return torch.linalg.cholesky(P + sigma * I + (A.T * rhov) @ A)

    x = torch.zeros(n, dtype=dtype, device=dev) if x0 is None else x0 / d_vec
    y = (torch.zeros(m, dtype=dtype, device=dev) if y0 is None
         else c_cost * y0 / e_vec)
    z = torch.clamp(A @ x, l, u)
    rho_s = torch.as_tensor(rho, dtype=dtype, device=dev)
    fac = factor(rho_s)

    it, done = 0, False
    while it < max_iter and not done:
        rhov = rho_s * rho_scale
        rhs = sigma * x - q + A.T @ (rhov * z - y)
        if x_solver == "kinv":
            x_t = fac @ rhs
        else:
            x_t = torch.cholesky_solve(rhs[:, None], fac)[:, 0]
        z_t = A @ x_t
        x = alpha * x_t + (1 - alpha) * x
        z_rel = alpha * z_t + (1 - alpha) * z
        z_new = torch.clamp(z_rel + y / rhov, l, u)
        y = y + rhov * (z_rel - z_new)
        z = z_new
        it += 1
        if it % check_every:
            continue
        # termination in the original problem's units (OSQP sec 5.1)
        pri, pri_sc, dua, dua_sc = _residuals(
            P0, q0, A0, d_vec * x, e_vec * y / c_cost, z / e_vec)
        flags = [(pri <= eps_abs + eps_rel * pri_sc)
                 & (dua <= eps_abs + eps_rel * dua_sc)]
        if adaptive_rho and it % rho_every == 0:
            # rho acts in the Ruiz-scaled space, so the balance ratio uses
            # scaled residuals (OSQP sec 5.2), and adaptation is rare:
            # re-balancing at every check sets up a rho limit cycle on
            # slack-epigraph QPs
            pri_s, pri_s_sc, dua_s, dua_s_sc = _residuals(P, q, A, x, y, z)
            ratio = torch.sqrt(
                (pri_s / torch.clamp(pri_s_sc, min=1e-12))
                / torch.clamp(dua_s / torch.clamp(dua_s_sc, min=1e-12),
                              min=1e-18))
            rho_new = torch.clamp(rho_s * ratio, RHO_MIN, RHO_MAX)
            flags.append((rho_new > 5.0 * rho_s) | (rho_new < rho_s / 5.0))
        flags = torch.stack(flags).tolist()  # the one host read per check
        done = flags[0]
        if len(flags) > 1 and flags[1]:
            rho_s = rho_new
            fac = factor(rho_s)

    x_u = d_vec * x
    y_u = e_vec * y / c_cost
    z_u = z / e_vec

    if polish:
        # polish in the equilibrated space (well-conditioned even when the
        # original P is nearly singular), then unscale the candidate
        x_ps, y_ps, z_ps = _polish(P, q, A, l, u, y)
        x_p = d_vec * x_ps
        y_p = e_vec * y_ps / c_cost
        z_p = z_ps / e_vec

        # accept the polish iff it reduces the worst KKT residual (unscaled)
        def kkt_res(xv, yv):
            Ax = A0 @ xv
            pri = torch.clamp(torch.maximum((Ax - u0).amax(),
                                            (l0 - Ax).amax()), min=0.0)
            return torch.maximum(pri, _amax(P0 @ xv + q0 + A0.T @ yv))

        if bool(kkt_res(x_p, y_p) < kkt_res(x_u, y_u)):
            x_u, y_u, z_u = x_p, y_p, z_p

    pri, pri_sc, dua, dua_sc = _residuals(P0, q0, A0, x_u, y_u, z_u)
    solved = bool((pri <= eps_abs + eps_rel * pri_sc)
                  & (dua <= eps_abs + eps_rel * dua_sc))
    obj = 0.5 * x_u @ (P0 @ x_u) + q0 @ x_u
    return QPSolution(x_u, y_u, z_u, obj, pri, dua, it, solved, pri_sc,
                      dua_sc)
