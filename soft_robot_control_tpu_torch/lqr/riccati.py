"""Riccati equation solvers over any leading batch axes (for example one
gain per TPWL point in one call):

- `solve_riccati`: the reference's DARE fixed-point iteration
  (sofacontrol/lqr/lqr.py:6-21) with its stopping rule ||L - L_old|| > tol,
  as a host loop: each system stops at its own iteration (later
  iterations leave it as it is), and the host reads one flag, "any system
  still running", every CHECK_EVERY iterations;
- `dare`: the structure-preserving doubling algorithm, a fixed number of
  iterations, in place of scipy.solve_discrete_are (lqr/lqr.py:24-31);
- `care`: the continuous ARE by the matrix sign function of the
  Hamiltonian (Roberts' method), 60 fixed iterations (lqr/lqr.py:57-64).

All return a gain K with u = +K x, K = -(R + B'PB)^-1 B'PA, the
reference's sign convention.
"""

from __future__ import annotations

import torch

CHECK_EVERY = 8


def _t(M):
    return M.transpose(-1, -2)


def solve_riccati(A, B, Q, R, tol: float = 1e-4):
    """DARE fixed-point iteration with the reference's update and stopping
    rule: A (...,n,n), B (...,n,m), Q (n,n) or (...,n,n), R (m,m) or
    (...,m,m). Returns (L, P), u = +L x."""
    Bt, At = _t(B), _t(A)

    def gain(P):
        return -torch.linalg.solve(R + Bt @ P @ B, Bt @ P @ A)

    P = torch.zeros_like(A)
    L = gain(P)
    Lold = torch.full_like(L, float("inf"))
    k = 0
    while True:
        # the JAX loop's condition, per system; NaN compares False and stops
        running = torch.linalg.matrix_norm(L - Lold) > tol
        if k % CHECK_EVERY == 0 and not bool(running.any()):
            break
        BtPB = Bt @ P @ B
        P_new = At @ P @ A - At @ P @ B @ torch.linalg.inv(R + BtPB) @ (
            Bt @ P @ A) + Q
        L_new = gain(P_new)
        r = running[..., None, None]
        P, L, Lold = (torch.where(r, P_new, P), torch.where(r, L_new, L),
                      torch.where(r, L, Lold))
        k += 1
    return L, P


def dare(A, B, Q, R, iters: int = 40):
    """DARE via doubling: A (...,n,n), B (...,n,m), Q (n,n), R (m,m).
    Returns (K, P) with u = +K x, K = -(R + B'PB)^-1 B'PA."""
    n = A.shape[-1]
    Bt = _t(B)
    G = B @ torch.linalg.solve(R, Bt)
    I = torch.eye(n, dtype=A.dtype, device=A.device)
    Ak, Gk, Hk = A, G, Q.expand_as(A)
    for _ in range(int(iters)):
        W = I + Gk @ Hk
        WinvA = torch.linalg.solve(W, Ak)
        A1 = Ak @ WinvA
        G1 = Gk + Ak @ torch.linalg.solve(W, Gk @ _t(Ak))
        H1 = Hk + _t(Ak) @ Hk @ WinvA
        Ak, Gk, Hk = A1, G1, H1
    P = Hk
    K = -torch.linalg.solve(R + Bt @ P @ B, Bt @ P @ A)
    return K, P


def care(A, B, Q, R, iters: int = 60):
    """CARE via the matrix sign function of the Hamiltonian
    H = [[A, -B R^-1 B'], [-Q, -A']]: Newton's iteration with determinant
    scaling Z <- (c Z + (c Z)^-1) / 2, then P from sign(H) + I by least
    squares. Returns (K, P) with u = +K x, K = -R^-1 B' P."""
    n = A.shape[-1]
    lead = A.shape[:-2]
    Rinv_Bt = torch.linalg.solve(R, _t(B))
    Qb = Q.expand(lead + Q.shape[-2:])
    H = torch.cat((torch.cat((A, -B @ Rinv_Bt), dim=-1),
                   torch.cat((-Qb, -_t(A)), dim=-1)), dim=-2)
    Z = H
    for _ in range(int(iters)):
        Zinv = torch.linalg.inv(Z)
        _, logdet = torch.linalg.slogdet(Z)
        c = torch.exp(-logdet / (2 * n))[..., None, None]
        Z = 0.5 * (c * Z + Zinv / c)
    S = Z
    # stable invariant subspace: (S + I) [I; P] = 0, solved for P by least
    # squares: [[S12], [S22 + I]] P = -[[S11 + I], [S21]]
    I = torch.eye(n, dtype=A.dtype, device=A.device)
    M = torch.cat((S[..., :n, n:], S[..., n:, n:] + I), dim=-2)
    rhs = -torch.cat((S[..., :n, :n] + I, S[..., n:, :n]), dim=-2)
    P = torch.linalg.lstsq(M, rhs).solution
    P = 0.5 * (P + _t(P))
    K = -Rinv_Bt @ P
    return K, P


def dlqr_gain(model, A_c, B_c, Q, R, dt):
    """Infinite-horizon discrete LQR for a continuous linearization:
    discretize with the model's method, then the fixed-point DARE
    (lqr/lqr.py:34-54)."""
    d = torch.zeros(A_c.shape[:-1], dtype=A_c.dtype, device=A_c.device)
    A_d, B_d, _ = model.discretize_dynamics(A_c, B_c, d, dt)
    K, _ = solve_riccati(A_d, B_d, Q, R)
    return K


def clqr_gain(A_c, B_c, Q, R):
    """Infinite-horizon continuous LQR gain (lqr/lqr.py:57-64)."""
    K, _ = care(A_c, B_c, Q, R)
    return K
