"""Discrete algebraic Riccati equation by the structure-preserving doubling
algorithm, over any leading batch axes (one gain per TPWL point in one
call). `solve_riccati` and `care` are not ported yet."""

from __future__ import annotations

import torch


def dare(A, B, Q, R, iters: int = 40):
    """DARE via doubling: A (...,n,n), B (...,n,m), Q (n,n), R (m,m).
    Returns (K, P) with u = +K x, K = -(R + B'PB)^-1 B'PA."""
    n = A.shape[-1]
    Bt = B.transpose(-1, -2)
    G = B @ torch.linalg.solve(R, Bt)
    I = torch.eye(n, dtype=A.dtype, device=A.device)
    Ak, Gk, Hk = A, G, Q.expand_as(A)
    for _ in range(int(iters)):
        W = I + Gk @ Hk
        WinvA = torch.linalg.solve(W, Ak)
        A1 = Ak @ WinvA
        G1 = Gk + Ak @ torch.linalg.solve(W, Gk @ Ak.transpose(-1, -2))
        H1 = Hk + Ak.transpose(-1, -2) @ Hk @ WinvA
        Ak, Gk, Hk = A1, G1, H1
    P = Hk
    K = -torch.linalg.solve(R + Bt @ P @ B, Bt @ P @ A)
    return K, P
