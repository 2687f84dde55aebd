"""Explicit ADMM x-step inverse K^-1 for batches of small dense QPs.

The JAX package builds K^-1 from blocked Cholesky and triangular-inverse
routines that only work around the TPU's row-sequential factorizations;
here the batched `torch.linalg.cholesky` and `solve_triangular` take their
place. The Jacobi scaling and the one Newton step on the triangular
inverse stay: they keep the f32 error near kappa(L_s) eps.
"""

from __future__ import annotations

import torch


def make_kinv(P, A, rho_vec, sigma=1e-6):
    """K^-1 of K = P + sigma I + A' diag(rho) A for a batch: P (B,n,n),
    A (B,m,n), rho_vec (m,) or (B,m). Returns (B,n,n)."""
    n = P.shape[-1]
    I = torch.eye(n, dtype=P.dtype, device=P.device)
    rho = rho_vec if rho_vec.dim() == A.dim() - 1 else rho_vec[None]
    K = P + sigma * I + (A.transpose(-1, -2) * rho[..., None, :]) @ A
    d = torch.rsqrt(torch.diagonal(K, dim1=-2, dim2=-1))
    Ks = K * d[..., :, None] * d[..., None, :]
    Ls = torch.linalg.cholesky(Ks)
    Linv = torch.linalg.solve_triangular(Ls, I.expand_as(Ls), upper=False)
    Linv = Linv @ (2.0 * I - Ls @ Linv)
    M1 = Linv * d[..., None, :]
    return M1.transpose(-1, -2) @ M1
