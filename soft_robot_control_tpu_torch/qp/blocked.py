"""Explicit ADMM x-step inverse K^-1 for batches of small dense QPs.

The JAX package builds K^-1 from blocked Cholesky and triangular-inverse
routines that only work around the TPU's row-sequential factorizations;
here the batched `torch.linalg.cholesky` and `solve_triangular` take their
place. The Jacobi scaling and the one Newton step on the triangular
inverse stay: they keep the f32 error near kappa(L_s) eps. `chol_blocked`
and `tri_inv_blocked` keep the JAX names and arguments over the same
library calls (the blocking has no purpose on the card).
"""

from __future__ import annotations

import torch

from soft_robot_control_tpu_torch.utils.timing import span


def tri_inv_blocked(L, leaf: int = 64):
    """Inverse of the lower-triangular L (..., n, n) by a batched
    triangular solve. `leaf`, the JAX package's block size, is accepted
    and ignored."""
    I = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, I.expand_as(L), upper=False)


def chol_blocked(K, leaf: int = 64):
    """Lower Cholesky factor of the symmetric positive definite K
    (..., n, n). `leaf` is accepted and ignored, as in tri_inv_blocked."""
    return torch.linalg.cholesky(K)


def make_kinv(P, A, rho_vec, sigma=1e-6, info=None):
    """K^-1 of K = P + sigma I + A' diag(rho) A for a batch: P (B,n,n),
    A (B,m,n), rho_vec (m,) or (B,m). Returns (B,n,n).

    A K that is not positive definite raises torch.linalg.LinAlgError at
    once (a host read of the Cholesky's status); or, with `info`, a bool
    tensor of one element on P's device, a failure of any QP of the batch
    is OR-ed into it on the device, nothing is read on the host, and K^-1
    is the same bits. The batch-fused MPC loop replays the deferred form
    in a CUDA graph, which holds no host read."""
    with span("qp.kinv"):
        n = P.shape[-1]
        I = torch.eye(n, dtype=P.dtype, device=P.device)
        rho = rho_vec if rho_vec.dim() == A.dim() - 1 else rho_vec[None]
        K = P + sigma * I + (A.transpose(-1, -2) * rho[..., None, :]) @ A
        d = torch.rsqrt(torch.diagonal(K, dim1=-2, dim2=-1))
        Ks = K * d[..., :, None] * d[..., None, :]
        if info is None:
            Ls = torch.linalg.cholesky(Ks)
        else:
            Ls, failed = torch.linalg.cholesky_ex(Ks, check_errors=False)
            info.logical_or_(failed.ne(0).any())
        Linv = torch.linalg.solve_triangular(Ls, I.expand_as(Ls),
                                             upper=False)
        Linv = Linv @ (2.0 * I - Ls @ Linv)
        M1 = Linv * d[..., None, :]
        return M1.transpose(-1, -2) @ M1
