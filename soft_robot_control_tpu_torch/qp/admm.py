"""OSQP constants and Ruiz equilibration for batches of dense QPs
(min 0.5 x'Px + q'x  s.t.  l <= Ax <= u). The adaptive-rho solver with
polish (`solve_qp_dense`) is not ported yet."""

from __future__ import annotations

import torch

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
