"""Structure-exploiting KKT solve for the LOCP: block-tridiagonal Cholesky.

The ADMM x-step solves K w = rhs with K = P + sigma I + A' diag(rho) A.
For the LOCP without trust region, with the variables ordered by stage
[x_0, u_0, x_1, u_1, ..., u_{N-1}, x_N], K is block-tridiagonal with stage
blocks of size (n_x + n_u): the cost is stage-separable and the dynamics
rows couple only adjacent stages. The block-tridiagonal factorization costs
O(N n^3) where a dense Cholesky costs O((N n)^3).

- `stage_permutation(N, nx, nu)`: the permutation from the LOCPSpec layout
  ([x_0..x_N | u_0..u_{N-1}]) to stage order;
- `btd_factor` / `btd_solve`: blocked Cholesky of a block-tridiagonal SPD
  matrix given as stacked diagonal and sub-diagonal blocks, and its forward
  and backward sweeps, as Python loops over the M = N+1 stage blocks;
- `StructuredKKT`: the permuted solve of a dense K, by cyclic reduction
  ('cr', qp/cyclic_reduction.py) or by the sequential sweeps ('scan');
- `admm_fixed_btd`: the fixed-iteration ADMM with the structured x-step.
"""

from __future__ import annotations

import numpy as np
import torch

from soft_robot_control_tpu_torch.qp.cyclic_reduction import (
    cholesky_nan, cr_factor, cr_solve)
from soft_robot_control_tpu_torch.utils.device import resolve_device


def stage_permutation(N: int, nx: int, nu: int) -> np.ndarray:
    """perm[i] = index in the LOCPSpec flat layout of stage-order entry i.

    Stage order: [x_0 (nx), u_0 (nu), x_1, u_1, ..., u_{N-1}, x_N]: blocks
    of (nx+nu) for stages 0..N-1 and a last block x_N of nx, which
    `extract_btd_blocks` pads to (nx+nu) with identity."""
    off_u = (N + 1) * nx
    idx = []
    for k in range(N):
        idx.extend(range(k * nx, (k + 1) * nx))
        idx.extend(range(off_u + k * nu, off_u + (k + 1) * nu))
    idx.extend(range(N * nx, (N + 1) * nx))
    return np.asarray(idx, dtype=np.int64)


def extract_btd_blocks(Kp, N: int, nb: int, nx: int):
    """(diag (N+1, nb, nb), lower (N, nb, nb)) stacked blocks of the
    permuted K (stage order); the last stage block (size nx) sits in an
    identity-padded (nb, nb) block, the last sub-diagonal block is
    zero-padded on the padded rows."""
    diag = [Kp[k * nb:(k + 1) * nb, k * nb:(k + 1) * nb] for k in range(N)]
    lower = [Kp[(k + 1) * nb:(k + 2) * nb, k * nb:(k + 1) * nb]
             for k in range(N - 1)]
    last = torch.eye(nb, dtype=Kp.dtype, device=Kp.device)
    last[:nx, :nx] = Kp[N * nb:, N * nb:]
    off_last = torch.zeros((nb, nb), dtype=Kp.dtype, device=Kp.device)
    off_last[:nx, :] = Kp[N * nb:, (N - 1) * nb:N * nb]
    return torch.stack(diag + [last]), torch.stack(lower + [off_last])


def btd_factor(diag, lower):
    """Block-tridiagonal Cholesky: (L_diag (M, nb, nb), the lower Cholesky
    factors of the Schur-complemented diagonal blocks; L_off (M-1, nb, nb),
    L_off[k] = lower[k] inv(L_diag[k])'). Like the JAX version, a block
    that is not positive definite gives NaN and raises nothing (no wait on
    the device)."""
    M = diag.shape[0]
    L_diag, L_off = [], []
    X = torch.zeros_like(diag[0])
    for k in range(M):
        L_k = cholesky_nan(diag[k] - X @ X.T)
        L_diag.append(L_k)
        if k < M - 1:
            # lower[k] inv(L_k)': solve L_k X' = lower[k]'
            X = torch.linalg.solve_triangular(L_k, lower[k].T,
                                              upper=False).T
            L_off.append(X)
    return torch.stack(L_diag), torch.stack(L_off) if L_off else \
        diag.new_zeros((0,) + diag.shape[1:])


def btd_solve(L_diag, L_off, rhs):
    """Solve the block-tridiagonal system factored by `btd_factor`; rhs
    (M, nb) -> (M, nb)."""
    M = L_diag.shape[0]
    ys = []
    y = None
    for k in range(M):
        r = rhs[k] if k == 0 else rhs[k] - L_off[k - 1] @ y
        y = torch.linalg.solve_triangular(L_diag[k], r[:, None],
                                          upper=False)[:, 0]
        ys.append(y)
    ws = [None] * M
    w = None
    for k in range(M - 1, -1, -1):
        r = ys[k] if k == M - 1 else ys[k] - L_off[k].T @ w
        w = torch.linalg.solve_triangular(L_diag[k].T, r[:, None],
                                          upper=True)[:, 0]
        ws[k] = w
    return torch.stack(ws)


class StructuredKKT:
    """Permuted structured solver of a LOCPSpec problem's K (trust region
    off): method 'cr' (default) by block cyclic reduction, 'scan' by the
    sequential block-tridiagonal Cholesky."""

    def __init__(self, N: int, nx: int, nu: int, dtype=torch.float64,
                 method: str = "cr", device="cuda"):
        if method not in ("cr", "scan"):
            raise ValueError(f"unknown method {method!r}")
        self.method = method
        self.N, self.nx, self.nu = int(N), int(nx), int(nu)
        self.nb = nx + nu
        self.device = resolve_device(device)
        perm = stage_permutation(N, nx, nu)
        self.perm = torch.as_tensor(perm, device=self.device)
        self.inv_perm = torch.as_tensor(np.argsort(perm), device=self.device)
        self.n_total = (N + 1) * nx + N * nu
        self.dtype = dtype

    def factor(self, K):
        Kp = K[self.perm][:, self.perm]
        diag, lower = extract_btd_blocks(Kp, self.N, self.nb, self.nx)
        if self.method == "cr":
            return cr_factor(diag, lower)
        return btd_factor(diag, lower)

    def solve(self, factors, rhs):
        rp = rhs[self.perm]
        pad = rhs.new_zeros(self.nb - self.nx)
        blocks = torch.cat([rp, pad]).reshape(self.N + 1, self.nb)
        if self.method == "cr":
            w_blocks = cr_solve(factors, blocks)
        else:
            w_blocks = btd_solve(*factors, blocks)
        return w_blocks.reshape(-1)[:self.n_total][self.inv_perm]


def admm_fixed_btd(P, q, A, l, u, w0, y0, rho_vec, iters: int,
                   skkt: StructuredKKT, sigma=1e-6, alpha=1.6):
    """Fixed-iteration ADMM with the block-tridiagonal x-step (trust region
    off; the update of control/batch_mpc.py's admm_fixed). Returns (w, y)."""
    n = P.shape[0]
    K = (P + sigma * torch.eye(n, dtype=P.dtype, device=P.device)
         + (A.T * rho_vec[None, :]) @ A)
    factors = skkt.factor(K)
    w, y = w0, y0
    z = torch.minimum(torch.maximum(A @ w0, l), u)
    for _ in range(int(iters)):
        rhs = sigma * w - q + A.T @ (rho_vec * z - y)
        w_t = skkt.solve(factors, rhs)
        z_t = A @ w_t
        w_new = alpha * w_t + (1 - alpha) * w
        z_rel = alpha * z_t + (1 - alpha) * z
        z = torch.minimum(torch.maximum(z_rel + y / rho_vec, l), u)
        y = y + rho_vec * (z_rel - z)
        w = w_new
    return w, y
