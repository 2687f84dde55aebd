"""Block cyclic reduction for block-tridiagonal SPD KKT systems.

The sequential block-tridiagonal Cholesky (qp/structured.py) runs N ~ 200
dependent steps of small (nb x nb) factorizations and triangular solves.
Cyclic reduction replaces that recurrence with log2(N) levels, each of
which eliminates every odd-indexed block at once: one batched SPD block
inverse and a few batched (M/2, nb, nb) products a level, depth 8 instead
of 200 at N=200.

Convention (that of qp/structured.py): the system has M diagonal blocks
D[i] (nb, nb) and M-1 sub-diagonal blocks L[i] = K[block i+1, block i],
so equation i reads  L[i-1] w[i-1] + D[i] w[i] + L[i]' w[i+1] = r[i].

Eliminating the odd blocks (i = 2j+1) leaves a half-size system over the
even blocks with

  D'[j] = D[2j] - L[2j-1] Dinv[2j-1] L[2j-1]' - L[2j]' Dinv[2j+1] L[2j]
  L'[j] = -L[2j+1] Dinv[2j+1] L[2j]
  r'[j] = r[2j] - L[2j-1] Dinv[2j-1] r[2j-1] - L[2j]' Dinv[2j+1] r[2j+1]

(terms past the ends vanish through zero-padded L). Schur complements of
an SPD matrix stay SPD, so every level is well posed. With an odd M the
last even block has no odd neighbour to its right; the padding covers it.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch


def cholesky_nan(K):
    """Lower Cholesky factor of K (..., n, n) that, as JAX's, is NaN where
    K is not positive definite, with no check that waits on the device."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where(info[..., None, None] == 0, L, float("nan"))


def spd_inv_blocked(K):
    """Batched SPD inverse over (..., nb, nb): Cholesky, triangular solve
    against the identity, L^-T L^-1, and one Newton step X (2I - K X),
    which carries the f32 accuracy. No factorization check waits on the
    device: a block that is not positive definite gives NaN."""
    n = K.shape[-1]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    L = cholesky_nan(K)
    Li = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    Kinv = Li.transpose(-1, -2) @ Li
    return Kinv @ (2.0 * eye - K @ Kinv)


class CRLevel(NamedTuple):
    Dinv_odd: torch.Tensor   # (mo, nb, nb) inverses of the odd diagonal blocks
    L_even: torch.Tensor     # (me, nb, nb) L[2j]   (zero-padded past the end)
    L_odd_m: torch.Tensor    # (me, nb, nb) L[2j-1] (zero at j=0)
    L_odd_p: torch.Tensor    # (mo, nb, nb) L[2j+1] (zero-padded past the end)


class CRFactors(NamedTuple):
    levels: List[CRLevel]
    root_inv: torch.Tensor   # (nb, nb)


def _pad_blocks(X, m, nb, dtype, device, identity=False):
    """X (k, nb, nb) (or None: no block) truncated or padded to m blocks,
    the padding zero or identity."""
    base = (torch.zeros((0, nb, nb), dtype=dtype, device=device)
            if X is None else X)
    cur = base.shape[0]
    if cur >= m:
        return base[:m]
    if identity:
        fill = torch.eye(nb, dtype=dtype, device=device).expand(
            m - cur, nb, nb)
    else:
        fill = torch.zeros((m - cur, nb, nb), dtype=dtype, device=device)
    return torch.cat([base, fill], dim=0)


def cr_factor(diag, lower) -> CRFactors:
    """Cyclic-reduction factorization: each level's odd-block inverses and
    coupling blocks. diag (M, nb, nb); lower (M-1, nb, nb)."""
    D, L = diag, lower
    nb, dtype, dev = D.shape[-1], D.dtype, D.device
    pad = lambda X, m: _pad_blocks(X, m, nb, dtype, dev)
    zero = torch.zeros((1, nb, nb), dtype=dtype, device=dev)
    levels: List[CRLevel] = []
    while D.shape[0] > 1:
        M = D.shape[0]
        me = (M + 1) // 2          # even blocks kept
        mo = M // 2                # odd blocks eliminated
        has_l = L.shape[0] > 0
        Dinv_odd = spd_inv_blocked(D[1::2])                  # (mo, ...)
        L_even = pad(L[0::2] if has_l else None, me)
        # L[2j-1]: zero at j=0, L[1::2][j-1] after
        L_odd_m = pad(torch.cat([zero, L[1::2]]) if has_l else None, me)
        L_odd_p = pad(L[1::2] if has_l else None, mo)
        levels.append(CRLevel(Dinv_odd, L_even, L_odd_m, L_odd_p))

        # the inverses beside each even block j: Dinv[2j-1], Dinv[2j+1]
        DI_l = pad(torch.cat([zero, Dinv_odd]), me)
        DI_r = pad(Dinv_odd, me)
        T_l = L_odd_m @ DI_l                                 # L[2j-1] DI
        T_r = L_even.transpose(1, 2) @ DI_r                  # L[2j]' DI
        D_new = (D[0::2] - T_l @ L_odd_m.transpose(1, 2)
                 - T_r @ L_even)
        # L'[j] = -L[2j+1] Dinv[2j+1] L[2j],  j = 0..me-2
        if me > 1:
            LOp = pad(L_odd_p, me - 1)
            DIr = pad(Dinv_odd, me - 1)
            L_new = -((LOp @ DIr) @ L_even[:me - 1])
        else:
            L_new = torch.zeros((0, nb, nb), dtype=dtype, device=dev)
        D, L = D_new, L_new
    return CRFactors(levels, spd_inv_blocked(D[0]))


def _pad_rows(X, m):
    """X (k, nb) truncated or zero-padded to m rows."""
    if X.shape[0] >= m:
        return X[:m]
    return torch.nn.functional.pad(X, (0, 0, 0, m - X.shape[0]))


def bmv(M, v):
    """Batched mat-vec M (k, p, n) v (k, n) -> (k, p), by one bmm."""
    return torch.bmm(M, v.unsqueeze(-1)).squeeze(-1)


def cr_solve(factors: CRFactors, rhs):
    """Solve the block-tridiagonal system factored by `cr_factor`; rhs
    (M, nb) -> (M, nb)."""
    # down-sweep: fold the odd right-hand sides into the even ones
    rs = [rhs]
    for lv in factors.levels:
        r = rs[-1]
        me = (r.shape[0] + 1) // 2
        dr_odd = bmv(lv.Dinv_odd, r[1::2])                    # (mo, nb)
        dr_l = _pad_rows(torch.nn.functional.pad(dr_odd, (0, 0, 1, 0)),
                         me)                                 # j-1 aligned
        dr_r = _pad_rows(dr_odd, me)                         # j aligned
        rs.append(r[0::2] - bmv(lv.L_odd_m, dr_l)
                  - bmv(lv.L_even.transpose(1, 2), dr_r))
    w = (factors.root_inv @ rs[-1][0])[None]
    # up-sweep: recover the odd blocks, deepest level first
    for lv, r in zip(reversed(factors.levels), reversed(rs[:-1])):
        M = r.shape[0]
        me, mo = (M + 1) // 2, M // 2
        w_even = w[:me]
        # w[2j+1] = Dinv[2j+1] (r[2j+1] - L[2j] w[2j] - L[2j+1]' w[2j+2])
        w_r = _pad_rows(w_even[1:], mo)
        rhs_odd = (r[1::2] - bmv(lv.L_even[:mo], w_even[:mo])
                   - bmv(lv.L_odd_p.transpose(1, 2), w_r))
        w_odd = bmv(lv.Dinv_odd, rhs_odd)
        # interleave: even, odd, even, ..., and the last even block alone
        # when M is odd (me = mo + 1)
        w = torch.cat([torch.stack([w_even[:mo], w_odd], dim=1).reshape(
            2 * mo, -1), w_even[mo:]])
    return w
