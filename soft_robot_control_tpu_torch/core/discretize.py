"""Discretization of continuous-time affine systems  xdot = A x + B u + d.

Methods: forward Euler ('fe'), backward Euler ('be'), bilinear/Tustin
('bil') and exact zero-order hold ('zoh', one matrix exponential of the
stacked block [[A, B_ext], [0, 0]]). Every function takes any leading batch
axes, so one call discretizes a stacked (P, n, n) dictionary.
"""

from __future__ import annotations

import torch

DISCR_METHODS = ("fe", "be", "bil", "zoh")


def _eye_like(A):
    n = A.shape[-1]
    return torch.eye(n, dtype=A.dtype, device=A.device).expand_as(A)


def zoh_linear(A, B, dt):
    """Exact ZOH of (A, B): expm of the stacked block, lower rows dropped."""
    n, m = A.shape[-1], B.shape[-1]
    em = torch.zeros(A.shape[:-2] + (n + m, n + m), dtype=A.dtype,
                     device=A.device)
    em[..., :n, :n] = A
    em[..., :n, n:] = B
    Phi = torch.linalg.matrix_exp(em * dt)
    return Phi[..., :n, :n], Phi[..., :n, n:]


def zoh_affine(A, B, d, dt):
    """Exact ZOH of the affine system: d is an extra constant input."""
    Ad, Bd_ext = zoh_linear(A, torch.cat((B, d[..., None]), dim=-1), dt)
    return Ad, Bd_ext[..., :-1], Bd_ext[..., -1]


def fe(A, B, d, dt):
    return _eye_like(A) + dt * A, dt * B, dt * d


def _inv(M):
    """M^-1 without a check: a singular M gives non-finite entries, as in
    the JAX package, and the card is not waited for."""
    return torch.linalg.inv_ex(M).inverse


def _solve(A, Y):
    """A^-1 Y without a check, as _inv."""
    return torch.linalg.solve_ex(A, Y).result


def be(A, B, d, dt):
    I = _eye_like(A)
    Ad = _inv(I - dt * A)
    sep = _solve(A, Ad - I)
    return Ad, sep @ B, (sep @ d[..., None])[..., 0]


def bil(A, B, d, dt):
    I = _eye_like(A)
    Ad = (I + 0.5 * dt * A) @ _inv(I - 0.5 * dt * A)
    sep = _solve(A, Ad - I)
    return Ad, sep @ B, (sep @ d[..., None])[..., 0]


_METHOD_FNS = {"fe": fe, "be": be, "bil": bil, "zoh": zoh_affine}


def discretize_affine(A, B, d, dt, method: str = "zoh"):
    """Discretize one affine system, or a stack of them."""
    if method not in _METHOD_FNS:
        raise ValueError(
            f"method must be one of {DISCR_METHODS}, got {method!r}")
    return _METHOD_FNS[method](A, B, d, dt)


def discretize_affine_batch(A, B, d, dt, method: str = "zoh"):
    """Discretize a stacked dictionary: A (P,n,n), B (P,n,m), d (P,n)."""
    return discretize_affine(A, B, d, dt, method=method)
