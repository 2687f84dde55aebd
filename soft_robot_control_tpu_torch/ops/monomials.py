"""Monomial exponent tables and their evaluation, with the Jacobian.

The SSM models' polynomial maps are coefficient matrices times a basis of
monomials. The orderings are integer exponent tables built once in pure
Python (the JAX package's `monomial_exponents`, copied here so that this
package does not import it); the basis and its Jacobian are power products
evaluated on any leading batch axes.

Zero exponents are masked out of every power: x**0 has no derivative at
x = 0 under automatic differentiation, and the SSM linearizations are taken
at the origin (every closed loop starts there). `monomial_jacobian` is the
analytic derivative of the masked power product, so it is finite and exact
at the origin too.
"""

from __future__ import annotations

from functools import lru_cache
from itertools import product

import numpy as np
import torch


@lru_cache(maxsize=None)
def monomial_exponents(dim: int, order: int, include_constant: bool = False):
    """Exponent tuples of all monomials in `dim` variables with total degree
    1..order (0..order if include_constant), sorted by (total degree,
    descending lex on exponents). Returns an (n_mono, dim) int32 array."""
    exps = []
    for e in product(range(order + 1), repeat=dim):
        deg = sum(e)
        if deg <= order and (include_constant or deg > 0):
            exps.append(e)
    exps.sort(key=lambda e: (sum(e), tuple(-ei for ei in e)))
    return np.asarray(exps, dtype=np.int32)


def _exps(exps, x):
    """The table as a tensor of x's dtype on x's device: a tensor already
    so (as the models keep it) is used as it is, with no copy."""
    if torch.is_tensor(exps):
        return exps.to(dtype=x.dtype, device=x.device)
    return torch.as_tensor(exps, dtype=x.dtype, device=x.device)


def eval_monomials(x, exps):
    """phi(x): the monomial basis at x (..., dim) -> (..., n_mono); exps
    is a table of `monomial_exponents` (array or tensor)."""
    e = _exps(exps, x)
    return torch.where(e > 0, x[..., None, :] ** e, 1.0).prod(dim=-1)


def monomial_jacobian(x, exps):
    """d phi / d x at x (..., dim) -> (..., n_mono, dim): entry (k, j) is
    e_kj x_j^(e_kj - 1) prod_{i != j} x_i^e_ki, with zero exponents masked
    as in `eval_monomials`. The product over i != j is taken with factor j
    set to 1, so there is no division by x_j (one (dim, dim) tile a
    monomial: dim is the reduced order, a few)."""
    e = _exps(exps, x)
    xe = x[..., None, :]
    pw = torch.where(e > 0, xe ** e, 1.0)
    dpw = torch.where(e > 0, e * xe ** (e - 1), 0.0)
    eye = torch.eye(x.shape[-1], dtype=torch.bool, device=x.device)
    others = torch.where(eye, 1.0, pw[..., None, :]).prod(dim=-1)
    return dpw * others


def make_poly_map(coeff, exps):
    """f(x) = coeff phi(x) on any leading batch axes of x."""
    coeff = torch.as_tensor(coeff)

    def f(x):
        return eval_monomials(x, exps) @ coeff.to(x).T

    return f
