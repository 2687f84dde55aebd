"""The port's plain fixed-iteration ADMM solvers of control/batch_mpc.py
(`admm_fixed`, `admm_fixed_kinv`, `admm_staged_kinv`), batched over a
leading axis, against the JAX package's per QP, f64 on the CPU at 1e-9;
and the kernel path's `admm_staged_batched` (rho folded into the rows)
against the explicit-rho `admm_staged_kinv`."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_helpers  # noqa: F401  (single-threaded torch)

from soft_robot_control_tpu.control import batch_mpc as jbm
from soft_robot_control_tpu_torch.control import batch_mpc as tbm
from soft_robot_control_tpu_torch.qp.blocked import make_kinv

ATOL = 1e-9
J = jnp.asarray
T = lambda a: torch.as_tensor(np.array(a))


def _qps(B, n, m, seed, eq_rows=4):
    """Random feasible QPs with equality rows (boosted rho), one-sided rows
    and a free row, as the sparse LOCP has them."""
    rng = np.random.default_rng(seed)
    Ph = rng.normal(size=(B, n, n))
    P = Ph @ Ph.transpose(0, 2, 1) + 0.1 * np.eye(n)
    q = rng.normal(size=(B, n))
    A = rng.normal(size=(B, m, n))
    mid = np.einsum("bmn,bn->bm", A, rng.normal(size=(B, n)) * 0.2)
    l = mid - rng.uniform(0.1, 1, (B, m))
    u = mid + rng.uniform(0.1, 1, (B, m))
    l[:, :eq_rows] = u[:, :eq_rows]
    l[:, eq_rows:eq_rows + 3] = -np.inf
    u[:, eq_rows + 2:eq_rows + 4] = np.inf
    rho = 0.1 * np.ones(m)
    rho[:eq_rows] *= 1000
    return (P, q, A, l, u, 0.1 * rng.normal(size=(B, n)),
            0.1 * rng.normal(size=(B, m))), rho


def _close(got, ref):
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


def test_admm_fixed_matches_jax():
    qp, rho = _qps(3, 16, 24, seed=0)
    ref = jax.vmap(lambda *a: jbm.admm_fixed(*a, J(rho), 120))(
        *[J(a) for a in qp])
    _close(tbm.admm_fixed(*[T(a) for a in qp], T(rho), 120), ref)


def test_admm_fixed_kinv_matches_jax():
    (P, q, A, l, u, w0, y0), rho = _qps(3, 16, 24, seed=1)
    Kinv = jax.vmap(lambda P_, A_: jbm.make_kinv(P_, A_, J(rho)))(J(P), J(A))
    ref = jax.vmap(lambda *a: jbm.admm_fixed_kinv(*a, J(rho), 120))(
        Kinv, *[J(a) for a in (q, A, l, u, w0, y0)])
    got = tbm.admm_fixed_kinv(make_kinv(T(P), T(A), T(rho)),
                              *[T(a) for a in (q, A, l, u, w0, y0)], T(rho),
                              120)
    _close(got, ref)


@pytest.mark.parametrize("stages", [1, 3])
def test_admm_staged_kinv_matches_jax(stages):
    qp, rho = _qps(3, 16, 24, seed=2 + stages)
    ref = jax.vmap(lambda *a: jbm.admm_staged_kinv(*a, J(rho), 90, stages))(
        *[J(a) for a in qp])
    _close(tbm.admm_staged_kinv(*[T(a) for a in qp], T(rho), 90, stages),
           ref)


@pytest.mark.parametrize("stages", [1, 4])
def test_folded_rho_matches_explicit_rho(stages):
    """Folding sqrt(rho) into the rows (what the kernel path does, one
    shared unit rho row) is the same iteration as the explicit per-row
    rho, infinite bounds included."""
    qp, rho = _qps(4, 16, 24, seed=9)
    targs = [T(a) for a in qp]
    ref = tbm.admm_staged_kinv(*targs, T(rho), 80, stages)
    got = tbm.admm_staged_batched(*targs, T(rho), 80, stages)
    assert all(torch.isfinite(t).all() for t in got)
    _close(got, [r.numpy() for r in ref])
