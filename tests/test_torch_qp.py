"""The port's `solve_qp_dense` (adaptive rho, termination checks, polish,
both x-step solvers) against the JAX package's on the QPs of
tests/test_qp.py, f64 on the CPU: x to 1e-6, the same `solved` flag and
iteration count."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_helpers  # noqa: F401  (single-threaded torch)
from test_qp import _kkt_check, _random_qp

from soft_robot_control_tpu.qp.admm import solve_qp_dense as jax_solve
from soft_robot_control_tpu_torch.qp.admm import solve_qp_dense

ATOL = 1e-6


def _both(qp, **kw):
    ref = jax_solve(*[jnp.asarray(a) for a in qp], **kw)
    got = solve_qp_dense(*[torch.as_tensor(np.array(a)) for a in qp], **kw)
    assert got.solved == bool(ref.solved)
    assert got.iters == int(ref.iters)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), atol=ATOL)
    np.testing.assert_allclose(got.y.numpy(), np.asarray(ref.y), atol=1e-5)
    np.testing.assert_allclose(float(got.obj), float(ref.obj), atol=ATOL)
    return ref, got


@pytest.mark.parametrize("seed", range(5))
def test_random_qps_match_jax(seed):
    qp = _random_qp(seed=seed)
    _, got = _both(qp)
    assert got.solved
    _kkt_check(*qp, got)


@pytest.mark.parametrize("kw", [dict(polish=False), dict(x_solver="kinv"),
                                dict(adaptive_rho=False, max_iter=300),
                                dict(scaling_iters=0, rho=1.0),
                                dict(check_every=10, rho_every=50)])
def test_solver_options_match_jax(kw):
    _both(_random_qp(n=10, m=14, n_eq=3, seed=21), **kw)


def test_warm_start_matches_jax():
    # not tests/test_qp.py's seed 7: there a dual that is rounding noise
    # (1e-17, its sign differs between the runtimes) makes the JAX polish
    # guess a wrong active set, which its acceptance test lets through
    P, q, A, l, u = _random_qp(seed=3)
    ref, got = _both((P, q, A, l, u))
    ref2 = jax_solve(*[jnp.asarray(a) for a in (P, q + 1e-3, A, l, u)],
                     x0=ref.x, y0=ref.y)
    got2 = solve_qp_dense(*[torch.as_tensor(a) for a in (P, q + 1e-3, A, l,
                                                         u)],
                          x0=got.x, y0=got.y)
    assert got2.solved and got2.iters == int(ref2.iters)
    np.testing.assert_allclose(got2.x.numpy(), np.asarray(ref2.x), atol=ATOL)


def test_badly_scaled_box_matches_jax():
    """1e6 spread of scales: Ruiz equilibration carries it (test_qp.py)."""
    rng = np.random.default_rng(11)
    n = 6
    scales = 10.0 ** np.linspace(-3, 3, n)
    Ph = rng.normal(size=(n, n))
    P = np.diag(scales) @ (Ph @ Ph.T + 0.1 * np.eye(n)) @ np.diag(scales)
    q = rng.normal(size=n) * scales
    l = -np.abs(rng.normal(size=n)) * scales
    u = np.abs(rng.normal(size=n)) * scales
    ref = jax_solve(*[jnp.asarray(a) for a in (P, q, np.eye(n), l, u)])
    got = solve_qp_dense(*[torch.as_tensor(a) for a in (P, q, np.eye(n), l,
                                                        u)])
    assert got.solved == bool(ref.solved)
    np.testing.assert_allclose(got.x.numpy() / scales,
                               np.asarray(ref.x) / scales, atol=ATOL)


def test_vacuous_zero_row_f32():
    """A zero constraint row must not blow up the Ruiz scaling in f32."""
    rng = np.random.default_rng(5)
    n = 8
    Ph = rng.normal(size=(n, n)).astype(np.float32)
    P = Ph @ Ph.T + 0.5 * np.eye(n, dtype=np.float32)
    q = rng.normal(size=n).astype(np.float32)
    sol = solve_qp_dense(torch.as_tensor(P), torch.as_tensor(q),
                         torch.zeros((1, n)), torch.full((1,), -1e30),
                         torch.full((1,), 1e30), eps_abs=1e-5, eps_rel=1e-5)
    assert torch.isfinite(sol.x).all() and torch.isfinite(sol.dua_res)
    x_unc = np.linalg.solve(P.astype(np.float64), -q.astype(np.float64))
    np.testing.assert_allclose(sol.x.numpy(), x_unc, atol=5e-4)


def test_rejects_what_it_does_not_take():
    P, q, A, l, u = (torch.as_tensor(a) for a in _random_qp(seed=0))
    with pytest.raises(ValueError, match="x_solver"):
        solve_qp_dense(P, q, A, l, u, x_solver="lu")
    with pytest.raises(ValueError, match="constraint row"):
        solve_qp_dense(P, q, A[:0], l[:0], u[:0])


def test_singular_polish_is_rejected_as_jax():
    """Two equal rows both active in float32: the polish step's masked
    system is singular once its 1e-7 regularization is lost in the
    rounding (a float32 SSM closed loop on the card met one). The port
    rejects the non-finite candidate as the JAX package's LU solve does,
    instead of raising, and returns JAX's solution."""
    qp = (np.eye(2), np.array([-200.0, 0.0]),
          np.array([[100.0, 0.0], [100.0, 0.0]]), np.array([-1e3, -1e3]),
          np.array([100.0, 100.0]))
    kw = dict(eps_abs=1e-5, eps_rel=1e-5)
    ref = jax_solve(*[jnp.asarray(a, jnp.float32) for a in qp], **kw)
    got = solve_qp_dense(*[torch.as_tensor(a, dtype=torch.float32)
                           for a in qp], **kw)
    assert got.solved and bool(ref.solved)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), atol=1e-5)
    np.testing.assert_allclose(got.y.numpy(), np.asarray(ref.y), atol=1e-5)
