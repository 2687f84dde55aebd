"""The block-tridiagonal KKT solves of the port (qp/structured.py and
qp/cyclic_reduction.py) against a dense solve and against the JAX package,
f64 on the CPU: random SPD block-tridiagonal systems of M = N+1 blocks for
N = 1, 2, 3 (M = 2, 3, 4: the smallest reductions), odd and even N; the
LOCP's own K through StructuredKKT, with and without the dU coupling; and
the fixed-iteration ADMM over the structured x-step.

Tolerances: solutions within 1e-9 of the dense solve relative to their
scale (the systems have condition numbers near 1e2), and within 1e-11 of
the JAX solution; ADMM iterates within 1e-9 after 150 iterations."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_helpers  # noqa: F401  (single-threaded torch)

from soft_robot_control_tpu.control.batch_mpc import admm_fixed as jax_admm
from soft_robot_control_tpu.core.constraints import HyperRectangle as JaxBox
from soft_robot_control_tpu.qp import cyclic_reduction as jcr
from soft_robot_control_tpu.qp import structured as jst
from soft_robot_control_tpu.qp.admm import OSQP_RHO_EQ_SCALE
from soft_robot_control_tpu.scp.locp import LOCPParams, LOCPSpec
from soft_robot_control_tpu_torch.qp import cyclic_reduction as tcr
from soft_robot_control_tpu_torch.qp import structured as tst

DENSE_RTOL = 1e-9
JAX_RTOL = 1e-11
ADMM_ATOL = 1e-9


def _btd_system(M, nb=5, seed=0):
    """Random SPD block-tridiagonal (diag (M, nb, nb), lower (M-1, nb,
    nb)), its dense matrix and a right-hand side (M, nb)."""
    rng = np.random.default_rng(seed)
    lower = rng.normal(size=(M - 1, nb, nb))
    G = rng.normal(size=(M, nb, nb))
    diag = G @ np.swapaxes(G, 1, 2) + 4.0 * nb * np.eye(nb)
    K = np.zeros((M * nb, M * nb))
    for k in range(M):
        K[k * nb:(k + 1) * nb, k * nb:(k + 1) * nb] = diag[k]
    for k in range(M - 1):
        K[(k + 1) * nb:(k + 2) * nb, k * nb:(k + 1) * nb] = lower[k]
        K[k * nb:(k + 1) * nb, (k + 1) * nb:(k + 2) * nb] = lower[k].T
    return diag, lower, K, rng.normal(size=(M, nb))


def _close(got, ref, rtol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=rtol * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("N", [1, 2, 3, 4, 7, 8])
@pytest.mark.parametrize("method", ["cr", "scan"])
def test_block_solve_matches_dense_and_jax(N, method):
    M = N + 1
    diag, lower, K, rhs = _btd_system(M, seed=N)
    t = lambda a: torch.as_tensor(a)
    if method == "cr":
        got = tcr.cr_solve(tcr.cr_factor(t(diag), t(lower)), t(rhs))
        ref = jcr.cr_solve(jcr.cr_factor(jnp.asarray(diag),
                                         jnp.asarray(lower)),
                           jnp.asarray(rhs))
        assert len(tcr.cr_factor(t(diag), t(lower)).levels) == \
            int(np.ceil(np.log2(M)))
    else:
        got = tst.btd_solve(*tst.btd_factor(t(diag), t(lower)), t(rhs))
        ref = jst.btd_solve(*jst.btd_factor(jnp.asarray(diag),
                                            jnp.asarray(lower)),
                            jnp.asarray(rhs))
    assert got.shape == (M, diag.shape[1])
    _close(got.numpy().reshape(-1), np.linalg.solve(K, rhs.reshape(-1)),
           DENSE_RTOL)
    _close(got.numpy(), ref, JAX_RTOL)


def test_spd_inverse_and_factors_match_jax():
    diag, lower, _, _ = _btd_system(9, nb=6, seed=3)
    inv = tcr.spd_inv_blocked(torch.as_tensor(diag)).numpy()
    _close(inv, np.linalg.inv(diag), 1e-12)
    got = tcr.cr_factor(torch.as_tensor(diag), torch.as_tensor(lower))
    ref = jcr.cr_factor(jnp.asarray(diag), jnp.asarray(lower))
    assert len(got.levels) == len(ref.levels) == 4
    for lg, lr in zip(got.levels, ref.levels):
        for a, b in zip(lg, lr):
            assert a.shape == b.shape
            _close(a.numpy(), b, JAX_RTOL)
    _close(got.root_inv.numpy(), ref.root_inv, JAX_RTOL)
    Ld, Lo = tst.btd_factor(torch.as_tensor(diag), torch.as_tensor(lower))
    Jd, Jo = jst.btd_factor(jnp.asarray(diag), jnp.asarray(lower))
    _close(Ld.numpy(), Jd, JAX_RTOL)
    _close(Lo.numpy(), Jo, JAX_RTOL)


def test_block_factor_of_an_indefinite_block_gives_nan_without_raising():
    """No factorization check waits on the device: as in JAX, a block
    that is not positive definite gives NaN."""
    diag, lower, _, rhs = _btd_system(4, seed=1)
    diag[1] = -diag[1]
    t = lambda a: torch.as_tensor(a)
    w = tst.btd_solve(*tst.btd_factor(t(diag), t(lower)), t(rhs))
    assert not torch.isfinite(w).all()


def _locp_qp(N=8, nx=5, nu=2, nz=2, seed=0, with_dU=True):
    """tests/test_structured.py's LOCP (trust region off), assembled by
    the JAX LOCPSpec: (spec, P, q, A, l, u, rho) as numpy arrays."""
    rng = np.random.default_rng(seed)
    H = rng.normal(size=(nz, nx))
    U = JaxBox(np.ones(nu), -np.ones(nu))
    dU = JaxBox(0.3 * np.ones(nu), -0.3 * np.ones(nu)) if with_dU else None
    spec = LOCPSpec(N, H, np.eye(nz), 0.1 * np.eye(nu), U=U, dU=dU,
                    is_tr_active=False)
    Ad = rng.normal(size=(N, nx, nx)) * 0.3 + 0.7 * np.eye(nx)
    Bd = rng.normal(size=(N, nx, nu))
    dd = 0.05 * rng.normal(size=(N, nx))
    x0 = rng.normal(size=nx) * 0.3
    params = LOCPParams(
        Ad=jnp.array(Ad), Bd=jnp.array(Bd), dd=jnp.array(dd),
        x0=jnp.array(x0), xk=jnp.zeros((N + 1, nx)), delta=jnp.array(0.0),
        omega=jnp.array(0.0), z=jnp.array(rng.normal(size=(N + 1, nz))),
        zf=jnp.zeros(nz), u_des=jnp.zeros((N, nu)),
        Hd=jnp.zeros((N + 1, nz, nx)), cd=jnp.zeros((N + 1, nz)))
    P, q, A, l, u, _ = (np.asarray(a) for a in spec.assemble(params))
    rho = np.full(spec.n_con, 0.1)
    rho[spec.r_init:spec.r_init + nx] *= OSQP_RHO_EQ_SCALE
    rho[spec.r_dyn:spec.r_dyn + N * nx] *= OSQP_RHO_EQ_SCALE
    return spec, P, q, A, l, u, rho


@pytest.mark.parametrize("N", [1, 2, 3, 8])
@pytest.mark.parametrize("with_dU", [False, True])
@pytest.mark.parametrize("method", ["cr", "scan"])
def test_structured_kkt_on_the_locp(N, with_dU, method):
    nx, nu = 5, 2
    spec, P, q, A, l, u, rho = _locp_qp(N=N, nx=nx, nu=nu, with_dU=with_dU,
                                        seed=N)
    n = spec.n_var
    K = P + 1e-6 * np.eye(n) + (A.T * rho[None, :]) @ A
    np.testing.assert_array_equal(tst.stage_permutation(N, nx, nu),
                                  jst.stage_permutation(N, nx, nu))
    tk = tst.StructuredKKT(N, nx, nu, method=method, device="cpu")
    Kp = torch.as_tensor(K)[tk.perm][:, tk.perm]
    jd, jl = jst.extract_btd_blocks(jnp.asarray(K)[jst.stage_permutation(
        N, nx, nu)][:, jst.stage_permutation(N, nx, nu)], N, nx + nu, nx)
    td, tl = tst.extract_btd_blocks(Kp, N, nx + nu, nx)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))

    rhs = np.random.default_rng(1).normal(size=n)
    w = tk.solve(tk.factor(torch.as_tensor(K)), torch.as_tensor(rhs))
    jk = jst.StructuredKKT(N, nx, nu, method=method)
    ref = jk.solve(jk.factor(jnp.asarray(K)), jnp.asarray(rhs))
    _close(w.numpy(), np.linalg.solve(K, rhs), 1e-8)
    _close(w.numpy(), ref, 1e-10)


def test_admm_fixed_btd_matches_jax_and_dense_admm():
    N, nx, nu = 10, 4, 2
    spec, P, q, A, l, u, rho = _locp_qp(N=N, nx=nx, nu=nu, seed=3)
    w0, y0 = np.zeros(spec.n_var), np.zeros(spec.n_con)
    t = lambda a: torch.as_tensor(np.array(a))
    w, y = tst.admm_fixed_btd(t(P), t(q), t(A), t(l), t(u), t(w0), t(y0),
                              t(rho), 150,
                              tst.StructuredKKT(N, nx, nu, device="cpu"))
    jw, jy = jst.admm_fixed_btd(*(jnp.asarray(a) for a in (
        P, q, A, l, u, w0, y0, rho)), 150, jst.StructuredKKT(N, nx, nu))
    dw, _ = jax_admm(*(jnp.asarray(a) for a in (P, q, A, l, u, w0, y0)),
                     jnp.asarray(rho), 150)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=ADMM_ATOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy),
                               atol=ADMM_ATOL * max(1.0, np.abs(jy).max()))
    np.testing.assert_allclose(w.numpy(), np.asarray(dw), atol=1e-8)


def test_structured_kkt_refuses_an_unknown_method_and_defaults_to_the_card():
    with pytest.raises(ValueError, match="unknown method"):
        tst.StructuredKKT(4, 2, 1, method="lu", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tst.StructuredKKT(4, 2, 1)
