"""The port's numerical building blocks against the JAX package, f64 on
the CPU: discretizers, packing and constraints, K^-1, Ruiz equilibration,
the rho re-balance, DARE, the EKF correction and the condensed LOCP."""

from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_helpers  # noqa: F401  (single-threaded torch)

from soft_robot_control_tpu.control import batch_mpc as jbm
from soft_robot_control_tpu.core import constraints as jcon
from soft_robot_control_tpu.core import discretize as jdisc
from soft_robot_control_tpu.core import packing as jpack
from soft_robot_control_tpu.estimators.ekf import EKFState as JEKF
from soft_robot_control_tpu.estimators.ekf import ekf_correct as jax_ekf
from soft_robot_control_tpu.lqr.riccati import dare as jax_dare
from soft_robot_control_tpu.qp.admm import _ruiz_equilibrate as jax_ruiz
from soft_robot_control_tpu.scp import locp_condensed as jlc
from soft_robot_control_tpu_torch.control import batch_mpc as tbm
from soft_robot_control_tpu_torch.core import constraints as tcon
from soft_robot_control_tpu_torch.core import discretize as tdisc
from soft_robot_control_tpu_torch.core import packing as tpack
from soft_robot_control_tpu_torch.estimators.ekf import EKFState as TEKF
from soft_robot_control_tpu_torch.estimators.ekf import ekf_correct as t_ekf
from soft_robot_control_tpu_torch.lqr.riccati import dare as t_dare
from soft_robot_control_tpu_torch.qp.admm import _ruiz_equilibrate as t_ruiz
from soft_robot_control_tpu_torch.qp.blocked import make_kinv as t_make_kinv
from soft_robot_control_tpu_torch.scp import locp_condensed as tlc

T = lambda a: torch.as_tensor(np.array(a))
J = jnp.asarray
close = lambda a, b, **kw: np.testing.assert_allclose(
    np.asarray(a), np.asarray(b), **kw)


def _qps(B, n, m, seed):
    rng = np.random.default_rng(seed)
    Ph = rng.normal(size=(B, n, n))
    P = Ph @ Ph.transpose(0, 2, 1) + np.eye(n)
    A = rng.normal(size=(B, m, n)) * rng.uniform(0.1, 50.0, (B, m, 1))
    q = rng.normal(size=(B, n)) * 30.0
    mid = np.einsum("bmn,bn->bm", A, rng.normal(size=(B, n)))
    return (P, q, A, mid - rng.uniform(0.1, 1, (B, m)),
            mid + rng.uniform(0.1, 1, (B, m)), rng.normal(size=(B, n)),
            rng.normal(size=(B, m)))


@pytest.mark.parametrize("method", ["fe", "be", "bil", "zoh"])
def test_discretizers(method):
    rng = np.random.default_rng(1)
    P, n, m = 5, 6, 2
    A = -2.0 * np.eye(n) + 0.3 * rng.normal(size=(P, n, n))
    B = rng.normal(size=(P, n, m))
    d = rng.normal(size=(P, n))
    ref = jdisc.discretize_affine_batch(J(A), J(B), J(d), 0.02, method=method)
    got = tdisc.discretize_affine_batch(T(A), T(B), T(d), 0.02, method=method)
    for g, r in zip(got, ref):
        close(g, r, atol=1e-9)


@pytest.mark.parametrize("method", ["be", "bil"])
def test_singular_discretization_is_non_finite_as_in_jax(method):
    """At a point where A is singular and I - dt A (for 'bil', I - dt A /
    2) too, the implicit discretizers give JAX's non-finite entries, each
    where JAX has one, and its finite ones (to 1e-12); on the card a check
    of the factorization raised here (a linear-algebra error, and a host
    sync a call), where JAX returns the values."""
    A = np.zeros((2, 3, 3))
    A[:, 0, 0] = 2.0 if method == "be" else 4.0   # dt A[0, 0] exactly 1 or 2
    A[1, 1, 2] = 0.3
    B, d = np.ones((2, 3, 1)), np.ones((2, 3))
    ref = jdisc.discretize_affine_batch(J(A), J(B), J(d), 0.5, method=method)
    got = tdisc.discretize_affine_batch(T(A), T(B), T(d), 0.5, method=method)
    for g, r in zip(got, ref):
        g, r = np.asarray(g), np.asarray(r)
        assert not np.isfinite(r).all()
        assert np.array_equal(np.isfinite(g), np.isfinite(r))
        assert np.array_equal(np.isnan(g), np.isnan(r))
        close(g[np.isfinite(r)], r[np.isfinite(r)], atol=1e-12)


def test_packing_and_constraints():
    rng = np.random.default_rng(2)
    q, v = rng.normal(size=(3, 4)), rng.normal(size=(3, 4))
    x = tpack.qv2x(T(q), T(v))
    close(x, jpack.qv2x(J(q), J(v)), atol=0)
    for g, r in zip(tpack.x2qv(x), jpack.x2qv(J(np.asarray(x)))):
        close(g, r, atol=0)
    hr_t = tcon.HyperRectangle([3.0, 2.0], [-1.0, 0.5])
    hr_j = jcon.HyperRectangle([3.0, 2.0], [-1.0, 0.5])
    close(hr_t.A, hr_j.A, atol=0)
    close(hr_t.b, hr_j.b, atol=0)
    assert hr_t.dim == 2


def test_make_kinv():
    P, _, A, _, _, _, _ = _qps(4, 20, 40, seed=3)
    rho = np.random.default_rng(3).uniform(0.05, 2.0, 40)
    ref = jax.vmap(lambda P_, A_: jbm.make_kinv(P_, A_, J(rho)))(J(P), J(A))
    close(t_make_kinv(T(P), T(A), T(rho)), ref, atol=1e-9)


def test_ruiz_equilibrate_and_equilibrate_qp():
    P, q, A, l, u, w0, y0 = _qps(3, 20, 40, seed=4)
    ref = jax.vmap(lambda *a: jax_ruiz(*a, 6))(J(P), J(q), J(A))
    got = t_ruiz(T(P), T(q), T(A), 6)
    for g, r in zip(got, ref):
        close(g, r, rtol=1e-9, atol=1e-9)
    ref = jax.vmap(lambda *a: jbm.equilibrate_qp(*a, iters=6))(
        *[J(a) for a in (P, q, A, l, u, w0, y0)])
    got = tbm.equilibrate_qp(*[T(a) for a in (P, q, A, l, u, w0, y0)], 6)
    for g, r in zip(got[:7] + got[7], ref[:7] + ref[7]):
        close(g, r, rtol=1e-9, atol=1e-9)


def test_rho_multiplier():
    args = _qps(5, 20, 40, seed=5)
    ref = jax.vmap(jbm._rho_multiplier)(*[J(a) for a in args])
    close(tbm._rho_multiplier(*[T(a) for a in args]), ref, rtol=1e-12,
          atol=1e-9)


def test_admm_staged_batched_matches_pallas_staging():
    P, q, A, l, u, w0, y0 = _qps(3, 20, 40, seed=6)
    rho = 0.1 * np.ones(40)
    ref = jbm.admm_staged_pallas(*[J(a) for a in (P, q, A, l, u, w0, y0)],
                                 J(rho), 100, 4, interpret=True)
    got = tbm.admm_staged_batched(*[T(a) for a in (P, q, A, l, u, w0, y0)],
                                  T(rho), 100, 4)
    for g, r in zip(got, ref):
        close(g, r, atol=1e-9)


def test_dare():
    rng = np.random.default_rng(7)
    Pn, n, m = 3, 8, 2
    A = np.eye(n) + 0.05 * rng.normal(size=(Pn, n, n))
    B = rng.normal(size=(Pn, n, m))
    Q, R = np.eye(n), 0.1 * np.eye(m)
    Kr, Pr = jax.vmap(lambda a, b: jax_dare(a, b, J(Q), J(R)))(J(A), J(B))
    Kt, Pt = t_dare(T(A), T(B), T(Q), T(R))
    close(Kt, Kr, atol=1e-9)
    close(Pt, Pr, rtol=1e-9, atol=1e-9)


def test_ekf_correct():
    rng = np.random.default_rng(8)
    Bsz, n, ny = 4, 10, 6
    C, y_ref = rng.normal(size=(ny, n)), rng.normal(size=ny)
    Lh = rng.normal(size=(Bsz, n, n))
    Sig = Lh @ Lh.transpose(0, 2, 1) + np.eye(n)
    x, y = rng.normal(size=(Bsz, n)), rng.normal(size=(Bsz, ny))
    V = 1e-2 * np.eye(ny)
    jm = SimpleNamespace(C=J(C), y_ref=J(y_ref))
    ref = jax.vmap(lambda x_, S_, y_: jax_ekf(jm, JEKF(x_, S_), y_, J(V)))(
        J(x), J(Sig), J(y))
    tm = SimpleNamespace(C=T(C), y_ref=T(y_ref))
    got = t_ekf(tm, TEKF(T(x), T(Sig)), T(y), T(V))
    close(got.x, ref.x, atol=1e-9)
    close(got.Sigma, ref.Sigma, atol=1e-9)


def test_condensed_assemble_and_recover_x():
    rng = np.random.default_rng(9)
    Bsz, N, nx, nu, nz = 3, 5, 8, 3, 2
    H = rng.normal(size=(nz, nx))
    Qz, R = 100.0 * np.eye(nz), 1e-3 * np.eye(nu)
    Ad = np.eye(nx) + 0.1 * rng.normal(size=(Bsz, N, nx, nx))
    Bd = rng.normal(size=(Bsz, N, nx, nu))
    dd = rng.normal(size=(Bsz, N, nx))
    x0, z = rng.normal(size=(Bsz, nx)), rng.normal(size=(Bsz, N + 1, nz))
    u_des = rng.normal(size=(Bsz, N, nu))
    ub, lb = 3.0 * np.ones(nu), np.zeros(nu)
    dUA, dUb = np.vstack([np.eye(nu), -np.eye(nu)]), 0.5 * np.ones(2 * nu)
    js = jlc.CondensedSpec(N, H, Qz, R, U=jcon.HyperRectangle(ub, lb),
                           dU=jcon.Polyhedron(dUA, dUb), dtype=jnp.float64)
    ts = tlc.CondensedSpec(N, H, Qz, R, U=tcon.HyperRectangle(ub, lb),
                           dU=tcon.Polyhedron(dUA, dUb), dtype=torch.float64,
                           device="cpu")
    assert (ts.n_var, ts.n_con) == (js.n_var, js.n_con)
    zeros = lambda *s: jnp.zeros(s)
    ref = jax.vmap(lambda a, b, c, x_, z_, ud: js.assemble(jlc.CondensedParams(
        Ad=a, Bd=b, dd=c, x0=x_, z=z_, u_des=ud, Hd=zeros(N + 1, nz, nx),
        cd=zeros(N + 1, nz))))(*[J(a) for a in (Ad, Bd, dd, x0, z, u_des)])
    got = ts.assemble(tlc.CondensedParams(
        Ad=T(Ad), Bd=T(Bd), dd=T(dd), x0=T(x0), z=T(z), u_des=T(u_des)))
    for g, r in zip(got, ref):
        close(g, r, rtol=1e-9, atol=1e-9)
    w = rng.normal(size=(Bsz, N * nu))
    ref_x = jax.vmap(js.recover_x)(ref[6], ref[7], J(w))
    close(ts.recover_x(got[6], got[7], T(w)), ref_x, rtol=1e-9, atol=1e-9)


def test_condensed_spec_refuses_unported_options():
    """The trust region, X, the nonlinear observer's output map and Qzf
    were refused until the condensed LOCP was completed; each is now taken,
    with the JAX spec's dimensions. What both packages still refuse is a
    terminal set Xf (CondensedLOCPAdapter)."""
    for kw in (dict(trust_region=True), dict(X=tcon.Polyhedron([[1.0]], [1.0])),
               dict(nonlinear_observer=True), dict(Qzf=np.eye(1))):
        ts = tlc.CondensedSpec(2, np.eye(1), np.eye(1), np.eye(1),
                               device="cpu", **kw)
        if "X" in kw:
            kw["X"] = jcon.Polyhedron([[1.0]], [1.0])
        js = jlc.CondensedSpec(2, np.eye(1), np.eye(1), np.eye(1), **kw)
        assert (ts.n_var, ts.n_con) == (js.n_var, js.n_con)
    with pytest.raises(NotImplementedError, match="terminal-set"):
        tlc.CondensedLOCPAdapter(2, np.eye(1), np.eye(1), np.eye(1),
                                 Xf=tcon.Polyhedron([[1.0]], [1.0]),
                                 device="cpu")


def test_window_targets_and_demo_targets():
    z = np.arange(20, dtype=float)[:, None]
    np.testing.assert_array_equal(tbm.window_targets(z, 3, 2, 4),
                                  jbm.window_targets(z, 3, 2, 4))
    from soft_robot_control_tpu.tasks.demo import demo_targets as jdt
    from soft_robot_control_tpu_torch.tasks.demo import demo_targets as tdt

    jm = SimpleNamespace(H=np.zeros((2, 4)), z_ref=np.array([0.5, -1.0]),
                         q=np.zeros((3, 2)))
    tm = SimpleNamespace(H=torch.zeros((2, 4)), z_ref=T(jm.z_ref),
                         q=torch.zeros((3, 2), dtype=torch.float64))
    np.testing.assert_array_equal(tdt(tm, 3, 2, 4, 0.01, batch=2),
                                  jdt(jm, 3, 2, 4, 0.01, batch=2))
