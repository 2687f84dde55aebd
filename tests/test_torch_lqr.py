"""The LQR family, the port against the JAX package on the same numpy
inputs, f64 on the CPU: `solve_riccati`, `dare`, `care`, `dlqr_gain`,
`clqr_gain` (single systems and batches), `interp_rows`,
`tv_lqr_backward`, `TrajTrackingLQR` on the chain TPWL model, and iLQR on
a linear system and on the chain TPWL model (iterates, costs and the
accepted step sizes). Tolerances are stated in each test."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from helpers import chain_pipeline

from soft_robot_control_tpu.core.types import Target as JaxTarget
from soft_robot_control_tpu.core.types import QuadraticCost as JaxCost
from soft_robot_control_tpu.lqr import ilqr as jilqr
from soft_robot_control_tpu.lqr import riccati as jric
from soft_robot_control_tpu.lqr import tvlqr as jtv
from soft_robot_control_tpu_torch.core.types import QuadraticCost, Target
from soft_robot_control_tpu_torch.lqr import ilqr as tilqr
from soft_robot_control_tpu_torch.lqr import riccati as tric
from soft_robot_control_tpu_torch.lqr import tvlqr as ttv
from soft_robot_control_tpu_torch.models.convert import (model_arrays,
                                                         model_from_arrays)

# the Riccati solvers iterate the same f64 operations: rounding only
RIC_TOL = 1e-9


def _close(got, ref, tol, msg=""):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, msg
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(1.0, np.abs(ref).max()),
                               err_msg=msg)


def _systems(n=5, m=2, B=3, seed=0, discrete=True):
    """B random stabilizable (A, B) pairs and SPD weights Q, R."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, n, n)) / np.sqrt(n)
    if not discrete:
        A = A - 1.5 * np.eye(n)
    Bm = rng.normal(size=(B, n, m))
    L = rng.normal(size=(n, n))
    Q = L @ L.T / n + 0.1 * np.eye(n)
    R = np.diag(rng.uniform(0.5, 2.0, m))
    return A, Bm, Q, R


T = lambda a: torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def chain():
    """The chain pipeline's JAX model (pre-discretized at dt=0.02) and the
    port's model from the same arrays."""
    _, rom, model, Hf, Cf, X, u = chain_pipeline(
        n_nodes=10, n_cables=4, dt=0.02, threshold=0.5)
    jm = model.pre_discretize(0.02)
    return jm, model_from_arrays(model_arrays(jm), device="cpu"), rom, X, u


def test_solve_riccati_matches_jax_one_system_and_a_batch():
    """Each system of a batch stops at its own iteration, so the batch
    gives what the JAX loop gives system by system (1e-9 of the scale;
    the stopping rule is at 1e-4, so a different iteration count would
    show)."""
    A, B, Q, R = _systems()
    Lb, Pb = tric.solve_riccati(T(A), T(B), T(Q), T(R))
    for i in range(A.shape[0]):
        Lj, Pj = jric.solve_riccati(A[i], B[i], Q, R)
        _close(Lb[i], Lj, RIC_TOL)
        _close(Pb[i], Pj, RIC_TOL)
        L1, P1 = tric.solve_riccati(T(A[i]), T(B[i]), T(Q), T(R))
        _close(L1, Lj, RIC_TOL)
        _close(P1, Pj, RIC_TOL)


def test_dare_matches_jax_and_solve_riccati():
    A, B, Q, R = _systems(seed=1)
    Kb, Pb = tric.dare(T(A), T(B), T(Q), T(R))
    for i in range(A.shape[0]):
        Kj, Pj = jric.dare(A[i], B[i], Q, R)
        _close(Kb[i], Kj, RIC_TOL)
        _close(Pb[i], Pj, RIC_TOL)
    # the fixed point the doubling reaches is the iteration's (to its 1e-4
    # stopping rule)
    L, _ = tric.solve_riccati(T(A), T(B), T(Q), T(R))
    _close(L, Kb, 1e-3)


def test_care_matches_jax():
    """Sign-function CARE, 60 iterations: 1e-8 of the scale (LAPACK's and
    XLA's least-squares solvers differ in the last digits)."""
    A, B, Q, R = _systems(seed=2, discrete=False)
    Kb, Pb = tric.care(T(A), T(B), T(Q), T(R))
    for i in range(A.shape[0]):
        Kj, Pj = jric.care(A[i], B[i], Q, R)
        _close(Kb[i], Kj, 1e-8)
        _close(Pb[i], Pj, 1e-8)
        # the continuous Riccati residual vanishes
        P = Pb[i].numpy()
        res = A[i].T @ P + P @ A[i] - P @ B[i] @ np.linalg.solve(
            R, B[i].T) @ P + Q
        assert np.abs(res).max() < 1e-8 * max(1.0, np.abs(P).max())


def test_dlqr_and_clqr_gains_on_the_chain_model(chain):
    """At one continuous dictionary point of the chain model: the model's
    backward-Euler discretization then the fixed-point DARE, and the
    CARE gain."""
    jm, tm, *_ = chain
    n, m = jm.state_dim, jm.input_dim
    Q, R = np.eye(n), 0.1 * np.eye(m)
    A_c, B_c = np.asarray(jm.A_c[7]), np.asarray(jm.B_c[7])
    _close(tric.dlqr_gain(tm, T(A_c), T(B_c), T(Q), T(R), 0.02),
           jric.dlqr_gain(jm, A_c, B_c, Q, R, 0.02), RIC_TOL)
    _close(tric.clqr_gain(T(A_c), T(B_c), T(Q), T(R)),
           jric.clqr_gain(A_c, B_c, Q, R), 1e-8)


def test_interp_rows_matches_jax():
    rng = np.random.default_rng(3)
    tg = np.sort(rng.uniform(0, 2, 9))
    X = rng.normal(size=(9, 4))
    tq = np.linspace(-0.5, 2.5, 31)   # both ends clamp
    _close(ttv.interp_rows(tq, tg, X), jtv.interp_rows(tq, tg, X), 1e-14)


def test_tv_lqr_backward_matches_jax():
    """A reversed loop over 40 steps, re-symmetrized: 1e-10 of the scale;
    a leading batch axis gives each trajectory's recursion."""
    rng = np.random.default_rng(4)
    Tn, n, m = 40, 6, 2
    A = np.eye(n) + 0.05 * rng.normal(size=(2, Tn, n, n))
    B = 0.1 * rng.normal(size=(2, Tn, n, m))
    Q, R = np.eye(n), 0.01 * np.eye(m)
    Kb, Pb = ttv.tv_lqr_backward(T(A), T(B), Q, R)
    assert Kb.shape == (2, Tn, m, n) and Pb.shape == (2, Tn + 1, n, n)
    for i in range(2):
        Kj, Pj = jtv.tv_lqr_backward(A[i], B[i], Q, R)
        _close(Kb[i], Kj, 1e-10)
        _close(Pb[i], Pj, 1e-10)


def test_traj_tracking_lqr_on_the_chain_model(chain):
    """Nominal states and inputs interpolated onto the dt grid, the
    Jacobians at all of them in one call, the backward pass: 1e-10."""
    jm, tm, rom, X, u = chain
    dt = 0.02
    t = dt * np.arange(60)
    x_nom = np.asarray(jax.vmap(rom.project_x)(jnp.asarray(X[:60])))
    n, m = jm.state_dim, jm.input_dim
    Q, R = np.eye(n), 0.01 * np.eye(m)
    ref = jtv.TrajTrackingLQR(dt, jm, JaxCost(Q=Q, R=R)).compute_policy(
        JaxTarget(t=t, x=x_nom, u=u[:60]))
    got = ttv.TrajTrackingLQR(dt, tm, QuadraticCost(Q=Q, R=R)).compute_policy(
        Target(t=t, x=x_nom, u=u[:60]))
    for g, r, name in zip(got, ref, ("x_bar", "u_bar", "K")):
        _close(g, r, 1e-10, name)


class _JaxLinear:
    """x+ = A x + B u + d with z = H x + z_ref, in JAX."""

    def __init__(self, A, B, d, H, z_ref):
        self.A, self.B, self.d = (jnp.asarray(a) for a in (A, B, d))
        self.H, self.z_ref = jnp.asarray(H), jnp.asarray(z_ref)

    def get_state_dim(self):
        return self.A.shape[0]

    def get_input_dim(self):
        return self.B.shape[1]

    def get_jacobians(self, x, dt=None, u=None):
        return self.A, self.B, self.d


class _TorchLinear(_JaxLinear):
    """The same system in the port's terms (tensors, leading axes)."""

    def __init__(self, A, B, d, H, z_ref):
        self.A, self.B, self.d = (torch.as_tensor(a) for a in (A, B, d))
        self.H, self.z_ref = torch.as_tensor(H), torch.as_tensor(z_ref)

    def get_jacobians(self, x, dt=None, u=None):
        lead = x.shape[:-1]
        return (self.A.expand(lead + self.A.shape),
                self.B.expand(lead + self.B.shape),
                self.d.expand(lead + self.d.shape))


def _record_forward(solver, alpha_arg=5):
    """Wrap the solver's forward pass: the step size, cost, states and
    inputs of every call (the initial rollout and every line-search
    trial)."""
    calls, real = [], solver._forward

    def rec(*a):
        out = real(*a)
        calls.append((float(a[alpha_arg]), float(out[2]),
                      np.array(out[0]), np.array(out[1])))
        return out

    solver._forward = rec
    return calls


def _same_ilqr(js, ts, x0, tol):
    calls_j, calls_t = _record_forward(js), _record_forward(ts)
    xj, uj, Kj = js.ilqr_computation(x0)
    xt, ut, Kt = ts.ilqr_computation(x0)
    assert [c[0] for c in calls_t] == [c[0] for c in calls_j]
    np.testing.assert_allclose([c[1] for c in calls_t],
                               [c[1] for c in calls_j], rtol=tol)
    for k, (ct, cj) in enumerate(zip(calls_t, calls_j)):
        _close(ct[2], cj[2], tol, f"x of forward pass {k}")
        _close(ct[3], cj[3], tol, f"u of forward pass {k}")
    for g, r, name in ((xt, xj, "x"), (ut, uj, "u"), (Kt, Kj, "K")):
        _close(g, r, tol, name)
    assert (ts.rho, ts.drho) == pytest.approx((js.rho, js.drho), rel=1e-12)
    return calls_t


@pytest.mark.parametrize("du,state_reg", [(True, True), (False, False)])
def test_ilqr_on_a_linear_system(du, state_reg):
    """A lightly unstable linear system tracking a ramp on two outputs:
    the forward passes' step sizes identical, their costs, the iterates
    and the gains within 1e-9."""
    rng = np.random.default_rng(5)
    n, m, Tn = 6, 2, 30
    A = np.eye(n) + 0.03 * rng.normal(size=(n, n))
    B, d = 0.1 * rng.normal(size=(n, m)), 0.01 * rng.normal(size=n)
    H, z_ref = rng.normal(size=(2, n)), np.array([0.3, -0.2])
    cost = dict(Q=10.0 * np.eye(2), R=0.05 * np.eye(m), Qf=50.0 * np.eye(2))
    cfg_j, cfg_t = jilqr.iLQRConfig(), tilqr.iLQRConfig()
    for c in (cfg_j, cfg_t):
        c.include_input_var_constraint = du
        c.state_regularization = state_reg
    js = jilqr.iLQR(0.02, _JaxLinear(A, B, d, H, z_ref), JaxCost(**cost), Tn,
                    config=cfg_j)
    ts = tilqr.iLQR(0.02, _TorchLinear(A, B, d, H, z_ref),
                    QuadraticCost(**cost), Tn, config=cfg_t)
    z_t = np.linspace(0, 1, Tn + 1)[:, None] * np.array([1.0, -0.5])
    for s in (js, ts):
        s.set_target(z_t)
        s.set_u_last(np.array([0.1, -0.1]))
    calls = _same_ilqr(js, ts, 0.1 * rng.normal(size=n), 1e-9)
    assert len(calls) >= 3


def test_ilqr_on_the_chain_tpwl_model(chain):
    """The chain TPWL model (nearest-point Jacobians a step) tracking a
    tip sine over 25 steps: the step sizes identical, costs, iterates and
    gains within 1e-8 of their scale."""
    jm, tm, *_ = chain
    Tn, dt = 25, 0.02
    cost = dict(Q=np.array([[500.0]]), R=0.01 * np.eye(4),
                Qf=np.array([[500.0]]))
    js = jilqr.iLQR(dt, jm, JaxCost(**cost), Tn)
    ts = tilqr.iLQR(dt, tm, QuadraticCost(**cost), Tn)
    z0 = float(np.asarray(jm.z_ref)[0])
    z_t = (z0 + 0.06 * np.sin(2 * np.pi * dt * np.arange(Tn + 1)))[:, None]
    for s in (js, ts):
        s.set_target(z_t)
    calls = _same_ilqr(js, ts, np.zeros(jm.state_dim), 1e-8)
    assert len(calls) >= 2
