"""GuSTOJit, the trust-region SCP loop over batches on the device:
`solve`, `solve_packed`, `solve_batch` and `solve_batch_fused` in both
formulations, against the JAX package (its fused path with the Pallas
kernel in interpret mode), f64 on the CPU, on the Dubins car and on a
small synthetic TPWL model (r=3, so the sparse QP stays small). Iteration
counts and convergence flags must be identical; x and u are held to 1e-9
of their scale, J to 1e-6: J also holds omega times the trust-region slack,
the variable that a fixed ADMM budget converges least, so rounding
differences between the runtimes show up there first."""

import numpy as np
import jax
import pytest
import torch

import torch_helpers  # noqa: F401  (single-threaded torch)

from soft_robot_control_tpu.core.constraints import HyperRectangle as JaxBox
from soft_robot_control_tpu.models.dubins import DubinsCar as JaxDubins
from soft_robot_control_tpu.models.interfaces import TPWLGuSTO as JaxAdapter
from soft_robot_control_tpu.scp.gusto_jit import GuSTOJit as JaxJit
from soft_robot_control_tpu.tasks.demo import make_demo_tpwl as jax_demo
from soft_robot_control_tpu_torch.core.constraints import HyperRectangle
from soft_robot_control_tpu_torch.models.dubins import DubinsCar
from soft_robot_control_tpu_torch.models.interfaces import TPWLGuSTO
from soft_robot_control_tpu_torch.scp import gusto_jit
from soft_robot_control_tpu_torch.scp.gusto_jit import GuSTOJit
from soft_robot_control_tpu_torch.tasks.demo import make_demo_tpwl

TOL = 1e-9
B = 3


def _same(ref, got, tol=TOL):
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(ref.converged))
    for k, t in (("x", tol), ("u", tol), ("J", 1e3 * tol)):
        r, g = np.asarray(getattr(ref, k)), getattr(got, k).numpy()
        fin = np.isfinite(r)
        np.testing.assert_array_equal(np.isfinite(g), fin)
        np.testing.assert_allclose(g[fin], r[fin], rtol=0,
                                   atol=t * max(1.0, np.abs(r[fin]).max()),
                                   err_msg=k)


def _dubins_batch(N, dt, X=False):
    """Both packages' GuSTOJit arguments on the Dubins car and a batch of B
    targets."""
    jm, tm = JaxDubins(), DubinsCar(device="cpu")
    Qz, R = np.diag([1.0, 1.0, 0.0]), 0.1 * np.eye(2)
    U = ([1.0, 1.0], [0.0, -1.0])
    box = ([0.6, 10.0, 10.0], [-10.0, -10.0, -10.0])
    rng = np.random.default_rng(1)
    z = np.zeros((B, N + 1, 3))
    z[:, :, :2] = rng.uniform(0.5, 1.5, size=(B, 1, 2))
    x0 = np.zeros((B, 3))
    u0 = np.zeros((B, N, 2))
    xi = np.stack([np.asarray(jm.rollout(x0[b], u0[b], dt))
                   for b in range(B)])
    jkw = dict(U=JaxBox(*U), X=JaxBox(*box) if X else None)
    tkw = dict(U=HyperRectangle(*U), X=HyperRectangle(*box) if X else None)
    return (jm, jkw), (tm, tkw), Qz, R, (x0, u0, xi, z)


def _demo_batch(N, dt):
    """A synthetic TPWL dictionary (r=3, P=24, 2 inputs, 2 outputs), both
    packages, pre-discretized at dt, and a batch of B problems."""
    kw = dict(r=3, P=24, m=2, nz=2, nf=8, seed=4, dtype=np.float64)
    ja = JaxAdapter(jax_demo(**kw).pre_discretize(dt))
    ta = TPWLGuSTO(make_demo_tpwl(device="cpu", **kw).pre_discretize(dt))
    rng = np.random.default_rng(6)
    x0 = 0.2 * rng.normal(size=(B, 6))
    u0 = np.zeros((B, N, 2))
    xi = np.repeat(x0[:, None], N + 1, axis=1)
    z = 0.3 * rng.normal(size=(B, N + 1, 2))
    U = (np.ones(2), -np.ones(2))
    return ((ja, dict(U=JaxBox(*U))), (ta, dict(U=HyperRectangle(*U))),
            10.0 * np.eye(2), 1e-2 * np.eye(2), (x0, u0, xi, z))


CASES = {
    # name: (problem, N, dt, GuSTOJit settings)
    "dubins_sparse_chol": ("dubins", 10, 0.1,
                           dict(max_iters=8, qp_iters=200)),
    "dubins_sparse_kinv": ("dubins", 10, 0.1,
                           dict(max_iters=8, qp_iters=200, x_step="kinv")),
    "dubins_condensed": ("dubins", 10, 0.1,
                         dict(max_iters=8, qp_iters=1000, x_step="kinv",
                              formulation="condensed", qp_stages=4)),
    "dubins_condensed_X": ("dubins_X", 10, 0.1,
                           dict(max_iters=6, qp_iters=600, x_step="kinv",
                                formulation="condensed")),
    "demo_sparse": ("demo", 4, 0.05,
                    dict(max_iters=5, qp_iters=100, x_step="kinv")),
    "demo_condensed": ("demo", 4, 0.05,
                       dict(max_iters=5, qp_iters=100, x_step="kinv",
                            formulation="condensed")),
}


def _build(name):
    prob, N, dt, kw = CASES[name]
    if prob.startswith("dubins"):
        (jm, jkw), (tm, tkw), Qz, R, args = _dubins_batch(N, dt, "X" in prob)
    else:
        (jm, jkw), (tm, tkw), Qz, R, args = _demo_batch(N, dt)
    return (JaxJit(jm, N, dt, Qz, R, **jkw, **kw),
            GuSTOJit(tm, N, dt, Qz, R, **tkw, **kw), args)


@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_and_solve_batch_match_jax(name):
    """solve_batch against JAX's (a vmapped while_loop), and solve on the
    first problem against JAX's solve and against the batch's element."""
    jj, tj, args = _build(name)
    ref = jj.solve_batch(*args)
    got = tj.solve_batch(*args)
    _same(ref, got)
    one = [a[0] for a in args]
    ref1 = jj.solve(*one)
    got1 = tj.solve(*one)
    _same(ref1, got1)
    assert int(got1.iters) == int(got.iters[0])
    np.testing.assert_allclose(got1.x.numpy(), got.x[0].numpy(), rtol=0,
                               atol=TOL * float(got.x.abs().max()))


@pytest.mark.parametrize("name", ["dubins_sparse_kinv", "dubins_condensed",
                                  "dubins_condensed_X", "demo_sparse",
                                  "demo_condensed"])
def test_solve_batch_fused_matches_jax(name, monkeypatch):
    """The lockstep loop against JAX's, whose LOCPs go through the Pallas
    kernel in interpret mode; one batched ADMM call an iteration."""
    jj, tj, args = _build(name)
    calls = []
    real = gusto_jit.admm_batched

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(gusto_jit, "admm_batched", spy)
    ref = jj.solve_batch_fused(*args)
    got = tj.solve_batch_fused(*args)
    _same(ref, got)
    assert len(calls) == tj.max_iters
    n_var = (tj.cspec if tj.formulation == "condensed" else tj.spec).n_var
    assert all(c == (B, n_var, n_var) for c in calls)


def test_solve_packed_layout():
    jj, tj, args = _build("dubins_sparse_kinv")
    one = [a[0] for a in args]
    flat = tj.solve_packed(*one).numpy()
    np.testing.assert_allclose(flat, np.asarray(jj.solve_packed(*one)),
                               rtol=0, atol=1e-9)
    r = tj.solve(*one)
    nx = r.x.numel()
    np.testing.assert_array_equal(flat[:nx], r.x.numpy().ravel())
    assert flat[-3] == int(r.iters) and flat[-2] == float(r.converged)


def test_unknown_formulation_raises():
    with pytest.raises(ValueError, match="formulation"):
        GuSTOJit(DubinsCar(device="cpu"), 3, 0.1, np.eye(3), np.eye(2),
                 formulation="stage")
