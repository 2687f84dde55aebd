"""Native SSM identification of the port (models/ssm_learn.py,
tasks/sysid_export.py:train_ssm_native) against the JAX package, in f64 on
the CPU, from the same numpy inputs.

The data are tests/test_ssm_learn.py's: damped Duffing-style reduced
dynamics observed through an invertible polynomial map, 16 decays of 600
steps and 4 actuated runs, integrated here with RK4 in numpy. Both
packages fit on the host in numpy f64 with the same regressions, so the
ridge weight the holdout selects must be the same, and the models'
coefficients, maps and rollouts agree to the tolerances stated beside each
assertion.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from soft_robot_control_tpu.models import ssm as jssm
from soft_robot_control_tpu.models import ssm_learn as jlearn
from soft_robot_control_tpu_torch.models import ssm as tssm
from soft_robot_control_tpu_torch.models import ssm_learn as tlearn
from soft_robot_control_tpu_torch.utils.device import to_numpy

import torch_helpers  # noqa: F401  (single-threaded torch)

A_TRUE = np.array([[0.0, 1.0], [-4.0, -0.4]])
B_TRUE = np.array([[0.0], [1.0]])
COEFFS = ("w_coeff", "v_coeff", "r_coeff", "B_r", "rd_coeff", "Bd_r",
          "z_ref")


def _f(x, u):
    return A_TRUE @ x + np.array([0.0, -0.5 * x[0] ** 3]) + B_TRUE @ u


def _obs(x):
    return np.array([x[0] + 0.1 * x[0] ** 2, x[1] + 0.05 * x[0] * x[1]])


def _rk4_obs(x0, dt, T, u=None):
    """Observed trajectory (T+1, 2) of the true system from x0 under the
    inputs u (T, 1) (zero if None)."""
    u = np.zeros((T, 1)) if u is None else u
    x = np.asarray(x0, float)
    out = [_obs(x)]
    for k in range(T):
        f = lambda xx: _f(xx, u[k])
        k1 = f(x)
        k2 = f(x + 0.5 * dt * k1)
        k3 = f(x + 0.5 * dt * k2)
        k4 = f(x + dt * k3)
        x = x + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        out.append(_obs(x))
    return np.asarray(out)


@pytest.fixture(scope="module")
def duffing():
    """tests/test_ssm_learn.py's data: 16 decays from seeded states, 4
    actuated runs of a seeded sine each (the input sampled a step)."""
    dt = 0.01
    rng = np.random.default_rng(0)
    decays = [_rk4_obs(rng.uniform(-0.8, 0.8, 2), dt, 600)
              for _ in range(16)]
    act, us = [], []
    for s in range(4):
        r = np.random.default_rng(100 + s)
        a, ph = r.uniform(0.2, 0.6), r.uniform(0, 2 * np.pi)
        u = a * np.sin(0.05 * np.arange(401) + ph)[:, None]
        act.append(_rk4_obs(np.zeros(2), dt, 400, u))
        us.append(u)
    return dt, decays, act, us


def _lams(module, monkeypatch):
    """The ridge weight of every regression the module's learn_ssm makes,
    in order (its _ridge_fit wrapped)."""
    seen = []
    real = module._ridge_fit

    def rec(Phi, Y, lam):
        seen.append(lam)
        return real(Phi, Y, lam)

    monkeypatch.setattr(module, "_ridge_fit", rec)
    return seen


def _coeffs(model):
    return {k: np.asarray(to_numpy(getattr(model, k))) for k in COEFFS}


def _close(got, ref, tol, msg=""):
    """max |got - ref| <= tol * max(1, max |ref|)."""
    got, ref = np.asarray(got, float), np.asarray(ref, float)
    assert got.shape == ref.shape, msg
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got - ref).max()) <= tol * scale, (
        msg, float(np.abs(got - ref).max()), scale)


def test_delay_embed_and_differentiate_are_the_jax_packages():
    """Both exact: the same numpy arithmetic; tensors are taken too."""
    rng = np.random.default_rng(1)
    y = rng.normal(size=(30, 3))
    for d in (0, 1, 3):
        assert np.array_equal(tlearn.delay_embed(y, d),
                              jlearn.delay_embed(y, d))
    assert np.array_equal(tlearn.delay_embed(torch.as_tensor(y), 2),
                          jlearn.delay_embed(y, 2))
    for T in (4, 5, 200):
        x = rng.normal(size=(T, 2))
        assert np.array_equal(tlearn.differentiate(x, 0.01),
                              jlearn.differentiate(x, 0.01))
    x = rng.normal(size=(50, 2))
    assert np.array_equal(tlearn.differentiate(torch.as_tensor(x), 0.02),
                          jlearn.differentiate(x, 0.02))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(ridge=[1e-8, 1e-6, 1e-4, 1e-2]),
    dict(ridge=[1e-8, 1e-6, 1e-4, 1e-2], joint_fit=True),
], ids=["one_ridge", "holdout", "holdout_joint"])
def test_learn_ssm_is_the_jax_packages(duffing, monkeypatch, kw):
    """tests/test_ssm_learn.py's fit (state_dim 2, SSM order 3, ROM order
    5, z_ref at the origin, the actuated runs for B), with one ridge
    weight, with the holdout selection over four, and with the joint [R |
    B] fit: every regression at the same weight (so the same one
    selected), the coefficients within 1e-9 of their scale (the same
    numpy and scipy calls; 1e-9 leaves room for another BLAS order), the
    chart, the parametrization and the reduced dynamics at 50 points and a
    300-step rollout within 1e-8 of their scale."""
    dt, decays, act, us = duffing
    args = dict(state_dim=2, SSM_order=3, ROM_order=5, z_ref=np.zeros(2),
                actuated_trajs=act, input_trajs=us, **kw)
    lam_t, lam_j = _lams(tlearn, monkeypatch), _lams(jlearn, monkeypatch)
    tm = tlearn.learn_ssm(decays, dt, device="cpu", **args)
    jm = jlearn.learn_ssm(decays, dt, **args)
    assert lam_t == lam_j and len(lam_t) >= 4
    if "ridge" in kw:
        # the selected weight refits on all decays: the last four fits
        assert len(set(lam_t[-4:])) == 1 and lam_t[-1] in kw["ridge"]
    assert isinstance(tm, tssm.SSMModel) and tm.device.type == "cpu"
    assert tm.dtype == torch.float64
    for k in ("state_dim", "input_dim", "output_dim", "SSM_order",
              "ROM_order", "Ts", "discr_method"):
        assert getattr(tm, k) == getattr(jm, k), k
    tc, jc = _coeffs(tm), _coeffs(jm)
    for k in COEFFS:
        _close(tc[k], jc[k], 1e-9, k)
    rng = np.random.default_rng(5)
    x = rng.uniform(-0.4, 0.4, size=(50, 2))
    u = rng.uniform(-0.5, 0.5, size=(50, 1))
    tx, tu = torch.as_tensor(x), torch.as_tensor(u)
    for name, got, ref in (
            ("C_map", tm.C_map(tx), [jm.C_map(jnp.asarray(v)) for v in x]),
            ("W_map", tm.W_map(tx), [jm.W_map(jnp.asarray(v)) for v in x]),
            ("f", tm.reduced_dynamics(tx, tu),
             [jm.reduced_dynamics(jnp.asarray(a), jnp.asarray(b))
              for a, b in zip(x, u)])):
        _close(to_numpy(got), np.asarray(ref), 1e-8, name)
    y0 = _rk4_obs(np.array([0.5, -0.3]), dt, 1)[0]
    uu = 0.3 * np.sin(0.07 * np.arange(300))[:, None]
    xt, zt = tm.rollout(tm.compute_RO_state(torch.as_tensor(y0)),
                        torch.as_tensor(uu), dt)
    xj, zj = jm.rollout(jm.compute_RO_state(jnp.asarray(y0)),
                        jnp.asarray(uu), dt)
    _close(to_numpy(zt), np.asarray(zj), 1e-8, "rollout")


def test_learn_ssm_refuses_what_the_jax_package_refuses():
    """An embedded observable of another size than the state: a
    ValueError in both packages."""
    y = [np.random.default_rng(2).normal(size=(40, 3))]
    for mod, kw in ((tlearn, dict(device="cpu")), (jlearn, {})):
        with pytest.raises(ValueError, match="state_dim"):
            mod.learn_ssm(y, 0.01, state_dim=2, z_ref=np.zeros(3), **kw)


def test_mat_round_trips_both_ways(duffing, tmp_path):
    """The port's save_mat read by the JAX from_mat, and the JAX save_mat
    read by the port's from_mat: every coefficient and the dimensions
    exact, with the equilibrium the file carries."""
    dt, decays, act, us = duffing
    args = dict(state_dim=2, SSM_order=3, ROM_order=3, z_ref=np.zeros(2),
                actuated_trajs=act, input_trajs=us)
    tm = tlearn.learn_ssm(decays[:4], dt, device="cpu", **args)
    jm = jlearn.learn_ssm(decays[:4], dt, **args)
    pt, pj = str(tmp_path / "port.mat"), str(tmp_path / "jax.mat")
    tlearn.save_mat(tm, pt)
    jlearn.save_mat(jm, pj)
    for got, ref in ((jssm.from_mat(pt, None), tm),
                     (tssm.from_mat(pj, None, device="cpu"), jm)):
        gc, rc = _coeffs(got), _coeffs(ref)
        for k in COEFFS:
            assert np.array_equal(gc[k], rc[k]), k
        for k in ("state_dim", "input_dim", "output_dim", "SSM_order",
                  "ROM_order", "Ts"):
            assert getattr(got, k) == getattr(ref, k), k
    d = tlearn.to_mat_dict(tm)["py_data"]
    assert sorted(d) == sorted(jlearn.to_mat_dict(jm)["py_data"])
    assert all(isinstance(v, (np.ndarray, float)) for v in
               d["model"].values())


def test_train_ssm_native_on_the_chain_is_the_jax_packages(monkeypatch):
    """tests/test_ssm_learn.py:209-258's identification on the chain (10
    nodes, 4 cables, three node positions with one delay tap, ROM order 5,
    settle_skip 30, five ridge candidates), its hold and decay cut to 1 s
    and 2 s, 8 levels in one batch: the same ridge weights in order, the
    decays within 1e-12 of their scale (the same implicit steps), the
    coefficients within 1e-6 of their scale (the fit's ill-conditioned
    directions amplify the decays' last bits) and a 200-step held-out
    rollout within 1e-6 of its scale."""
    from soft_robot_control_tpu.sim.fem_surrogate import (
        make_chain_robot as jchain)
    from soft_robot_control_tpu.tasks import sysid_export as jsys
    from soft_robot_control_tpu_torch.sim.fem_surrogate import (
        make_chain_robot as tchain)
    from soft_robot_control_tpu_torch.tasks import sysid_export as tsys

    jp = jchain(n_nodes=10, n_cables=4, seed=0)
    tp = tchain(n_nodes=10, n_cables=4, seed=0, device="cpu")
    n = jp.n_nodes_dof
    Hf = np.zeros((3, 2 * n))
    for i, nd in enumerate((3, 6, 9)):
        Hf[i, n + nd] = 1.0
    rng = np.random.default_rng(0)
    levels = [rng.uniform(0.0, 2.5, 4) for _ in range(8)]
    kw = dict(state_dim=6, SSM_order=3, ROM_order=5, n_delay=1,
              hold_time=1.0, decay_time=2.0, dt=0.01, settle_skip=30,
              ridge=(1e-8, 1e-6, 1e-4, 1e-2, 1e-1))
    dec_t = tsys.collect_decay_trajectories(tp, Hf, levels[:2], 1.0, 2.0)
    dec_j = jsys.collect_decay_trajectories(jp, Hf, levels[:2], 1.0, 2.0)
    for (tt, zt), (tj, zj) in zip(dec_t, dec_j):
        assert np.array_equal(tt, tj)
        _close(zt, zj, 1e-12, "decay")
    lam_t, lam_j = _lams(tlearn, monkeypatch), _lams(jlearn, monkeypatch)
    tm = tsys.train_ssm_native(tp, Hf, levels, **kw)
    jm = jsys.train_ssm_native(jp, Hf, levels, **kw)
    assert lam_t == lam_j
    assert tm.device.type == "cpu"
    tc, jc = _coeffs(tm), _coeffs(jm)
    for k in COEFFS:
        _close(tc[k], jc[k], 1e-6, k)
    z0 = tlearn.delay_embed(dec_t[1][1], 1)[30]
    u = np.zeros((200, tm.input_dim))
    _, zt = tm.rollout(tm.compute_RO_state(torch.as_tensor(z0)),
                       torch.as_tensor(u), 0.01)
    _, zj = jm.rollout(jm.compute_RO_state(jnp.asarray(z0)),
                       jnp.asarray(u), 0.01)
    _close(to_numpy(zt), np.asarray(zj), 1e-6, "rollout")
