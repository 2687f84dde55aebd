"""Observers and measurement models, the port against the JAX package on
the same numpy inputs, f64 on the CPU: `ekf_predict`, `ekf_update`,
`DiscreteEKFObserver` over a logged sequence of the chain model,
`FullStateObserver`, `linearModel.evaluate` (with `qv`) and
`MeasurementModel` (the noise formula with the normal draws injected; the
generator-driven path by its seed's reproducibility and its sample
moments). Tolerances are stated in each test."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from helpers import chain_pipeline

from soft_robot_control_tpu.estimators import ekf as jekf
from soft_robot_control_tpu.estimators.full_state import (
    FullStateObserver as JaxFull)
from soft_robot_control_tpu.sim import measurement as jmeas
from soft_robot_control_tpu_torch.estimators import ekf as tekf
from soft_robot_control_tpu_torch.estimators.full_state import (
    FullStateObserver)
from soft_robot_control_tpu_torch.models.convert import (model_arrays,
                                                         model_from_arrays)
from soft_robot_control_tpu_torch.sim import measurement as tmeas

# f64 filter steps: rounding only, over the 40-step sequence below
TOL = 1e-10


def _close(got, ref, tol=TOL, msg=""):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, msg
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(1.0, np.abs(ref).max()),
                               err_msg=msg)


@pytest.fixture(scope="module")
def chain():
    """The JAX chain model (pre-discretized at dt=0.02), the port's model
    from the same arrays, and a logged sequence: inputs, full states and
    measurements y = Cf x of the snapshot run."""
    plant, rom, model, Hf, Cf, X, u = chain_pipeline(
        n_nodes=10, n_cables=4, dt=0.02, threshold=0.5)
    jm = model.pre_discretize(0.02)
    tm = model_from_arrays(model_arrays(jm), device="cpu")
    return jm, tm, u[:40], X[1:41], X[1:41] @ Cf.T


def test_ekf_predict_and_update_match_jax(chain):
    """One step from a perturbed state, single and as a batch of three
    filters (the batched form BatchMPC runs)."""
    jm, tm, u, X, Y = chain
    n = jm.state_dim
    rng = np.random.default_rng(0)
    x = 0.01 * rng.normal(size=(3, n))
    L = rng.normal(size=(n, n))
    S = L @ L.T / n + np.eye(n)
    W, V = 100.0 * np.eye(n), np.eye(Y.shape[1])
    t = lambda a: torch.as_tensor(np.array(a))
    for i in range(3):
        js = jekf.EKFState(jnp.asarray(x[i]), jnp.asarray(S))
        jp = jekf.ekf_predict(jm, js, u[i], 0.02, W)
        tp = tekf.ekf_predict(tm, tekf.EKFState(t(x[i]), t(S)), t(u[i]),
                              0.02, t(W))
        _close(tp.x, jp.x)
        _close(tp.Sigma, jp.Sigma)
        ju = jekf.ekf_update(jm, js, u[i], Y[i], 0.02, W, V)
        tu = tekf.ekf_update(tm, tekf.EKFState(t(x[i]), t(S)), t(u[i]),
                             t(Y[i]), 0.02, t(W), t(V))
        _close(tu.x, ju.x)
        _close(tu.Sigma, ju.Sigma)
    tb = tekf.ekf_update(tm, tekf.EKFState(t(x), t(S).expand(3, n, n)),
                         t(u[:3]), t(Y[:3]), 0.02, t(W), t(V))
    for i in range(3):
        ju = jekf.ekf_update(jm, jekf.EKFState(jnp.asarray(x[i]),
                                               jnp.asarray(S)),
                             u[i], Y[i], 0.02, W, V)
        _close(tb.x[i], ju.x)
        _close(tb.Sigma[i], ju.Sigma)


@pytest.mark.parametrize("defaults", [True, False])
def test_discrete_ekf_observer_over_a_logged_sequence(chain, defaults):
    """The stateful filter over 40 logged (u, y) pairs: its defaults
    (Sigma0 = I, W = 100 I, V = I, start at the ROM reference) or the
    recipe's W and V; x, Sigma and z after every step within 1e-10."""
    jm, tm, u, X, Y = chain
    kw = {}
    if not defaults:
        dx = np.asarray(jm.get_characteristic_dx(0.02))
        kw = dict(W=np.diag(dx + 1e-8), V=0.1 * np.eye(Y.shape[1]),
                  Sigma0=2.0 * np.eye(jm.state_dim))
    jo = jekf.DiscreteEKFObserver(jm, **kw)
    to = tekf.DiscreteEKFObserver(tm, **kw)
    _close(to.x, jo.x)
    for k in range(len(u)):
        jo.update(u[k], Y[k], 0.02)
        to.update(u[k], torch.as_tensor(Y[k]), 0.02)
        _close(to.x, jo.x, msg=f"x at {k}")
        _close(to.Sigma, jo.Sigma, msg=f"Sigma at {k}")
        _close(to.z, jo.z, msg=f"z at {k}")
    jo.initialize(X[5])
    to.initialize(X[5])
    _close(to.x, jo.x)
    params = to.get_observer_params()
    assert params["meas_dim"] == jo.get_meas_dim() == to.get_meas_dim()
    _close(params["W"], jo.get_observer_params()["W"])


def test_full_state_observer(chain):
    jm, tm, u, X, Y = chain
    x = np.asarray(jm.rom.project_x(jnp.asarray(X[3])))
    jo, to = JaxFull(jm.state_dim, jm.H), FullStateObserver(tm.state_dim,
                                                            tm.H)
    jo.update(u[0], Y[0], 0.02, x=jnp.asarray(x))
    to.update(u[0], Y[0], 0.02, x=torch.as_tensor(np.array(x)))
    _close(to.x, jo.x)
    _close(to.z, jo.z)
    bare = FullStateObserver(tm.state_dim)
    bare.update(None, None, None, x=torch.as_tensor(np.array(x)))
    _close(bare.z, x)
    assert to.get_observer_params() == jo.get_observer_params()


@pytest.mark.parametrize("pos,vel,qv", [(True, True, False),
                                        (True, True, True),
                                        (False, True, False),
                                        (True, False, True)])
def test_linear_model_evaluate(pos, vel, qv):
    """Selection on a batch of states, exactly (a gather)."""
    x = np.random.default_rng(1).normal(size=(4, 6 * 7))
    jl = jmeas.linearModel([1, 4, 6], 7, pos=pos, vel=vel)
    tl = tmeas.linearModel([1, 4, 6], 7, pos=pos, vel=vel)
    np.testing.assert_array_equal(tl.C, jl.C)
    np.testing.assert_array_equal(tl.evaluate(torch.as_tensor(x), qv=qv),
                                  jl.evaluate(x, qv=qv))
    np.testing.assert_array_equal(tl.evaluate(x[0]), jl.evaluate(x[0]))


def _noisy(qv):
    rng = np.random.default_rng(2)
    Lq, Lv = rng.normal(size=(6, 6)), rng.normal(size=(6, 6))
    kw = dict(mu_q=rng.normal(size=6), S_q=Lq @ Lq.T + np.eye(6),
              mu_v=rng.normal(size=6), S_v=Lv @ Lv.T + np.eye(6), qv=qv)
    return (jmeas.MeasurementModel([0, 3], 5, **kw),
            tmeas.MeasurementModel([0, 3], 5, **kw))


@pytest.mark.parametrize("qv", [False, True])
def test_measurement_noise_formula_with_injected_draws(monkeypatch, qv):
    """mean + chol(cov) w with the same standard normal draws w handed to
    both packages: 1e-12."""
    jmm, tmm = _noisy(qv)
    x = np.random.default_rng(3).normal(size=30)
    w = np.random.default_rng(4).normal(size=12)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(w))
    monkeypatch.setattr(tmeas, "_normal", lambda n, gen, dtype:
                        torch.as_tensor(w, dtype=dtype))
    ref = jmm.evaluate(x, key=jax.random.PRNGKey(0))
    got = tmm.evaluate(torch.as_tensor(x), generator=torch.Generator())
    _close(got, ref, 1e-12)
    # without a generator (a key) there is no noise
    _close(tmm.evaluate(torch.as_tensor(x)), jmm.evaluate(x), 0.0)
    # a zero covariance adds the mean only
    zm = tmeas.MeasurementModel([0, 3], 5, mu_q=np.ones(6))
    _close(zm.evaluate(torch.as_tensor(x), generator=torch.Generator()),
           jmeas.MeasurementModel([0, 3], 5, mu_q=np.ones(6)).evaluate(
               x, key=jax.random.PRNGKey(1)), 1e-12)


def test_measurement_noise_from_a_generator():
    """The same seed draws the same noise; 4000 draws have the model's
    mean and covariance (within 5 standard errors)."""
    _, tmm = _noisy(False)
    x = torch.zeros(30, dtype=torch.float64)
    g = lambda: torch.Generator().manual_seed(11)
    a = tmm.evaluate(x, generator=g())
    np.testing.assert_array_equal(a, tmm.evaluate(x, generator=g()))
    assert not torch.equal(a, tmm.evaluate(x, generator=torch.Generator()
                                           .manual_seed(12)))
    gen = g()
    Z = torch.stack([tmm.evaluate(x, generator=gen) for _ in range(4000)])
    Z = Z.numpy()
    sd = np.sqrt(np.diag(tmm.covariance))
    assert (np.abs(Z.mean(0) - tmm.mean) < 5 * sd / np.sqrt(4000)).all()
    C = np.cov(Z.T)
    scale = np.sqrt(np.outer(np.diag(tmm.covariance),
                             np.diag(tmm.covariance)))
    assert (np.abs(C - tmm.covariance) < 5 * scale * np.sqrt(2 / 4000)).all()
