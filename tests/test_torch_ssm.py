"""The SSM models of the port against the JAX package, f64 on the CPU: the
monomial tables and their Jacobian, `from_mat` on the committed trunk and
Diamond artifacts, the model's maps and linearizations, the manifold
observer, the GuSTO adapter, and the host GuSTO loop with the nonlinear
observer. Both packages' models are built from the same f64 arrays (the
Diamond artifact stores float32). Tolerances are stated in each test."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_helpers import SSM_ARTIFACTS

from soft_robot_control_tpu.core.constraints import HyperRectangle as JaxBox
from soft_robot_control_tpu.estimators.ssm_observer import (
    SSMObserver as JaxObserver)
from soft_robot_control_tpu.models import ssm as jssm
from soft_robot_control_tpu.models.interfaces import SSMGuSTO as JaxAdapter
from soft_robot_control_tpu.ops import monomials as jmono
from soft_robot_control_tpu.scp.gusto import GuSTO as JaxGuSTO
from soft_robot_control_tpu_torch.core.constraints import HyperRectangle
from soft_robot_control_tpu_torch.estimators.ssm_observer import SSMObserver
from soft_robot_control_tpu_torch.models import ssm as tssm
from soft_robot_control_tpu_torch.models.convert import (
    ssm_model_arrays, ssm_model_from_arrays)
from soft_robot_control_tpu_torch.models.interfaces import SSMGuSTO
from soft_robot_control_tpu_torch.ops import monomials as tmono
from soft_robot_control_tpu_torch.scp.gusto import GuSTO

RTOL = 1e-9


def ssm_models(name):
    """The JAX and port models of an artifact, from the same f64 arrays
    (loaded as the benchmark loads them: equilibrium from the file,
    continuous, backward Euler)."""
    jm = jssm.from_mat(SSM_ARTIFACTS[name], None, discrete=False,
                       discr_method="be")
    arrays = {k: (v.astype(np.float64) if isinstance(v, np.ndarray) else v)
              for k, v in ssm_model_arrays(jm).items()}
    return jssm.SSMModel(**arrays), ssm_model_from_arrays(arrays,
                                                          device="cpu")


def _close(got, ref, rtol=RTOL):
    ref = np.asarray(ref)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


@pytest.mark.parametrize("dim,order,const", [(6, 3, False), (6, 3, True),
                                             (2, 5, False), (4, 1, False),
                                             (3, 4, True)])
def test_monomial_exponents_match(dim, order, const):
    np.testing.assert_array_equal(
        tmono.monomial_exponents(dim, order, const),
        jmono.monomial_exponents(dim, order, const))


@pytest.mark.parametrize("dim,order", [(6, 3), (3, 4), (2, 5)])
def test_monomials_and_their_jacobian(dim, order):
    """phi and d phi / d x against jnp and jax.jacfwd, to 1e-12 relative,
    at random points (a batch of 2 x 5) and at the origin, where the
    Jacobian must be finite (the rows of the linear monomials are the
    identity)."""
    exps = jmono.monomial_exponents(dim, order)
    rng = np.random.default_rng(dim + order)
    x = 0.7 * rng.normal(size=(2, 5, dim))
    x[0, 1, 0] = x[1, 2, :2] = 0.0  # zeros among nonzero coordinates
    for pts in (x, np.zeros((1, dim))):
        flat = jnp.asarray(pts.reshape(-1, dim))
        phi = jax.vmap(lambda v: jmono.eval_monomials(v, exps))(flat)
        jac = jax.vmap(jax.jacfwd(lambda v: jmono.eval_monomials(v, exps)))(
            flat)
        xt = torch.as_tensor(pts)
        _close(tmono.eval_monomials(xt, exps).reshape(phi.shape), phi, 1e-12)
        got = tmono.monomial_jacobian(xt, exps)
        assert bool(torch.isfinite(got).all())
        _close(got.reshape(jac.shape), jac, 1e-12)
    np.testing.assert_array_equal(got[0, :dim].numpy(), np.eye(dim))
    coeff = rng.normal(size=(3, len(exps)))
    _close(tmono.make_poly_map(coeff, exps)(torch.as_tensor(x)),
           jax.vmap(jax.vmap(jmono.make_poly_map(coeff, exps)))(
               jnp.asarray(x)), 1e-12)


@pytest.mark.parametrize("name", ["trunk", "diamond"])
def test_from_mat_gives_the_same_model(name):
    """from_mat in both packages: the same arrays (the port's in f64 on the
    named device) and the same dimensions, orders and flags."""
    jm = jssm.from_mat(SSM_ARTIFACTS[name], None, discrete=False,
                       discr_method="be")
    tm = tssm.from_mat(SSM_ARTIFACTS[name], None, discrete=False,
                       discr_method="be", device="cpu")
    for k in tssm.SSMModel._children:
        got = getattr(tm, k)
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jm, k), np.float64))
    static = ("state_dim", "input_dim", "output_dim", "SSM_order",
              "ROM_order", "Ts", "discrete", "discr_method")
    assert [getattr(tm, k) for k in static] == [getattr(jm, k)
                                               for k in static]
    assert (tm.state_dim, tm.output_dim, tm.SSM_order, tm.Ts) == (6, 6, 3,
                                                                  0.01)
    assert tm.input_dim == {"trunk": 8, "diamond": 4}[name]
    assert tm.nonlinear_observer and tm.H.shape == (6, 6)
    assert not bool(tm.H.any())
    assert tm.get_sim_params() == jm.get_sim_params()
    assert tssm.SSMDynamics is tssm.SSMModel
    f32 = tm.to(dtype=torch.float32)
    assert f32.dtype == torch.float32 and f32._rom_exps.dtype == torch.float32


@pytest.mark.parametrize("name", ["trunk", "diamond"])
def test_model_maps_and_linearizations(name):
    """Every map of the model on a batch of states (and at rest) against
    the JAX model's vmapped one, f64 to 1e-9 relative: the dynamics and
    their continuous, discrete (native) and discretized Jacobians at
    dt=0.02, the observer Jacobians, the chart and the parametrization and
    their round trip W_map(C_map(x)), the shifted-output helpers, a step
    and a rollout."""
    jm, tm = ssm_models(name)
    rng = np.random.default_rng(3)
    x = np.concatenate([np.zeros((1, 6)), 0.5 * rng.normal(size=(4, 6))])
    u = rng.uniform(0.0, 1.0, size=(5, jm.input_dim))
    X, U = jnp.asarray(x), jnp.asarray(u)
    xt, ut = torch.as_tensor(x), torch.as_tensor(u)
    vm = lambda f, *a: jax.vmap(f)(*a)
    pairs = [
        (tm.reduced_dynamics(xt, ut), vm(jm.reduced_dynamics, X, U)),
        (tm.reduced_dynamics_discrete(xt, ut),
         vm(jm.reduced_dynamics_discrete, X, U)),
        (tm.C_map(xt), vm(jm.C_map, X)),
        (tm.W_map(xt), vm(jm.W_map, X)),
        (tm.W_map(tm.C_map(xt)), vm(lambda v: jm.W_map(jm.C_map(v)), X)),
        (tm.x_to_zfyf(xt), jm.x_to_zfyf(X)),
        (tm.x_to_zy(xt), jm.x_to_zy(X)),
        (tm.zfyf_to_zy(xt), jm.zfyf_to_zy(X)),
        (tm.zy_to_zfyf(xt), jm.zy_to_zfyf(X)),
        (tm.compute_RO_state(tm.x_to_zfyf(xt)),
         vm(lambda v: jm.compute_RO_state(jm.x_to_zfyf(v)), X)),
        (tm.update_state(xt, ut, 0.02),
         vm(lambda a, b: jm.update_state(a, b, 0.02), X, U)),
        (tm.update_observer_state(xt), vm(jm.update_observer_state, X)),
    ]
    for fn in ("get_continuous_jacobians", "get_discrete_jacobians"):
        pairs += zip(getattr(tm, fn)(xt, ut), vm(getattr(jm, fn), X, U))
    pairs += zip(tm.get_jacobians(xt, ut, 0.02),
                 vm(lambda a, b: jm.get_jacobians(a, b, 0.02), X, U))
    pairs += zip(tm.get_jacobians(xt, ut), vm(jm.get_jacobians, X, U))
    pairs += zip(tm.get_observer_jacobians(xt),
                 vm(jm.get_observer_jacobians, X))
    for got, ref in pairs:
        _close(got, ref)
    # the chart's Jacobian at rest is its linear part
    np.testing.assert_array_equal(
        tm.get_observer_jacobians(torch.zeros(6, dtype=torch.float64))[0],
        tm.w_coeff[:, :6])
    for got, ref in zip(tm.rollout(xt[1], ut, 0.02),
                        jm.rollout(X[1], U, 0.02)):
        _close(got, ref)
    # a batch of rollouts is each rollout
    xb, zb = tm.rollout(xt[:2], torch.stack([ut, ut.flip(0)]), 0.02)
    for b, uu in enumerate((U, U[::-1])):
        _close(xb[b], jm.rollout(X[b], uu, 0.02)[0])


@pytest.mark.parametrize("name", ["trunk", "diamond"])
def test_ssm_observer_update(name):
    """The manifold observer on raw [v; q] measurements near rest."""
    jm, tm = ssm_models(name)
    rng = np.random.default_rng(4)
    y = np.asarray(jm.z_ref)[None] + 0.5 * rng.normal(size=(3, 6))
    jo, to = JaxObserver(jm), SSMObserver(tm)
    jo.initialize()
    to.initialize()
    for yk in y:
        jo.update(None, jnp.asarray(yk), 0.02)
        to.update(None, yk, 0.02)
        _close(to.z, jo.z)
        _close(to.x, jo.x)
    to.update(None, y, 0.02)  # a batch of measurements at once
    _close(to.x[-1], jo.x)


@pytest.mark.parametrize("name", ["trunk", "diamond"])
def test_gusto_adapter(name):
    jm, tm = ssm_models(name)
    ja, ta = JaxAdapter(jm), SSMGuSTO(tm)
    assert ta.nonlinear_observer and (ta.n_x, ta.n_u, ta.n_z) == (
        ja.n_x, ja.n_u, ja.n_z)
    assert ta.device.type == "cpu" and ta.dtype == torch.float64
    rng = np.random.default_rng(5)
    x, u = 0.3 * rng.normal(size=(4, 6)), rng.uniform(size=(4, ja.n_u))
    X, U = jnp.asarray(x), jnp.asarray(u)
    xt, ut = torch.as_tensor(x), torch.as_tensor(u)
    for got, ref in zip(ta.get_continuous_dynamics(xt, ut),
                        jax.vmap(ja.get_continuous_dynamics)(X, U)):
        _close(got, ref)
    for got, ref in zip(ta.get_discrete_dynamics(xt, ut, 0.02), jax.vmap(
            lambda a, b: ja.get_discrete_dynamics(a, b, 0.02))(X, U)):
        _close(got, ref)
    for got, ref in zip(ta.get_observer_jacobians(xt),
                        jax.vmap(ja.get_observer_jacobians)(X)):
        _close(got, ref)
    for got, ref in zip(ta.get_characteristic_vals(),
                        ja.get_characteristic_vals()):
        np.testing.assert_array_equal(got, ref)


def _gusto_problem():
    """The Diamond SSM with a reach target 3 mm along the tip's x (shifted
    coordinates), N=4, dt=0.02, a loose box on z (never active: it
    exercises the check on C_map(x))."""
    jm, tm = ssm_models("diamond")
    N, dt, nz = 4, 0.02, 6
    Qz = np.zeros((nz, nz))
    Qz[0, 0] = Qz[1, 1] = 100.0
    R = 1e-3 * np.eye(4)
    z = np.zeros((N + 1, nz))
    z[:, 0] = 3.0
    x0, u0 = np.zeros(6), np.zeros((N, 4))
    x_init = np.asarray(jm.rollout(jnp.asarray(x0), jnp.asarray(u0), dt)[0])
    box = (1e3 * np.ones(nz), -1e3 * np.ones(nz))
    return jm, tm, N, dt, Qz, R, z, x0, u0, x_init, box


@pytest.mark.parametrize("backend,later_iters", [("dense", 5),
                                                 ("condensed", 5),
                                                 ("condensed", 0)])
def test_host_gusto_with_the_nonlinear_observer(backend, later_iters):
    """GuSTO(SSMGuSTO(model)) on the Diamond SSM: the construction solve,
    then a warm-started solve from a moved state (with later_iters=0 and
    the condensed backend, the one-shot real-time path). Identical
    iteration counts, x, u and z (= C_map(x)) to 1e-6 relative; dense
    solves with polish=False."""
    jm, tm, N, dt, Qz, R, z, x0, u0, xi, box = _gusto_problem()
    kw = dict(z=z, max_gusto_iters=later_iters, locp_backend=backend,
              polish=False)
    jg = JaxGuSTO(JaxAdapter(jm), N, dt, Qz, R, x0, u0, xi, X=JaxBox(*box),
                  **kw)
    tg = GuSTO(SSMGuSTO(tm), N, dt, Qz, R, x0, u0, xi,
               X=HyperRectangle(*box), **kw)
    x1 = x0 + 0.01
    xw = np.asarray(jm.rollout(jnp.asarray(x1), jnp.asarray(jg.uopt),
                               dt)[0])
    for solve in (False, True):
        if solve:
            jg.solve(x1, jg.uopt, xw, z=z)
            tg.solve(x1, tg.uopt, xw, z=z)
        assert tg.itr_count == jg.itr_count
        for k in ("xopt", "uopt", "zopt"):
            _close(getattr(tg, k), getattr(jg, k), 1e-6)
    _close(tg.zopt, jax.vmap(jm.C_map)(jnp.asarray(jg.xopt)), 1e-6)
    assert np.abs(tg.zopt[-1, 0] - 3.0) < np.abs(tg.zopt[0, 0] - 3.0)


def test_gusto_state_constraints_on_the_chart():
    """state_constraints_violated takes z_traj = C_map(x) as JAX's does,
    and device_tr refuses a nonlinear observer in both packages."""
    jm, tm, N, dt, Qz, R, z, x0, u0, xi, box = _gusto_problem()
    tight = (0.5 * np.ones(6), -0.5 * np.ones(6))
    jg = JaxGuSTO(JaxAdapter(jm), N, dt, Qz, R, x0, u0, xi, z=z,
                  X=JaxBox(*tight), max_gusto_iters=1, polish=False)
    tg = GuSTO(SSMGuSTO(tm), N, dt, Qz, R, x0, u0, xi, z=z,
               X=HyperRectangle(*tight), max_gusto_iters=1, polish=False)
    zt = np.asarray(jax.vmap(jm.C_map)(jnp.asarray(jg.xopt)))
    got = tg.state_constraints_violated(jg.xopt, z_traj=zt)
    ref = jg.state_constraints_violated(jg.xopt, z_traj=zt)
    assert got[1] == ref[1]
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-12)
    for G, ad, mdl in ((JaxGuSTO, JaxAdapter, jm), (GuSTO, SSMGuSTO, tm)):
        with pytest.raises(NotImplementedError, match="linear observers"):
            G(ad(mdl), N, dt, Qz, R, x0, u0, xi, z=z,
              locp_backend="condensed", device_tr=True)
