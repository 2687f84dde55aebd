"""The TPWL model carried across to the port: artifact loading with the
campaign's output maps, conversion of a JAX-built model, pre-discretization
and the batched rollout, against the JAX package."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_helpers import (CAMPAIGN, CAMPAIGN_PARAMS, campaign_dict,
                           campaign_output_maps)
from helpers import chain_pipeline

from soft_robot_control_tpu.models import tpwl as jtpwl
from soft_robot_control_tpu_torch.models import tpwl as ttpwl
from soft_robot_control_tpu_torch.models.convert import (model_arrays,
                                                         model_from_arrays)


def test_from_tpwl_dict_campaign_output_maps():
    """The artifact as committed (float32), Cf/Hf as bench.py builds them:
    C, H, y_ref and z_ref come out in float64 in both packages."""
    Cf, Hf = campaign_output_maps()
    kw = dict(params=CAMPAIGN_PARAMS, Cf=Cf, Hf=Hf, discr_method="be")
    jm = jtpwl.from_tpwl_dict(CAMPAIGN, **kw)
    tm = ttpwl.from_tpwl_dict(CAMPAIGN, device="cpu", **kw)
    for k in ("C", "H", "y_ref", "z_ref"):
        ref = np.asarray(getattr(jm, k))
        got = getattr(tm, k)
        assert got.dtype == torch.float64 and got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-10)
    assert (tm.num_points, tm.state_dim, tm.input_dim) == (1087, 60, 4)
    assert tm.pre_discretized_dt == jm.pre_discretized_dt == 0.01
    assert (tm.dist_w_q, tm.dist_w_v) == (10.0, 1.0)


def test_convert_chain_model_and_pre_discretize():
    _, rom, jm, _, _, X, _ = chain_pipeline()
    tm = model_from_arrays(model_arrays(jm), device="cpu")
    np.testing.assert_allclose(tm.rom.project_x(torch.tensor(X[:5])),
                               np.asarray(rom.project_x(jnp.asarray(X[:5]))),
                               atol=1e-12)
    for k in ("q", "v", "u", "A_c", "B_c", "d_c", "C", "y_ref", "H",
              "z_ref"):
        np.testing.assert_array_equal(getattr(tm, k).numpy(),
                                      np.asarray(getattr(jm, k)))
    assert tm.A_d is None and jm.A_d is None  # a continuous dictionary
    assert tm.discr_method == jm.discr_method == "be"
    jd, td = jm.pre_discretize(0.02), tm.pre_discretize(0.02)
    for k in ("A_d", "B_d", "d_d"):
        np.testing.assert_allclose(getattr(td, k).numpy(),
                                   np.asarray(getattr(jd, k)), atol=1e-9)
    assert td.pre_discretize(0.02) is td
    x = np.asarray(jm.q)[3:4].repeat(2, axis=1)
    assert int(tm.calc_nearest_point(torch.as_tensor(x[0]))) == int(
        jm.calc_nearest_point(jnp.asarray(x[0])))


def _campaign_models(params=CAMPAIGN_PARAMS):
    """The campaign in both packages, with backward-Euler discretization
    (forward Euler of the stiff continuous points diverges at 0.02)."""
    Cf, Hf = campaign_output_maps()
    kw = dict(params=params, Cf=Cf, Hf=Hf, discr_method="be")
    data = campaign_dict()
    return (jtpwl.from_tpwl_dict(data, **kw),
            ttpwl.from_tpwl_dict(data, device="cpu", **kw))


def _cable_inputs(B, T, dt, seed=11):
    rng = np.random.default_rng(seed)
    t = dt * np.arange(T)
    return 750.0 * (1.0 + np.sin(2 * np.pi * t[None, :, None] / 0.1
                                 + rng.uniform(0, 2 * np.pi, (B, 1, 4))))


def _assert_same_trajectory(got, ref):
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-9,
                               atol=1e-9 * np.abs(ref).max())


def test_rollout_batch_campaign():
    """The default select on the campaign, at the cached dt and at a dt
    without the cache (rolled out through get_jacobians, as in JAX)."""
    jm, tm = _campaign_models()
    B, T = 4, 10
    for dt in (0.01, 0.02):
        u = _cable_inputs(B, T, dt)
        ref = np.asarray(jtpwl.rollout_batch(jm, jnp.zeros((B, 60)),
                                             jnp.asarray(u), dt))
        got = ttpwl.rollout_batch(
            tm, torch.zeros((B, 60), dtype=torch.float64),
            torch.as_tensor(u), dt)
        _assert_same_trajectory(got, ref)


def _jax_indices(jm, select, X):
    if select == "matmul":
        return np.asarray(jnp.argmin(jtpwl._batch_distances(jm, X), axis=1))
    return np.asarray(jax.vmap(jm.calc_nearest_point)(X))


def _port_indices(tm, select, X):
    if select == "matmul":
        return torch.argmin(ttpwl._batch_distances(tm, X), dim=1).numpy()
    return tm.select(X)[0].numpy()


@pytest.mark.parametrize("select", ["auto", "exact", "matmul", "pallas",
                                    "weighting"])
def test_rollout_batch_select_modes(select):
    """Every select mode of the JAX call on the campaign dictionary, in
    f64: the trajectories to 1e-9 relative and, for the nearest-point
    modes, the indices selected along them. 'auto' at B=32 takes 'matmul';
    'pallas' (the Pallas kernel in interpret mode) against the select
    kernel's plain version; 'weighting' with beta=3."""
    params = dict(CAMPAIGN_PARAMS, beta_weighting=3.0)
    jm, tm = _campaign_models(params)
    B, T, dt = 32, 8, 0.01
    u = _cable_inputs(B, T, dt, seed=5)
    kw = {"interpret": True} if select == "pallas" else {}
    ref = np.asarray(jtpwl.rollout_batch(jm, jnp.zeros((B, 60)),
                                         jnp.asarray(u), dt, select=select,
                                         **kw))
    got = ttpwl.rollout_batch(tm, torch.zeros((B, 60), dtype=torch.float64),
                              torch.as_tensor(u), dt, select=select,
                              interpret=True)
    _assert_same_trajectory(got, ref)
    if select != "weighting":
        mode = "matmul" if select == "auto" else select
        for k in range(T):
            np.testing.assert_array_equal(
                _port_indices(tm, mode, got[:, k]),
                _jax_indices(jm, mode, jnp.asarray(ref[:, k])))


def test_rollout_batch_refuses_as_jax_does():
    """'matmul' and 'pallas' need the cache at this dt; 'weighting' needs
    beta: the port raises where the JAX package does."""
    jm, tm = _campaign_models()
    x0, u = np.zeros((2, 60)), _cable_inputs(2, 3, 0.02)
    for select, msg in (("matmul", "pre-discretized"),
                        ("pallas", "pre-discretized"),
                        ("weighting", "beta")):
        with pytest.raises(ValueError, match=msg):
            jtpwl.rollout_batch(jm, jnp.asarray(x0), jnp.asarray(u), 0.02,
                                select=select)
        with pytest.raises(ValueError, match=msg):
            ttpwl.rollout_batch(tm, torch.as_tensor(x0), torch.as_tensor(u),
                                0.02, select=select)


@pytest.mark.parametrize("dt", [0.01, 0.02])
def test_rollout_is_the_jax_function(dt):
    """models/tpwl.py:rollout(model, x0, u, dt) on the campaign dictionary:
    x only, from a dictionary point, at the cached dt (the pre-discretized
    tables) and at a dt without the cache (the continuous rows discretized
    a step), as the JAX function; the method's x is the same."""
    jm, tm = _campaign_models()
    x0 = np.concatenate((np.asarray(jm.v)[7], np.asarray(jm.q)[7]))
    u = _cable_inputs(1, 12, dt)[0]
    ref = np.asarray(jtpwl.rollout(jm, jnp.asarray(x0), jnp.asarray(u), dt))
    got = ttpwl.rollout(tm, torch.as_tensor(x0), torch.as_tensor(u), dt)
    assert got.shape == ref.shape == (13, 60)
    _assert_same_trajectory(got, ref)
    x, z = tm.rollout(torch.as_tensor(x0), torch.as_tensor(u), dt)
    assert torch.equal(x, got) and z.shape == (13, 3)
