"""The TPWL model carried across to the port: artifact loading with the
campaign's output maps, conversion of a JAX-built model, pre-discretization
and the batched rollout, against the JAX package."""

import numpy as np
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


def test_rollout_batch_campaign():
    Cf, Hf = campaign_output_maps()
    data = campaign_dict()
    jm = jtpwl.from_tpwl_dict(data, params=CAMPAIGN_PARAMS, Cf=Cf, Hf=Hf)
    tm = ttpwl.from_tpwl_dict(data, params=CAMPAIGN_PARAMS, Cf=Cf, Hf=Hf,
                              device="cpu")
    rng = np.random.default_rng(11)
    B, T, dt = 4, 10, 0.01
    t = dt * np.arange(T)
    u = 750.0 * (1.0 + np.sin(2 * np.pi * t[None, :, None] / 0.1
                              + rng.uniform(0, 2 * np.pi, (B, 1, 4))))
    ref = np.asarray(jtpwl.rollout_batch(jm, jnp.zeros((B, 60)),
                                         jnp.asarray(u), dt, select="exact"))
    got = ttpwl.rollout_batch(tm, torch.zeros((B, 60), dtype=torch.float64),
                              torch.as_tensor(u), dt)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-9,
                               atol=1e-9 * np.abs(ref).max())
    with pytest.raises(ValueError, match="pre-discretized"):
        ttpwl.rollout_batch(tm, torch.zeros((B, 60), dtype=torch.float64),
                            torch.as_tensor(u), 0.02)
