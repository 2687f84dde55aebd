"""Kernel 2 of the port, the TPWL nearest-point select and gather, on the
committed Diamond campaign dictionary (P=1087, r=30): its plain version
against TPWLModel.calc_nearest_point and the Pallas kernel (interpret
mode). The CUDA kernel is held to the plain version in
tests/test_torch_kernels_cuda.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_helpers import (CAMPAIGN_PARAMS, campaign_dict,
                           campaign_output_maps)

from soft_robot_control_tpu.models.tpwl import from_tpwl_dict, rollout_batch
from soft_robot_control_tpu.ops.pallas_tpwl import tpwl_gather_pallas
from soft_robot_control_tpu_torch.ops.tpwl_select import (tpwl_select,
                                                          tpwl_select_plain)


@pytest.fixture(scope="module")
def campaign():
    """JAX campaign model (f64) and states: a rollout of smooth cable
    inputs from rest, and dictionary states with small seeded noise."""
    Cf, Hf = campaign_output_maps()
    model = from_tpwl_dict(campaign_dict(), params=CAMPAIGN_PARAMS, Cf=Cf,
                           Hf=Hf, discr_method="be")
    rng = np.random.default_rng(7)
    B, T, dt = 4, 12, float(model.pre_discretized_dt)
    t = dt * np.arange(T)
    u = 750.0 * (1.0 + np.sin(2 * np.pi * t[None, :, None] / 0.1
                              + rng.uniform(0, 2 * np.pi, (B, 1, 4))))
    X = np.asarray(rollout_batch(model, jnp.zeros((B, 60)), jnp.asarray(u),
                                 dt, select="exact")).reshape(-1, 60)
    pts = rng.choice(model.num_points, 24, replace=False)
    xd = np.concatenate([np.asarray(model.v)[pts], np.asarray(model.q)[pts]],
                        axis=1)
    xd = xd + 1e-3 * np.abs(xd).max() * rng.normal(size=xd.shape)
    return model, np.concatenate([X, xd])


def _dictionary(model):
    return [torch.as_tensor(np.array(a)) for a in
            (model.q, model.v, model.A_d, model.B_d, model.d_d)]


def test_plain_matches_model_and_pallas(campaign):
    model, X = campaign
    q, v, A_d, B_d, d_d = _dictionary(model)
    wq, wv = float(model.dist_w_q), float(model.dist_w_v)
    launches = tpwl_select.launches
    idx, A, Bm, d = tpwl_select(torch.as_tensor(X), q, v, A_d, B_d, d_d,
                                wq, wv)
    assert tpwl_select.launches == launches  # CPU tensors: no kernel
    ref_idx = np.asarray(jax.vmap(model.calc_nearest_point)(jnp.asarray(X)))
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    assert len(np.unique(ref_idx)) > 10  # the states visit many points
    A_p, B_p, d_p = tpwl_gather_pallas(
        jnp.asarray(X), model.q, model.v, model.A_d, model.B_d, model.d_d,
        wq, wv, interpret=True)
    for got, ref in ((A, A_p), (Bm, B_p), (d, d_p)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-12)


def test_ties_go_to_the_lowest_index():
    q = torch.tensor([[1.0], [0.0], [0.0], [2.0]], dtype=torch.float64)
    v = torch.zeros((4, 1), dtype=torch.float64)
    A = torch.arange(4, dtype=torch.float64).reshape(4, 1, 1)
    x = torch.tensor([[0.0, 0.0], [0.0, 1.5]], dtype=torch.float64)
    idx, A_sel, _, _ = tpwl_select_plain(x, q, v, A, A, A[:, 0], 1.0, 1.0)
    assert idx.tolist() == [1, 0]  # points 1 and 2 tie; 0 and 3 tie
    assert A_sel[:, 0, 0].tolist() == [1.0, 0.0]



@pytest.fixture(scope="module")
def campaign_reference(campaign):
    """The JAX package's indices (calc_nearest_point) and rows (the Pallas
    kernel, interpret mode) for every campaign state."""
    model, X = campaign
    idx = np.asarray(jax.vmap(model.calc_nearest_point)(jnp.asarray(X)))
    rows = tpwl_gather_pallas(
        jnp.asarray(X), model.q, model.v, model.A_d, model.B_d, model.d_d,
        float(model.dist_w_q), float(model.dist_w_v), interpret=True)
    return idx, [np.asarray(a) for a in rows]


@pytest.mark.parametrize("third", [0, 1, 3])
def test_index_only_gives_indices_everywhere_and_rows_after(
        campaign, campaign_reference, third):
    """index_only = k (0, B/3, B): every state's index as the JAX model's,
    and rows only for states k.., as the Pallas kernel's for those states
    (atol 1e-12)."""
    model, X = campaign
    ref_idx, ref_rows = campaign_reference
    k = X.shape[0] * third // 3
    q, v, A_d, B_d, d_d = _dictionary(model)
    wq, wv = float(model.dist_w_q), float(model.dist_w_v)
    idx, *rows = tpwl_select(torch.as_tensor(X), q, v, A_d, B_d, d_d, wq, wv,
                             index_only=k)
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    for got, ref in zip(rows, ref_rows):
        assert got.shape == (X.shape[0] - k,) + ref.shape[1:]
        np.testing.assert_allclose(got.numpy(), ref[k:], atol=1e-12)


def test_index_only_outside_the_batch_raises():
    q = torch.zeros((2, 1), dtype=torch.float64)
    A = torch.zeros((2, 1, 1), dtype=torch.float64)
    x = torch.zeros((3, 2), dtype=torch.float64)
    for k in (-1, 4):
        with pytest.raises(ValueError, match="index_only"):
            tpwl_select(x, q, q, A, A, A[:, 0], 1.0, 1.0, index_only=k)
