"""The port's slice as a whole: the batched condensed MPC+EKF closed loop
(`build_fused` and `build`) against the JAX package's, noise-free, f64 on
the CPU, on the chain model and on a 64-point subset of the Diamond
campaign dictionary at its full widths (r=30, n_u=4, n_y=30, n_z=3)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_helpers import CAMPAIGN_PARAMS, campaign_dict, campaign_output_maps
from helpers import chain_pipeline

from soft_robot_control_tpu.control.batch_mpc import BatchMPC as JaxMPC
from soft_robot_control_tpu.control.batch_mpc import window_targets
from soft_robot_control_tpu.core.constraints import HyperRectangle as JaxBox
from soft_robot_control_tpu.models.tpwl import from_tpwl_dict as jax_from
from soft_robot_control_tpu_torch.control.batch_mpc import BatchMPC
from soft_robot_control_tpu_torch.core.constraints import HyperRectangle
from soft_robot_control_tpu_torch.models.convert import (model_arrays,
                                                         model_from_arrays)
from soft_robot_control_tpu_torch.models.tpwl import from_tpwl_dict

ATOL = 1e-7


def _compare(jax_logs, logs):
    for k in ("z", "u"):
        ref = np.asarray(jax_logs[k])
        assert logs[k].shape == ref.shape
        np.testing.assert_allclose(logs[k].numpy(), ref, atol=ATOL)


def _both(jax_model, model, Qz, R, U=None, **kw):
    """The JAX and the port BatchMPC at the same settings (f64)."""
    jmpc = JaxMPC(jax_model, Qz, R, dtype=jnp.float64, x_step="kinv",
                  formulation="condensed",
                  U=None if U is None else JaxBox(*U), **kw)
    tmpc = BatchMPC(model, Qz, R, dtype=torch.float64, device="cpu",
                    formulation="condensed",
                    U=None if U is None else HyperRectangle(*U), **kw)
    jax.block_until_ready(jmpc.K_pts)
    return jmpc, tmpc


def _run_both(jmpc, tmpc, n_win, x0B, zt):
    B = x0B.shape[0]
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    ref_f = jmpc.build_fused(n_win)(jnp.asarray(x0B), jnp.asarray(x0B),
                                    jnp.asarray(zt), keys)
    ref_f = {k: np.asarray(v) for k, v in ref_f.items()}
    _compare(ref_f, tmpc.build_fused(n_win)(x0B, x0B, zt))
    ref_1 = jax.jit(jmpc.build(n_win))(jnp.asarray(x0B[0]),
                                       jnp.asarray(x0B[0]),
                                       jnp.asarray(zt[0]), keys[0])
    ref_1 = {k: np.asarray(v) for k, v in ref_1.items()}
    _compare(ref_1, tmpc.build(n_win)(x0B[0], x0B[0], zt[0]))


@pytest.fixture(scope="module")
def chain():
    _, rom, model, Hf, _, X, _ = chain_pipeline()
    x0 = np.asarray(rom.project_x(jnp.asarray(X[0])))
    return model, float(X[0] @ Hf[0]), x0


def test_chain_closed_loop_matches_jax(chain):
    model, z0, x0 = chain
    tm = model_from_arrays(model_arrays(model), device="cpu")
    n_win, B, dt = 5, 3, 0.02
    jmpc, tmpc = _both(model, tm, np.array([[100.0]]), 1e-3 * np.eye(4),
                       U=(3.0 * np.ones(4), np.zeros(4)), N=4, dt=dt,
                       N_replan=2, qp_iters=40, rho_stages=2,
                       W=1e-2 * np.eye(model.state_dim),
                       V=1e-4 * np.eye(model.C.shape[0]))
    offs = np.random.default_rng(4).uniform(0.03, 0.07, size=B)
    T = n_win * 2 + 4 + 1
    zt = np.stack([window_targets(np.full((T, 1), z0 + o), n_win, 2, 4)
                   for o in offs])
    _run_both(jmpc, tmpc, n_win, np.tile(x0, (B, 1)), zt)


def test_campaign_subset_closed_loop_matches_jax():
    """bench.py's quality-gated settings on 64 of the 1087 campaign points
    (every 17th), so that the per-point DARE stays cheap on the CPU."""
    data = campaign_dict(np.arange(0, 1087, 17)[:64])
    Cf, Hf = campaign_output_maps()
    kw = dict(params=CAMPAIGN_PARAMS, Cf=Cf, Hf=Hf, discr_method="be")
    jm = jax_from(data, **kw)
    tm = from_tpwl_dict(data, device="cpu", **kw)
    N, N_rep, n_win, B, dt = 5, 2, 4, 3, 0.01
    jmpc, tmpc = _both(jm, tm, 100.0 * np.eye(3), 1e-5 * np.eye(4),
                       U=(1500.0 * np.ones(4), np.zeros(4)), N=N, dt=dt,
                       N_replan=N_rep, qp_iters=100, rho_stages=4,
                       scaling_iters=6, W=1e-2 * np.eye(60),
                       V=1e-4 * np.eye(30))
    np.testing.assert_allclose(tmpc.K_pts.numpy(), np.asarray(jmpc.K_pts),
                               rtol=1e-9, atol=1e-9)
    rng = np.random.default_rng(0)
    T = n_win * N_rep + N + 1
    t = dt * np.arange(T)
    z_ref = np.asarray(jm.z_ref)
    zt = np.stack([window_targets(
        z_ref + 2.0 * np.sin(2 * np.pi * t[:, None] / 0.5
                             + rng.uniform(0, 2 * np.pi, 3)),
        n_win, N_rep, N) for _ in range(B)])
    _run_both(jmpc, tmpc, n_win, np.zeros((B, 60)), zt)


def test_measurement_noise_is_taken_as_given(chain):
    model, z0, x0 = chain
    tm = model_from_arrays(model_arrays(model), device="cpu")
    mpc = BatchMPC(tm, np.array([[100.0]]), 1e-3 * np.eye(4), N=4, dt=0.02,
                   N_replan=2, qp_iters=20, dtype=torch.float64,
                   device="cpu")
    zt = np.stack([window_targets(np.full((11, 1), z0 + 0.05), 3, 2, 4)] * 2)
    x0B = np.tile(x0, (2, 1))
    run = mpc.build_fused(3, noise_std=1e-3)
    noise = torch.randn((3, 2, 2, mpc.n_y), dtype=torch.float64,
                        generator=torch.Generator().manual_seed(0))
    a = run(x0B, x0B, zt, noise=noise)
    b = run(x0B, x0B, zt, noise=noise)
    clean = mpc.build_fused(3)(x0B, x0B, zt)
    assert torch.equal(a["u"], b["u"])
    assert not torch.equal(a["u"], clean["u"])
    g = run(x0B, x0B, zt, generator=torch.Generator().manual_seed(0))
    assert torch.equal(g["u"], a["u"])  # same draws from the same seed


@pytest.mark.parametrize("kw", [dict(formulation="sparse"),
                                dict(use_pallas=True),
                                dict(trust_region=True)])
def test_unported_options_raise(chain, kw):
    tm = model_from_arrays(model_arrays(chain[0]), device="cpu")
    with pytest.raises(NotImplementedError):
        BatchMPC(tm, np.eye(1), np.eye(4), N=2, dt=0.02, device="cpu",
                 dtype=torch.float64, **kw)
