"""The sparse-LOCP slice as a whole at the Diamond campaign's full widths:
the port's sparse `build_fused`, `build` (each QP solver) and `run_batch`
against the JAX package's, noise-free, f64 on the CPU, on a 64-point subset
of the campaign dictionary (r=30, n_u=4, n_y=30, n_z=3, N=5: the QP has
n=380 variables and m=400 rows, where the JAX dispatch takes the per-QP
grid kernel). Also the port's own condensed-against-sparse check."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_helpers import CAMPAIGN_PARAMS, campaign_dict, campaign_output_maps
from helpers import chain_pipeline
from test_torch_batch_mpc import (PALLAS_ATOL, _both, _run_both,  # noqa: F401
                                  pallas_on_cpu)

from soft_robot_control_tpu.control.batch_mpc import window_targets
from soft_robot_control_tpu.models.tpwl import from_tpwl_dict as jax_from
from soft_robot_control_tpu.ops.pallas_admm import _pick_chunk
from soft_robot_control_tpu_torch.control.batch_mpc import BatchMPC
from soft_robot_control_tpu_torch.core.constraints import HyperRectangle
from soft_robot_control_tpu_torch.models.convert import (model_arrays,
                                                         model_from_arrays)
from soft_robot_control_tpu_torch.models.tpwl import from_tpwl_dict

N, N_REP, N_WIN, B, DT = 5, 2, 2, 2, 0.01
# 1e-6 of each log's scale (commands reach 1500 mN). The loops agree to
# about 1e-11 of it with one rho stage; every rho re-balance divides two
# small residuals and so amplifies the rounding differences between the two
# runtimes, to 1e-8 of the scale (1.5e-5 mN) at four stages.
TOL = dict(atol=0.0, rel=1e-6)


@pytest.fixture(scope="module")
def campaign():
    """Both packages' model on every 17th of the 1087 campaign points, and
    sinusoidal targets around z_ref."""
    data = campaign_dict(np.arange(0, 1087, 17)[:64])
    Cf, Hf = campaign_output_maps()
    kw = dict(params=CAMPAIGN_PARAMS, Cf=Cf, Hf=Hf, discr_method="be")
    jm = jax_from(data, **kw)
    tm = from_tpwl_dict(data, device="cpu", **kw)
    rng = np.random.default_rng(0)
    t = DT * np.arange(N_WIN * N_REP + N + 1)
    z_ref = np.asarray(jm.z_ref)
    zt = np.stack([window_targets(
        z_ref + 2.0 * np.sin(2 * np.pi * t[:, None] / 0.5
                             + rng.uniform(0, 2 * np.pi, 3)),
        N_WIN, N_REP, N) for _ in range(B)])
    return jm, tm, zt


def _mpcs(campaign, R, **kw):
    jm, tm, _ = campaign
    both = _both(jm, tm, 100.0 * np.eye(3), R * np.eye(4),
                 U=(1500.0 * np.ones(4), np.zeros(4)), N=N, dt=DT,
                 N_replan=N_REP, formulation="sparse", W=1e-2 * np.eye(60),
                 V=1e-4 * np.eye(30), **kw)
    assert both[1]._qp_dims() == both[0]._qp_dims() == (380, 400)
    assert _pick_chunk(B, 380, 400, 8) == 0
    return both


def test_campaign_sparse_fused_loop_matches_jax(campaign):
    """The fused sparse loop at its benchmark settings (K^-1 x-step, 100
    iterations in 4 rho stages, 6 Ruiz iterations, R = 1e-5 I):
    `build_fused`, and `build` with x_step='kinv'."""
    jmpc, tmpc = _mpcs(campaign, 1e-5, x_step="kinv", qp_iters=100,
                       rho_stages=4, scaling_iters=6)
    _run_both(jmpc, tmpc, N_WIN, np.zeros((B, 60)), campaign[2], **TOL)


def test_campaign_sparse_single_qp_loop_matches_jax(campaign, pallas_on_cpu):
    """The single-trajectory loop at its benchmark settings (use_pallas, 50
    iterations, R = 1e-3 I): against the JAX loop through its f32-rounding
    Pallas kernel at PALLAS_ATOL of the scale, and against the JAX Cholesky
    x-step, the same iteration in f64, at 1e-6 of it; `build` and `run_batch`."""
    jmpc, tmpc = _mpcs(campaign, 1e-3, use_pallas=True, x_step="chol",
                       qp_iters=50)
    x0B, zt = np.zeros((B, 60)), campaign[2]
    _run_both(jmpc, tmpc, N_WIN, x0B[:1], zt[:1], fused=False, atol=0.0,
              rel=PALLAS_ATOL)
    jmpc.use_pallas = False
    _run_both(jmpc, tmpc, N_WIN, x0B, zt, fused=False, batch=True, **TOL)


def test_campaign_sparse_cholesky_loop_matches_jax(campaign):
    """x_step='chol' (the default), `build` and `run_batch`."""
    jmpc, tmpc = _mpcs(campaign, 1e-3, x_step="chol", qp_iters=50)
    _run_both(jmpc, tmpc, N_WIN, np.zeros((B, 60)), campaign[2], fused=False,
              batch=True, **TOL)


def test_condensed_matches_sparse():
    """The condensed formulation reproduces the sparse LOCP's closed loop:
    same QP optimum, so with enough ADMM iterations both converge to the
    same plans (f64; tests/test_batch_mpc.py's case and atol 2e-5)."""
    _, rom, model, Hf, _, X, _ = chain_pipeline()
    tm = model_from_arrays(model_arrays(model), device="cpu")
    z0 = float(X[0] @ Hf[0])
    x0 = np.asarray(rom.project_x(jnp.asarray(X[0])))
    n_win = 5
    zt = window_targets(np.full((n_win * 2 + 4 + 1, 1), z0 + 0.05), n_win, 2,
                        4)
    runs = {}
    for form in ("sparse", "condensed"):
        mpc = BatchMPC(tm, np.array([[100.0]]), 1e-3 * np.eye(4), N=4,
                       dt=0.02, N_replan=2, qp_iters=600,
                       dtype=torch.float64, device="cpu", x_step="kinv",
                       U=HyperRectangle(3.0 * np.ones(4), np.zeros(4)),
                       W=1e-2 * np.eye(model.state_dim),
                       V=1e-4 * np.eye(model.C.shape[0]), formulation=form)
        runs[form] = mpc.build(n_win)(x0, x0, zt)
    for k in ("z", "u"):
        np.testing.assert_allclose(runs["condensed"][k].numpy(),
                                   runs["sparse"][k].numpy(), atol=2e-5)
    # the input bound binds and is respected to ADMM's finite-iteration
    # primal tolerance
    u = runs["condensed"]["u"].numpy()
    assert u.max() <= 3.0 + 1e-2 and u.min() >= -1e-2
    assert u.max() > 2.99
