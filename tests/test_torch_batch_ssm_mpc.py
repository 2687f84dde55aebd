"""BatchSSMMPC of the port against the JAX package, f64 on the CPU, on the
committed trunk (bench.py section 5's model) and Diamond SSM artifacts in
both formulations: `build` + `run_batch` (the plain ADMM) and
`build_fused` (the batched ADMM kernel's plain version here; the JAX fused
path runs its Pallas kernel in interpret mode on the CPU), at B=8 and 2
windows with bench.py's costs, horizon and iteration count. The logs agree
to 1e-8 of their scale: the outputs about z_ref and the commands."""

import inspect

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_helpers import SSM_ARTIFACTS, ssm_targets

from soft_robot_control_tpu.control import batch_mpc as jbm
from soft_robot_control_tpu.models import ssm as jssm
from soft_robot_control_tpu_torch.control import batch_mpc as tbm
from soft_robot_control_tpu_torch.models.convert import (
    ssm_model_arrays, ssm_model_from_arrays)

B, N_WIN, N, N_REPLAN, DT, QP_ITERS = 8, 2, 3, 2, 0.02, 50
TOL = 1e-8


def _models(name):
    jm = jssm.from_mat(SSM_ARTIFACTS[name], None, discrete=False,
                       discr_method="be")
    arrays = {k: (v.astype(np.float64) if isinstance(v, np.ndarray) else v)
              for k, v in ssm_model_arrays(jm).items()}
    return jssm.SSMModel(**arrays), ssm_model_from_arrays(arrays,
                                                          device="cpu")


def _costs(nu):
    """bench.py section 5: Qz on the tip's x and y, R = 1e-6 I."""
    Qz = np.zeros((6, 6))
    Qz[0, 0] = Qz[1, 1] = 100.0
    return Qz, 1e-6 * np.eye(nu)


def _assert_logs(got, ref, z_ref):
    for k in ("z", "u"):
        r = np.asarray(ref[k]) - (z_ref if k == "z" else 0.0)
        g = got[k].numpy() - (z_ref if k == "z" else 0.0)
        assert g.shape == r.shape == (B, N_WIN * N_REPLAN, r.shape[-1])
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, r, rtol=0, atol=TOL * np.abs(r).max(),
                                   err_msg=k)


@pytest.mark.parametrize("name", ["trunk", "diamond"])
@pytest.mark.parametrize("formulation", ["condensed", "sparse"])
def test_batch_ssm_mpc_matches_jax(name, formulation):
    """run_batch after build, and build_fused, each against its JAX twin;
    the QP sizes are those of ROADMAP's table (trunk 24 / 1 and 48 / 24,
    Diamond 12 / 1 and 36 / 24)."""
    jm, tm = _models(name)
    Qz, R = _costs(jm.input_dim)
    kw = dict(N=N, dt=DT, N_replan=N_REPLAN, qp_iters=QP_ITERS,
              formulation=formulation)
    jmpc = jbm.BatchSSMMPC(jm, Qz, R, dtype=jnp.float64, **kw)
    tmpc = tbm.BatchSSMMPC(tm, Qz, R, dtype=torch.float64, device="cpu", **kw)
    nu = jm.input_dim
    assert tmpc._qp_dims() == jmpc._qp_dims() == {
        "condensed": (N * nu, 1), "sparse": ((N + 1) * 6 + N * nu, 24)}[
            formulation]
    zt, x0 = ssm_targets(B, N_WIN), np.zeros((B, 6))
    jmpc.build(N_WIN)
    tmpc.build(N_WIN)
    ref = jmpc.run_batch(jnp.asarray(x0), jnp.asarray(zt))
    ref_f = jmpc.build_fused(N_WIN)(jnp.asarray(x0), jnp.asarray(zt))
    jax.block_until_ready(ref_f)
    z_ref = np.asarray(jm.z_ref)
    _assert_logs(tmpc.run_batch(x0, zt), ref, z_ref)
    _assert_logs(tmpc.build_fused(N_WIN)(x0, zt), ref_f, z_ref)
    # build's single-trajectory run is run_batch's first loop
    one = tmpc.build(N_WIN)(x0[0], zt[0])
    for k in ("z", "u"):
        np.testing.assert_allclose(one[k].numpy(), np.asarray(ref[k][0]),
                                   rtol=0, atol=TOL * np.abs(
                                       np.asarray(ref[k])).max())


def test_sparse_cholesky_x_step_matches_jax():
    """The sparse loop with a Cholesky solve every iteration (x_step other
    than 'kinv': the JAX package's admm_fixed)."""
    jm, tm = _models("diamond")
    Qz, R = _costs(jm.input_dim)
    kw = dict(N=N, dt=DT, N_replan=N_REPLAN, qp_iters=QP_ITERS,
              formulation="sparse", x_step="chol")
    jmpc = jbm.BatchSSMMPC(jm, Qz, R, dtype=jnp.float64, **kw)
    tmpc = tbm.BatchSSMMPC(tm, Qz, R, dtype=torch.float64, device="cpu", **kw)
    zt, x0 = ssm_targets(B, N_WIN), np.zeros((B, 6))
    jmpc.build(N_WIN)
    tmpc.build(N_WIN)
    _assert_logs(tmpc.run_batch(x0, zt),
                 jmpc.run_batch(jnp.asarray(x0), jnp.asarray(zt)),
                 np.asarray(jm.z_ref))


def test_constructor_and_plan_shift_match_jax():
    """The JAX constructor's arguments and defaults (dtype aside, plus the
    device), the sparse rho row with the 1e3 boost on the init and
    dynamics rows, and the plan shift of the fused path (JAX's axis=1)."""
    jp = inspect.signature(jbm.BatchSSMMPC).parameters
    tp = inspect.signature(tbm.BatchSSMMPC).parameters
    assert list(tp)[:-1] == list(jp)
    for k in jp:
        if k != "dtype":
            assert tp[k].default == jp[k].default, k
    assert tp["device"].default == "cuda"
    jm, tm = _models("trunk")
    Qz, R = _costs(8)
    jmpc = jbm.BatchSSMMPC(jm, Qz, R, N=N, dt=DT, N_replan=N_REPLAN,
                           formulation="sparse")
    tmpc = tbm.BatchSSMMPC(tm, Qz, R, N=N, dt=DT, N_replan=N_REPLAN,
                           formulation="sparse", device="cpu")
    np.testing.assert_array_equal(tmpc.rho_vec.numpy(),
                                  np.asarray(jmpc.rho_vec))
    rng = np.random.default_rng(9)
    xp, up = rng.normal(size=(3, N + 1, 6)), rng.normal(size=(3, N, 8))
    for got, ref in zip(tmpc._shift_plan(torch.as_tensor(xp),
                                         torch.as_tensor(up)),
                        jmpc._shift_plan(jnp.asarray(xp), jnp.asarray(up),
                                         axis=1)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(RuntimeError, match="build"):
        tmpc.run_batch(np.zeros((1, 6)), ssm_targets(1, 1))
