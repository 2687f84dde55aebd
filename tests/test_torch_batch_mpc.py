"""The port's slices as a whole: the batched MPC+EKF closed loop, condensed
and sparse (`build_fused`, `build` with each of its QP solvers, and
`run_batch`), against the JAX package's, noise-free, f64 on the CPU, on the
chain model and on a 64-point subset of the Diamond campaign dictionary at
its full widths (r=30, n_u=4, n_y=30, n_z=3; the sparse QP has n=380
variables and m=400 rows)."""

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


def _compare(jax_logs, logs, atol=ATOL, rel=0.0):
    """Logs equal to `atol` plus `rel` times the reference log's largest
    magnitude."""
    for k in ("z", "u"):
        ref = np.asarray(jax_logs[k])
        assert logs[k].shape == ref.shape
        np.testing.assert_allclose(logs[k].numpy(), ref, rtol=0,
                                   atol=atol + rel * np.abs(ref).max())


def _both(jax_model, model, Qz, R, U=None, dU=None, formulation="condensed",
          x_step="kinv", **kw):
    """The JAX and the port BatchMPC at the same settings (f64); U and dU
    are (ub, lb) pairs."""
    box = lambda Box, b: None if b is None else Box(*b)
    jmpc = JaxMPC(jax_model, Qz, R, dtype=jnp.float64, x_step=x_step,
                  formulation=formulation, U=box(JaxBox, U),
                  dU=box(JaxBox, dU), **kw)
    tmpc = BatchMPC(model, Qz, R, dtype=torch.float64, device="cpu",
                    x_step=x_step, formulation=formulation,
                    U=box(HyperRectangle, U), dU=box(HyperRectangle, dU),
                    **kw)
    jax.block_until_ready(jmpc.K_pts)
    return jmpc, tmpc


def _run_both(jmpc, tmpc, n_win, x0B, zt, fused=True, batch=False,
              **tol):
    """Compare the logs of `build` (always), `build_fused` and
    `run_batch` (where asked) between the two packages."""
    B = x0B.shape[0]
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    jx, jz = jnp.asarray(x0B), jnp.asarray(zt)
    if fused:
        ref_f = jmpc.build_fused(n_win)(jx, jx, jz, keys)
        ref_f = {k: np.asarray(v) for k, v in ref_f.items()}
        _compare(ref_f, tmpc.build_fused(n_win)(x0B, x0B, zt), **tol)
    ref_1 = jax.jit(jmpc.build(n_win))(jx[0], jx[0], jz[0], keys[0])
    ref_1 = {k: np.asarray(v) for k, v in ref_1.items()}
    _compare(ref_1, tmpc.build(n_win)(x0B[0], x0B[0], zt[0]), **tol)
    if batch:
        ref_b = jmpc.run_batch(jx, jx, jz, keys)
        ref_b = {k: np.asarray(v) for k, v in ref_b.items()}
        _compare(ref_b, tmpc.run_batch(x0B, x0B, zt), **tol)


@pytest.fixture
def pallas_on_cpu(monkeypatch):
    """Let the JAX package's `BatchMPC(use_pallas=True)` run here: its
    single-QP Pallas kernel in interpret mode, as tests/test_pallas.py runs
    it. That kernel rounds every mat-vec to f32 (its dots carry
    preferred_element_type=float32), so logs that went through it are
    compared at PALLAS_ATOL; the same loop is held tightly against the
    Cholesky x-step, which computes the same iteration in full f64."""
    from functools import partial

    from soft_robot_control_tpu.ops import pallas_admm

    monkeypatch.setattr(pallas_admm, "admm_fixed_pallas", partial(
        pallas_admm.admm_fixed_pallas, interpret=True))


PALLAS_ATOL = 1e-3


@pytest.fixture(scope="module")
def chain():
    _, rom, model, Hf, _, X, _ = chain_pipeline()
    x0 = np.asarray(rom.project_x(jnp.asarray(X[0])))
    return model, float(X[0] @ Hf[0]), x0


def _chain_case(chain, n_win=5, B=3, **kw):
    """Both packages' BatchMPC on the chain model, with B constant offset
    targets."""
    model, z0, x0 = chain
    tm = model_from_arrays(model_arrays(model), device="cpu")
    both = _both(model, tm, np.array([[100.0]]), 1e-3 * np.eye(4),
                 **{**dict(U=(3.0 * np.ones(4), np.zeros(4)), N=4, dt=0.02,
                           N_replan=2, qp_iters=40,
                           W=1e-2 * np.eye(model.state_dim),
                           V=1e-4 * np.eye(model.C.shape[0])), **kw})
    offs = np.random.default_rng(4).uniform(0.03, 0.07, size=B)
    T = n_win * 2 + 4 + 1
    zt = np.stack([window_targets(np.full((T, 1), z0 + o), n_win, 2, 4)
                   for o in offs])
    return both, np.tile(x0, (B, 1)), zt


def test_chain_closed_loop_matches_jax(chain):
    (jmpc, tmpc), x0B, zt = _chain_case(chain, rho_stages=2)
    _run_both(jmpc, tmpc, 5, x0B, zt)


# the sparse loop's solvers: the staged K^-1 path (fused, and in build),
# the single-QP M1 path and the Cholesky path, with and without the trust
# region, an input-rate polyhedron and a state scale
SPARSE_CASES = {
    "kinv_staged": dict(x_step="kinv", rho_stages=2),
    "use_pallas": dict(use_pallas=True, x_step="chol"),
    "chol": dict(x_step="chol"),
    "kinv_trust_region": dict(x_step="kinv", trust_region=True,
                              delta0=0.5, omega0=10.0,
                              x_char=np.linspace(0.5, 2.0, 18)),
    "chol_no_scaling_dU": dict(x_step="chol", scaling_iters=0,
                               dU=(0.5 * np.ones(4), -0.5 * np.ones(4))),
}


@pytest.mark.parametrize("case", list(SPARSE_CASES))
def test_chain_sparse_closed_loop_matches_jax(chain, case, pallas_on_cpu):
    """Sparse `build_fused`, `build` and `run_batch` on the chain model."""
    (jmpc, tmpc), x0B, zt = _chain_case(chain, n_win=3, B=2,
                                        formulation="sparse",
                                        **SPARSE_CASES[case])
    assert tmpc._qp_dims() == jmpc._qp_dims()
    _run_both(jmpc, tmpc, 3, x0B, zt, fused=case != "use_pallas", batch=True,
              atol=PALLAS_ATOL if case == "use_pallas" else ATOL)
    if case == "use_pallas":  # the M1 iteration equals the Cholesky one
        jmpc.use_pallas = False
        _run_both(jmpc, tmpc, 3, x0B, zt, fused=False, batch=True)


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
                   formulation="condensed", device="cpu")
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


@pytest.mark.parametrize("kw", [dict(trust_region=True,
                                     formulation="condensed")])
def test_unported_options_raise(chain, kw):
    """The condensed formulation has no trust region, in either package."""
    tm = model_from_arrays(model_arrays(chain[0]), device="cpu")
    with pytest.raises(NotImplementedError):
        BatchMPC(tm, np.eye(1), np.eye(4), N=2, dt=0.02, device="cpu",
                 dtype=torch.float64, **kw)
    with pytest.raises(NotImplementedError):
        JaxMPC(chain[0], np.eye(1), np.eye(4), N=2, dt=0.02,
               dtype=jnp.float64, **kw)


def test_constructor_takes_the_jax_arguments_and_defaults(chain):
    """Same parameter names, order and defaults as the JAX class (the port
    adds `device` and spells the dtype in torch), so that the same call
    builds the same controller: the sparse formulation with the Cholesky
    x-step."""
    import inspect

    jp = inspect.signature(JaxMPC.__init__).parameters
    tp = inspect.signature(BatchMPC.__init__).parameters
    assert [k for k in tp if k != "device"] == list(jp)
    for k, v in jp.items():
        if k != "dtype":
            assert tp[k].default == v.default, k
    tm = model_from_arrays(model_arrays(chain[0]), device="cpu")
    mpc = BatchMPC(tm, np.eye(1), np.eye(4), N=2, dt=0.02, device="cpu")
    assert (mpc.formulation, mpc.x_step, mpc.use_pallas) == (
        "sparse", "chol", False)
    assert mpc._qp_dims() == (3 * 18 + 2 * 4, 3 * 18)


@pytest.mark.parametrize("kw", [dict(formulation="dense"),
                                dict(x_step="lu")])
def test_unknown_option_values_raise(chain, kw):
    tm = model_from_arrays(model_arrays(chain[0]), device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        BatchMPC(tm, np.eye(1), np.eye(4), N=2, dt=0.02, device="cpu", **kw)


def test_run_batch_needs_build_first(chain):
    tm = model_from_arrays(model_arrays(chain[0]), device="cpu")
    mpc = BatchMPC(tm, np.eye(1), np.eye(4), N=2, dt=0.02, device="cpu")
    with pytest.raises(RuntimeError, match="build"):
        mpc.run_batch(np.zeros((1, 18)), np.zeros((1, 18)),
                      np.zeros((1, 1, 3, 1)))
