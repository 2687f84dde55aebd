"""The plant side of the closed loop, the port against the JAX package on
the same numpy inputs, f64 on the CPU: the FEM surrogate (`f`, `jacobians`,
`step`, the four `simulate*` functions, `make_chain_robot`'s arrays), the
POD lifts and projections, `compute_POD` and `load_POD`, and the committed
chain-pipeline fixture that carries the chain model to the card without
JAX. Tolerances are stated in each test."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from helpers import chain_pipeline
from torch_helpers import CHAIN_FIXTURE, chain_fixture

from soft_robot_control_tpu.rom import pod as jpod
from soft_robot_control_tpu.sim import fem_surrogate as jfem
from soft_robot_control_tpu_torch.models.convert import (
    flatten_arrays, model_arrays, surrogate_arrays, surrogate_from_arrays,
    unflatten_arrays)
from soft_robot_control_tpu_torch.rom import pod as tpod
from soft_robot_control_tpu_torch.sim import fem_surrogate as tfem

# single f64 operations and short recursions: rounding only
TOL = 1e-12


def chain_fixture_tree():
    """The chain model of the golden closed loop, built by the JAX
    pipeline: the TPWL model pre-discretized at dt=0.02 (dictionary, POD
    basis and references, output maps), the plant's arrays, Hf, Cf, and
    the snapshot trajectory X with its inputs u."""
    plant, rom, model, Hf, Cf, X, u = chain_pipeline(
        n_nodes=10, n_cables=4, dt=0.02, threshold=0.5)
    return {"tpwl": model_arrays(model.pre_discretize(0.02)),
            "plant": surrogate_arrays(plant), "Hf": np.asarray(Hf),
            "Cf": np.asarray(Cf), "X": np.asarray(X), "u": np.asarray(u)}


def _close(got, ref, tol=TOL, msg=""):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, msg
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(1.0, np.abs(ref).max()),
                               err_msg=msg)


def test_chain_fixture_is_the_jax_pipeline():
    """The committed fixture equals a fresh build by the JAX pipeline:
    strings and numbers exactly, arrays within 1e-10 of their scale (the
    pipeline's XLA kernels may round differently on another CPU)."""
    with np.load(CHAIN_FIXTURE) as f:
        got = dict(f)
    ref = flatten_arrays(chain_fixture_tree())
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        if v.dtype.kind in "fc" and v.ndim:
            _close(got[k], v, 1e-10, k)
        else:
            assert got[k] == v, k
    tree = unflatten_arrays(got)
    assert tree["tpwl"]["pre_discretized_dt"] == 0.02
    assert tree["tpwl"]["discr_method"] == "be"
    assert "beta" not in tree["tpwl"]


def test_chain_fixture_loads_as_the_port_objects():
    plant, model, Hf, Cf, X, u = chain_fixture("cpu")
    assert model.num_points == 169 and model.state_dim == 18
    assert plant.state_dim == 20 and plant.input_dim == 4
    assert model.pre_discretized_dt == 0.02 and model.A_d is not None
    assert X.shape == (207, 20) and u.shape == (206, 4)
    assert Hf.shape == (1, 20) and Cf.shape == (6, 20)


@pytest.fixture(scope="module")
def plants():
    """make_chain_robot in both packages (12 nodes, the default), and a
    seeded batch of states and inputs about its rest state."""
    jp, tp = jfem.make_chain_robot(seed=3), tfem.make_chain_robot(
        seed=3, device="cpu")
    rng = np.random.default_rng(5)
    x = np.asarray(jp.x_rest()) + 0.1 * rng.normal(size=(4, jp.state_dim))
    u = rng.uniform(0, 2, size=(4, jp.input_dim))
    return jp, tp, x, u


def test_make_chain_robot_arrays_are_the_jax_packages(plants):
    """The same numpy construction from default_rng(seed): bitwise."""
    jp, tp, _, _ = plants
    for k, v in surrogate_arrays(jp).items():
        np.testing.assert_array_equal(surrogate_arrays(tp)[k], v, err_msg=k)
    np.testing.assert_array_equal(tp.D, jp.D)
    np.testing.assert_array_equal(tp.x_rest(), jp.x_rest())
    assert (tp.state_dim, tp.input_dim, tp.n_nodes_dof) == (
        jp.state_dim, jp.input_dim, jp.n_nodes_dof)


def test_surrogate_f_jacobians_step(plants):
    """f, the analytic (A, B, d) and the linearly implicit Euler step, one
    state at a time and batched: 1e-12 of the scale."""
    jp, tp, x, u = plants
    t = lambda a: torch.as_tensor(a)
    for i in range(len(x)):
        _close(tp.f(t(x[i]), t(u[i])), jp.f(x[i], u[i]))
        for g, r in zip(tp.jacobians(t(x[i]), t(u[i])),
                        jp.jacobians(x[i], u[i])):
            _close(g, r)
        _close(tp.step(t(x[i]), t(u[i]), 0.02), jp.step(x[i], u[i], 0.02))
    A, B, d = tp.jacobians(t(x), t(u))
    assert A.shape == (4, 24, 24) and B.shape == (4, 24, 4)
    _close(tp.step(t(x), t(u), 0.02)[2], jp.step(x[2], u[2], 0.02))
    # the affine expansion is exact at its own point
    _close((A @ t(x)[..., None] + B @ t(u)[..., None])[..., 0] + d,
           tp.f(t(x), t(u)))


def test_simulate_family(plants):
    """simulate, simulate_batch and both chunked forms over 23 steps
    (chunks that do not divide the horizon): 1e-10 of the scale."""
    jp, tp, x, _ = plants
    rng = np.random.default_rng(6)
    U = rng.uniform(0, 2, size=(2, 23, 4))
    x0 = x[:2]
    ref = np.asarray(jfem.simulate(jp, jnp.asarray(x0[0]),
                                   jnp.asarray(U[0]), 0.02))
    _close(tfem.simulate(tp, x0[0], U[0], 0.02), ref, 1e-10)
    _close(tfem.simulate_chunked(tp, x0[0], U[0], 0.02, chunk=5),
           jfem.simulate_chunked(jp, jnp.asarray(x0[0]), jnp.asarray(U[0]),
                                 0.02, chunk=5), 1e-10)
    refb = np.asarray(jfem.simulate_batch(jp, jnp.asarray(x0),
                                          jnp.asarray(U), 0.02))
    _close(tfem.simulate_batch(tp, x0, U, 0.02), refb, 1e-10)
    _close(tfem.simulate_batch_chunked(tp, x0, U, 0.02, chunk=10),
           jfem.simulate_batch_chunked(jp, jnp.asarray(x0), jnp.asarray(U),
                                       0.02, chunk=10), 1e-10)
    _close(refb[0], ref, 1e-10)


def test_surrogate_carried_across(plants):
    jp, _, x, u = plants
    tp = surrogate_from_arrays(surrogate_arrays(jp), device="cpu")
    _close(tp.step(torch.as_tensor(x[0]), torch.as_tensor(u[0]), 0.02),
           jp.step(x[0], u[0], 0.02))


@pytest.fixture(scope="module")
def bases():
    """A POD basis of a seeded snapshot matrix in both packages."""
    rng = np.random.default_rng(7)
    nf, r = 15, 4
    U = np.linalg.qr(rng.normal(size=(nf, r)))[0]
    info = {"U": U, "q_ref": rng.normal(size=nf), "v_ref": rng.normal(size=nf)}
    return jpod.POD(info), tpod.POD(info, device="cpu"), rng


def test_pod_lifts_and_projections(bases):
    """lift_q/v/x, project_q/v/x and the matrix projections, on a batch:
    1e-12 of the scale."""
    jb, tb, rng = bases
    nf, r = 15, 4
    xr = rng.normal(size=(3, 2 * r))
    xf = rng.normal(size=(3, 2 * nf))
    for name, arg in (("lift_q", xr[:, :r]), ("lift_v", xr[:, r:]),
                      ("lift_x", xr), ("project_q", xf[:, :nf]),
                      ("project_v", xf[:, nf:]), ("project_x", xf)):
        _close(getattr(tb, name)(torch.as_tensor(arg)),
               getattr(jb, name)(arg), msg=name)
    _close(tb.project_x(tb.lift_x(torch.as_tensor(xr))), xr)
    M = rng.normal(size=(nf, nf))
    for kw in ({}, {"left": True}, {"right": True},
               {"left": True, "right": True}):
        _close(tb.project_matrix(M, **kw), jb.project_matrix(M, **kw))
    for Mf in (rng.normal(size=(2 * nf, 2 * nf)), rng.normal(size=(5, 2 * nf))):
        _close(tb.project_block_matrix(Mf), jb.project_block_matrix(Mf))
    _close(tb.project_output_matrix(Mf), jb.project_output_matrix(Mf))
    for k, v in jb.get_info().items():
        if k == "type":
            assert tb.get_info()[k] == v
        else:
            np.testing.assert_array_equal(tb.get_info()[k], v)


@pytest.mark.parametrize("tol,rom_dim", [(1e-3, None), (1e-8, None),
                                         (1.0, None), (0.0, None),
                                         (1e-3, 3)])
def test_compute_pod(tol, rom_dim):
    """The SVD and the energy rule on a snapshot matrix with decaying
    modes: the same r and singular values, bases equal up to rounding."""
    rng = np.random.default_rng(8)
    snaps = rng.normal(size=(20, 6)) @ np.diag(10.0 ** -np.arange(6)) @ \
        rng.normal(size=(6, 40))
    got = tpod.compute_POD(snaps, tol, rom_dim=rom_dim)
    ref = jpod.compute_POD(snaps, tol, rom_dim=rom_dim)
    assert got[2] == ref[2]
    for g, r in zip((got[0], got[1], got[3]), (ref[0], ref[1], ref[3])):
        _close(g, r)


def test_load_pod(tmp_path, bases):
    """A reference-format pickle ({'POD_info', ...}) loads into the same
    basis; a missing file raises as in the JAX package."""
    from soft_robot_control_tpu_torch.utils.io import save_data

    jb, _, _ = bases
    path = str(tmp_path / "pod.pkl")
    save_data(path, {"POD_info": jb.get_info(), "Sigma": np.ones(3)})
    tb = tpod.load_POD(path, device="cpu")
    jl = jpod.load_POD(path)
    for k in ("U", "q_ref", "v_ref"):
        np.testing.assert_array_equal(getattr(tb, k), getattr(jl, k))
    with pytest.raises(RuntimeError, match="not a valid file"):
        tpod.load_POD(str(tmp_path / "missing.pkl"), device="cpu")
