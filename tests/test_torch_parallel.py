"""The port's scale-out (parallel/mesh.py) against the JAX package's, case
by case as tests/test_parallel.py runs it, f64 on the CPU: the JAX package
on its 8 virtual host devices (its fused loop's Pallas kernel in interpret
mode, as it runs itself there), the port on a mesh of the CPU device given
8 times. Then the sharded select against the unsharded one on the
committed campaign dictionary (P=1087), and the mesh helpers."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from helpers import chain_pipeline
from torch_helpers import CAMPAIGN_PARAMS, campaign_dict

from soft_robot_control_tpu.control.batch_mpc import BatchMPC as JaxMPC
from soft_robot_control_tpu.control.batch_mpc import window_targets
from soft_robot_control_tpu.parallel import mesh as jax_mesh
from soft_robot_control_tpu_torch.control.batch_mpc import BatchMPC
from soft_robot_control_tpu_torch.models.convert import (model_arrays,
                                                         model_from_arrays)
from soft_robot_control_tpu_torch.models.tpwl import (from_tpwl_dict,
                                                      rollout_batch)
from soft_robot_control_tpu_torch.ops.tpwl_select import (
    point_distances_batch, tpwl_select)
from soft_robot_control_tpu_torch.parallel.mesh import (
    PointShards, make_mesh, replicate, shard_batch, shard_tpwl_gather,
    sharded_batch_mpc_fused, sharded_batch_mpc_fused_mp,
    sharded_rollout_batch)

CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def setup():
    plant, rom, model, Hf, Cf, X, _ = chain_pipeline()
    jm = model.pre_discretize(0.02)
    tm = model_from_arrays(model_arrays(jm), device="cpu")
    x0 = np.asarray(rom.project_x(jnp.asarray(X[0])))
    return jm, tm, x0, float(X[0] @ Hf[0])


@pytest.mark.parametrize("dp,mp,B,N,seed", [(4, 2, 8, 25, 0),
                                            (2, 4, 4, 10, 1)])
def test_sharded_rollout_matches_jax(setup, dp, mp, B, N, seed):
    """dp=4 x mp=2, then dp=2 x mp=4, where the chain's points do not
    divide over mp (the JAX package pads, the port splits unevenly)."""
    jm, tm, x0, _ = setup
    assert tm.num_points % 4
    rng = np.random.default_rng(seed)
    x0s = x0 + 0.05 * rng.normal(size=(B, jm.state_dim))
    us = np.abs(rng.normal(size=(B, N, jm.input_dim)))
    ref = np.asarray(jax_mesh.sharded_rollout_batch(
        jm, jnp.asarray(x0s), jnp.asarray(us), 0.02,
        jax_mesh.make_mesh(dp, mp)))
    got = sharded_rollout_batch(tm, x0s, us, 0.02,
                                make_mesh(dp, mp, devices=CPU8))
    assert got.shape == (B, N + 1, jm.state_dim)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)
    local = rollout_batch(tm, torch.as_tensor(x0s), torch.as_tensor(us),
                          0.02, select="exact")
    assert torch.equal(got, local)


def _mpc_case(setup, B, n_win, seed):
    """Both packages' BatchMPC at tests/test_parallel.py's settings (sparse,
    K^-1 x-step, 30 ADMM iterations) and B offset targets."""
    jm, tm, x0, z0 = setup
    kw = dict(N=4, dt=0.02, N_replan=2, qp_iters=30, x_step="kinv",
              W=1e-2 * np.eye(jm.state_dim), V=1e-4 * np.eye(jm.C.shape[0]))
    jmpc = JaxMPC(jm, np.array([[100.0]]), 1e-3 * np.eye(4),
                  dtype=jnp.float64, **kw)
    tmpc = BatchMPC(tm, np.array([[100.0]]), 1e-3 * np.eye(4),
                    dtype=torch.float64, device="cpu", **kw)
    T = n_win * 2 + 4 + 1
    offs = np.random.default_rng(seed).uniform(0.02, 0.05, size=B)
    zt = np.stack([window_targets(np.full((T, 1), z0 + o), n_win, 2, 4)
                   for o in offs])
    x0B = np.tile(x0, (B, 1))
    jargs = (jnp.asarray(x0B), jnp.asarray(x0B), jnp.asarray(zt),
             jax.random.split(jax.random.PRNGKey(0), B))
    return jmpc, tmpc, jargs, (x0B, x0B, zt)


# The packages' unsharded fused loops already differ in u by up to 2.5e-11
# of its 4.7 (their DARE gains agree to 1e-9 relative and multiply the
# estimate's error); z agrees to 1e-13. A dp part's loop differs from the
# whole batch's in the last bits as well: a GEMM of 2 rows and one of 8
# round a row alike only to the last bits (the library picks its kernel by
# the row count), and the gains amplify that in u to 1.1e-11.
U_ATOL = 1e-10


def _close(got, ref):
    """Logs within 1e-12 (z) and U_ATOL (u) of a reference run's."""
    for k, atol in (("z", 1e-12), ("u", U_ATOL)):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]),
                                   rtol=0, atol=atol)


def _same(got, ref):
    assert all(torch.equal(got[k], ref[k]) for k in ("z", "u"))


def test_batch_mpc_fused_dp_matches_jax(setup):
    """dp=4, noise-free, against the JAX package's fused run (its sharded
    run is held to it by tests/test_parallel.py) and the port's unsharded
    run."""
    jmpc, tmpc, jargs, targs = _mpc_case(setup, 8, 4, 3)
    got = sharded_batch_mpc_fused(tmpc, 4, make_mesh(4, 1, devices=CPU8))(
        *targs)
    _close(got, jmpc.build_fused(4)(*jargs))
    _close(got, tmpc.build_fused(4)(*targs))


def test_batch_mpc_fused_mp_matches_jax(setup):
    """dp=2 x mp=4 with the dictionary and the DARE gains split over mp,
    against the JAX package's sharded_batch_mpc_fused_mp within 1e-10; and
    dp=1 x mp=4, whose batch is the unsharded run's, equal to that run bit
    for bit (the same indices, the rows copied)."""
    jmpc, tmpc, jargs, targs = _mpc_case(setup, 4, 3, 5)
    ref = jax_mesh.sharded_batch_mpc_fused_mp(
        jmpc, 3, jax_mesh.make_mesh(2, 4))(*jargs)
    got = sharded_batch_mpc_fused_mp(tmpc, 3, make_mesh(2, 4, devices=CPU8))(
        *targs)
    for k in ("z", "u"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=1e-10)
    local = tmpc.build_fused(3)(*targs)
    _close(got, local)
    _same(sharded_batch_mpc_fused_mp(tmpc, 3, make_mesh(1, 4, devices=CPU8))(
        *targs), local)


def test_sharded_runs_draw_the_noise_of_the_unsharded_run(setup):
    """With measurement noise, the sharded loops take the unsharded loop's
    draws from the same generator: the noise is drawn once for the batch
    (the mp-only split equals that run bit for bit)."""
    _, tmpc, _, targs = _mpc_case(setup, 4, 2, 6)
    gen = lambda: torch.Generator().manual_seed(3)
    ref = tmpc.build_fused(2, noise_std=1e-3)(*targs, generator=gen())
    clean = tmpc.build_fused(2)(*targs)
    assert (ref["u"] - clean["u"]).abs().max() > 1e3 * U_ATOL
    for build, (dp, mp) in ((sharded_batch_mpc_fused, (4, 1)),
                            (sharded_batch_mpc_fused_mp, (2, 2)),
                            (sharded_batch_mpc_fused_mp, (1, 2))):
        run = build(tmpc, 2, make_mesh(dp, mp, devices=CPU8), noise_std=1e-3)
        got = run(*targs, generator=gen())
        (_same if dp == 1 else _close)(got, ref)


@pytest.fixture(scope="module")
def campaign():
    """The committed campaign dictionary (f64) and 1024 states near it."""
    model = from_tpwl_dict(campaign_dict(), params=CAMPAIGN_PARAMS,
                           device="cpu")
    rng = np.random.default_rng(3)
    X = torch.cat([model.v, model.q], dim=1)
    pts = torch.as_tensor(rng.integers(0, model.num_points, 1024))
    x = X[pts] + 0.05 * X.std(dim=0) * torch.as_tensor(
        rng.normal(size=(1024, model.state_dim)))
    return model, x


@pytest.mark.parametrize("mp", [2, 3, 4, 8])
def test_sharded_select_is_the_unsharded_select(campaign, mp):
    """Identical indices and bitwise rows on P=1087 over mp parts, all rows
    and index-only for the first third, with the gains of the first third
    from their owners."""
    model, x = campaign
    mesh = make_mesh(1, mp, devices=CPU8)
    # stored transposed, as the DARE gains are: the gathered gains must be
    # laid out as K[idx] lays them out, or a product with them rounds
    # otherwise on a card
    K = torch.randn((model.num_points, model.state_dim, 4),
                    generator=torch.Generator().manual_seed(0),
                    dtype=torch.float64).transpose(1, 2)
    shards = PointShards(model, mesh, gains=K)
    assert [p[torch.device("cpu")]["q"].shape[0] for p in shards.parts] == [
        len(a) for a in np.array_split(np.arange(1087), mp)]
    tables = (model.q, model.v, model.A_d, model.B_d, model.d_d,
              model.dist_w_q, model.dist_w_v)
    for k in (0, 341):
        ref = tpwl_select(x, *tables, index_only=k)
        got = shards.select(x, mesh.devices[0], index_only=k, gains=k > 0)
        assert all(torch.equal(a, b) for a, b in zip(got[:4], ref))
        if k:
            want = K[ref[0][:k]]
            assert torch.equal(got[4], want)
            assert got[4].stride() == want.stride() == (240, 1, 4)
        else:
            assert got[4] is None
        assert all(torch.equal(a, b) for a, b in zip(
            shard_tpwl_gather(shards, x, mesh.devices[0], k), ref))
    # the distances the parts compared: the whole dictionary's minima
    idx, *_, dist = tpwl_select(x, *tables, distances=True)
    D = point_distances_batch(x, model.q, model.v, model.dist_w_q,
                              model.dist_w_v)
    assert torch.equal(dist, D.min(dim=1).values)
    assert torch.equal(dist, D[torch.arange(len(x)), idx])


def test_make_mesh_raises_the_jax_error_and_takes_repeated_devices():
    with pytest.raises(ValueError, match="need 8 devices, have 4"):
        make_mesh(4, 2, devices=CPU8[:4])
    mesh = make_mesh(2, 3, devices=CPU8)
    assert mesh.shape == {"dp": 2, "mp": 3}
    assert mesh.devices.shape == (2, 3)
    assert all(d == torch.device("cpu") for d in mesh.devices.ravel())
    with pytest.raises(ValueError, match="cannot fill"):
        PointShards(make_demo_model(3), make_mesh(1, 4, devices=CPU8))


def make_demo_model(P):
    from soft_robot_control_tpu_torch.tasks.demo import make_demo_tpwl

    return make_demo_tpwl(r=2, P=P, nf=4, device="cpu").pre_discretize(0.02)


def test_shard_batch_and_replicate():
    mesh = make_mesh(4, 2, devices=CPU8)
    a = torch.arange(24.0).reshape(8, 3)
    tree = {"x": a, "pair": (a[:, 0], a[:, :2]), "n": 3}
    parts = shard_batch(tree, mesh)
    assert len(parts) == 4
    assert torch.equal(torch.cat([p["x"] for p in parts]), a)
    assert torch.equal(parts[2]["pair"][1], a[4:6, :2])
    assert all(p["n"] == 3 for p in parts)
    assert len(shard_batch(a, mesh, "mp")) == 2
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(a[:6], mesh)
    copies = replicate(tree, mesh)
    assert len(copies) == 8
    assert all(torch.equal(c["x"], a) and torch.equal(c["pair"][0], a[:, 0])
               for c in copies)
