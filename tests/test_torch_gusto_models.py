"""What the GuSTO and LTI paths take from the models and the core, against
the JAX package, f64 on the CPU: the TPWL model's batched Jacobians (one
select-kernel launch for all states; identical nearest points), weighting
mode, rollout and characteristic values on a 64-point subset of the Diamond
campaign dictionary at full width (r=30, n_u=4); the synthetic TPWL model;
the Dubins car; the GuSTO adapter; the polyhedron's membership, violation
and projection; the linear ROM; the cost and target containers."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_helpers import (CAMPAIGN, CAMPAIGN_PARAMS, campaign_dict,
                           campaign_output_maps)

from soft_robot_control_tpu.core import constraints as jcons
from soft_robot_control_tpu.models import linear as jlin
from soft_robot_control_tpu.models import tpwl as jtpwl
from soft_robot_control_tpu.models.dubins import DubinsCar as JaxDubins
from soft_robot_control_tpu.models.interfaces import TPWLGuSTO as JaxAdapter
from soft_robot_control_tpu.tasks.demo import make_demo_tpwl as jax_demo
from soft_robot_control_tpu_torch.core import constraints as tcons
from soft_robot_control_tpu_torch.core.types import (QuadraticCost, Target,
                                                     load_target_file)
from soft_robot_control_tpu_torch.models import linear as tlin
from soft_robot_control_tpu_torch.models import tpwl as ttpwl
from soft_robot_control_tpu_torch.models.dubins import DubinsCar
from soft_robot_control_tpu_torch.models.interfaces import TPWLGuSTO
from soft_robot_control_tpu_torch.ops.tpwl_select import tpwl_select
from soft_robot_control_tpu_torch.tasks.demo import make_demo_tpwl
from soft_robot_control_tpu_torch.utils.io import save_data

POINTS = np.arange(0, 1087, 17)[:64]


def _campaign_pair(**params):
    """The JAX and the port model on the same 64-point subset (f64)."""
    Cf, Hf = campaign_output_maps()
    data = campaign_dict(POINTS)
    kw = dict(params={**CAMPAIGN_PARAMS, **params}, Cf=Cf, Hf=Hf,
              discr_method="be")
    return (jtpwl.from_tpwl_dict(data, **kw),
            ttpwl.from_tpwl_dict(data, device="cpu", **kw))


def _states_near(tm, B, seed):
    """States near the dictionary points: a point plus seeded noise."""
    rng = np.random.default_rng(seed)
    X = torch.cat([tm.v, tm.q], dim=1).numpy()
    pts = rng.integers(0, tm.num_points, B)
    return X[pts] + 0.05 * X.std(axis=0) * rng.normal(size=(B, X.shape[1]))


@pytest.mark.parametrize("dt", [None, 0.01, 0.02])
def test_get_jacobians_nn_matches_jax(dt):
    """Continuous rows (dt None), the pre-discretized cache (dt 0.01, the
    campaign's), and continuous rows discretized by backward Euler (0.02),
    for a (3, 5) batch of states in one select launch."""
    jm, tm = _campaign_pair()
    x = _states_near(tm, 15, 1).reshape(3, 5, -1)
    ref = jax.vmap(jax.vmap(lambda s: jm.get_jacobians(s, dt=dt)))(
        jnp.asarray(x))
    got = tm.get_jacobians(torch.as_tensor(x), dt=dt)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-10 * max(1.0, np.abs(r).max()))
    idx = tpwl_select(torch.as_tensor(x.reshape(15, -1)), tm.q, tm.v,
                      tm.A_c, tm.B_c, tm.d_c, tm.dist_w_q, tm.dist_w_v)[0]
    ref_idx = jax.vmap(jm.calc_nearest_point)(jnp.asarray(x.reshape(15, -1)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))


def test_get_jacobians_weighting_matches_jax():
    jm, tm = _campaign_pair(tpwl_method="weighting", beta_weighting=3.0)
    x = _states_near(tm, 6, 2)
    x[0] = torch.cat([tm.v[4], tm.q[4]]).numpy()  # distance 0: one-hot
    w_ref = jax.vmap(jm.calc_weighting_factors)(jnp.asarray(x))
    np.testing.assert_allclose(
        tm.calc_weighting_factors(torch.as_tensor(x)).numpy(),
        np.asarray(w_ref), rtol=0, atol=1e-12)
    for dt in (None, 0.01):
        ref = jax.vmap(lambda s: jm.get_jacobians(s, dt=dt))(jnp.asarray(x))
        got = tm.get_jacobians(torch.as_tensor(x), dt=dt)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                       atol=1e-10 * np.abs(r).max())


def test_rollout_update_state_and_characteristic_dx():
    jm, tm = _campaign_pair()
    rng = np.random.default_rng(4)
    u = 750.0 * (1.0 + np.sin(rng.uniform(0, 6, size=(6, 4))))
    x0 = _states_near(tm, 1, 3)[0]
    for dt in (0.01, 0.02):
        xr, zr = jm.rollout(jnp.asarray(x0), jnp.asarray(u), dt)
        xg, zg = tm.rollout(x0, u, dt)
        scale = np.abs(np.asarray(xr)).max()
        np.testing.assert_allclose(xg.numpy(), np.asarray(xr), rtol=0,
                                   atol=1e-9 * scale)
        np.testing.assert_allclose(zg.numpy(), np.asarray(zr), rtol=0,
                                   atol=1e-9 * np.abs(np.asarray(zr)).max())
    np.testing.assert_allclose(tm.get_characteristic_dx(0.01).numpy(),
                               np.asarray(jm.get_characteristic_dx(0.01)),
                               rtol=1e-10)


def test_tpwl_adapter_matches_jax():
    jm, tm = _campaign_pair()
    ja, ta = JaxAdapter(jm), TPWLGuSTO(tm)
    assert (ta.n_x, ta.n_u, ta.n_z) == (ja.n_x, ja.n_u, ja.n_z) == (60, 4, 3)
    x = _states_near(tm, 5, 6)
    u = np.random.default_rng(6).uniform(0, 1500, size=(5, 4))
    ref = jax.vmap(ja.get_continuous_dynamics)(jnp.asarray(x),
                                               jnp.asarray(u))
    got = ta.get_continuous_dynamics(torch.as_tensor(x), torch.as_tensor(u))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-10 * np.abs(r).max())
    ref = jax.vmap(lambda a, b: ja.get_discrete_dynamics(a, b, 0.01))(
        jnp.asarray(x), jnp.asarray(u))
    got = ta.get_discrete_dynamics(torch.as_tensor(x), torch.as_tensor(u),
                                   0.01)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    for g, r in zip(ta.get_characteristic_vals(),
                    ja.get_characteristic_vals()):
        np.testing.assert_allclose(g, r, rtol=1e-12)


def test_make_demo_tpwl_matches_jax():
    kw = dict(r=4, P=16, m=2, nz=3, nf=12, seed=5, dtype=np.float64)
    jm, tm = jax_demo(**kw), make_demo_tpwl(device="cpu", **kw)
    for k in ("q", "v", "u", "A_c", "B_c", "d_c", "H", "z_ref", "C",
              "y_ref"):
        np.testing.assert_allclose(getattr(tm, k).numpy(),
                                   np.asarray(getattr(jm, k)), rtol=0,
                                   atol=1e-13, err_msg=k)
    assert (tm.dist_w_q, tm.dist_w_v, tm.discr_method) == (10.0, 1.0, "zoh")


def test_dubins_matches_jax():
    jd, td = JaxDubins(), DubinsCar(device="cpu")
    rng = np.random.default_rng(8)
    x, u = rng.normal(size=(7, 3)), rng.normal(size=(7, 2))
    ref = jax.vmap(jd.get_continuous_dynamics)(jnp.asarray(x),
                                               jnp.asarray(u))
    got = td.get_continuous_dynamics(torch.as_tensor(x), torch.as_tensor(u))
    ref_d = jax.vmap(lambda a, b: jd.get_discrete_dynamics(a, b, 0.1))(
        jnp.asarray(x), jnp.asarray(u))
    got_d = td.get_discrete_dynamics(x, u, 0.1)
    for g, r in zip(got + got_d, ref + ref_d):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-15)
    np.testing.assert_allclose(td.rollout(x[0], u, 0.1).numpy(),
                               np.asarray(jd.rollout(x[0], u, 0.1)), rtol=0,
                               atol=1e-14)
    assert (td.n_x, td.n_u, td.n_z) == (3, 2, 3)
    np.testing.assert_array_equal(td.get_characteristic_vals()[0],
                                  jd.get_characteristic_vals()[0])


def test_polyhedron_contains_violation_project():
    rng = np.random.default_rng(9)
    A, b = rng.normal(size=(6, 3)), rng.uniform(0.5, 1.0, 6)
    jp, tp = jcons.Polyhedron(A, b), tcons.Polyhedron(A, b)
    x = 2.0 * rng.normal(size=(2, 5, 3))
    np.testing.assert_array_equal(
        tp.contains(torch.as_tensor(x)).numpy(),
        np.asarray(jp.contains(jnp.asarray(x))))
    np.testing.assert_allclose(tp.violation(torch.as_tensor(x)).numpy(),
                               np.asarray(jp.violation(jnp.asarray(x))),
                               rtol=0, atol=1e-14)
    box_j = jcons.HyperRectangle([1.0, 2.0], [-1.0, 0.0])
    box_t = tcons.HyperRectangle([1.0, 2.0], [-1.0, 0.0])
    for pt in ([2.0, -1.0], [0.3, 1.0]):
        ref = np.asarray(box_j.project(jnp.asarray(pt)))
        got = box_t.project(torch.tensor(pt, dtype=torch.float64))
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-8)
    np.testing.assert_allclose(box_t.project(torch.tensor([2.0, -1.0],
                                                          dtype=torch.float64)
                                             ).numpy(), [1.0, 0.0],
                               atol=1e-8)


def test_linear_rom_matches_jax(tmp_path):
    """The campaign dictionary's first discrete point at its own dt, saved
    and loaded back; and the ZOH of a continuous point (the synthetic
    model's: the campaign's is too stiff for a ZOH) at another."""
    Cf, Hf = campaign_output_maps()
    path = str(tmp_path / "lin.pkl")
    data = jlin.tpwl_to_linear_rom(CAMPAIGN)
    tlin.tpwl_to_linear_rom(CAMPAIGN, save_path=path)
    assert os.path.exists(path)
    jl = jlin.LinearROM(data, 0.01, Cf=Cf, Hf=Hf)
    tl = tlin.LinearROM(path, 0.01, Cf=Cf, Hf=Hf, device="cpu")
    for k in ("A_d", "B_d", "d_d", "C", "y_ref", "H", "z_ref"):
        r = np.asarray(getattr(jl, k))
        np.testing.assert_allclose(getattr(tl, k).numpy(), r, rtol=0,
                                   atol=1e-10 * max(1, np.abs(r).max()),
                                   err_msg=k)
    u = np.full((5, 4), 600.0)
    xr, zr = jl.rollout(jnp.zeros(60), jnp.asarray(u))
    xg, zg = tl.rollout(np.zeros(60), u)
    np.testing.assert_allclose(xg.numpy(), np.asarray(xr), rtol=0,
                               atol=1e-9 * np.abs(np.asarray(xr)).max())
    np.testing.assert_allclose(zg.numpy(), np.asarray(zr), rtol=0,
                               atol=1e-9 * np.abs(np.asarray(zr)).max())
    assert (tl.state_dim, tl.input_dim, tl.get_output_dim()) == (60, 4, 3)
    demo = jax_demo(r=4, P=3, m=2, nz=3, nf=12, dtype=np.float64)
    d64 = {k: np.asarray(getattr(demo, k)) for k in ("A_c", "B_c", "d_c")}
    d64["rom_info"] = {"type": "POD", "U": np.asarray(demo.rom.U),
                       "q_ref": np.asarray(demo.rom.q_ref),
                       "v_ref": np.asarray(demo.rom.v_ref)}
    d64 = jlin.tpwl_to_linear_rom(d64)
    jz = jlin.LinearROM(d64, 0.02)
    tz = tlin.LinearROM(d64, 0.02, device="cpu")
    for k in ("A_d", "B_d", "d_d"):
        r = np.asarray(getattr(jz, k))
        np.testing.assert_allclose(getattr(tz, k).numpy(), r, rtol=0,
                                   atol=1e-9 * np.abs(r).max(), err_msg=k)


def test_cost_and_target_containers(tmp_path):
    c = QuadraticCost(Q=np.eye(3), R=np.eye(2))
    assert repr(c) == "QuadraticCost(Q=(3, 3), R=(2, 2), Qf=None)"
    path = str(tmp_path / "t.pkl")
    save_data(path, {"t": np.arange(3.0), "z": np.ones((3, 2)), "u": None})
    tgt = load_target_file(path)
    assert isinstance(tgt, Target)
    np.testing.assert_array_equal(tgt.z, np.ones((3, 2)))
    assert tgt.u is None and tgt.Hf is None
