"""The tet-FEM plant of the port (sim/fem_tet.py, sim/modal.py,
tasks/plant_validation.py, the tet robots) against the JAX package, in
f64 on the CPU, from the same numpy seeds.

The plant is tests/test_fem_tet.py:51-61's box (make_box_mesh(3, 3, 5),
its two cables and fixed base). Each package builds it from the same
arrays; the dynamics tests run the port on the JAX plant's own leaves
(`models/convert.py:tet_fem_from_arrays`), so that they compare the
methods and not two eigendecompositions. JAX's PCG iteration counts are
read by wrapping `jax.lax.while_loop` around eager calls. The Diamond
recipe chain runs on a small box placed in the Diamond's scene (written
as a .vtu and read by both packages' robots). No test reads files from
outside the repository. Tolerances are stated beside each assertion.
"""

import os
import pickle

import numpy as np
import pytest
import scipy.io as sio
import torch

import jax
import jax.numpy as jnp

from soft_robot_control_tpu.robots.robots import DiamondTetRobot as JDiamond
from soft_robot_control_tpu.rom.pod import POD as JPOD
from soft_robot_control_tpu.sim import fem_tet as J
from soft_robot_control_tpu.sim import modal as jmodal
from soft_robot_control_tpu.tasks import plant_validation as jval
from soft_robot_control_tpu.tasks import recipes as jrec
from soft_robot_control_tpu_torch.models.convert import (tet_fem_arrays,
                                                         tet_fem_from_arrays)
from soft_robot_control_tpu_torch.robots.robots import (DiamondTetRobot,
                                                        TetMeshRobot,
                                                        TrunkTetRobot)
from soft_robot_control_tpu_torch.rom.pod import POD
from soft_robot_control_tpu_torch.sim import fem_tet as P
from soft_robot_control_tpu_torch.sim import modal as tmodal
from soft_robot_control_tpu_torch.tasks import plant_validation as tval
from soft_robot_control_tpu_torch.tasks import recipes as trec
from soft_robot_control_tpu_torch.utils.device import to_numpy

import torch_helpers  # noqa: F401  (single-threaded torch)
from tet_box import box_cables, box_plant


def _np(a):
    return to_numpy(a) if torch.is_tensor(a) else np.asarray(a)


def _rel(got, ref):
    """max |got - ref| over max(max |ref|, 1e-300)."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.fixture(scope="module")
def mesh():
    return J.make_box_mesh(3, 3, 5, spacing=10.0)


@pytest.fixture(scope="module")
def jplant():
    return box_plant(J)


@pytest.fixture(scope="module")
def built():
    """The port's own build of the box."""
    return box_plant(P, device="cpu")


@pytest.fixture(scope="module")
def plant(jplant):
    """The port's plant on the JAX plant's leaves."""
    return tet_fem_from_arrays(tet_fem_arrays(jplant), device="cpu")


@pytest.fixture
def jax_iters(monkeypatch):
    """The iteration counts of the JAX PCG loops the test runs, in order:
    the final carry's k of each `jax.lax.while_loop`, reported by a
    `jax.debug.callback` (so also from inside jit, scan and vmap, where
    it is the array of every lane's count)."""
    real, seen = jax.lax.while_loop, []

    def counted(cond, body, init):
        out = real(cond, body, init)
        jax.debug.callback(lambda k: seen.append(np.asarray(k).tolist()),
                           out[0])
        return out

    monkeypatch.setattr(jax.lax, "while_loop", counted)
    return seen


def _state(p, rng, dq=0.3, dv=2.0):
    """A seeded state about the equilibrium, numpy (2n,)."""
    n3 = p.n_nodes_dof
    fm = _np(p.free_mask)
    q = _np(p.q_eq) + dq * rng.normal(size=n3) * fm
    v = dv * rng.normal(size=n3) * fm
    return np.concatenate([v, q])


# --------------------------------------------------------------------------
# mesh IO


def _write_vtk(path, pts, tets, binary):
    """A legacy .vtk as Gmsh writes it: ASCII or big-endian BINARY."""
    cells = np.hstack([np.full((len(tets), 1), 4), tets]).astype(">i4")
    with open(path, "wb") as f:
        f.write(b"# vtk DataFile Version 2.0\nbox\n"
                + (b"BINARY\n" if binary else b"ASCII\n")
                + b"DATASET UNSTRUCTURED_GRID\n"
                + f"POINTS {len(pts)} double\n".encode())
        f.write(pts.astype(">f8").tobytes() if binary else
                "\n".join(" ".join(repr(float(c)) for c in p)
                          for p in pts).encode() + b"\n")
        f.write(f"\nCELLS {len(tets)} {cells.size}\n".encode())
        f.write(cells.tobytes() if binary else "\n".join(
            " ".join(str(int(c)) for c in row) for row in cells).encode())
        f.write(f"\nCELL_TYPES {len(tets)}\n".encode())
        types = np.full(len(tets), 10, dtype=">i4")
        f.write(types.tobytes() if binary else
                "\n".join(["10"] * len(tets)).encode())
        f.write(b"\n")


@pytest.mark.parametrize("fmt", ["vtu", "vtk_ascii", "vtk_binary"])
def test_loaders_read_written_meshes_as_jax_does(mesh, tmp_path, fmt):
    """The .vtu (written by the port's write_vtu_ascii) and legacy .vtk
    files of a box with a non-tet cell appended: both packages' loaders
    give the box's points (exact) and tets (exact, int32)."""
    pts, tets = mesh
    pts = pts + np.array([0.125, -3.5, 7.0])
    path = str(tmp_path / f"box.{fmt[:3]}")
    if fmt == "vtu":
        P.write_vtu_ascii(path, pts, tets)
        jl, tl = J.load_vtu_ascii, P.load_vtu_ascii
    else:
        _write_vtk(path, pts, tets, binary=fmt == "vtk_binary")
        jl, tl = J.load_vtk_legacy, P.load_vtk_legacy
    (pj, cj), (pt, ct) = jl(path), tl(path)
    assert np.array_equal(pt, pts) and np.array_equal(pj, pts)
    assert ct.dtype == cj.dtype == np.int32
    assert np.array_equal(ct, tets) and np.array_equal(cj, tets)


def test_transform_and_cables_are_the_jax_packages(mesh):
    """transform_mesh, the Diamond and Trunk cables and the cable columns
    of the box: exact."""
    pts, tets = mesh
    for rot, tr in (((90.0, 0.0, 0.0), (0.0, 0.0, 35.0)),
                    ((10.0, -20.0, 30.0), (1.0, 2.0, 3.0))):
        assert np.array_equal(P.transform_mesh(pts, rot, tr),
                              J.transform_mesh(pts, rot, tr))
    for jc, tc in ((J.diamond_cables(), P.diamond_cables()),
                   (J.trunk_cables(), P.trunk_cables())):
        assert len(jc) == len(tc)
        for a, b in zip(jc, tc):
            assert sorted(a) == sorted(b)
            for k in a:
                assert np.array_equal(a[k], b[k])
    t2, _, _ = J._tet_precompute(pts, tets)
    for c in box_cables() + P.diamond_cables():
        assert np.array_equal(
            P._cable_column(pts, t2, c["waypoints"], c.get("pull_point")),
            J._cable_column(pts, t2, c["waypoints"], c.get("pull_point")))


# --------------------------------------------------------------------------
# the build


def test_built_leaves_are_the_jax_packages(jplant, built):
    """Every leaf of the port's build: the element indices, masks, mesh
    arrays, gravity and scalars exact; Ke, K0, H and the eigenvalues
    within 1e-12 of their scale; the preconditioner's operator S_q
    diag(1/S_lam) S_q^T within 1e-12 of its scale (S_q itself is not
    unique: the fixed dofs share one eigenvalue)."""
    leaves, aux = jplant.tree_flatten()
    assert (built.dt, built.cg_iters, built.cg_tol) == aux
    exact = ("rest_pos", "tets", "Bm", "vol", "m_node", "alpha", "beta",
             "free_mask", "g_full", "q_eq")
    got = P._leaf_arrays(built)
    for name, ref in zip(P.LEAVES, leaves):
        ref = np.asarray(ref)
        assert got[name].dtype == ref.dtype and got[name].shape == ref.shape
        if name in exact:
            assert np.array_equal(got[name], ref), name
        elif name != "S_q":
            assert _rel(got[name], ref) <= 1e-12, name

    def op(p):
        return (_np(p.S_q) / _np(p.S_lam)) @ _np(p.S_q).T

    assert _rel(op(built), op(jplant)) <= 1e-12
    assert built.device.type == "cpu" and built.dtype == torch.float64


def test_element_stiffness_is_the_jax_packages(mesh):
    """_element_stiffness (jacfwd of the linear element force) on a
    sheared box at other moduli: within 1e-12 of the scale, symmetric."""
    pts, tets = mesh
    rng = np.random.default_rng(5)
    pts = pts + rng.normal(size=pts.shape)
    t2, Bm, vol = J._tet_precompute(pts, tets)
    args = (pts.reshape(-1), t2, Bm, vol, 31.0, 270.0)
    Kt, Kj = P._element_stiffness(*args), J._element_stiffness(*args)
    assert _rel(Kt, Kj) <= 1e-12
    assert np.array_equal(Kt, np.swapaxes(Kt, 1, 2))


# --------------------------------------------------------------------------
# forces and tangents


def test_forces_and_tangents_are_the_jax_packages(jplant, plant):
    """f_int, force, f, kt_frozen_matvec (one vector and columns) and
    kt_matvec (jvp through the polar iteration; one vector and columns) at
    seeded states: within 1e-12 of their scale."""
    rng = np.random.default_rng(0)
    n3 = plant.n_nodes_dof
    x = _state(plant, rng, dq=0.5)
    q, v = x[n3:], x[:n3]
    u = np.array([30.0, 12.0])
    W = rng.normal(size=(3, n3))
    jq = jnp.asarray(q)
    jR = jplant.rotations(jq)
    tR = plant.rotations(_t(q))
    assert _rel(tR, jR) <= 1e-12
    assert _rel(plant.node_rotations(tR), jplant.node_rotations(jR)) <= 1e-12
    assert _rel(plant.f_int(_t(q)), jplant.f_int(jq)) <= 1e-12
    assert _rel(plant.force(_t(q), _t(v), _t(u)),
                jplant.force(jq, jnp.asarray(v), jnp.asarray(u))) <= 1e-12
    assert _rel(plant.f(_t(x), _t(u)),
                jplant.f(jnp.asarray(x), jnp.asarray(u))) <= 1e-12
    kf = np.asarray(jax.vmap(lambda w: jplant.kt_frozen_matvec(w, jR))(
        jnp.asarray(W)))
    assert _rel(plant.kt_frozen_matvec(_t(W[0]), tR), kf[0]) <= 1e-12
    assert _rel(plant.kt_frozen_matvec(_t(W), tR), kf) <= 1e-12
    kt = np.asarray(jax.vmap(lambda w: jplant.kt_matvec(jq, w))(
        jnp.asarray(W)))
    assert _rel(plant.kt_matvec(_t(q), _t(W[0])), kt[0]) <= 1e-12
    assert _rel(plant.kt_matvec(_t(q), _t(W)), kt) <= 1e-12


def test_rest_is_an_equilibrium_and_forces_rotate(plant):
    """The port's own invariants (tests/test_fem_tet.py:64-93): zero force
    at rest (1e-8), f(R q) = R f(q) for a rigid rotation (1e-8)."""
    assert float(plant.f_int(plant.rest_pos).abs().max()) < 1e-8
    free = copy_with_all_free(plant)
    rng = np.random.default_rng(0)
    q = _np(free.rest_pos) + 0.5 * rng.normal(size=free.n_nodes_dof)
    th = 0.7
    Rz = np.array([[np.cos(th), -np.sin(th), 0.0],
                   [np.sin(th), np.cos(th), 0.0], [0.0, 0.0, 1.0]])
    f = _np(free.f_int(_t(q))).reshape(-1, 3)
    fR = _np(free.f_int(_t((q.reshape(-1, 3) @ Rz.T).reshape(-1))))
    np.testing.assert_allclose(fR.reshape(-1, 3), f @ Rz.T, rtol=1e-8,
                               atol=1e-8)


def copy_with_all_free(p):
    arrays = tet_fem_arrays(p)
    arrays["free_mask"] = np.ones_like(arrays["free_mask"])
    return tet_fem_from_arrays(arrays, device="cpu")


# --------------------------------------------------------------------------
# the PCG step


def test_twenty_steps_are_the_jax_packages(jplant, plant, built, jax_iters):
    """20 steps from the equilibrium under seeded cable inputs: the states
    within 1e-10 of their scale and the same PCG iterations each step, for
    the port on the JAX leaves and for the port's own build."""
    rng = np.random.default_rng(1)
    us = 40.0 * rng.random((20, 2))
    x0 = np.asarray(jplant.x_rest())

    def jstep(x, u):
        x = jplant.step(x, u, jplant.dt)
        return x, x

    XJ = np.asarray(jax.jit(lambda x, u: jax.lax.scan(jstep, x, u)[1])(
        jnp.asarray(x0), jnp.asarray(us)))
    xt, xb = _t(x0), _t(x0)
    its, its_b = [], []
    for u, xj in zip(us, XJ):
        xt, k = plant.step_iters(xt, _t(u), plant.dt)
        xb, kb = built.step_iters(xb, _t(u), built.dt)
        its.append(int(k))
        its_b.append(int(kb))
        assert _rel(xt, xj) <= 1e-10 and _rel(xb, xj) <= 1e-10
    assert its == jax_iters == its_b
    assert max(its) > 1


def test_batched_step_is_each_lane_alone(jplant, plant, jax_iters):
    """A batch of 4 states (one at rest with zero input, which takes no
    iteration: nr0 = 0): each lane within 1e-10 of the state's scale of
    its step alone and of JAX's (the batch's products sum in another
    order), with the iterations it takes alone, which are JAX's but at
    rest: the port's closed-form polar factor of F = I is I
    exactly, so f_int(rest) = 0 and the rhs is 0, where JAX's LU inverse
    leaves a rounding residual that takes it one iteration."""
    rng = np.random.default_rng(2)
    X = np.stack([_state(plant, rng), _state(plant, rng, dq=1.0, dv=8.0),
                  np.asarray(jplant.x_rest()), _state(plant, rng, dq=0.05)])
    Uin = np.array([[10.0, 5.0], [300.0, 0.0], [0.0, 0.0], [0.0, 40.0]])
    # lane 2 at rest: no gravity on the box, f_int(rest) = 0 exactly
    assert float(plant.g_full.abs().max()) == 0.0
    xb, kb = plant.step_iters(_t(X), _t(Uin), plant.dt)
    alone = [plant.step_iters(_t(x), _t(u), plant.dt)
             for x, u in zip(X, Uin)]
    for i, (x1, k1) in enumerate(alone):
        assert int(kb[i]) == int(k1)
        assert _rel(xb[i], x1) <= 1e-10
        assert _rel(xb[i], jplant.step(jnp.asarray(X[i]),
                                       jnp.asarray(Uin[i]), plant.dt)) \
            <= 1e-10
    kj = jax_iters
    assert [k for i, k in enumerate(kb.tolist()) if i != 2] == \
        [k for i, k in enumerate(kj) if i != 2]
    assert int(kb[2]) == 0 and kj[2] <= 1 and len(set(kb.tolist())) > 2
    assert np.array_equal(_np(xb[2]), X[2])


def test_solve_st_multi_runs_every_column_to_the_slowest(jplant, plant,
                                                         jax_iters):
    """solve_st_multi on columns of very different difficulty: within
    1e-12 of JAX's, the same iteration count, which is the slowest
    column's; a column solved alone stops earlier (so the block kept it
    iterating, as in JAX)."""
    rng = np.random.default_rng(3)
    n3 = plant.n_nodes_dof
    x = _state(plant, rng, dq=0.3)
    q = x[n3:]
    fm = _np(plant.free_mask)
    Bc = np.stack([rng.normal(size=n3) * fm, _np(plant.H[:, 0]),
                   plant.m_node * _np(plant.q_eq) * fm], axis=1)
    R = plant.rotations(_t(q))
    Rn = plant.node_rotations(R)
    jR = jplant.rotations(jnp.asarray(q))
    Xj = jplant.solve_st_multi(jnp.asarray(Bc), jR,
                               jplant.node_rotations(jR))
    Xt, k = plant.solve_st_multi_iters(_t(Bc), R, Rn)
    assert _rel(Xt, Xj) <= 1e-12
    assert [int(k)] == jax_iters
    alone = [int(plant.solve_st_multi_iters(_t(Bc[:, j:j + 1]), R, Rn)[1])
             for j in range(Bc.shape[1])]
    assert int(k) == max(alone) and min(alone) < int(k)


# --------------------------------------------------------------------------
# the projections and the dense Jacobians


@pytest.fixture(scope="module")
def rom_pair(plant):
    rng = np.random.default_rng(4)
    n3 = plant.n_nodes_dof
    U, _ = np.linalg.qr(rng.normal(size=(n3, 6)))
    info = {"U": U, "q_ref": _np(plant.q_eq), "v_ref": np.zeros(n3)}
    return JPOD(info), POD(info, device="cpu")


@pytest.mark.parametrize("given_next", [False, True])
def test_reduced_discrete_dynamics_is_the_jax_packages(jplant, plant,
                                                       rom_pair, given_next):
    """(A_d, B_d, d_d) at a seeded point, with x_next_r from one plant
    step (None) or given: within 1e-10 of their scale; exact at the point
    (A_d x_r + B_d u + d_d = the projected step, 1e-9)."""
    jrom, trom = rom_pair
    rng = np.random.default_rng(5)
    x = _state(plant, rng, dq=0.2, dv=0.5)
    u = np.array([40.0, 15.0])
    xn = np.asarray(jrom.project_x(jplant.step(jnp.asarray(x),
                                               jnp.asarray(u), plant.dt)))
    xnr = 1.01 * xn if given_next else None
    got = plant.reduced_discrete_dynamics(trom, _t(x), _t(u), plant.dt,
                                          x_next_r=None if xnr is None
                                          else _t(xnr))
    ref = jplant.reduced_discrete_dynamics(
        jrom, jnp.asarray(x), jnp.asarray(u), plant.dt,
        x_next_r=None if xnr is None else jnp.asarray(xnr))
    for g, r in zip(got, ref):
        assert _rel(g, r) <= 1e-10
    A, B, d = (_np(a) for a in got)
    want = xn if xnr is None else xnr
    pred = A @ _np(trom.project_x(_t(x))) + B @ u + d
    assert np.abs(pred - want).max() <= 1e-9 * np.abs(want).max()


def test_reduced_affine_dynamics_is_the_jax_packages(jplant, plant,
                                                     rom_pair):
    """(A_r, B_r, d_r) at two seeded points, one at a time and as a batch
    of points (the TPWL build's call): within 1e-10 of JAX's."""
    jrom, trom = rom_pair
    rng = np.random.default_rng(6)
    X = np.stack([_state(plant, rng), _state(plant, rng, dq=0.6)])
    Uin = np.array([[25.0, 10.0], [0.0, 60.0]])
    batch = plant.reduced_affine_dynamics(trom, _t(X), _t(Uin))
    for i in range(2):
        ref = jplant.reduced_affine_dynamics(jrom, jnp.asarray(X[i]),
                                             jnp.asarray(Uin[i]))
        one = plant.reduced_affine_dynamics(trom, _t(X[i]), _t(Uin[i]))
        for b, g, r in zip(batch, one, ref):
            assert _rel(g, r) <= 1e-10 and _rel(b[i], r) <= 1e-10


def test_dense_jacobians_are_the_jax_packages_and_guarded(jplant, plant):
    """jacobians at a seeded point (and a batch of two): within 1e-10 of
    JAX's (A, B, d); past 400 nodes both raise NotImplementedError."""
    rng = np.random.default_rng(7)
    X = np.stack([_state(plant, rng), _state(plant, rng, dq=0.1)])
    u = np.array([[20.0, 5.0], [1.0, 2.0]])
    ref = jplant.jacobians(jnp.asarray(X[0]), jnp.asarray(u[0]))
    got = plant.jacobians(_t(X[0]), _t(u[0]))
    both = plant.jacobians(_t(X), _t(u))
    for g, b, r in zip(got, both, ref):
        assert _rel(g, r) <= 1e-10 and _rel(b[0], r) <= 1e-10
    big = tet_fem_arrays(plant)
    big["rest_pos"] = np.zeros(3 * 401)
    with pytest.raises(NotImplementedError, match="reduced_affine"):
        tet_fem_from_arrays(big, device="cpu").jacobians(
            np.zeros(6 * 401), np.zeros(2))
    jbig = J.TetFEM.tree_unflatten(
        jplant.tree_flatten()[1],
        [jnp.zeros(3 * 401)] + list(jplant.tree_flatten()[0][1:]))
    with pytest.raises(NotImplementedError, match="reduced_affine"):
        jbig.jacobians(jnp.zeros(6 * 401), jnp.zeros(2))


# --------------------------------------------------------------------------
# settle, Young's modulus scale, the cache


@pytest.fixture(scope="module")
def settled():
    """Both packages' builds under gravity with a 0.2 s settle."""
    kw = dict(gravity=(0.0, 0.0, -9810.0), settle_time=0.2)
    return box_plant(J, **kw), box_plant(P, device="cpu", **kw)


def test_gravity_settle_is_the_jax_packages(settled):
    """q_eq after the settle (20 PCG steps through the port's simulate):
    within 1e-10 of JAX's, moved from the rest positions."""
    jp, tp = settled
    assert _rel(tp.q_eq, jp.q_eq) <= 1e-10
    assert float((tp.q_eq - tp.rest_pos).abs().max()) > 1e-3


@pytest.mark.parametrize("alpha,settle", [(None, 0.0), (0.8, 0.1)])
def test_with_young_scale_is_the_jax_packages(settled, alpha, settle):
    """with_young_scale(s=1.3): Ke, K0 and S_lam within 1e-12, alpha
    exact, q_eq (the settle from the rest positions, or kept) within
    1e-10 of JAX's; the plant it came from unchanged."""
    jp, tp = settled
    ke0 = tp.Ke.clone()
    jn = J.with_young_scale(jp, 1.3, alpha=alpha, settle_time=settle)
    tn = P.with_young_scale(tp, 1.3, alpha=alpha, settle_time=settle)
    for k in ("Ke", "K0", "S_lam"):
        assert _rel(getattr(tn, k), getattr(jn, k)) <= 1e-12, k
    assert tn.alpha == float(jn.alpha)
    assert _rel(tn.q_eq, jn.q_eq) <= 1e-10
    assert torch.equal(tp.Ke, ke0)


def test_with_young_scale_is_a_build_at_the_scaled_modulus():
    """tests/test_plant_validation.py:58-83's identity on the port: the
    step matrix of with_young_scale(s = 1.37) equals a fresh build's at
    1.37 x young on the free dofs (the mass is a multiple of I, so S(s)
    shares K0's eigenvectors; 1e-8 relative, 1e-10 absolute), Ke and K0
    too."""
    pts, tets = P.make_box_mesh(2, 2, 3, spacing=8.0)
    cab = [{"waypoints": np.asarray([[4.0, 4.0, 16.0]]),
            "pull_point": np.asarray([4.0, 4.0, 0.0])}]
    kw = dict(poisson=0.4, total_mass=0.05, alpha=1.0, beta=0.02,
              fixed_box=(-100, -100, -1, 100, 100, 1), cables=cab,
              dt=0.01, device="cpu")
    p1 = P.build_tet_fem(pts, tets, young=100.0, **kw)
    p2 = P.build_tet_fem(pts, tets, young=137.0, **kw)
    ps = P.with_young_scale(p1, 1.37)

    fm = _np(p1.free_mask).astype(bool)
    S2 = precond_inverse(p2)[np.ix_(fm, fm)]
    Ss = precond_inverse(ps)[np.ix_(fm, fm)]
    assert np.allclose(S2, Ss, rtol=1e-8, atol=1e-10)
    assert np.allclose(_np(ps.Ke), _np(p2.Ke))
    assert np.allclose(_np(ps.K0), _np(p2.K0))


def precond_inverse(p):
    """The step matrix S = S_q diag(S_lam) S_q^T (the preconditioner's
    inverse), numpy."""
    return (_np(p.S_q) * _np(p.S_lam)[None]) @ _np(p.S_q).T


def test_plant_cache_round_trip_eviction_and_jax_files(jplant, built,
                                                       tmp_path):
    """The port's cache file round-trips every leaf exactly; a file the
    JAX package writes loads into the port (leaves exact, the same step
    within 1e-12); a truncated file is evicted with a warning."""
    path = str(tmp_path / "p.npz")
    P._save_plant(built, path)
    back = P._load_plant(path, device="cpu")
    a, b = P._leaf_arrays(built), P._leaf_arrays(back)
    for k in P.LEAVES:
        assert np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype, k
    assert (back.dt, back.cg_iters, back.cg_tol) == (
        built.dt, built.cg_iters, built.cg_tol)
    jpath = str(tmp_path / "j.npz")
    J._save_plant(jplant, jpath)
    fromj = P._load_plant_or_evict(jpath, device="cpu")
    leaves, aux = jplant.tree_flatten()
    c = P._leaf_arrays(fromj)
    for k, ref in zip(P.LEAVES, leaves):
        assert np.array_equal(c[k], np.asarray(ref)), k
    x = np.asarray(jplant.x_rest())
    u = np.array([50.0, 20.0])
    assert _rel(fromj.step(_t(x), _t(u), fromj.dt),
                jplant.step(jnp.asarray(x), jnp.asarray(u), jplant.dt)) \
        <= 1e-12
    with open(path, "r+b") as f:
        f.truncate(100)
    with pytest.warns(UserWarning, match="corrupt plant cache"):
        assert P._load_plant_or_evict(path, device="cpu") is None
    assert not os.path.exists(path)


def test_robots_build_from_a_mesh_file_through_the_cache(mesh, tmp_path,
                                                         monkeypatch):
    """Trunk and Diamond tet robots from written mesh files (the builder's
    arguments through the robot), and the cache used only for the
    reference mesh: a second build with mesh_path=None loads the first's
    file."""
    pts, tets = mesh
    vtk = str(tmp_path / "t.vtk")
    _write_vtk(vtk, pts - np.array([10.0, 10.0, 0.0]), tets, binary=True)
    tr = TrunkTetRobot(mesh_path=vtk, cache=False, gravity_on=False,
                       device="cpu")
    assert tr.plant.input_dim == 8 and tr.nb_nodes == len(pts)
    assert tr.get_output_model(nodes=[3]).shape == (3, 6 * len(pts))
    assert issubclass(TrunkTetRobot, TetMeshRobot)
    mesh_dir = tmp_path / "mesh"
    mesh_dir.mkdir()
    P.write_vtu_ascii(str(mesh_dir / "diamond.vtu"), pts, tets)
    monkeypatch.setattr(P, "REFERENCE_MESH_DIR", str(mesh_dir))
    monkeypatch.setattr(P, "PLANT_CACHE_DIR", str(tmp_path / "cache"))
    kw = dict(gravity_on=False, device="cpu", dtype=torch.float32)
    first = DiamondTetRobot(**kw)
    (name,) = os.listdir(tmp_path / "cache")
    assert name.endswith("_float32.npz") and first.plant.dtype == \
        torch.float32
    os.remove(mesh_dir / "diamond.vtu")  # the second build cannot read it
    second = DiamondTetRobot(**kw)
    a, b = P._leaf_arrays(first.plant), P._leaf_arrays(second.plant)
    assert all(np.array_equal(a[k], b[k]) for k in P.LEAVES)


# --------------------------------------------------------------------------
# modal analysis


def test_mode_shapes_are_the_jax_packages(jplant, plant):
    """Frequencies within 1e-10 of their scale, modes within 1e-8 up to
    sign (the box's symmetric modes come in pairs of near-equal frequency,
    so only the well-separated ones are compared as vectors)."""
    wj, Pj = jmodal.mode_shapes(jplant, n_modes=6)
    wt, Pt = tmodal.mode_shapes(plant, n_modes=6)
    assert _rel(wt, wj) <= 1e-10
    gap = np.diff(wj) > 1e-6 * wj.max()
    single = np.concatenate([[gap[0]], gap[1:] & gap[:-1], [gap[-1]]])
    assert single.any()
    s = np.sign(np.sum(Pj * Pt, axis=0))
    assert _rel((Pt * s)[:, single], Pj[:, single]) <= 1e-8


def test_modal_decay_batch_is_the_jax_packages_and_resumes(jplant, plant,
                                                           tmp_path):
    """Two modes x one amplitude x two signs for 0.1 s as one batched
    simulation: each case within 1e-10 of JAX's; with save_dir, the files
    are written, a second call skips them and loads them back."""
    _, modes = tmodal.mode_shapes(plant, n_modes=2)
    kw = dict(amplitudes=[2.0], duration=0.1, dt=plant.dt)
    ref = jmodal.modal_decay_batch(jplant, modes.T, **kw)
    got = tmodal.modal_decay_batch(plant, modes.T, save_dir=str(tmp_path),
                                   **kw)
    assert sorted(got) == sorted(ref) and len(got) == 4
    for k in ref:
        assert _rel(got[k], ref[k]) <= 1e-10, k
    again = tmodal.modal_decay_batch(plant, modes, save_dir=str(tmp_path),
                                     **kw)
    assert all(np.array_equal(again[k], got[k]) for k in got)
    assert len(os.listdir(tmp_path)) == 4


def test_modal_decay_runs_every_case_in_one_batched_simulation(plant,
                                                               monkeypatch):
    """modal_decay_batch makes one simulate_batch call with every case."""
    calls = []
    real = tmodal.simulate_batch

    def spy(p, x0, u, dt):
        calls.append(tuple(x0.shape))
        return real(p, x0, u, dt)

    monkeypatch.setattr(tmodal, "simulate_batch", spy)
    _, modes = tmodal.mode_shapes(plant, n_modes=3)
    out = tmodal.modal_decay_batch(plant, modes.T, amplitudes=[1.0, 2.0],
                                   duration=0.02, dt=plant.dt)
    assert calls == [(12, plant.state_dim)] and len(out) == 12
    assert all(np.isfinite(v).all() for v in out.values())


def test_load_reference_modes_on_written_mat_files(tmp_path):
    """mode1-3.mat written with scipy.io.savemat: both packages load and
    rotate them alike (exact), with and without the scene transform."""
    rng = np.random.default_rng(8)
    for i in (1, 2, 3):
        sio.savemat(str(tmp_path / f"mode{i}.mat"),
                    {f"mode{i}": rng.normal(size=(3, 7))})
    for tr in (True, False):
        got = tmodal.load_reference_modes(str(tmp_path), transform=tr)
        assert got.shape == (3, 21)
        assert np.array_equal(
            got, jmodal.load_reference_modes(str(tmp_path), transform=tr))


# --------------------------------------------------------------------------
# plant validation


@pytest.fixture(scope="module")
def check_dir(tmp_path_factory, settled):
    """Written stand-ins of the recorded run (u_big.csv, z_big.csv: 31
    rows) and of SOFA's rest field (rest_qv.pkl: the settled plant's q_eq
    with a seeded perturbation)."""
    d = tmp_path_factory.mktemp("checkModel")
    rng = np.random.default_rng(9)
    T = 31
    np.savetxt(d / "u_big.csv", 50.0 * rng.random((T, 2)), delimiter=",")
    z = np.hstack([0.1 * rng.normal(size=(T, 3)),
                   40.0 + rng.normal(size=(T, 3))])
    np.savetxt(d / "z_big.csv", z, delimiter=",")
    q = _np(settled[1].q_eq)
    with open(d / "rest_qv.pkl", "wb") as f:
        pickle.dump({"rest": (q + 0.05 * rng.normal(size=q.shape),
                              np.zeros_like(q))}, f)
    return d


def test_plant_vs_sofa_on_written_files(settled, check_dir):
    """load_check_data and diamond_plant_vs_sofa (tip node 7, 20 steps, in
    chunks of 8): the loaded arrays exact, every number within 1e-10 of
    JAX's."""
    jp, tp = settled
    uj, zj = jval.load_check_data(str(check_dir))
    ut, zt = tval.load_check_data(str(check_dir))
    assert np.array_equal(ut, uj) and np.array_equal(zt, zj)
    kw = dict(n_steps=20, chunk=8, tip_node=7, data_path=str(check_dir))
    ref = jval.diamond_plant_vs_sofa(jp, **kw)
    got = tval.diamond_plant_vs_sofa(tp, **kw)
    assert sorted(got) == sorted(ref) and got["n_steps"] == 21
    for k, v in ref.items():
        assert np.allclose(got[k], v, rtol=1e-10, atol=1e-12), k


def test_calibrate_young_on_written_files(settled, check_dir):
    """load_sofa_rest and calibrate_diamond_young (2 secant iterations,
    0.05 s settles): the history, the scale and the plant's q_eq within
    1e-9 of JAX's."""
    jp, tp = settled
    qj, _ = jval.load_sofa_rest(str(check_dir / "rest_qv.pkl"))
    qt, _ = tval.load_sofa_rest(str(check_dir / "rest_qv.pkl"))
    assert np.array_equal(qt, qj)
    kw = dict(settle_time=0.05, iters=2,
              rest_path=str(check_dir / "rest_qv.pkl"))
    pj, ij = jval.calibrate_diamond_young(jp, **kw)
    pt, it = tval.calibrate_diamond_young(tp, **kw)
    assert len(it["history"]) == len(ij["history"]) == 2
    for hg, hr in zip(it["history"], ij["history"]):
        for k in hr:
            assert abs(hg[k] - hr[k]) <= 1e-9 * max(1.0, abs(hr[k])), k
    assert abs(it["scale"] - ij["scale"]) <= 1e-9
    assert _rel(pt.q_eq, pj.q_eq) <= 1e-9


def test_plant_validation_main_prints_the_summary(settled, check_dir,
                                                  monkeypatch, capsys):
    """main() on the CPU with its plant builder and data path replaced by
    the box and the written files: the summary's numbers are the
    function's."""
    _, tp = settled
    real = tval.diamond_plant_vs_sofa
    asked = []

    def run(plant=None, **kw):
        asked.append((plant, kw["dtype"], kw["device"]))
        return real(tp, n_steps=kw["n_steps"], tip_node=7,
                    data_path=str(check_dir))

    monkeypatch.setattr(tval, "diamond_plant_vs_sofa", run)
    out = tval.main(["--device", "cpu", "--steps", "5"])
    ref = real(tp, n_steps=5, tip_node=7, data_path=str(check_dir))
    assert asked == [(None, np.float64, "cpu")]
    assert out["n_steps"] == 6
    assert out["tip_rmse_mm"] == ref["tip_rmse_mm"]
    assert '"mse_ref_formula"' in capsys.readouterr().out


# --------------------------------------------------------------------------
# the Diamond recipe chain on a small box


@pytest.fixture(scope="module")
def diamond_chain(tmp_path_factory):
    """Both packages' Diamond tet robots on make_box_mesh(3, 5, 3) shifted
    by (-10, -30, -10) (written as a .vtu; in the Diamond's scene its
    y = -30 layer, 9 nodes, lies in the fixed box and the four cables snap
    to nodes), 0.2 s settle, output node 44 and measurement nodes 44, 20;
    then collect_pod_data (2 LHS samples, t_step 0.1) -> compute_pod_basis
    (pod_type 'a', r = 6) -> collect_tpwl_data (threshold 5, 2 samples,
    dynamics='discrete') -> tpwl_rollout_check (2 samples, seed 333)."""
    d = tmp_path_factory.mktemp("diamond_box")
    pts, tets = P.make_box_mesh(3, 5, 3)
    path = str(d / "box.vtu")
    P.write_vtu_ascii(path, pts - np.array([10.0, 30.0, 10.0]), tets)
    kw = dict(mesh_path=path, cache=False, settle_time=0.2)
    robots = {"j": JDiamond(dtype=np.float64, **kw),
              "t": DiamondTetRobot(device="cpu", dtype=np.float64, **kw)}
    out = {}
    for pkg, rec in (("j", jrec), ("t", trec)):
        r = robots[pkg]
        r.default_output_nodes = [44]
        r.default_measurement_nodes = [44, 20]
        sd = str(tmp_path_factory.mktemp(f"chain_{pkg}"))
        snap = rec.collect_pod_data(r, sd, nbr_samples=2, t_step=0.1)
        pod = rec.compute_pod_basis(sd, pod_tolerance=5e-5, pod_type="a",
                                    rom_dim=6)
        model = rec.collect_tpwl_data(r, sd, threshold=5.0, nbr_samples=2,
                                      t_step=0.1, dynamics="discrete")
        chk = rec.tpwl_rollout_check(r, sd, nbr_samples=2, seed=333,
                                     t_step=0.1)
        out[pkg] = dict(robot=r, snap=snap, pod=pod, model=model, chk=chk)
    return out


def test_diamond_box_robot_is_the_jax_packages(diamond_chain):
    """The small box in the Diamond's scene: 9 fixed nodes, four cable
    columns of unit force, q_eq within 1e-10 of JAX's."""
    jr, tr = diamond_chain["j"]["robot"], diamond_chain["t"]["robot"]
    p = tr.plant
    assert int((p.free_mask == 0).sum()) == 27 and p.input_dim == 4
    assert torch.allclose(p.H.reshape(-1, 3, 4).sum(0).norm(dim=0),
                          torch.ones(4, dtype=p.dtype))
    assert _rel(p.q_eq, jr.plant.q_eq) <= 1e-10
    assert np.array_equal(tr.get_measurement_model(),
                          np.asarray(jr.get_measurement_model()))


def test_diamond_chain_dictionary_is_the_jax_packages(diamond_chain):
    """The snapshots within 1e-10, the basis up to sign within 1e-8, the
    same dictionary steps and points, A_d, B_d, d_d (and the continuous
    A_c, B_c, d_c) within 1e-9 of their scale in the basis of the same
    signs, the rollout's z within 1e-8 of its scale and its MSE within
    1e-8 relative."""
    j, t = diamond_chain["j"], diamond_chain["t"]
    for k in ("q", "v", "q+", "v+"):
        assert _rel(np.asarray(t["snap"][k]), np.asarray(j["snap"][k])) \
            <= 1e-10, k
    Uj, Ut = j["pod"]["POD_info"]["U"], t["pod"]["POD_info"]["U"]
    s = np.sign(np.sum(Uj * Ut, axis=0))
    assert Ut.shape == Uj.shape == (135, 6)
    assert _rel(Ut * s, Uj) <= 1e-8
    jm, tm = j["model"], t["model"]
    assert tm.num_points == jm.num_points >= 3
    s2 = np.concatenate((s, s))
    assert np.array_equal(_np(tm.u), np.asarray(jm.u))
    assert _rel(_np(tm.q) * s, jm.q) <= 1e-9
    for k in ("A_d", "A_c"):
        assert _rel(s2[:, None] * _np(getattr(tm, k)) * s2[None, :],
                    getattr(jm, k)) <= 1e-9, k
    for k in ("B_d", "B_c"):
        assert _rel(s2[:, None] * _np(getattr(tm, k)), getattr(jm, k)) \
            <= 1e-9, k
    for k in ("d_d", "d_c"):
        assert _rel(s2 * _np(getattr(tm, k)), getattr(jm, k)) <= 1e-9, k
    assert _rel(t["chk"]["z_rom"], j["chk"]["z_rom"]) <= 1e-8
    assert abs(t["chk"]["mse"] - j["chk"]["mse"]) <= 1e-8 * j["chk"]["mse"]
    assert np.isfinite(t["chk"]["rel_err"])
