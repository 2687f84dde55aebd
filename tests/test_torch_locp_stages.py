"""The port's stage-structured LOCP (scp/locp_stages.py), GuSTO's stage
backend and run_gusto_standalone against the JAX package, f64 on the CPU,
at N <= 30 (after tests/test_locp_stages.py).

Tolerances: the matrix-free operators and the K blocks within 1e-12 of
JAX relative to their scale; StageLOCP.solve after 150 ADMM iterations
within 1e-9 of JAX, and "cr" within 1e-8 of "scan" (the two KKT solves
round differently, and the 1e3 equality rho amplifies it); GuSTO on the
Dubins car with identical SCP iteration counts and plans within 1e-7 of
their scale (its 600 ADMM iterations an LOCP carry the rounding further)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_helpers  # noqa: F401  (single-threaded torch)

from soft_robot_control_tpu.core.constraints import HyperRectangle as JaxBox
from soft_robot_control_tpu.models.dubins import DubinsCar as JaxDubins
from soft_robot_control_tpu.scp.gusto import GuSTO as JaxGuSTO
from soft_robot_control_tpu.scp.locp_stages import StageLOCP as JaxStage
from soft_robot_control_tpu.scp.locp_stages import (
    StageLOCPAdapter as JaxAdapter)
from soft_robot_control_tpu.scp.standalone import (
    run_gusto_standalone as jax_standalone)
from soft_robot_control_tpu_torch.core.constraints import HyperRectangle
from soft_robot_control_tpu_torch.models.dubins import DubinsCar
from soft_robot_control_tpu_torch.scp.gusto import GuSTO
from soft_robot_control_tpu_torch.scp.locp_stages import (StageLOCP,
                                                          StageLOCPAdapter)
from soft_robot_control_tpu_torch.scp.standalone import run_gusto_standalone

OP_RTOL = 1e-12
SOLVE_ATOL = 1e-9
CR_SCAN_ATOL = 1e-8
GUSTO_RTOL = 1e-7


def _problem(N=8, nx=5, nu=2, nz=2, seed=0, with_sets=True):
    """tests/test_locp_stages.py's problem; the sets as (ub, lb) pairs."""
    rng = np.random.default_rng(seed)
    H = rng.normal(size=(nz, nx))
    Qz = np.diag(rng.uniform(0.5, 2.0, nz))
    R = np.diag(rng.uniform(0.05, 0.2, nu))
    sets = ({"U": (np.ones(nu), -np.ones(nu)),
             "dU": (0.3 * np.ones(nu), -0.3 * np.ones(nu)),
             "X": (2 * np.ones(nx), -2 * np.ones(nx))} if with_sets else {})
    Ad = rng.normal(size=(N, nx, nx)) * 0.3 + 0.7 * np.eye(nx)
    Bd = rng.normal(size=(N, nx, nu))
    dd = 0.05 * rng.normal(size=(N, nx))
    x0 = rng.normal(size=nx) * 0.3
    z = rng.normal(size=(N + 1, nz))
    return H, Qz, R, sets, Ad, Bd, dd, x0, z


def _pair(N, H, Qz, R, sets, kkt_solver="cr", **kw):
    """The JAX StageLOCP and the port's, on the same data."""
    jk = {k: JaxBox(*v) for k, v in sets.items()}
    tk = {k: HyperRectangle(*v) for k, v in sets.items()}
    return (JaxStage(N, H, Qz, R, kkt_solver=kkt_solver, **jk, **kw),
            StageLOCP(N, H, Qz, R, kkt_solver=kkt_solver, device="cpu",
                      **tk, **kw))


def _close(got, ref, rtol):
    ref = np.asarray(ref)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * max(1.0, np.abs(ref).max()))


T = lambda a: torch.as_tensor(np.array(a, dtype=np.float64))


@pytest.mark.parametrize("with_sets", [False, True])
@pytest.mark.parametrize("trust_region", [False, True])
def test_operators_and_blocks_match_jax(with_sets, trust_region):
    N = 7
    H, Qz, R, sets, Ad, Bd, dd, x0, z = _problem(N=N, with_sets=with_sets,
                                                 seed=4)
    kw = {}
    if trust_region:
        kw = dict(trust_region=True, x_char=np.abs(
            np.random.default_rng(5).normal(size=5)) + 0.5)
    js, ts = _pair(N, H, Qz, R, sets, **kw)
    assert (ts.n_var, ts.n_con, ts.nb) == (js.n_var, js.n_con, js.nb)
    rng = np.random.default_rng(1)
    w = rng.normal(size=js.n_var)
    v = rng.normal(size=js.n_con)
    jA, jB = jnp.asarray(Ad), jnp.asarray(Bd)
    _close(ts.A_mv(T(Ad), T(Bd), T(w)), js.A_mv(jA, jB, jnp.asarray(w)),
           OP_RTOL)
    _close(ts.At_mv(T(Ad), T(Bd), T(v)), js.At_mv(jA, jB, jnp.asarray(v)),
           OP_RTOL)
    _close(ts.P_mv(T(w)), js.P_mv(jnp.asarray(w)), OP_RTOL)
    u_des = rng.normal(size=(N, R.shape[0]))
    tr = dict(delta=0.8, xk=0.2 * rng.normal(size=(N + 1, 5)))
    if trust_region:
        _close(ts.q_vec(T(z), T(u_des), omega=T(2.0)),
               js.q_vec(jnp.asarray(z), jnp.asarray(u_des),
                        omega=jnp.asarray(2.0)), OP_RTOL)
        got = ts.bounds(T(x0), T(dd), T(tr["delta"]), T(tr["xk"]))
        ref = js.bounds(jnp.asarray(x0), jnp.asarray(dd),
                        jnp.asarray(tr["delta"]), jnp.asarray(tr["xk"]))
    else:
        _close(ts.q_vec(T(z), T(u_des)),
               js.q_vec(jnp.asarray(z), jnp.asarray(u_des)), OP_RTOL)
        got = ts.bounds(T(x0), T(dd))
        ref = js.bounds(jnp.asarray(x0), jnp.asarray(dd))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(ts.K_blocks(T(Ad), T(Bd)), js.K_blocks(jA, jB)):
        assert a.shape == b.shape
        _close(a, b, OP_RTOL)
    stages = ts.to_stages(T(w))
    _close(stages, js.to_stages(jnp.asarray(w)), 0.0)
    _close(ts.from_stages(stages), w, 0.0)


@pytest.mark.parametrize("with_sets", [False, True])
@pytest.mark.parametrize("N", [1, 2, 8])
def test_solve_matches_jax_cr_and_scan(with_sets, N):
    H, Qz, R, sets, Ad, Bd, dd, x0, z = _problem(N=N, with_sets=with_sets)
    out = {}
    for kkt in ("cr", "scan"):
        js, ts = _pair(N, H, Qz, R, sets, kkt_solver=kkt)
        w, y = ts.solve(Ad, Bd, dd, x0, z, iters=150)
        jw, jy = js.solve(Ad, Bd, dd, x0, z, iters=150)
        _close(w, jw, SOLVE_ATOL)
        _close(y, jy, SOLVE_ATOL)
        out[kkt] = w
    _close(out["cr"], out["scan"].numpy(), CR_SCAN_ATOL)


@pytest.mark.parametrize("kkt", ["cr", "scan"])
def test_solve_with_trust_region_matches_jax(kkt):
    N, nx = 6, 4
    H, Qz, R, sets, Ad, Bd, dd, x0, z = _problem(N=N, nx=nx, seed=4)
    sets["X"] = (2 * np.ones(nx), -2 * np.ones(nx))
    x_char = np.abs(np.random.default_rng(5).normal(size=nx)) + 0.5
    js, ts = _pair(N, H, Qz, R, sets, kkt_solver=kkt, trust_region=True,
                   x_char=x_char)
    xk = 0.2 * np.random.default_rng(6).normal(size=(N + 1, nx))
    w, y = ts.solve(Ad, Bd, dd, x0, z, iters=150, delta=0.8, omega=2.0,
                    xk=xk)
    jw, jy = js.solve(Ad, Bd, dd, x0, z, iters=150, delta=0.8, omega=2.0,
                      xk=xk)
    _close(w, jw, SOLVE_ATOL)
    _close(y, jy, SOLVE_ATOL)


def test_adapter_matches_jax():
    """update / solve / get_solution: the objective, the acceptance and the
    plan, a cold solve then a warm one."""
    N, nx = 6, 4
    H, Qz, R, sets, Ad, Bd, dd, x0, z = _problem(N=N, nx=nx, seed=2)
    x_char = np.ones(nx)
    ja = JaxAdapter(N, H, Qz, R, U=JaxBox(*sets["U"]),
                    dU=JaxBox(*sets["dU"]), x_char=x_char, iters=300)
    ta = StageLOCPAdapter(N, H, Qz, R, U=HyperRectangle(*sets["U"]),
                          dU=HyperRectangle(*sets["dU"]), x_char=x_char,
                          iters=300, device="cpu")
    xk = np.zeros((N + 1, nx))
    for delta in (5.0, 0.5):
        ja.update(Ad, Bd, dd.reshape(-1), x0, xk, delta, 1.0, z=z)
        ta.update(Ad, Bd, dd.reshape(-1), x0, xk, delta, 1.0, z=z)
        (jJ, jok, _), (tJ, tok, _) = ja.solve(), ta.solve()
        assert tok == jok
        np.testing.assert_allclose(tJ, jJ, rtol=1e-10)
        for a, b in zip(ta.get_solution(), ja.get_solution()):
            _close(a, b, SOLVE_ATOL)


def _dubins_problem(N):
    Qz = np.diag([1.0, 1.0, 0.0])
    R = 0.1 * np.eye(2)
    U = (np.array([1.0, 1.0]), np.array([0.0, -1.0]))
    z = np.tile(np.array([1.0, 1.0, 0.0]), (N + 1, 1))
    return Qz, R, U, z


def _same_plan(tg, jg):
    assert tg.itr_count == jg.itr_count
    for k in ("xopt", "uopt", "zopt"):
        _close(getattr(tg, k), getattr(jg, k), GUSTO_RTOL)


def test_gusto_stage_backend_matches_jax():
    """tests/test_locp_stages.py's Dubins problem (N=30, 600 ADMM
    iterations an LOCP) through GuSTO(locp_backend='stage')."""
    N, dt = 30, 0.1
    Qz, R, U, z = _dubins_problem(N)
    jm, tm = JaxDubins(), DubinsCar(device="cpu")
    x0, u_init = np.zeros(3), np.zeros((N, 2))
    x_init = np.asarray(jm.rollout(x0, u_init, dt))
    jg = JaxGuSTO(jm, N, dt, Qz, R, x0, u_init, x_init, z=z, U=JaxBox(*U),
                  verbose=0, warm_start=True, locp_backend="stage",
                  iters=600)
    tg = GuSTO(tm, N, dt, Qz, R, x0, u_init, x_init, z=z,
               U=HyperRectangle(*U), verbose=0, warm_start=True,
               locp_backend="stage", iters=600)
    assert isinstance(tg.locp, StageLOCPAdapter)
    assert tg.itr_count > 1
    _same_plan(tg, jg)


def test_run_gusto_standalone_stage_matches_jax():
    """The open-loop entry point: the rollout guess, a longer time-stamped
    target interpolated onto the grid, the stage backend."""
    N, dt = 20, 0.1
    Qz, R, U, _ = _dubins_problem(N)
    t = 0.05 * np.arange(2 * N + 1)
    z = np.stack([t / t[-1], 0.5 * t / t[-1], np.zeros_like(t)], axis=1)
    jx, ju, jz, jt, jg = jax_standalone(
        JaxDubins(), N, dt, Qz, R, np.zeros(3), t=t, z=z, U=JaxBox(*U),
        locp_backend="stage", iters=400, max_gusto_iters=5)
    tx, tu, tz, tt, tg = run_gusto_standalone(
        DubinsCar(device="cpu"), N, dt, Qz, R, np.zeros(3), t=t, z=z,
        U=HyperRectangle(*U), locp_backend="stage", iters=400,
        max_gusto_iters=5)
    np.testing.assert_array_equal(tt, jt)
    _same_plan(tg, jg)
    for a, b in ((tx, jx), (tu, ju), (tz, jz)):
        _close(a, b, GUSTO_RTOL)


class _Observer(DubinsCar):
    nonlinear_observer = True


@pytest.mark.parametrize("case", ["nonlinear_observer", "Qzf", "Xf"])
def test_gusto_stage_backend_refuses_as_jax_does(case):
    N, dt = 4, 0.1
    Qz, R, U, z = _dubins_problem(N)
    model = (_Observer if case == "nonlinear_observer" else DubinsCar)(
        device="cpu")
    kw = {"Qzf": Qz} if case == "Qzf" else {}
    if case == "Xf":
        kw["Xf"] = HyperRectangle(np.ones(3), -np.ones(3))
    x0 = np.zeros(3)
    with pytest.raises(NotImplementedError, match="stage backend"):
        GuSTO(model, N, dt, Qz, R, x0, np.zeros((N, 2)),
              np.zeros((N + 1, 3)), z=z, locp_backend="stage", **kw)


def test_stage_locp_refuses_an_unknown_solver():
    with pytest.raises(ValueError, match="unknown kkt_solver"):
        StageLOCP(3, np.eye(2), np.eye(2), np.eye(1), kkt_solver="lu",
                  device="cpu")


@pytest.mark.parametrize("kkt", ["cr", "scan"])
def test_f32_error_is_the_jax_packages(kkt):
    """bench.py section 4b's problem (the campaign dictionary's first
    point repeated, Qz = 100 I, R = 1e-3 I, cables in [0, 1500] mN) at
    N=40, 100 iterations, in f32: the 1e3 equality rho amplifies f32
    rounding (cyclic reduction's block inverses more than the sequential
    Cholesky), and the port's f32 solution is as far from its f64 one as
    the JAX package's f32 solution is from JAX's f64 one, within 2x."""
    from torch_helpers import campaign_dict, campaign_output_maps
    from soft_robot_control_tpu_torch.models.tpwl import from_tpwl_dict

    N = 40
    d = campaign_dict([0])
    H = from_tpwl_dict(d, Hf=campaign_output_maps()[1],
                       device="cpu").H.numpy()
    rep = lambda a: np.repeat(np.asarray(a, np.float64), N, axis=0)
    z = 0.05 * np.random.default_rng(3).normal(size=(N + 1, 3))
    data = (rep(d["A_d"]), rep(d["B_d"]), rep(d["d_d"]), np.zeros(60), z)
    args = (N, H, 100.0 * np.eye(3), 1e-3 * np.eye(4))
    err = {}
    for pkg in ("jax", "torch"):
        w = {}
        for name, dt in (("f64", np.float64), ("f32", np.float32)):
            if pkg == "jax":
                st = JaxStage(*args, U=JaxBox(1500.0 * np.ones(4),
                                              np.zeros(4)),
                              kkt_solver=kkt, dtype=dt)
                w[name] = np.asarray(st.solve(
                    *(a.astype(dt) for a in data), iters=100)[0],
                    np.float64)
            else:
                st = StageLOCP(*args, U=HyperRectangle(1500.0 * np.ones(4),
                                                       np.zeros(4)),
                               kkt_solver=kkt, device="cpu",
                               dtype=getattr(torch, str(np.dtype(dt))))
                w[name] = st.solve(*data, iters=100)[0].double().numpy()
        err[pkg] = (np.abs(w["f32"] - w["f64"]).max()
                    / max(np.abs(w["f64"]).max(), 1.0))
    assert 0.0 < err["torch"] <= 2.0 * err["jax"]
