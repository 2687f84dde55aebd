"""The LTI baselines of the port against the JAX package, f64 on the CPU:
the model getters of LinearROM and TPWLModel on the Diamond campaign
dictionary, the Luenberger observer, ROMPC over the campaign's linear ROM,
the Koopman model (exponent tables, EDMD, the .mat constructor, the delay
buffer, the conversion from a JAX model) and KoopmanMPC on synthetic
arrays. Both controllers are fed the same seeded measurement sequence and
must give the same commands step by step.

Tolerances: getters and the observer's gain within 1e-10 of their scale
(the DAREs run 40 doubling steps with LU solves in each package); the
controllers' commands within 1e-9 of their scale over 14 ticks and 3
replans (measured 1e-14 to 5e-14: each replan's ADMM and the observer
carry the rounding on); EDMD within 1e-9 (normal equations of a Gram
matrix with a condition number near 1e6)."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.io
import torch

from torch_helpers import CAMPAIGN, CAMPAIGN_PARAMS, campaign_output_maps

from soft_robot_control_tpu.control import koopman as jck
from soft_robot_control_tpu.control import linear_mpc as jlm
from soft_robot_control_tpu.control import rompc as jrompc
from soft_robot_control_tpu.control.policies import (
    _interp_rows as jax_interp_rows)
from soft_robot_control_tpu.core.constraints import HyperRectangle as JaxBox
from soft_robot_control_tpu.core.types import QuadraticCost as JaxCost
from soft_robot_control_tpu.core.types import Target as JaxTarget
from soft_robot_control_tpu.estimators import luenberger as jlu
from soft_robot_control_tpu.models import koopman as jkm
from soft_robot_control_tpu.models import linear as jlin
from soft_robot_control_tpu.models import tpwl as jtpwl
from soft_robot_control_tpu.ops.monomials import eval_monomials as jax_mono
from soft_robot_control_tpu_torch.control import koopman as tck
from soft_robot_control_tpu_torch.control import linear_mpc as tlm
from soft_robot_control_tpu_torch.control import rompc as trompc
from soft_robot_control_tpu_torch.control.policies import _interp_rows
from soft_robot_control_tpu_torch.core.constraints import HyperRectangle
from soft_robot_control_tpu_torch.core.types import QuadraticCost, Target
from soft_robot_control_tpu_torch.estimators import luenberger as tlu
from soft_robot_control_tpu_torch.models import convert
from soft_robot_control_tpu_torch.models import koopman as tkm
from soft_robot_control_tpu_torch.models import linear as tlin
from soft_robot_control_tpu_torch.models import tpwl as ttpwl

GETTER_RTOL = 1e-10
U_RTOL = 1e-9
EDMD_RTOL = 1e-9


def _close(got, ref, rtol):
    ref = np.asarray(ref, float)
    got = (got.numpy() if torch.is_tensor(got) else np.asarray(got, float))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * max(1.0, np.abs(ref).max()))


@pytest.fixture(scope="module")
def linear_roms():
    """The campaign's linear ROM (its first dictionary point, the
    dictionary's discrete step at dt=0.01) in both packages, in float64
    (the JAX DARE's loop cannot carry the artifact's float32 A_d)."""
    Cf, Hf = campaign_output_maps()
    data = jlin.tpwl_to_linear_rom(CAMPAIGN)
    data.update({k: np.asarray(v, np.float64) for k, v in data.items()
                 if k in ("A_c", "B_c", "d_c", "A_d", "B_d", "d_d")})
    return (jlin.LinearROM(data, 0.01, Cf=Cf, Hf=Hf),
            tlin.LinearROM(data, 0.01, Cf=Cf, Hf=Hf, device="cpu"))


def test_linear_rom_getters_match_jax(linear_roms):
    jl, tl = linear_roms
    assert (tl.get_state_dim(), tl.get_input_dim()) == \
        (jl.get_state_dim(), jl.get_input_dim()) == (60, 4)
    assert tl.get_output_dim() == jl.get_output_dim() == 3
    assert tl.get_meas_dim() == jl.get_meas_dim() == 30
    assert tl.get_sim_params() == jl.get_sim_params()
    rng = np.random.default_rng(0)
    zf, yf = rng.normal(size=3), rng.normal(size=(2, 30))
    _close(tl.zfyf_to_zy(zf=zf), jl.zfyf_to_zy(zf=jnp.asarray(zf)),
           GETTER_RTOL)
    _close(tl.zfyf_to_zy(yf=yf), jl.zfyf_to_zy(yf=jnp.asarray(yf)),
           GETTER_RTOL)
    _close(tl.zy_to_zfyf(z=zf), jl.zy_to_zfyf(z=jnp.asarray(zf)),
           GETTER_RTOL)
    _close(tl.zy_to_zfyf(y=yf[0]), jl.zy_to_zfyf(y=jnp.asarray(yf[0])),
           GETTER_RTOL)
    x, u = rng.normal(size=60), rng.normal(size=4)
    args = [tl.A_d, tl.B_d, tl.d_d]
    _close(tlin.LinearROM.update_dynamics(torch.as_tensor(x),
                                          torch.as_tensor(u), *args),
           jlin.LinearROM.update_dynamics(jnp.asarray(x), jnp.asarray(u),
                                          jl.A_d, jl.B_d, jl.d_d),
           GETTER_RTOL)
    with pytest.raises(RuntimeError, match="output or meas"):
        tl.zfyf_to_zy()


def test_tpwl_getters_match_jax():
    Cf, Hf = campaign_output_maps()
    jm = jtpwl.from_tpwl_dict(CAMPAIGN, params=CAMPAIGN_PARAMS, Cf=Cf, Hf=Hf)
    tm = ttpwl.from_tpwl_dict(CAMPAIGN, params=CAMPAIGN_PARAMS, Cf=Cf, Hf=Hf,
                              device="cpu")
    for name in ("get_state_dim", "get_input_dim", "get_output_dim",
                 "get_meas_dim", "get_sim_params"):
        assert getattr(tm, name)() == getattr(jm, name)(), name
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 60))
    zf, yf = rng.normal(size=3), rng.normal(size=30)
    _close(tm.zfyf_to_zy(zf=zf), jm.zfyf_to_zy(zf=jnp.asarray(zf)),
           GETTER_RTOL)
    _close(tm.zfyf_to_zy(yf=yf), jm.zfyf_to_zy(yf=jnp.asarray(yf)),
           GETTER_RTOL)
    _close(tm.zy_to_zfyf(y=yf), jm.zy_to_zfyf(y=jnp.asarray(yf)),
           GETTER_RTOL)
    for kw in ({"z": True}, {"y": True}):
        _close(tm.x_to_zy(torch.as_tensor(x), **kw),
               jm.x_to_zy(jnp.asarray(x), **kw), GETTER_RTOL)


def test_interp_rows_matches_jax():
    rng = np.random.default_rng(2)
    t = np.cumsum(rng.uniform(0.1, 1, 9))
    Y = rng.normal(size=(9, 3))
    tq = rng.uniform(t[0] - 1, t[-1] + 1, 20)
    np.testing.assert_array_equal(_interp_rows(tq, t, Y),
                                  jax_interp_rows(tq, t, Y))
    np.testing.assert_array_equal(tck._interp_prev(tq, t, Y),
                                  jck._interp_prev(tq, t, Y))


def test_luenberger_observer_matches_jax(linear_roms):
    """The gain of the dual DARE, then an observer run from a full-order
    state near rest under seeded commands and measurements."""
    jl, tl = linear_roms
    nx, ny = 60, 30
    Q, R = np.eye(nx), np.eye(ny)
    L = tlu.luenberger_gain(tl.A_d, tl.C, torch.as_tensor(Q),
                            torch.as_tensor(R))
    jL = jlu.luenberger_gain(jl.A_d, jl.C, jnp.asarray(Q), jnp.asarray(R))
    _close(L, jL, GETTER_RTOL)
    jo = jlu.DiscreteLuenbergerObserver(jl, Q, R)
    to = tlu.DiscreteLuenbergerObserver(tl, Q, R)
    rng = np.random.default_rng(3)
    xf = np.asarray(jl.rom.x_ref) + 0.1 * rng.normal(size=jl.rom.x_ref.shape)
    jo.initialize(xf)
    to.initialize(xf)
    _close(to.x, jo.x, GETTER_RTOL)
    y_ref = np.asarray(jl.y_ref)
    for _ in range(5):
        u = rng.uniform(0, 1500, 4)
        y = y_ref + rng.normal(size=ny)
        jo.update(u, y)
        to.update(u, y)
        _close(to.x, jo.x, GETTER_RTOL)
        _close(to.z, jo.z, GETTER_RTOL)
    x, u = rng.normal(size=nx), rng.uniform(0, 1500, 4)
    y = y_ref + rng.normal(size=ny)
    _close(tlu.luenberger_update(tl, torch.as_tensor(x), torch.as_tensor(u),
                                 torch.as_tensor(y), L),
           jlu.luenberger_update(jl, jnp.asarray(x), jnp.asarray(u),
                                 jnp.asarray(y), jL), GETTER_RTOL)


@pytest.mark.parametrize("qp_backend", ["xla", "pallas"])
def test_rompc_commands_match_jax(linear_roms, qp_backend):
    """examples/diamond_baselines_campaign.py's ROMPC settings (Qz =
    diag(100, 100, 0), R = 1e-4 I, Qf = 10 Qz, N_replan=4, condensed) at
    a horizon of 8, fed one seeded measurement sequence: 3 replans. The
    adaptive 'xla' solve runs with polish=False: its polish step guesses
    the active set from the signs of duals that are rounding noise at the
    cable's lower bound, and the two runtimes guess differently
    (ROADMAP.md, section 3)."""
    jl, tl = linear_roms
    N, dt = 8, 0.01
    Qz, R = np.diag([100.0, 100.0, 0.0]), 1e-4 * np.eye(4)
    tt = dt * np.arange(400)
    zt = np.zeros((len(tt), 3))
    zt[:, 0] = 15.0 * np.sin(2 * np.pi * tt / 2.0)
    zt[:, 1] = 7.5 * np.sin(4 * np.pi * tt / 2.0)
    H = np.asarray(jl.H)
    kw = dict(locp_backend="condensed", qp_backend=qp_backend)
    if qp_backend == "xla":
        kw["polish"] = False
    U = (1500.0 * np.ones(4), np.zeros(4))
    js = jlm.LinearMPCService(jl, N, dt, JaxCost(Q=Qz, R=R, Qf=10.0 * Qz),
                              JaxTarget(t=tt, z=zt), U=JaxBox(*U), **kw)
    ts = tlm.LinearMPCService(tl, N, dt, QuadraticCost(Q=Qz, R=R,
                                                       Qf=10.0 * Qz),
                              Target(t=tt, z=zt), U=HyperRectangle(*U), **kw)
    cost = dict(Q=H.T @ Qz @ H, R=R)
    costL = dict(Q=np.eye(60), R=np.eye(30))
    jc = jrompc.ROMPC(jl, JaxCost(**cost), JaxCost(**costL), dt, N_replan=4,
                      delay=0.02, wait=True, solver_service=js)
    tc = trompc.ROMPC(tl, QuadraticCost(**cost), QuadraticCost(**costL), dt,
                      N_replan=4, delay=0.02, wait=True, solver_service=ts)
    _close(tc.K, jc.K, GETTER_RTOL)
    rng = np.random.default_rng(4)
    xf = np.asarray(jl.rom.x_ref) + 0.01 * rng.normal(
        size=jl.rom.x_ref.shape)
    y_ref = np.asarray(jl.y_ref)
    u_prev = np.zeros(4)
    for k in range(14):
        y = y_ref + 0.1 * rng.normal(size=30)
        ju = jc.evaluate(dt * k, y, xf, u_prev)
        tu = tc.evaluate(dt * k, y, xf, u_prev)
        _close(tu, ju, U_RTOL)
        u_prev = ju
    assert tc.t_compute == jc.t_compute
    assert len(tc.solve_times) == len(jc.solve_times) == 3
    ji, ti = jc.save_controller_info(), tc.save_controller_info()
    for k in ("t_opt", "u_opt", "z_opt"):
        _close(ti[k], ji[k], U_RTOL)


@pytest.mark.parametrize("dim,order,dmd", [(3, 2, False), (4, 2, True),
                                           (2, 3, False), (10, 2, False)])
def test_koopman_exponents_match_jax(dim, order, dmd):
    got = tkm.koopman_exponents(dim, order, dmd)
    np.testing.assert_array_equal(got, jkm.koopman_exponents(dim, order, dmd))
    assert (got[-1] == 0).all() != dmd


def _edmd_data(seed=2, nz=2, m=1, deg=2, T=300):
    """A system linear in the lifted space (after tests/
    test_koopman_rompc.py): (zeta, u)."""
    rng = np.random.default_rng(seed)
    exps = jkm.koopman_exponents(nz, deg)
    A_true = rng.normal(size=(len(exps), len(exps))) * 0.2
    B_true = rng.normal(size=(len(exps), m)) * 0.2
    zeta = np.zeros((T, nz))
    u = rng.normal(size=(T, m))
    zeta[0] = rng.normal(size=nz) * 0.1
    for t in range(T - 1):
        phi = np.asarray(jax_mono(jnp.asarray(zeta[t]), exps))
        zeta[t + 1] = (A_true @ phi + B_true @ u[t])[:nz]
    return zeta, u


def test_train_edmd_matches_jax():
    zeta, u = _edmd_data()
    for reg in (0.0, 1e-8):
        got = tkm.train_edmd(zeta, u, degree=2, reg=reg, device="cpu")
        ref = jkm.train_edmd(zeta, u, degree=2, reg=reg)
        for g, r in zip(got, ref):
            _close(g, r, EDMD_RTOL)


def _scale(ny, nu, rng):
    return {"y_offset": rng.normal(size=ny),
            "y_factor": rng.uniform(0.5, 2.0, ny),
            "u_offset": np.zeros(nu), "u_factor": rng.uniform(0.5, 2.0, nu)}


def test_koopman_model_from_mat_matches_jax(tmp_path):
    """A .mat in the soft-robot-koopman layout, written by scipy's savemat:
    dimensions, lifting, and the delay buffer against JAX."""
    rng = np.random.default_rng(5)
    n, m, delays, deg = 3, 4, 1, 2
    nzeta = n * (delays + 1) + m * delays
    N = len(jkm.koopman_exponents(nzeta, deg))
    C = np.zeros((n, N))
    C[:, :n] = np.eye(n)
    model = {"A": 0.1 * rng.normal(size=(N, N)),
             "B": rng.normal(size=(N, m)), "C": C, "M": np.eye(2),
             "K": np.zeros(2), "W": np.eye(N)}
    params = {"n": n, "m": m, "N": N, "nzeta": nzeta, "delays": delays,
              "obs_degree": deg, "Ts": 0.05,
              "obs_type": np.array([["poly"]], dtype=object),
              "scale": _scale(n, m, rng)}
    path = str(tmp_path / "koopman_model.mat")
    scipy.io.savemat(path, {"py_data": {"model": model, "params": params}})
    d = scipy.io.loadmat(path)["py_data"][0, 0]
    jm = jkm.KoopmanModel(d["model"], d["params"])
    tm = tkm.KoopmanModel(d["model"], d["params"], device="cpu")
    assert (tm.n, tm.m, tm.N, tm.state_dim, tm.delays, tm.obs_degree) == \
        (jm.n, jm.m, jm.N, jm.state_dim, jm.delays, jm.obs_degree) == \
        (n, m, N, nzeta, delays, deg)
    assert tm.Ts == jm.Ts and tm.obs_type == jm.obs_type == "poly"
    for k in ("A_d", "B_d", "C", "H", "V", "W"):
        np.testing.assert_array_equal(getattr(tm, k).numpy(),
                                      np.asarray(getattr(jm, k)), err_msg=k)
    zeta = 0.3 * rng.normal(size=nzeta)
    _close(tm.lift_data(*zeta), jm.lift_data(*zeta), 1e-15)
    Z = rng.normal(size=(5, nzeta))
    _close(tm.lift_batch(Z), jm.lift_batch(jnp.asarray(Z)), 1e-15)
    assert float(tm.lift_data(*zeta)[-1]) == 1.0

    jd, td = jkm.KoopmanData(jm.scale, delays), tkm.KoopmanData(tm.scale,
                                                               delays)
    assert td.get_zeta is not None
    for _ in range(4):
        y, u = rng.normal(size=n), rng.normal(size=m)
        jd.add_measurement(y, u)
        td.add_measurement(y, u)
        np.testing.assert_array_equal(np.asarray(td.get_zeta(), float),
                                      np.asarray(jd.get_zeta(), float))
    with pytest.raises(ValueError, match="params N="):
        bad = dict(params, N=N + 1)
        scipy.io.savemat(path, {"py_data": {"model": model, "params": bad}})
        d = scipy.io.loadmat(path)["py_data"][0, 0]
        tkm.KoopmanModel(d["model"], d["params"], device="cpu")


def test_koopman_offline_data_matches_jax(tmp_path):
    """KoopmanOfflineData's bulk zeta over a recorded run (a pickle the
    port's save_data writes) against JAX's, and its last row against the
    online buffer."""
    from soft_robot_control_tpu_torch.utils.io import save_data

    rng = np.random.default_rng(8)
    sc = tkm.ScaleRows(_scale(3, 4, rng))
    T, delays = 20, 2
    data = {"t": 0.05 * np.arange(T), "z": rng.normal(size=(T, 3)),
            "u": rng.normal(size=(T, 4))}
    path = str(tmp_path / "run_sim.pkl")
    save_data(path, data)
    got, ref = (m.KoopmanOfflineData(sc, delays) for m in (tkm, jkm))
    for o in (got, ref):
        o.load_offline_data(path)
        o.add_zeta_offline()
    assert got.zeta.shape == (T - delays, 3 * (delays + 1) + 4 * delays)
    np.testing.assert_array_equal(got.zeta, ref.zeta)
    online = tkm.KoopmanData(sc, delays)
    for y, u in zip(data["z"], data["u"]):
        online.add_measurement(y, u)
    np.testing.assert_allclose(got.zeta[-1], online.get_zeta(), rtol=0,
                               atol=1e-12)


def _koopman_pair(rng, dmd=False):
    """A JAX KoopmanModel trained by EDMD on synthetic data, and the
    port's from it through models/convert.py."""
    ny, m, delays, deg = 2, 1, 1, 2
    zeta_raw, u = _edmd_data(nz=ny, m=m)
    # delay-embed the synthetic outputs: [y_t, y_{t-1}, u_{t-1}]
    zeta = np.hstack([zeta_raw[1:], zeta_raw[:-1], u[:-1]])
    A, B, C = jkm.train_edmd(zeta, u[1:], degree=deg, dmd=dmd, reg=1e-8)
    jm = jkm.koopman_model_from_arrays(
        A, B, C[:ny], n=ny, m=m, nzeta=zeta.shape[1], delays=delays,
        obs_degree=deg, Ts=0.05, scale_dict=_scale(ny, m, rng), dmd=dmd)
    return jm, convert.koopman_model_from_dict(
        convert.koopman_model_arrays(jm), device="cpu")


def test_koopman_model_conversion():
    rng = np.random.default_rng(6)
    jm, tm = _koopman_pair(rng)
    arrays = convert.koopman_model_arrays(tm)
    ref = convert.koopman_model_arrays(jm)
    assert arrays.keys() == ref.keys()
    for k, v in ref.items():
        if isinstance(v, dict):
            for kk in v:
                np.testing.assert_array_equal(arrays[k][kk], v[kk])
        else:
            np.testing.assert_array_equal(np.asarray(arrays[k]),
                                          np.asarray(v), err_msg=k)
    direct = tkm.koopman_model_from_arrays(
        np.asarray(jm.A_d), np.asarray(jm.B_d), np.asarray(jm.C), jm.n,
        jm.m, jm.state_dim, jm.delays, jm.obs_degree, jm.Ts,
        {k: np.ravel(jm.scale[k]) for k in ("y_offset", "y_factor",
                                            "u_offset", "u_factor")},
        device="cpu")
    zeta = rng.normal(size=jm.state_dim)
    _close(direct.lift_data(*zeta), jm.lift_data(*zeta), 1e-15)
    assert direct.get_state_dim() == jm.get_state_dim()
    assert direct.get_input_dim() == jm.get_input_dim() == 1


def _koopman_controllers(jm, tm, qp_backend, input_hold, Y=None):
    """KoopmanMPC at the campaign's settings (U = [0, 1], dU = +-0.08,
    Qf = 5 Qz, rollout_horizon=4, condensed), N=6, in both packages (the
    JAX one None where jm is None)."""
    N, dt, ny, m = 6, tm.Ts, tm.n, tm.m
    tt = dt * np.arange(200)
    zt = 0.3 * np.stack([np.sin(tt), np.cos(tt)], axis=1)
    Qz, R = 100.0 * np.eye(ny), 1e-1 * np.eye(m)
    ub = (np.ones(m), np.zeros(m))
    dub = (0.08 * np.ones(m), -0.08 * np.ones(m))
    kw = dict(locp_backend="condensed", qp_backend=qp_backend, max_iter=2000)
    if qp_backend == "pallas":
        kw.update(qp_iters=600, rho_stages=6)
    ctl = dict(delay=0.1, wait=True, rollout_horizon=4, input_hold=input_hold)
    ts = tlm.LinearMPCService(tm, N, dt, QuadraticCost(Q=Qz, R=R, Qf=5 * Qz),
                              Target(t=tt, z=zt), U=HyperRectangle(*ub),
                              dU=HyperRectangle(*dub), **kw)
    tc = tck.KoopmanMPC(tm, solver_service=ts, Y=Y, **ctl)
    if jm is None:
        return None, tc
    js = jlm.LinearMPCService(jm, N, dt, JaxCost(Q=Qz, R=R, Qf=5 * Qz),
                              JaxTarget(t=tt, z=zt), U=JaxBox(*ub),
                              dU=JaxBox(*dub), **kw)
    return jck.KoopmanMPC(jm, solver_service=js, **ctl), tc


@pytest.mark.parametrize("qp_backend", ["xla", "pallas"])
@pytest.mark.parametrize("input_hold", [False, True])
def test_koopman_mpc_commands_match_jax(qp_backend, input_hold):
    """KoopmanMPC as examples/diamond_baselines_campaign.py runs it (no
    measurement polytope) on the EDMD model of synthetic data, fed one
    seeded measurement sequence: the commands step by step, the plans and
    the delay buffer."""
    rng = np.random.default_rng(7)
    jm, tm = _koopman_pair(rng)
    jc, tc = _koopman_controllers(jm, tm, qp_backend, input_hold)
    u_prev = np.zeros(tm.m)
    for k in range(14):
        y = rng.normal(size=tm.n)
        ju = jc.evaluate(tm.Ts * k, y, None, u_prev)
        tu = tc.evaluate(tm.Ts * k, y, None, u_prev)
        _close(tu, ju, U_RTOL)
        u_prev = ju
    assert tc.t_compute == jc.t_compute
    assert len(tc.solve_times) == len(jc.solve_times) >= 2
    ji, ti = jc.save_controller_info(), tc.save_controller_info()
    for k in ("t_opt", "u_opt", "z_opt"):
        _close(ti[k], ji[k], U_RTOL)
    _close(tc.x_opt_full, jc.x_opt_full, U_RTOL)
    _close(tc.data.y_norm, jc.data.y_norm, 1e-12)


def test_koopman_mpc_reprojects_measurements_outside_y():
    """With a measurement polytope Y, a measurement outside it enters the
    delay buffer as its Euclidean projection: against the same controller
    without Y fed the exact projection (the clip onto the box).

    Not held to JAX: the projection is an adaptive ADMM solve whose polish
    step guesses the active set from the signs of the duals, and on this
    sequence the JAX package's guess takes an inactive row in, projecting
    (0.695, -1.344) onto [-0.8, 0.8]^2 at (0.8, -0.8) (ROADMAP.md,
    section 3, reference behaviour)."""
    rng = np.random.default_rng(7)
    _, tm = _koopman_pair(rng)
    lim = 0.8 * np.ones(tm.n)
    _, with_y = _koopman_controllers(None, tm, "pallas", False,
                                     Y=HyperRectangle(lim, -lim))
    _, clipped = _koopman_controllers(None, tm, "pallas", False)
    u_prev, outside = np.zeros(tm.m), 0
    for k in range(14):
        y = rng.normal(size=tm.n)
        outside += int(np.abs(y).max() > 0.8)
        u = with_y.evaluate(tm.Ts * k, y, None, u_prev)
        _close(u, clipped.evaluate(tm.Ts * k, np.clip(y, -lim, lim), None,
                                   u_prev), 1e-6)
        u_prev = u
    assert outside >= 5
    _close(with_y.data.y_norm, clipped.data.y_norm, 1e-6)


class _DeviceTensor(torch.Tensor):
    """A tensor that numpy cannot read in place, as one on the card: its
    values reach the host through .cpu() only."""

    def __array__(self, *a, **k):
        raise TypeError("can't convert a device tensor to numpy")


def test_koopman_mpc_takes_the_measurement_as_a_device_tensor():
    """The closed loop hands the controller the measurement as a tensor on
    the plant's device (sim/closed_loop.py): KoopmanMPC copies it to its
    host delay buffer, and its commands are those of numpy measurements.
    Before the copy, numpy read the tensor in place and a measurement on
    the card raised."""
    rng = np.random.default_rng(7)
    _, tm = _koopman_pair(rng)
    _, host = _koopman_controllers(None, tm, "pallas", False)
    _, dev = _koopman_controllers(None, tm, "pallas", False)
    u_prev = np.zeros(tm.m)
    with pytest.raises(TypeError):
        np.asarray(torch.zeros(2).as_subclass(_DeviceTensor))
    for k in range(8):
        y = rng.normal(size=tm.n)
        u = host.evaluate(tm.Ts * k, y, None, u_prev)
        yd = torch.as_tensor(y).as_subclass(_DeviceTensor)
        np.testing.assert_array_equal(dev.evaluate(tm.Ts * k, yd, None,
                                                   u_prev), u)
        u_prev = u
    assert len(dev.solve_times) >= 2
    np.testing.assert_array_equal(dev.data.y_norm, host.data.y_norm)
