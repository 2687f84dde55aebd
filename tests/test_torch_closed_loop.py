"""The host orchestration layer end to end, f64 on the CPU:

1. the golden closed loop (chain plant, TPWL model, EKF, GuSTO MPC through
   `scp`) of tests/test_golden.py, on the committed chain fixture, held to
   tests/golden/closed_loop_chain.npz at that test's tolerances;
2. the configurations of tests/test_closed_loop.py and
   tests/test_policies.py (TrajTracking, the GuSTO MPC, its asynchronous
   solves, StateDLQR / StateCLQR, OpenLoop with an observer, the `ilqr`
   policy), each against a live JAX run on the same model, cut to short
   horizons;
3. `scp` on a 64-point subset of the Diamond campaign dictionary at its
   full width with its POD lift as the plant (the campaign's real-time
   settings), and `scp_ssm` on the committed Diamond SSM artifact with the
   SSM as the plant (tests/test_ssm_mpc.py's configuration), a few ticks
   each against JAX.

Tolerances are stated in each test."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from helpers import chain_pipeline
from torch_helpers import (CAMPAIGN_DT, CAMPAIGN_GUSTO, CAMPAIGN_PARAMS,
                           GOLDEN_CHAIN, SSM_ARTIFACTS, LiftedPlant, TLin,
                           campaign_dict, campaign_output_maps, campaign_scp,
                           campaign_target, golden_loop)

from soft_robot_control_tpu.control import mpc as jmpc
from soft_robot_control_tpu.control import policies as jpol
from soft_robot_control_tpu.control.service import GuSTOService as JService
from soft_robot_control_tpu.core import types as jtypes
from soft_robot_control_tpu.core.constraints import HyperRectangle as JBox
from soft_robot_control_tpu.estimators.ekf import DiscreteEKFObserver as JEKF
from soft_robot_control_tpu.estimators.full_state import (
    FullStateObserver as JFull)
from soft_robot_control_tpu.models import interfaces as jint
from soft_robot_control_tpu.models import ssm as jssm
from soft_robot_control_tpu.models import tpwl as jtpwl
from soft_robot_control_tpu.sim.closed_loop import run_closed_loop as jrun
from soft_robot_control_tpu.sim.fem_surrogate import simulate as jsimulate
from soft_robot_control_tpu_torch.control import mpc as tmpc
from soft_robot_control_tpu_torch.control import policies as tpol
from soft_robot_control_tpu_torch.control.service import GuSTOService
from soft_robot_control_tpu_torch.core import types as ttypes
from soft_robot_control_tpu_torch.estimators.ekf import DiscreteEKFObserver
from soft_robot_control_tpu_torch.estimators.full_state import (
    FullStateObserver)
from soft_robot_control_tpu_torch.models import interfaces as tint
from soft_robot_control_tpu_torch.models import tpwl as ttpwl
from soft_robot_control_tpu_torch.models.convert import (
    model_arrays, model_from_arrays, ssm_model_arrays, ssm_model_from_arrays,
    surrogate_arrays, surrogate_from_arrays)
from soft_robot_control_tpu_torch.sim.closed_loop import run_closed_loop
from soft_robot_control_tpu_torch.sim.measurement import MeasurementModel

DT = 0.02


def _np(a):
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _close(got, ref, tol, msg=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, msg
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(1.0, np.abs(ref).max()),
                               err_msg=msg)


class _JLin:
    """z = M x, the JAX package's way (tests/test_closed_loop.py)."""

    def __init__(self, M):
        self.M = jnp.asarray(M)

    def evaluate(self, x, key=None):
        return self.M @ x


def test_golden_closed_loop():
    """z at rtol 1e-6 / atol 1e-9 and u at rtol 1e-5 / atol 1e-8, the
    golden test's own tolerances, with GuSTO's default dense backend and
    its polish step."""
    z, u, sim = golden_loop()
    ref = np.load(GOLDEN_CHAIN)
    np.testing.assert_allclose(z, ref["z"], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(u, ref["u"], rtol=1e-5, atol=1e-8)
    assert sim["z_hat"].shape == (150, 1) and sim["t"].shape == (150,)
    info = sim["info"]
    assert len(info["solve_times"]) == len(info["z_rollout"]) > 10
    assert info["z_opt"].shape == (len(info["t_opt"]), 1)


# --------------------------------------------------------------------------
# 2. the configurations of test_closed_loop.py and test_policies.py


@pytest.fixture(scope="module")
def pipe():
    """The JAX chain pipeline (plant, ROM, model pre-discretized at
    dt=0.02) and the port's plant and model from the same arrays."""
    jplant, rom, model, Hf, Cf, X, _ = chain_pipeline(
        n_nodes=10, n_cables=4, dt=DT, threshold=0.5)
    jm = model.pre_discretize(DT)
    tplant = surrogate_from_arrays(surrogate_arrays(jplant), device="cpu")
    tm = model_from_arrays(model_arrays(jm), device="cpu")
    return dict(jplant=jplant, tplant=tplant, jm=jm, tm=tm, rom=rom, Hf=Hf,
                Cf=Cf, X=X)


def _both(p, make_ctrl, duration, **kw):
    """make_ctrl(pkg) for the JAX package ('j') and the port ('t'), each
    in its own closed loop on its own plant. Returns the two sim dicts."""
    js = jrun(p["jplant"], make_ctrl("j"), sim_duration=duration, dt=DT,
              measurement_model=_JLin(p["Cf"]), output_model=_JLin(p["Hf"]),
              **kw)
    ts = run_closed_loop(p["tplant"], make_ctrl("t"), sim_duration=duration,
                         dt=DT, measurement_model=TLin(p["Cf"]),
                         output_model=TLin(p["Hf"]), **kw)
    return js, ts


def _same_logs(js, ts, tol):
    assert sorted(k for k in ts if k != "info") == sorted(
        k for k in js if k != "info")
    for k in ("t", "u", "z", "z_hat", "x"):
        if k in js:
            _close(ts[k], js[k], tol, k)


def test_traj_tracking_closed_loop(pipe):
    """Config 1 cut to 50 steps: the tracking LQR along a plant trajectory
    with the default full-state observer on the projected plant state;
    logs within 1e-9 of their scale."""
    p = pipe
    T_steps = 50
    t_traj = DT * np.arange(T_steps + 1)
    u_traj = np.zeros((T_steps + 1, 4))
    u_traj[:, 0] = 1.5 * (1 - np.cos(2 * np.pi * t_traj / 1.5)) / 2
    u_traj[:, 2] = 1.0 * (1 - np.cos(2 * np.pi * t_traj / 2.0)) / 2
    X_des = np.asarray(jsimulate(p["jplant"], p["jplant"].x_rest(),
                                 jnp.asarray(u_traj[:-1]), DT))
    x_red = np.asarray(jax.vmap(p["rom"].project_x)(jnp.asarray(X_des)))
    nx = p["jm"].state_dim
    cost = dict(Q=np.eye(nx), R=0.01 * np.eye(4))

    def make(pkg):
        pol, ty, m = ((jpol, jtypes, p["jm"]) if pkg == "j"
                      else (tpol, ttypes, p["tm"]))
        return pol.TrajTracking(m, ty.QuadraticCost(**cost),
                                ty.Target(t=t_traj, x=x_red, u=u_traj),
                                dt=DT, delay=0.0)

    js, ts = _both(p, make, T_steps * DT)
    _same_logs(js, ts, 1e-9)


def _mpc(p, pkg, N_replan, wait, gusto_iters, amp=0.08):
    """Config 3's GuSTO MPC: a tip sine, N=5 at dt=0.04, Qz=200, R=1e-3 I,
    the EKF with the recipe's W and V, scp(mpc=True), delay 0.2 s."""
    m = p["jm"] if pkg == "j" else p["tm"]
    z0 = float(p["X"][0] @ p["Hf"][0])
    t_target = np.arange(0, 12, DT)
    z_target = (z0 + amp * np.sin(2 * np.pi * t_target / 4.0))[:, None]
    Qz, R = np.array([[200.0]]), 1e-3 * np.eye(4)
    x0 = np.asarray(p["rom"].project_x(jnp.asarray(p["X"][0])))
    H = _np(m.H)
    dx = _np(m.get_characteristic_dx(DT))
    kw = dict(t=t_target, z=z_target, verbose=0, max_gusto_iters=gusto_iters,
              convg_thresh=1e-2)
    if pkg == "j":
        svc = JService(jint.TPWLGuSTO(m), 5, 2 * DT, Qz, R, x0, **kw)
        obs = JEKF(m, W=np.diag(dx + 1e-8), V=0.1 * np.eye(6))
        cost, cls = jtypes.QuadraticCost(Q=H.T @ Qz @ H, R=R), jmpc.scp
    else:
        svc = GuSTOService(tint.TPWLGuSTO(m), 5, 2 * DT, Qz, R, x0, **kw)
        obs = DiscreteEKFObserver(m, W=np.diag(dx + 1e-8), V=0.1 * np.eye(6))
        cost, cls = ttypes.QuadraticCost(Q=H.T @ Qz @ H, R=R), tmpc.scp
    return cls(m, cost, DT, N_replan=N_replan, observer=obs, delay=0.2,
               wait=wait, solver_service=svc, mpc=True)


@pytest.mark.parametrize("N_replan,wait,iters", [(2, True, 5),
                                                 (4, False, 3)])
def test_gusto_mpc_closed_loop(pipe, N_replan, wait, iters):
    """Config 3 (and its asynchronous variant: solves on a background
    thread while the loop runs the current plan) cut to 1 s: logs, the
    spliced plans and the solve count; 1e-7 of the scale (GuSTO's dense
    backend with its polish step, as in the golden loop)."""
    ctrls = {}

    def make(pkg):
        ctrls[pkg] = _mpc(pipe, pkg, N_replan, wait, iters)
        return ctrls[pkg]

    js, ts = _both(pipe, make, 1.0)
    _same_logs(js, ts, 1e-7)
    ji, ti = js["info"], ts["info"]
    assert len(ti["solve_times"]) == len(ji["solve_times"]) >= 3
    for k in ("t_opt", "u_opt", "z_opt"):
        _close(ti[k], ji[k], 1e-7, k)
    for a, b in zip(ti["z_rollout"], ji["z_rollout"]):
        _close(a, b, 1e-7)


def _setpoint_target(p, u_set, hold=6.0):
    """The steady state under a constant input, with the continuous
    linearization there (tests/test_policies.py:_setpoint_target), built
    once with JAX and handed to both packages."""
    N = int(hold / DT)
    X = np.asarray(jsimulate(p["jplant"], p["jplant"].x_rest(),
                             jnp.asarray(np.tile(u_set, (N, 1))), DT))
    x_set = np.asarray(p["rom"].project_x(jnp.asarray(X[-1])))
    A, B, _ = p["jm"].get_jacobians(jnp.asarray(x_set))
    return dict(x=x_set, u=u_set, A=np.asarray(A), B=np.asarray(B))


@pytest.mark.parametrize("name", ["StateDLQR", "StateCLQR"])
def test_setpoint_lqr_closed_loop(pipe, name):
    """The setpoint regulators of test_policies.py, 1 s: logs within 1e-9
    (DLQR) and 1e-8 (CLQR: the least-squares step of the sign-function
    CARE) of their scale."""
    p = pipe
    tgt = _setpoint_target(p, np.array([1.5, 0.0, 1.0, 0.0]))
    nx = p["jm"].state_dim
    H = np.asarray(p["jm"].H)
    cost = dict(Q=H.T @ np.array([[500.0]]) @ H + 1e-3 * np.eye(nx),
                R=0.1 * np.eye(4))

    def make(pkg):
        pol, ty, m = ((jpol, jtypes, p["jm"]) if pkg == "j"
                      else (tpol, ttypes, p["tm"]))
        return getattr(pol, name)(m, ty.QuadraticCost(**cost),
                                  ty.Target(**tgt), dt=DT, delay=0.2)

    js, ts = _both(p, make, 1.0)
    _same_logs(js, ts, 1e-9 if name == "StateDLQR" else 1e-8)


def test_open_loop_with_an_observer(pipe):
    """OpenLoop replay with a full-state observer on the raw plant state,
    the command clamped by u_limits and the full state logged: exactly
    the JAX run's commands, states within 1e-12."""
    p = pipe
    T = 100
    t_seq = DT * np.arange(T)
    u_seq = np.zeros((4, T))
    u_seq[0] = 1.0 * (1 - np.cos(2 * np.pi * t_seq / 1.0)) / 2
    limits = (np.zeros(4), 0.6 * np.ones(4))

    def make(pkg):
        ctrl = (jpol if pkg == "j" else tpol).OpenLoop(
            4, t_seq, u_seq, np.ones(T, dtype=bool), delay=0.3)
        ctrl.add_observer((JFull if pkg == "j" else FullStateObserver)(
            p["jm"].state_dim))
        return ctrl

    js, ts = _both(p, make, 1.0, u_limits=limits, save_full_state=True)
    _same_logs(js, ts, 1e-12)
    np.testing.assert_array_equal(ts["u"], js["u"])
    assert ts["u"].max() == 0.6 and ts["x"].shape == (50, 20)


def test_closed_loop_measurement_noise_from_a_generator(pipe):
    """A noisy MeasurementModel drawn from a torch.Generator, the
    measurements logged by an observer that keeps them: the same seed
    gives the same loop, another seed other measurements, and the noise
    has about the model's spread."""
    p = pipe
    # the chain's 20 states read as the 3-DoF packing of 3 nodes (18
    # states) after the first two
    noisy = MeasurementModel([0, 2], 3, S_q=1e-4 * np.eye(6),
                             S_v=1e-4 * np.eye(6))

    class _Meas:
        def evaluate(self, x, generator=None):
            return noisy.evaluate(x[2:], generator=generator)

    class _Keep:
        z = None

        def update(self, u, y, dt, x=None):
            self.z = y

    def run(seed):
        ctrl = tpol.OpenLoop(4, [0.0, 1.0], np.ones((4, 2)), [True, True],
                             delay=0.1)
        ctrl.add_observer(_Keep())
        return run_closed_loop(
            p["tplant"], ctrl, 0.4, DT, measurement_model=_Meas(),
            output_model=TLin(p["Hf"]), save_full_state=True,
            generator=None if seed is None
            else torch.Generator().manual_seed(seed))

    a, b, c, clean = run(1), run(1), run(2), run(None)
    np.testing.assert_array_equal(a["z_hat"], b["z_hat"])
    assert not np.array_equal(a["z_hat"], c["z_hat"])
    np.testing.assert_array_equal(a["u"], c["u"])
    np.testing.assert_array_equal(a["x"], clean["x"])
    w = a["z_hat"] - clean["z_hat"]
    assert 0.005 < w.std() < 0.02


@pytest.mark.parametrize("feedback_R", [None, 1.0])
def test_ilqr_policy_closed_loop(pipe, feedback_R):
    """The single-shot iLQR policy of test_policies.py with tf = 0.5 s
    (25 steps), 0.8 s of closed loop; with feedback_R the gains are
    recomputed along the plan by the tracking-LQR backward pass. Logs and
    the plan within 1e-8 of their scale."""
    p = pipe
    z0 = float(p["X"][0] @ p["Hf"][0])
    tf = 0.5
    t_traj = np.arange(0, tf + DT, DT)
    z_traj = (z0 + 0.06 * np.sin(2 * np.pi * t_traj / 3.0))[:, None]
    cost = dict(Q=np.array([[500.0]]), R=0.01 * np.eye(4),
                Qf=np.array([[500.0]]))
    ctrls = {}

    def make(pkg):
        pol, ty, m = ((jpol, jtypes, p["jm"]) if pkg == "j"
                      else (tpol, ttypes, p["tm"]))
        ctrls[pkg] = pol.ilqr(m, ty.QuadraticCost(**cost),
                              ty.Target(t=t_traj, z=z_traj, Hf=p["Hf"]),
                              dt=DT, delay=0.2, feedback_R=feedback_R)
        return ctrls[pkg]

    js, ts = _both(p, make, 0.8)
    _same_logs(js, ts, 1e-8)
    for k in ("x_bar", "u_bar", "K"):
        _close(getattr(ctrls["t"], k), getattr(ctrls["j"], k), 1e-8, k)


# --------------------------------------------------------------------------
# 3. scp on the campaign at full width, scp_ssm on the Diamond SSM


class _JLifted:
    """LiftedPlant in JAX: x+ = lift(update_state(project(x), u, dt))."""

    def __init__(self, model):
        self.m = model
        self.input_dim = model.input_dim

    def x_rest(self):
        return self.m.rom.x_ref

    def step(self, x, u, dt):
        rom = self.m.rom
        return rom.lift_x(self.m.update_state(rom.project_x(x), u, dt))


def test_scp_on_the_campaign_with_the_lifted_plant():
    """The Diamond campaign's real-time MPC (torch_helpers.campaign_scp:
    GuSTO one LOCP a query, no trust region, condensed, oneshot_iters=2,
    plan_bound=60, polish off; scp with DARE gains at every point; the
    EKF) at N=5 on a 64-point subset of the dictionary at full width
    (n_x=60, 9768-dim plant state, the lifted dictionary as the plant),
    commands clamped to [0, 1500], a 2-tick delay then 8 ticks. The JAX
    controller is built with the same settings. Logs, the gains and the
    spliced plan within 1e-7 of their scale."""
    Cf, Hf = campaign_output_maps()
    data = campaign_dict(np.arange(0, 1087, 17)[:64])
    kw = dict(params=CAMPAIGN_PARAMS, Cf=Cf, Hf=Hf, discr_method="be")
    jm = jtpwl.from_tpwl_dict(data, **kw)
    tm = ttpwl.from_tpwl_dict(data, device="cpu", **kw)
    dt, N = CAMPAIGN_DT, 5
    tt, z_t = campaign_target(np.asarray(jm.z_ref))
    Qz, R = np.diag([100.0, 100.0, 0.0]), 1e-5 * np.eye(4)
    H = np.asarray(jm.H)
    dx = np.asarray(jm.get_characteristic_dx(dt))
    svc = JService(jint.TPWLGuSTO(jm), N, dt, Qz, R,
                   np.asarray(jm.rom.project_x(jm.rom.x_ref)), t=tt,
                   z=np.asarray(jm.zfyf_to_zy(zf=jnp.asarray(z_t))),
                   U=JBox(1500.0 * np.ones(4), np.zeros(4)), **CAMPAIGN_GUSTO)
    jc = jmpc.scp(jm, jtypes.QuadraticCost(Q=H.T @ Qz @ H, R=R), dt,
                  N_replan=2,
                  observer=JEKF(jm, W=np.diag(dx + 1e-8), V=0.1 * np.eye(30)),
                  delay=0.02, wait=True, solver_service=svc, mpc=True,
                  feedback=True)
    tc = campaign_scp(tm, N=N)
    limits = (np.zeros(4), 1500.0 * np.ones(4))
    js = jrun(_JLifted(jm), jc, sim_duration=0.1, dt=dt,
              measurement_model=_JLin(Cf), output_model=_JLin(Hf),
              u_limits=limits)
    ts = run_closed_loop(LiftedPlant(tm), tc, sim_duration=0.1, dt=dt,
                         measurement_model=TLin(Cf), output_model=TLin(Hf),
                         u_limits=limits)
    assert tc.K.shape == (64, 4, 60)
    _close(tc.K, jc.K, 1e-9)
    _same_logs(js, ts, 1e-7)
    assert np.abs(ts["u"][2:]).max() > 0
    for k in ("t_opt", "u_opt", "z_opt"):
        _close(ts["info"][k], js["info"][k], 1e-7, k)


def test_scp_ssm_on_the_diamond_ssm():
    """scp_ssm with the manifold observer on the committed Diamond SSM,
    the SSM as the plant (tests/test_ssm_mpc.py:config 4): N=3 at
    dt=0.06, R=1e-7 I, one LOCP a query, a 2-tick delay then 8 ticks, the
    measurement the chart output in [v; q] packing; commands and plans
    within 1e-6 of their scale."""
    jm0 = jssm.from_mat(SSM_ARTIFACTS["diamond"], None, discrete=False,
                        discr_method="be")
    arrays = {k: (v.astype(np.float64) if isinstance(v, np.ndarray) else v)
              for k, v in ssm_model_arrays(jm0).items()}
    jm = jssm.SSMModel(**arrays)
    tm = ssm_model_from_arrays(arrays, device="cpu")
    nz = jm.output_dim
    t_target = np.arange(0, 10.0, DT)
    z_target = np.zeros((len(t_target), nz))
    z_target[:, 0] = 2.0 * np.cos(2 * np.pi * t_target / 6.0) - 2.0
    z_target[:, 1] = 2.0 * np.sin(2 * np.pi * t_target / 6.0)
    Qz = np.zeros((nz, nz))
    Qz[0, 0] = Qz[1, 1] = 100.0
    R = 1e-7 * np.eye(jm.input_dim)
    kw = dict(t=t_target, z=z_target, verbose=0, max_gusto_iters=0,
              convg_thresh=1e-2, polish=False)
    out = {}
    for pkg, m in (("j", jm), ("t", tm)):
        x0 = np.zeros(m.state_dim)
        if pkg == "j":
            svc = JService(jint.SSMGuSTO(m), 3, 0.06, Qz, R, x0, **kw)
            ctrl = jmpc.scp_ssm(m, None, DT, N_replan=2, delay=0.04,
                                wait=True, solver_service=svc)
            x = jnp.zeros(m.state_dim)
        else:
            svc = GuSTOService(tint.SSMGuSTO(m), 3, 0.06, Qz, R, x0, **kw)
            ctrl = tmpc.scp_ssm(m, None, DT, N_replan=2, delay=0.04,
                                wait=True, solver_service=svc)
            x = torch.zeros(m.state_dim, dtype=torch.float64)
        ctrl.set_sim_timestep(DT)
        us, u_prev = [], np.zeros(m.input_dim)
        for i in range(10):
            zf = _np(m.x_to_zfyf(x))
            y = np.concatenate((zf[3:], zf[:3]))
            u = ctrl.evaluate(i * DT, y, None, u_prev)
            x = m.update_state(x, (jnp.asarray(u) if pkg == "j"
                                   else torch.as_tensor(u)), DT)
            us.append(u)
            u_prev = u
        out[pkg] = (np.asarray(us), ctrl.save_controller_info(), _np(x))
    (uj, ij, xj), (ut, it, xt) = out["j"], out["t"]
    _close(ut, uj, 1e-6)
    _close(xt, xj, 1e-6)
    assert len(it["solve_times"]) == len(ij["solve_times"]) >= 4
    assert np.abs(ut[2:]).max() > 0
    for k in ("t_opt", "u_opt", "z_opt"):
        _close(it[k], ij[k], 1e-6, k)
